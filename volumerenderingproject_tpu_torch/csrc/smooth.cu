// Smooth-mode a1 ray march (K8) for NVIDIA Hopper (sm_90a).
//
// Replaces volumerenderingproject_tpu/ops/pallas_smooth.py:
// _smooth_fwd_kernel: ortho or conic rays, zero-padded trilinear
// intensities of the f32 volume over the float cal_max, the sigmoid-product
// smooth transfer function (Interp.TRILINEAR), front-to-back (C, T)
// compositing and early ray termination; out = (C + T * background, 1).
//
// One thread marches one ray.  It clips itself to the samples that may
// have a corner in the volume (smooth_sample_range, smooth_common.cuh): a
// sample outside that range reads intensity 0, whose smooth alpha is not 0
// (1.8e-11 for the default TF at sharpness 200, 2.6e-4 at 60), so it still
// composites, with the launch's constant RGBA rgba0 = classify(0 / cal_max),
// taken once per block through the same function; only the samples in the
// range run the position, the eight reads and the sigmoids.  Every sample
// gets the RGBA and the compositing it got from the full evaluation, in the
// same order, so the march is bit-exact to march_smooth_plain.  The ray
// stops before the first sample at which |T| <= eps (per ray; the TPU
// kernel tests max(T) > eps over a 16x16 tile per 16-sample chunk, which is
// within eps of it for T >= 0; at eps 0 this march stops only where T == 0,
// so a ray whose T went negative after an alpha above 1 goes on, as the
// reference scan does, where the TPU kernel drops its tile).  The TPU's
// 10-bit packed volume and its f32 rows (z <= 128) were layouts for VMEM;
// here the volume stays exact f32 [X, Y, Z] in HBM at any size (29 MB at
// 182x218x182, which the 50 MB L2 holds); the TF and rgba0 sit in shared
// memory.
//
// What bounds it on an H100: operations, those of the samples in the range
// (some 110 float operations at 4 intervals: position, floor and
// fractions, seven lerps, the division, two expf, two IEEE divisions and a
// product per interval, compositing), which the launch's bound counts,
// beside 9 a sample for the rest.  A warp runs the full chain for the union
// of its 32 rays' ranges, so its rays are neighbours (4 x 8 pixels,
// smooth_common.cuh): that keeps the union near each ray's own and their
// corner loads in few lines.
// Tensor cores, TMA and clusters do not serve this walk: its eight corner
// reads per sample depend on the ray, and there is no product to tile.

#include "smooth_common.cuh"

namespace {

template <int KMAX>
__global__ void __launch_bounds__(kSmoothThreads)
smooth_fwd_kernel(const float* __restrict__ scal,
                  const float* __restrict__ lower,
                  const float* __restrict__ upper,
                  const float* __restrict__ colors, int num_intervals,
                  const float* __restrict__ vol, Geom g, int conic,
                  float* __restrict__ out) {
  __shared__ SmoothTF<KMAX> tf;
  const SmoothScalars s = load_smooth_scalars(scal);
  load_tf<KMAX>(tf, lower, upper, colors, num_intervals, s);

  // threadIdx.x runs along y, as in K1: out is [W, H, 4], y fastest
  const int py = blockIdx.x * blockDim.x + threadIdx.x;
  const int px = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= g.width || py >= g.height) return;

  float o[3], d[3];
  ray_setup(scal, g, px, py, conic, o, d);
  const float eps = fmaxf(scal[S_EPS], 0.0f);
  int i_lo, i_hi;
  smooth_sample_range(o, d, s, g, i_lo, i_hi);
  const float4 rgba0 = tf.rgba0;

  float s1[KMAX], s2[KMAX], w[KMAX];  // unused here: K9's
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, t = 1.0f;
  for (int i = 0; i < g.spr; ++i) {
    if (!(fabsf(t) > eps)) break;
    float4 col = rgba0;
    if (i >= i_lo && i <= i_hi) {
      int b[3];
      float f[3];
      smooth_position(i, o, d, s, b, f);
      const float vn = smooth_intensity(vol, g, b, f) / s.cal;
      col = smooth_classify<KMAX>(tf, num_intervals, s.sharp, vn, s1, s2, w);
    }
    const float wt = t * col.w;
    cr = cr + wt * col.x;
    cg = cg + wt * col.y;
    cb = cb + wt * col.z;
    t = t * (1.0f - col.w);
  }

  float4 px_out;
  px_out.x = cr + t * scal[SM_BG];
  px_out.y = cg + t * scal[SM_BG + 1];
  px_out.z = cb + t * scal[SM_BG + 2];
  px_out.w = 1.0f;
  reinterpret_cast<float4*>(out)[(long long)px * g.height + py] = px_out;
}

}  // namespace

// Launches the smooth march on `stream`; returns cudaGetLastError() (0 =
// launched).  scal: [29] f32 (ops/smooth.py layout); lower, upper: [K] f32;
// colors: [K, 4] f32, K <= 16; vol: [d1, d2, d3] f32 (C order); out:
// [width, height, 4] f32.
extern "C" int vrp_smooth_fwd(const float* scal, const float* lower,
                              const float* upper, const float* colors, int K,
                              const float* vol, int d1, int d2, int d3,
                              int width, int height, int spr, int conic,
                              float* out, void* stream) {
  if (K <= 0 || K > kSmoothMaxIntervals || width <= 0 || height <= 0 ||
      spr <= 0 || d1 <= 0 || d2 <= 0 || d3 <= 0)
    return (int)cudaErrorInvalidValue;
  const Geom g = make_geom(d1, d2, d3, 0, width, height, spr, 0, 0, 0);
  const dim3 block(kSmoothBlockY, kSmoothBlockX);
  const dim3 grid((height + kSmoothBlockY - 1) / kSmoothBlockY,
                  (width + kSmoothBlockX - 1) / kSmoothBlockX);
  const cudaStream_t st = (cudaStream_t)stream;
  if (K <= 4)
    smooth_fwd_kernel<4><<<grid, block, 0, st>>>(scal, lower, upper, colors,
                                                  K, vol, g, conic, out);
  else if (K <= 8)
    smooth_fwd_kernel<8><<<grid, block, 0, st>>>(scal, lower, upper, colors,
                                                  K, vol, g, conic, out);
  else
    smooth_fwd_kernel<16><<<grid, block, 0, st>>>(scal, lower, upper, colors,
                                                   K, vol, g, conic, out);
  return (int)cudaGetLastError();
}
