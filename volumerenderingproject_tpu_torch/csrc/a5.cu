// Fused a5/TEST ray march (K3) for NVIDIA Hopper (sm_90a).
//
// Replaces volumerenderingproject_tpu/ops/pallas_a5.py:_a5_kernel in its
// unlit resident modes (the f32 rows for z <= 127 and the 4-bit id grid for
// z <= 1023): camera-grid sample positions through modelCam, inverseView and
// toVolume, 8 corners per sample with float-offset truncation and the
// flat-index wrap, per-corner classification, the y->x->z colour mix,
// front-to-back (C, T) compositing and early ray termination; and its
// baked-light variant (`baked_light`, a template parameter): per-voxel
// Blinn-Phong factor grids M and S (f32, in HBM), rgb <- rgb * M + S at the
// containing voxel trunc(p) of a sample inside the volume, M = 1 and S = 0
// outside (pallas_a5.py:93-98, 283, 447-455).  The a5 view direction is the
// camera's front for every ray, so the factors are per voxel for any
// camera.  Its segment and streamed (ms_stream, id_stream) variants are not
// here.
//
// One thread marches one ray:
//   per sample: the three stage matrices -> inside [0, dims)? -> 8 corner
//   ids from a flat uint8 id grid (a corner at flat >= total takes id0) ->
//   8 RGBAs from shared memory -> mix y->x->z [-> rgb * M + S] ->
//   C += T*a*rgb, T *= 1 - a;
//   a sample outside the volume takes TF(0)'s colour
//   -> stop before the first sample with T <= eps
//   -> out = (C + T * background, 1).
// The id grid replaces both TPU layouts: the classification is per corner,
// so corner ids and the colour table give the corner colours bit for bit,
// and indexing by the flat index reproduces the reference's row wraps.
// There is no skip besides early termination (the TPU kernel has none).
//
// What bounds it on an H100: operations.  The id grid takes one byte per
// voxel (7.2 MB at 182x218x182) and stays in the 50 MB L2; the image is 16
// bytes per ray.  Each sample costs some 110 float operations (positions
// 54, fractions 9, the mix 84 over four channels, the composite 9, less what
// a ray hoists) and eight dependent byte loads.  The design keeps the stage
// matrices in registers, the colours in shared memory, uses 16x16 pixel
// blocks so that a warp's corner loads share cache lines, and stops each ray
// as soon as its transmittance reaches eps.  The baked variant is bound by
// bytes instead: M and S take 8 bytes per voxel (58 MB at 182x218x182, more
// than L2 holds), two loads per sample inside the volume at its containing
// voxel, shared between neighbouring rays as the corner loads are.
//
// Position and corner chain are in a5_common.cuh, shared with the backward
// march (a5_bwd.cu).

#include "a5_common.cuh"

namespace {

constexpr int kMaxIntervals = 256;  // ids are uint8

template <bool kBaked>
__global__ void __launch_bounds__(256)
march_a5_kernel(const float* __restrict__ scal,
                const float* __restrict__ colors, int num_intervals,
                const uint8_t* __restrict__ ids,
                const float* __restrict__ mgrid,
                const float* __restrict__ sgrid, A5Geom g,
                float* __restrict__ out) {
  __shared__ float4 s_col[kMaxIntervals];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = tid; k < num_intervals; k += blockDim.x * blockDim.y)
    s_col[k] = make_float4(colors[4 * k], colors[4 * k + 1],
                           colors[4 * k + 2], colors[4 * k + 3]);
  __syncthreads();

  // threadIdx.x runs along y: out is [W, H, 4], y fastest
  const int py = blockIdx.x * blockDim.x + threadIdx.x;
  const int px = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= g.width || py >= g.height) return;

  A5Ray r;
  a5_ray_setup(scal, px, py, r);
  const float eps = fmaxf(scal[S_EPS], 0.0f);
  const int id0 = (int)scal[S_ID0];
  const float4 c0 = s_col[id0];

  float cr = 0.0f, cg = 0.0f, cb = 0.0f, t = 1.0f;
  for (int i = 0; i < g.spr; ++i) {
    if (!(t > eps)) break;
    int id8[8];
    float f[3];
    float4 col = c0;
    long long flat0 = -1;
    if (a5_corners(r, i, g, ids, id0, id8, f, kBaked ? &flat0 : nullptr)) {
      const float fx = f[0], fy = f[1], fz = f[2];
      const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
      float4 c[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) c[k] = s_col[id8[k]];
      // trilinear_mix_colors: y, then x, then z (kernel.cu:161-175)
#define A5_MIX(ch)                                                   \
  {                                                                  \
    const float cy1 = c[0].ch * gy + c[2].ch * fy;                   \
    const float cy2 = c[1].ch * gy + c[3].ch * fy;                   \
    const float cy3 = c[4].ch * gy + c[6].ch * fy;                   \
    const float cy4 = c[5].ch * gy + c[7].ch * fy;                   \
    const float cz1 = cy1 * gx + cy3 * fx;                           \
    const float cz2 = cy2 * gx + cy4 * fx;                           \
    col.ch = cz1 * gz + cz2 * fz;                                    \
  }
      A5_MIX(x)
      A5_MIX(y)
      A5_MIX(z)
      A5_MIX(w)
#undef A5_MIX
    }
    if constexpr (kBaked) {
      const float m = flat0 < 0 ? 1.0f : __ldg(mgrid + flat0);
      const float sh = flat0 < 0 ? 0.0f : __ldg(sgrid + flat0);
      col.x = col.x * m + sh;
      col.y = col.y * m + sh;
      col.z = col.z * m + sh;
    }
    const float w = t * col.w;
    cr = cr + w * col.x;
    cg = cg + w * col.y;
    cb = cb + w * col.z;
    t = t * (1.0f - col.w);
  }

  float4 px_out;
  px_out.x = cr + t * scal[S_BG];
  px_out.y = cg + t * scal[S_BG + 1];
  px_out.z = cb + t * scal[S_BG + 2];
  px_out.w = 1.0f;
  reinterpret_cast<float4*>(out)[(long long)px * g.height + py] = px_out;
}

}  // namespace

// Launches the a5 march on `stream`; returns cudaGetLastError() (0 =
// launched).  scal: [41] f32 (ops/a5.py layout); colors: [K, 4] f32,
// K <= 256; ids: [d1, d2, d3] uint8 (C order); mgrid, sgrid: [d1, d2, d3]
// f32, both null for an unlit march; out: [width, height, 4] f32.
extern "C" int vrp_march_a5(const float* scal, const float* colors, int K,
                            const uint8_t* ids, int d1, int d2, int d3,
                            int width, int height, int spr,
                            const float* mgrid, const float* sgrid,
                            float* out, void* stream) {
  if (K <= 0 || K > kMaxIntervals || width <= 0 || height <= 0 || spr <= 0 ||
      (mgrid == nullptr) != (sgrid == nullptr))
    return (int)cudaErrorInvalidValue;
  const A5Geom g = make_a5_geom(d1, d2, d3, width, height, spr);
  const dim3 block(16, 16);
  const dim3 grid((height + 15) / 16, (width + 15) / 16);
  const cudaStream_t s = (cudaStream_t)stream;
  if (mgrid != nullptr)
    march_a5_kernel<true><<<grid, block, 0, s>>>(scal, colors, K, ids, mgrid,
                                                 sgrid, g, out);
  else
    march_a5_kernel<false><<<grid, block, 0, s>>>(scal, colors, K, ids,
                                                  mgrid, sgrid, g, out);
  return (int)cudaGetLastError();
}
