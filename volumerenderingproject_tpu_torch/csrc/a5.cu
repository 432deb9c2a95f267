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
// camera; the single-scattering term rides S.  The volumes that its streamed
// modes (ms_stream, id_stream) stage block by block stay in device memory
// here.
//
// A sharded render (parallel/render_dist.py) launches it once per rank on
// that rank's work unit on the rays and samples axes (`segment=True`,
// pallas_a5.py:851, 1118-1123): columns [x_offset, x_offset + width) and
// samples [s_start, s_start + spr).  The camera grid is indexed by the
// global column (pallas_a5.py:172-178) and the position by the global
// sample index (:212), so the unit's samples sit where the whole render
// puts them; early termination acts on the unit's own T, which starts at 1;
// with `segment` set the output is (C, T), no background.
//
// One thread marches one ray:
//   per sample: the position (a5_common.cuh) -> inside [0, dims)? -> 8
//   corner ids from a flat uint8 id grid (a corner at flat >= total takes
//   id0) -> 8 RGBAs from shared memory -> mix y->x->z [-> rgb * M + S] ->
//   C += T*a*rgb, T *= 1 - a;
//   a sample outside the volume takes TF(0)'s colour c0
//   -> stop before the first sample with |T| <= eps (a sample of alpha
//      > 1 makes T negative, and the ray goes on compositing)
//   -> out = (C + T * background, 1).
// The id grid replaces both TPU layouts: the classification is per corner,
// so corner ids and the colour table give the corner colours bit for bit,
// and indexing by the flat index reproduces the reference's row wraps.
//
// Most samples of most rays lie outside the volume (8-9 % inside on an
// orbit of the MNI-dims grid).  So each ray takes its span (a5_span, the
// samples whose position may lie in [0, dims)) and runs the chain only
// there; inside the span the chain's own inside test decides, as before.
// Every sample outside the span is c0 (M = 1, S = 0 when baked):
//   * where c0's alpha is 0 (the default TF's interval 0), such a sample
//     changes nothing, bit for bit: w = T * 0 is a signed zero, C + (+-0)
//     is C (C is never -0: it starts at +0 and a sum that cancels is +0),
//     and T (1 - 0) is T, for any T, negative too.  Those samples are
//     skipped, and early termination, which reads T alone, stops the ray
//     at the same sample;
//   * otherwise they are composited with c0 in the full evaluation's
//     operations and early-termination test, with no chain and no load.
// So K3 stays bit-exact to march_a5_plain.  A ray that misses the box costs
// its span and, where c0's alpha is not 0, a composite a sample.
//
// What bounds it on an H100: operations.  The id grid takes one byte per
// voxel (7.2 MB at 182x218x182) and stays in the 50 MB L2; the image is 16
// bytes per ray.  A sample inside the span costs some 130 float operations
// (the position 16, the inside test 6, truncations and fractions 15, the
// mix 84 over four channels, the composite 9) and eight dependent byte
// loads.  The design keeps the
// launch's 13 chain constants and the ray's 3 in registers, the colours in
// shared memory, uses 4x64 pixel blocks (a warp is 4 x 8 neighbouring
// rays, whose spans and corner loads overlap), 32-bit voxel indices where
// a5_index32 allows them, and stops each ray as soon as its transmittance
// reaches eps.  The baked variant is bound by bytes instead: M and S take 8
// bytes per voxel (58 MB at 182x218x182, more than L2 holds), two loads per
// sample inside the volume at its containing voxel, shared between
// neighbouring rays as the corner loads are.
//
// Position, span and corner chain are in a5_common.cuh, shared with the
// backward march (a5_bwd.cu).

#include "a5_common.cuh"

namespace {

constexpr int kMaxIntervals = 256;  // ids are uint8
// a block's pixels along y (threadIdx.x) and x (threadIdx.y), as K1's: 24
// warps an SM at 70 registers, where K3 runs fastest (8x64 blocks, 16
// warps: 13 % slower at a5_500 on the MNI-dims volume; harness/ab_march.py)
constexpr int kBlockY = 4, kBlockX = 64;
constexpr int kThreads = kBlockY * kBlockX;

template <bool kBaked, typename Idx>
__global__ void __launch_bounds__(kThreads)
march_a5_kernel(const float* __restrict__ scal,
                const float* __restrict__ colors, int num_intervals,
                const uint8_t* __restrict__ ids,
                const float* __restrict__ mgrid,
                const float* __restrict__ sgrid, A5Geom g, int segment,
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

  const A5Chain ch = a5_chain(scal);
  float q[3];
  a5_ray_q(scal, px + g.x_off, py, q);
  const float eps = fmaxf(scal[S_EPS], 0.0f);
  const int id0 = (int)scal[S_ID0];
  float4 c0 = s_col[id0];
  if constexpr (kBaked) {  // a sample outside the volume: M = 1, S = 0
    c0.x = c0.x * 1.0f + 0.0f;
    c0.y = c0.y * 1.0f + 0.0f;
    c0.z = c0.z * 1.0f + 0.0f;
  }
  const bool c0_clear = c0.w == 0.0f;
  int lo, hi;
  a5_span(ch, q, g, lo, hi);
  const int end = g.s_start + g.spr;

  float cr = 0.0f, cg = 0.0f, cb = 0.0f, t = 1.0f;
  bool live = true;
  // a run [i, j) of samples outside the span: c0 each, as the full
  // evaluation composites it
#define A5_CONST_RUN(i0, j0)                       \
  if (live && !c0_clear) {                         \
    for (int i = (i0); i < (j0); ++i) {            \
      if (!(fabsf(t) > eps)) {                     \
        live = false;                              \
        break;                                     \
      }                                            \
      const float w = t * c0.w;                    \
      cr = cr + w * c0.x;                          \
      cg = cg + w * c0.y;                          \
      cb = cb + w * c0.z;                          \
      t = t * (1.0f - c0.w);                       \
    }                                              \
  }
  A5_CONST_RUN(g.s_start, lo)
  for (int i = lo; live && i <= hi; ++i) {
    if (!(fabsf(t) > eps)) {
      live = false;
      break;
    }
    int id8[8];
    float f[3];
    float4 col = c0;
    Idx flat0 = -1;
    if (a5_corners<Idx>(ch, q, i, g, ids, id0, id8, f,
                        kBaked ? &flat0 : nullptr)) {
      const float fx = f[0], fy = f[1], fz = f[2];
      const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
      float4 c[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) c[k] = s_col[id8[k]];
      // trilinear_mix_colors: y, then x, then z (kernel.cu:161-175)
#define A5_MIX(comp)                                                   \
  {                                                                    \
    const float cy1 = c[0].comp * gy + c[2].comp * fy;                 \
    const float cy2 = c[1].comp * gy + c[3].comp * fy;                 \
    const float cy3 = c[4].comp * gy + c[6].comp * fy;                 \
    const float cy4 = c[5].comp * gy + c[7].comp * fy;                 \
    const float cz1 = cy1 * gx + cy3 * fx;                             \
    const float cz2 = cy2 * gx + cy4 * fx;                             \
    col.comp = cz1 * gz + cz2 * fz;                                    \
  }
      A5_MIX(x)
      A5_MIX(y)
      A5_MIX(z)
      A5_MIX(w)
#undef A5_MIX
      if constexpr (kBaked) {
        const float m = __ldg(mgrid + flat0);
        const float sh = __ldg(sgrid + flat0);
        col.x = col.x * m + sh;
        col.y = col.y * m + sh;
        col.z = col.z * m + sh;
      }
    }
    const float w = t * col.w;
    cr = cr + w * col.x;
    cg = cg + w * col.y;
    cb = cb + w * col.z;
    t = t * (1.0f - col.w);
  }
  A5_CONST_RUN(hi + 1, end)
#undef A5_CONST_RUN

  float4 px_out;
  if (segment) {  // the unit's raw (C, T)
    px_out = make_float4(cr, cg, cb, t);
  } else {
    px_out.x = cr + t * scal[S_BG];
    px_out.y = cg + t * scal[S_BG + 1];
    px_out.z = cb + t * scal[S_BG + 2];
    px_out.w = 1.0f;
  }
  reinterpret_cast<float4*>(out)[(long long)px * g.height + py] = px_out;
}

template <typename Idx>
void launch(const float* scal, const float* colors, int K,
            const uint8_t* ids, const float* mgrid, const float* sgrid,
            const A5Geom& g, int segment, float* out, cudaStream_t s) {
  const dim3 block(kBlockY, kBlockX);
  const dim3 grid((g.height + kBlockY - 1) / kBlockY,
                  (g.width + kBlockX - 1) / kBlockX);
  if (mgrid != nullptr)
    march_a5_kernel<true, Idx><<<grid, block, 0, s>>>(
        scal, colors, K, ids, mgrid, sgrid, g, segment, out);
  else
    march_a5_kernel<false, Idx><<<grid, block, 0, s>>>(
        scal, colors, K, ids, mgrid, sgrid, g, segment, out);
}

}  // namespace

// Whether the a5 kernels take 32-bit voxel indices on a d1 x d2 x d3 grid
// (a5_index32); ops/a5.index32 mirrors it.
extern "C" int vrp_a5_index32(int d1, int d2, int d3) {
  return a5_index32(d1, d2, d3) ? 1 : 0;
}

// Launches the a5 march on `stream`; returns cudaGetLastError() (0 =
// launched).  scal: [41] f32 (ops/a5.py layout); colors: [K, 4] f32,
// K <= 256; ids: [d1, d2, d3] uint8 (C order); mgrid, sgrid: [d1, d2, d3]
// f32, both null for an unlit march; the work unit: columns [x_offset,
// x_offset + width), samples [s_start, s_start + spr); out: [width, height,
// 4] f32, (C + T bg, 1), or with segment set (C, T).
extern "C" int vrp_march_a5(const float* scal, const float* colors, int K,
                            const uint8_t* ids, int d1, int d2, int d3,
                            int width, int height, int spr,
                            const float* mgrid, const float* sgrid,
                            int x_offset, int s_start, int segment,
                            float* out, void* stream) {
  if (K <= 0 || K > kMaxIntervals || width <= 0 || height <= 0 || spr <= 0 ||
      (mgrid == nullptr) != (sgrid == nullptr) || x_offset < 0 ||
      s_start < 0)
    return (int)cudaErrorInvalidValue;
  const A5Geom g =
      make_a5_geom(d1, d2, d3, width, height, spr, x_offset, s_start);
  const cudaStream_t s = (cudaStream_t)stream;
  if (a5_index32(d1, d2, d3))
    launch<int>(scal, colors, K, ids, mgrid, sgrid, g, segment, out, s);
  else
    launch<long long>(scal, colors, K, ids, mgrid, sgrid, g, segment, out,
                      s);
  return (int)cudaGetLastError();
}
