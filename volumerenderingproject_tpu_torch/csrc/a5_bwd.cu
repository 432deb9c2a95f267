// Backward of the fused a5/TEST ray march (K6) for NVIDIA Hopper (sm_90a).
//
// Replaces volumerenderingproject_tpu/ops/pallas_a5.py:_a5_bwd_kernel (its
// f32-row and 4-bit id modes) and, for volumes the TPU streams, its
// streamed variant _a5_streamed_bwd_kernel: the id grid stays in device
// memory.  Given the per-ray cotangents g (of the rgb output) and g_t
// (of the final transmittance T_N, which reaches the output through
// out = C + T_N * bg), it computes dL/dcolors [K, 4] of the a5 march
// (a5.cu) at eps 0.
//
// The a5 sample colour is linear in the colour table: each corner
// classifies to one interval and the mix only weights them.  So sample s has
// per-interval coefficients
//   coef_k = sum_corners w_tri,c [id_c == k]   inside the volume,
//   coef_k = [id0 == k]                        outside it,
// with the trilinear weights as products in pallas_a5.py:1344-1349's order,
// and the prefix/suffix scheme of K4 (march_bwd.cu) carries over:
//   a_s = sum_k coef_k alpha_k,  rgb_s = sum_k coef_k rgb_k      (k order)
//   dL/drgb_k   += coef_k w_s g
//   dL/dalpha_k += coef_k (T_s (g . rgb_s) - (S_{>s} + T_N g_t) / (1 - a_s))
//   S_{>s}       = sum_{j>s} w_j (g . rgb_j)
// a and rgb are recomputed in this coefficient form in both passes (as the
// TPU kernel does, pallas_a5.py:1350-1368), so the suffix at the last sample
// is exactly 0; the forward's mixed form differs from it in the last bits.
// Where 1 - a_s == 0 the division term is 0, as in the TPU kernel.
//
// One thread marches one ray twice, back to back (pass A: the total and
// T_N; pass B: the prefix and the per-interval terms).  Every sample has a
// gradient (a sample of alpha 0 still has an alpha gradient), but most lie
// outside the volume, and there each is one constant of the launch: the
// coefficients [id0 == k], so colour c0 (alpha a0) by the coefficient
// form, and gd0 = g . c0 once a ray.  So each ray takes its span
// (a5_span, a5_common.cuh: the samples whose position may lie in [0,
// dims)) and runs the full chain only there; every sample outside it is the
// constant, as in K4:
//   * pass A adds (T a0) gd0 and multiplies T by 1 - a0, the full
//     evaluation's operations, so T_N, the total and pass B's prefix are the
//     full evaluation's to the bit;
//   * pass B keeps each constant sample's w, T and numerator S_{>s} + T_N
//     g_t but runs no chain, no load and no interval loop: its dL/da = T
//     gd0 - num / (1 - a0) is linear in T and num with constant
//     coefficients, so the ray sums w, T and num and folds them into
//     interval id0 once, with one division a ray;
//   * where a0 == 0 (the default TF's interval 0) such a sample leaves T
//     and the prefix as they are and every sample of a run of them has the
//     dL/da of the first: pass A skips the run, pass B adds its length times
//     that dL/da.
// The folds regroup float sums, so K6 is not bit-exact to
// march_a5_bwd_plain (chip_smoke.py holds it to TOL_GRAD of max |dplain|,
// and its block partials to the float64 sums of the plain terms).
//
// Per-interval sums stay in registers: the kernel is instantiated for K <=
// 4, 8 and 16, and a corner's weight reaches interval k through a select in
// the unrolled k loop (adding 0 elsewhere is exact).  A sample adds coef_k w
// and coef_k dL/da to interval k's two sums; the rgb columns are g times the
// first, taken once a ray (as K4 does).  Each block reduces its rays' [K, 4]
// sums by warp shuffles and then over the warps in a fixed order into one
// partial of partials [nblocks, K, 4] (block_reduce.cuh, shared with K4),
// which the caller sums with torch.sum: no atomics, the same bits every run.
//
// What bounds it on an H100: operations, those of the samples in the span.
// Per sample there and pass: the position and corner chain of K3 (some 40
// float operations, the position 16 of them, and eight dependent byte
// loads from the id grid, which the 50 MB L2 holds whole), the 8 weights,
// 8K coefficient selects and adds and 8K products and sums for a and rgb,
// and in pass B 4K more for the sums; a constant sample costs a few
// operations (none where a0 == 0).  A warp runs the chain for the union of
// its rays' spans; 8x64 pixel blocks make a warp 8 x 4 neighbouring rays,
// whose spans overlap, and hold an SM to 16 warps, whose corner lines stay
// in L1.  The bytes it must move (ids, 16 bytes of cotangent per ray, the
// partials) are far fewer.  Registers hold all per-ray state, shared memory
// the colours; voxel indices are 32-bit where a5_index32 allows them.
//
// A sharded a5 fit (parallel/render_dist.py, differentiable=True) launches
// it once per rank on that rank's work unit, the backward of K3's segment
// mode (render_test_pallas_diff_segment, pallas_a5.py:2056; scal[24] and
// [25] of _a5_bwd_kernel, :1177, 1186, 1219): columns [x_offset, x_offset
// + width) and samples [s_start, s_start + spr).  The camera grid takes the
// global column and the position the global sample index, as in a5.cu.
// g_t is then the cotangent of the unit's own final T, which the fold's
// autograd gives; bg_term = T_N g_t is unchanged.

#include "a5_common.cuh"
#include "block_reduce.cuh"

namespace {

constexpr int kMaxIntervals = 16;  // the JAX kernel's limit
// a block's pixels along y (threadIdx.x) and x (threadIdx.y);
// ops/a5_vjp.BLOCK_Y, BLOCK_X.  8x64: one block of 16 warps an SM at the
// K <= 4 instance's 80 registers, where 4x64 blocks put 24 warps there,
// whose corner lines thrash L1: 33 % faster at a5_500 on the MNI-dims
// volume, 2 % on sphere100; 15-29 % slower on bench.py's dense 320^3 /
// 512^3 spheres at 304x304x300, whose samples lie 2.1 voxels apart (0.87 at
// a5_500) and share fewer lines (harness/ab_march.py; PERF.md)
constexpr int kBlockY = 8, kBlockX = 64;
constexpr int kThreads = kBlockY * kBlockX;
constexpr int kWarps = kThreads / 32;

// Sample i of the ray in coefficient form: coef[k], alpha and rgb.
template <int KMAX, typename Idx>
__device__ __forceinline__ void a5_coef_sample(
    const A5Chain& ch, const float q[3], int i, const A5Geom& g,
    const uint8_t* __restrict__ ids, int id0,
    const float4* __restrict__ s_col, float coef[KMAX], float4& col) {
  int id8[8];
  float f[3];
  if (a5_corners<Idx>(ch, q, i, g, ids, id0, id8, f)) {
    const float fx = f[0], fy = f[1], fz = f[2];
    const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
    // corner order (00z, 00z1, 01z, 01z1, 10z, ...): (y * x) * z products
    const float wt[8] = {(gy * gx) * gz, (gy * gx) * fz, (fy * gx) * gz,
                         (fy * gx) * fz, (gy * fx) * gz, (gy * fx) * fz,
                         (fy * fx) * gz, (fy * fx) * fz};
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      float ck = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) ck = ck + (id8[c] == k ? wt[c] : 0.0f);
      coef[k] = ck;
    }
  } else {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) coef[k] = id0 == k ? 1.0f : 0.0f;
  }
  col = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    col.x = col.x + coef[k] * s_col[k].x;
    col.y = col.y + coef[k] * s_col[k].y;
    col.z = col.z + coef[k] * s_col[k].z;
    col.w = col.w + coef[k] * s_col[k].w;
  }
}

template <int KMAX, typename Idx>
__global__ void __launch_bounds__(kThreads)
march_bwd_a5_kernel(const float* __restrict__ scal,
                    const float* __restrict__ colors, int num_intervals,
                    const uint8_t* __restrict__ ids, A5Geom g,
                    const float* __restrict__ g_rgb,
                    const float* __restrict__ g_t,
                    float* __restrict__ partials) {
  __shared__ float4 s_col[KMAX];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < KMAX) {
    s_col[tid] = tid < num_intervals
                     ? make_float4(colors[4 * tid], colors[4 * tid + 1],
                                   colors[4 * tid + 2], colors[4 * tid + 3])
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  // per interval: the sum of coef w (the rgb columns, times g at the end)
  // and of coef dL/da
  float sw[KMAX], sa[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) sw[k] = sa[k] = 0.0f;
  float gr = 0.0f, gg = 0.0f, gb = 0.0f;

  // threadIdx.x runs along y, as in K3; threads off the image take part in
  // the reduction with zero sums
  const int py = blockIdx.x * blockDim.x + threadIdx.x;
  const int px = blockIdx.y * blockDim.y + threadIdx.y;
  if (px < g.width && py < g.height) {
    const A5Chain ch = a5_chain(scal);
    float q[3];
    a5_ray_q(scal, px + g.x_off, py, q);
    const int id0 = (int)scal[S_ID0];
    const long long ray = (long long)px * g.height + py;
    gr = g_rgb[3 * ray];
    gg = g_rgb[3 * ray + 1];
    gb = g_rgb[3 * ray + 2];
    float coef[KMAX];
    float4 col;
    // the constant: a sample outside the volume, by the coefficient form
#pragma unroll
    for (int k = 0; k < KMAX; ++k) coef[k] = id0 == k ? 1.0f : 0.0f;
    float4 c0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      c0.x = c0.x + coef[k] * s_col[k].x;
      c0.y = c0.y + coef[k] * s_col[k].y;
      c0.z = c0.z + coef[k] * s_col[k].z;
      c0.w = c0.w + coef[k] * s_col[k].w;
    }
    const float a0 = c0.w;
    const float gd0 = (gr * c0.x + gg * c0.y) + gb * c0.z;
    const float denom0 = 1.0f - a0;
    const bool a0_zero = a0 == 0.0f;
    const int lo = g.s_start, end = g.s_start + g.spr;
    int c_lo, c_hi;
    a5_span(ch, q, g, c_lo, c_hi);

    // ---- pass A: total of w (g . c) and the final transmittance ----------
    float t = 1.0f;
    float total = 0.0f;
#define A5_PASS_A_RUN(i0, j0)           \
  if (!a0_zero) {                       \
    for (int i = (i0); i < (j0); ++i) { \
      total = total + (t * a0) * gd0;   \
      t = t * denom0;                   \
    }                                   \
  }
    A5_PASS_A_RUN(lo, c_lo)
    for (int i = c_lo; i <= c_hi; ++i) {
      a5_coef_sample<KMAX, Idx>(ch, q, i, g, ids, id0, s_col, coef, col);
      const float gd = (gr * col.x + gg * col.y) + gb * col.z;
      total = total + (t * col.w) * gd;
      t = t * (1.0f - col.w);
    }
    A5_PASS_A_RUN(c_hi + 1, end)
#undef A5_PASS_A_RUN
    const float bg_term = t * g_t[ray];  // T_N * dL/dT_N

    // ---- pass B: prefix re-march and the per-interval terms --------------
    t = 1.0f;
    float pfx = 0.0f;
    // the constant samples' sums: w, dL/da, and where a0 != 0 T and the
    // numerator of the division, which is folded once a ray
    float ow = 0.0f, oda = 0.0f, ot = 0.0f, onum = 0.0f;
    // a run [i, j) of constant samples
#define A5_PASS_B_RUN(i0, j0)                               \
  if (a0_zero) {                                            \
    /* w = 0: T and the prefix stay, so every sample of the \
       run has the dL/da of its first (1 - 0 divides        \
       exactly) */                                          \
    const int n = (j0) - (i0);                              \
    if (n > 0) {                                            \
      const float num = (total - pfx) + bg_term;            \
      oda = oda + (float)n * (t * gd0 - num);               \
    }                                                       \
  } else {                                                  \
    for (int i = (i0); i < (j0); ++i) {                     \
      const float w = t * a0;                               \
      pfx = pfx + w * gd0;                                  \
      ow = ow + w;                                          \
      ot = ot + t;                                          \
      onum = onum + ((total - pfx) + bg_term);              \
      t = t * denom0;                                       \
    }                                                       \
  }
    A5_PASS_B_RUN(lo, c_lo)
    for (int i = c_lo; i <= c_hi; ++i) {
      a5_coef_sample<KMAX, Idx>(ch, q, i, g, ids, id0, s_col, coef, col);
      const float gd = (gr * col.x + gg * col.y) + gb * col.z;
      const float w = t * col.w;
      pfx = pfx + w * gd;  // pass A's order: total - pfx is exact at the end
      const float suffix = total - pfx;
      const float denom = 1.0f - col.w;
      const float num = suffix + bg_term;
      const float da = t * gd - (denom != 0.0f ? num / denom : 0.0f);
      t = t * denom;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        sw[k] += coef[k] * w;
        sa[k] += coef[k] * da;
      }
    }
    A5_PASS_B_RUN(c_hi + 1, end)
#undef A5_PASS_B_RUN
    // sum_s T_s gd0 - num_s / (1 - a0), the division gated as a sample's
    oda = oda + (gd0 * ot - (denom0 != 0.0f ? onum / denom0 : 0.0f));

    // ---- the constant samples' terms, folded once ------------------------
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const bool sel = id0 == k;
      sw[k] += sel ? ow : 0.0f;
      sa[k] += sel ? oda : 0.0f;
    }
  }

  float acc[KMAX][4];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    acc[k][0] = gr * sw[k];
    acc[k][1] = gg * sw[k];
    acc[k][2] = gb * sw[k];
    acc[k][3] = sa[k];
  }
  write_block_partial<KMAX, kWarps>(acc, num_intervals, partials);
}

template <typename Idx>
void launch(const float* scal, const float* colors, int K,
            const uint8_t* ids, const A5Geom& g, const float* g_rgb,
            const float* g_t, float* partials, cudaStream_t s) {
  const dim3 block(kBlockY, kBlockX);
  const dim3 grid((g.height + kBlockY - 1) / kBlockY,
                  (g.width + kBlockX - 1) / kBlockX);
  if (K <= 4) {
    march_bwd_a5_kernel<4, Idx><<<grid, block, 0, s>>>(
        scal, colors, K, ids, g, g_rgb, g_t, partials);
  } else if (K <= 8) {
    march_bwd_a5_kernel<8, Idx><<<grid, block, 0, s>>>(
        scal, colors, K, ids, g, g_rgb, g_t, partials);
  } else {
    march_bwd_a5_kernel<16, Idx><<<grid, block, 0, s>>>(
        scal, colors, K, ids, g, g_rgb, g_t, partials);
  }
}

}  // namespace

// Launches the a5 backward march on `stream`; returns cudaGetLastError()
// (0 = launched).  scal: [41] f32 (ops/a5.py layout); colors: [K, 4] f32,
// K <= 16; ids: [d1, d2, d3] uint8 (C order); the work unit: columns
// [x_offset, x_offset + width), samples [s_start, s_start + spr); g_rgb:
// [width, height, 3] f32 and g_t: [width, height] f32, the cotangents of
// the unit's C and final T; partials: [ceil(width/64) * ceil(height/8), K,
// 4] f32, one [K, 4] sum per block of 64 x 8 pixels (block (px / 64) *
// ceil(height / 8) + py / 8).
extern "C" int vrp_march_bwd_a5(const float* scal, const float* colors,
                                int K, const uint8_t* ids, int d1, int d2,
                                int d3, int width, int height, int spr,
                                int x_offset, int s_start,
                                const float* g_rgb, const float* g_t,
                                float* partials, void* stream) {
  if (K <= 0 || K > kMaxIntervals || width <= 0 || height <= 0 ||
      spr <= 0 || x_offset < 0 || s_start < 0)
    return (int)cudaErrorInvalidValue;
  const A5Geom g =
      make_a5_geom(d1, d2, d3, width, height, spr, x_offset, s_start);
  cudaStream_t s = (cudaStream_t)stream;
  if (a5_index32(d1, d2, d3))
    launch<int>(scal, colors, K, ids, g, g_rgb, g_t, partials, s);
  else
    launch<long long>(scal, colors, K, ids, g, g_rgb, g_t, partials, s);
  return (int)cudaGetLastError();
}
