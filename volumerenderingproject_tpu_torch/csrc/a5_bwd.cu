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
// Where 1 - a_s == 0 the division term is 0, as in the TPU kernel.  Every
// sample of every ray is marched: a sample of alpha 0 still has an alpha
// gradient.
//
// One thread marches one ray twice, back to back (pass A: the total and
// T_N; pass B: the prefix and the per-interval terms).  Per-interval sums
// stay in registers: the kernel is instantiated for K <= 4, 8 and 16, and a
// corner's weight reaches interval k through a select in the unrolled k
// loop (adding 0 elsewhere is exact).  Each block reduces its rays' [K, 4]
// sums by warp shuffles and then over the warps in a fixed order into one
// partial of partials [nblocks, K, 4] (block_reduce.cuh, shared with K4),
// which the caller sums with torch.sum: no atomics, the same bits every run.
//
// What bounds it on an H100: operations.  Per sample and pass it costs the
// position and corner chain of K3 (some 70 float operations and eight
// dependent byte loads from the id grid, which the 50 MB L2 holds whole),
// the 8 weights, 8K coefficient selects and adds and 8K products and sums
// for a and rgb, and in pass B 9K more for the terms; the bytes it must move
// (ids, 16 bytes of cotangent per ray, the partials) are far fewer.
// Registers hold all per-ray state, shared memory the colours.
//
// A sharded a5 fit (parallel/render_dist.py, differentiable=True) launches
// it once per rank on that rank's work unit, the backward of K3's segment
// mode (render_test_pallas_diff_segment, pallas_a5.py:2056; scal[24] and
// [25] of _a5_bwd_kernel, :1177, 1186, 1219): columns [x_offset, x_offset
// + width) and samples [s_start, s_start + spr).  The camera grid takes the
// global column and the stage matrices the global sample index, as in
// a5.cu.  g_t is then the cotangent of the unit's own final T, which the
// fold's autograd gives; bg_term = T_N g_t is unchanged.

#include "a5_common.cuh"
#include "block_reduce.cuh"

namespace {

constexpr int kMaxIntervals = 16;  // the JAX kernel's limit
constexpr int kBlock = 16;         // pixels per block edge
constexpr int kWarps = kBlock * kBlock / 32;

// Sample i of the ray in coefficient form: coef[k], alpha and rgb.
template <int KMAX>
__device__ __forceinline__ void a5_coef_sample(
    const A5Ray& r, int i, const A5Geom& g, const uint8_t* __restrict__ ids,
    int id0, const float4* __restrict__ s_col, float coef[KMAX],
    float4& col) {
  int id8[8];
  float f[3];
  if (a5_corners(r, i, g, ids, id0, id8, f)) {
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

template <int KMAX>
__global__ void __launch_bounds__(kBlock * kBlock)
march_bwd_a5_kernel(const float* __restrict__ scal,
                    const float* __restrict__ colors, int num_intervals,
                    const uint8_t* __restrict__ ids, A5Geom g,
                    int x_offset, int s_start,
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

  float acc[KMAX][4];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[k][c] = 0.0f;
  }

  // threadIdx.x runs along y, as in K3; threads off the image take part in
  // the reduction with zero sums
  const int py = blockIdx.x * blockDim.x + threadIdx.x;
  const int px = blockIdx.y * blockDim.y + threadIdx.y;
  if (px < g.width && py < g.height) {
    A5Ray r;
    a5_ray_setup(scal, px + x_offset, py, r);
    const int id0 = (int)scal[S_ID0];
    const long long ray = (long long)px * g.height + py;
    const float gr = g_rgb[3 * ray];
    const float gg = g_rgb[3 * ray + 1];
    const float gb = g_rgb[3 * ray + 2];
    float coef[KMAX];
    float4 col;

    // ---- pass A: total of w (g . c) and the final transmittance ----------
    float t = 1.0f;
    float total = 0.0f;
    for (int i = s_start; i < s_start + g.spr; ++i) {
      a5_coef_sample<KMAX>(r, i, g, ids, id0, s_col, coef, col);
      const float gd = (gr * col.x + gg * col.y) + gb * col.z;
      total = total + (t * col.w) * gd;
      t = t * (1.0f - col.w);
    }
    const float bg_term = t * g_t[ray];  // T_N * dL/dT_N

    // ---- pass B: prefix re-march and the per-interval terms --------------
    t = 1.0f;
    float pfx = 0.0f;
    for (int i = s_start; i < s_start + g.spr; ++i) {
      a5_coef_sample<KMAX>(r, i, g, ids, id0, s_col, coef, col);
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
        const float cw = coef[k] * w;
        acc[k][0] += cw * gr;
        acc[k][1] += cw * gg;
        acc[k][2] += cw * gb;
        acc[k][3] += coef[k] * da;
      }
    }
  }

  write_block_partial<KMAX, kWarps>(acc, num_intervals, partials);
}

}  // namespace

// Launches the a5 backward march on `stream`; returns cudaGetLastError()
// (0 = launched).  scal: [41] f32 (ops/a5.py layout); colors: [K, 4] f32,
// K <= 16; ids: [d1, d2, d3] uint8 (C order); the work unit: columns
// [x_offset, x_offset + width), samples [s_start, s_start + spr); g_rgb:
// [width, height, 3] f32 and g_t: [width, height] f32, the cotangents of
// the unit's C and final T; partials: [ceil(width/16) * ceil(height/16),
// K, 4] f32, one [K, 4] sum per 16x16 pixel block.
extern "C" int vrp_march_bwd_a5(const float* scal, const float* colors,
                                int K, const uint8_t* ids, int d1, int d2,
                                int d3, int width, int height, int spr,
                                int x_offset, int s_start,
                                const float* g_rgb, const float* g_t,
                                float* partials, void* stream) {
  if (K <= 0 || K > kMaxIntervals || width <= 0 || height <= 0 ||
      spr <= 0 || x_offset < 0 || s_start < 0)
    return (int)cudaErrorInvalidValue;
  const A5Geom g = make_a5_geom(d1, d2, d3, width, height, spr);
  const dim3 block(kBlock, kBlock);
  const dim3 grid((height + kBlock - 1) / kBlock,
                  (width + kBlock - 1) / kBlock);
  cudaStream_t s = (cudaStream_t)stream;
  if (K <= 4) {
    march_bwd_a5_kernel<4><<<grid, block, 0, s>>>(scal, colors, K, ids, g,
                                                   x_offset, s_start, g_rgb,
                                                   g_t, partials);
  } else if (K <= 8) {
    march_bwd_a5_kernel<8><<<grid, block, 0, s>>>(scal, colors, K, ids, g,
                                                   x_offset, s_start, g_rgb,
                                                   g_t, partials);
  } else {
    march_bwd_a5_kernel<16><<<grid, block, 0, s>>>(scal, colors, K, ids, g,
                                                    x_offset, s_start, g_rgb,
                                                    g_t, partials);
  }
  return (int)cudaGetLastError();
}
