// Backward of the fused a1/VRC ray march (K4) for NVIDIA Hopper (sm_90a).
//
// Replaces volumerenderingproject_tpu/ops/pallas_march_vjp.py:
// _march_bwd_kernel for the plain a1 path (the material-id grid; its baked
// light, LUT, slab, segment and multichannel variants are not here).  Given
// the per-ray cotangents g (of the rgb output) and g_t (of the final
// transmittance T_N, which reaches the output through out = C + T_N * bg),
// it computes dL/dcolors [K, 4] of the forward march (march.cu) at eps 0
// with density 1; the caller folds density_scale into the alpha column.
//
//   forward:   w_s = T_s a_s,   C += w_s c_s,   T_{s+1} = T_s (1 - a_s)
//   dL/dc_k   += g * w_s                              (samples in interval k)
//   dL/da_k   += T_s (g . c_s) - (S_{>s} + T_N g_t) / (1 - a_s)
//   S_{>s}     = sum_{j>s} w_j (g . c_j)
//
// One thread marches one ray twice, back to back.  Pass A sums
// total = sum_j w_j (g . c_j) and T_N.  Pass B marches again and keeps the
// prefix P_s in pass A's float order, so S_{>s} = total - P_s needs no
// per-sample storage.  Where 1 - a_s == 0 the division term is 0, as in the
// TPU kernel.  Every sample of the ray is marched: a sample of alpha 0 still
// has an alpha gradient, so the forward's box clip and brick skip do not
// apply here.  Off the volume a sample takes id0 and scatters into id0.
//
// Per-interval sums stay in registers: the kernel is instantiated for
// K <= 4, 8 and 16, and a sample adds its four terms to interval k through
// a select in the unrolled k loop (adding 0 to the other intervals is
// exact).  At the end each block reduces its rays' [K, 4] sums, by
// shuffles within each warp and then over the warps in shared memory in a
// fixed order (block_reduce.cuh), and writes one partial to partials
// [nblocks, K, 4]; the caller sums the partials with torch.sum.  No
// atomics, so every run gives the same bits.
//
// What bounds it on an H100: operations.  Each sample costs some 45 float
// operations per pass and a dependent one-byte load from the id grid, which
// the 50 MB L2 holds whole (7.2 MB at 182x218x182); the bytes it must move
// (ids, 16 bytes of cotangent per ray, the partials) are far fewer.  The
// design keeps all per-ray state in registers, the colours in shared
// memory, and uses K1's 16x16 pixel blocks so that a warp's loads share
// cache lines.  Ray setup and the sample -> id chain are K1's
// (march_common.cuh).

#include "march_common.cuh"
#include "block_reduce.cuh"

namespace {

constexpr int kMaxIntervals = 16;  // the JAX kernel's limit
constexpr int kBlock = 16;         // pixels per block edge
constexpr int kWarps = kBlock * kBlock / 32;

template <int KMAX>
__global__ void __launch_bounds__(kBlock * kBlock)
march_bwd_a1_kernel(const float* __restrict__ scal,
                    const float* __restrict__ colors, int num_intervals,
                    const uint8_t* __restrict__ ids, Geom g, int conic,
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

  // threadIdx.x runs along y, as in K1; threads off the image take part in
  // the reduction with zero sums
  const int py = blockIdx.x * blockDim.x + threadIdx.x;
  const int px = blockIdx.y * blockDim.y + threadIdx.y;
  if (px < g.width && py < g.height) {
    float o[3], d[3];
    ray_setup(scal, g, px, py, conic, o, d);
    const float ds = scal[S_DS];
    const float clip = scal[S_CLIP];
    const int id0 = (int)scal[S_ID0];
    const long long ray = (long long)px * g.height + py;
    const float gr = g_rgb[3 * ray];
    const float gg = g_rgb[3 * ray + 1];
    const float gb = g_rgb[3 * ray + 2];

    // ---- pass A: total of w (g . c) and the final transmittance ----------
    float t = 1.0f;
    float total = 0.0f;
    for (int i = 0; i < g.spr; ++i) {
      const float4 col = s_col[sample_id(i, o, d, ds, clip, g, ids, id0)];
      const float gd = (gr * col.x + gg * col.y) + gb * col.z;
      const float w = t * col.w;
      total = total + w * gd;
      t = t * (1.0f - col.w);
    }
    const float bg_term = t * g_t[ray];  // dL/dT_N * T_N, through + T_N*bg

    // ---- pass B: prefix re-march and the per-interval terms --------------
    t = 1.0f;
    float pfx = 0.0f;
    for (int i = 0; i < g.spr; ++i) {
      const int mid = sample_id(i, o, d, ds, clip, g, ids, id0);
      const float4 col = s_col[mid];
      const float gd = (gr * col.x + gg * col.y) + gb * col.z;
      const float w = t * col.w;
      pfx = pfx + w * gd;  // pass A's order: total - pfx is exact at the end
      const float suffix = total - pfx;
      const float denom = 1.0f - col.w;
      const float num = suffix + bg_term;
      const float da = t * gd - (denom != 0.0f ? num / denom : 0.0f);
      t = t * denom;
      const float dr = w * gr, dg = w * gg, db = w * gb;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        const bool m = mid == k;
        acc[k][0] += m ? dr : 0.0f;
        acc[k][1] += m ? dg : 0.0f;
        acc[k][2] += m ? db : 0.0f;
        acc[k][3] += m ? da : 0.0f;
      }
    }
  }

  write_block_partial<KMAX, kWarps>(acc, num_intervals, partials);
}

}  // namespace

// Launches the backward march on `stream`; returns cudaGetLastError()
// (0 = launched).  scal: [32] f32 (ops/march.py layout); colors: [K, 4] f32,
// K <= 16; ids: [d1, d2, d3] uint8 (C order); g_rgb: [width, height, 3] f32;
// g_t: [width, height] f32; partials: [ceil(width/16) * ceil(height/16), K,
// 4] f32, one [K, 4] sum per 16x16 pixel block.
extern "C" int vrp_march_bwd_a1(const float* scal, const float* colors, int K,
                                const uint8_t* ids, int d1, int d2, int d3,
                                int depth, int width, int height, int spr,
                                int conic, const float* g_rgb,
                                const float* g_t, float* partials,
                                void* stream) {
  if (K <= 0 || K > kMaxIntervals || width <= 0 || height <= 0 || spr <= 0)
    return (int)cudaErrorInvalidValue;
  const Geom g = make_geom(d1, d2, d3, depth, width, height, spr, 0, 0, 0);
  const dim3 block(kBlock, kBlock);
  const dim3 grid((height + kBlock - 1) / kBlock,
                  (width + kBlock - 1) / kBlock);
  cudaStream_t s = (cudaStream_t)stream;
  if (K <= 4) {
    march_bwd_a1_kernel<4><<<grid, block, 0, s>>>(scal, colors, K, ids, g,
                                                   conic, g_rgb, g_t, partials);
  } else if (K <= 8) {
    march_bwd_a1_kernel<8><<<grid, block, 0, s>>>(scal, colors, K, ids, g,
                                                   conic, g_rgb, g_t, partials);
  } else {
    march_bwd_a1_kernel<16><<<grid, block, 0, s>>>(
        scal, colors, K, ids, g, conic, g_rgb, g_t, partials);
  }
  return (int)cudaGetLastError();
}
