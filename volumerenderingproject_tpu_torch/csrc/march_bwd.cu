// Backward of the fused a1/VRC ray march (K4) for NVIDIA Hopper (sm_90a).
//
// Replaces volumerenderingproject_tpu/ops/pallas_march_vjp.py:
// _march_bwd_kernel on the resident a1 path, in four variants, template
// parameters of the one kernel as in K1 (march.cu):
//   * plain: uint8 interval ids (the material-id grid);
//   * baked light (`baked_light`): the forward shades c' = c * M + S with
//     the per-voxel factor grids M and S (f32, in HBM; M = 1, S = 0 off the
//     volume), pallas_march_vjp.py:354-367, 445;
//   * LUT (`lut_n`): uint16 indices into the dense TF LUT; entry i is the
//     colour of interval itv[i] (TransferFunction.to_lut gathers them), so
//     a sample's terms go to interval itv[idx] of the entry it read,
//     pallas_march_vjp.py:289-298;
//   * LUT + baked light: both;
//   * channel grids (`mc_grids`, 4-D volumes): the uint8 ids are the
//     intervals of the channel mean and give alpha only; c' is read from
//     the 1 (grey) or 3 channel grids at the sample's voxel (0 off the
//     volume), data the colours do not reach, so the rgb columns of
//     dL/dcolors are exactly 0 and only the alpha column's chain runs,
//     through g . c' of the channel rgb (pallas_march_vjp.py:315-360,
//     440-456).
// It also takes the volumes of _march_streamed_bwd_kernel (K5, the same
// two passes over HBM->VMEM x-blocks with ownership extents): the volume
// stays in device memory.
//
// A sharded fit (parallel/render_dist.py, differentiable=True) launches it
// once per rank on that rank's work unit, the backward of K1's segment and
// slab modes (render_vrc_pallas_diff_segment, pallas_march_vjp.py:1854;
// the kernel's local_width/slab_x handling, :111-130, 172-175, 238-241,
// 404-466):
//   * segment, every variant: columns [x_offset, x_offset + width) of a
//     full_width-wide image and samples [s_start, s_start + spr).  Rays
//     keep their global column in the ray setup and samples their global
//     index, as in K1 (the Geom fields, march_common.cuh).  The output the
//     cotangents belong to is the unit's (C, T) pair, so g_t is the
//     cotangent of the unit's own final T, which the fold's autograd gives
//     (the whole render's g_t = g . bg is the special case of one unit);
//     bg_term = T_N g_t is unchanged.
//   * slab (`kSlab`, plain and baked): the id grid and (M, S) hold
//     x-planes [x0, x0 + slab_x) only, and a sample belongs to the slab
//     that holds its x-clamped voxel index (sample_voxel_slab).  A sample
//     that another slab owns is the over identity in both passes, alpha
//     0, and scatters into no interval; an owned sample off the volume
//     takes id0 and scatters into its interval, as in the whole backward.
//     Summed over the slabs, the gradients are the whole render's: the
//     ownership partitions the samples.
// Given the per-ray cotangents g (of the rgb output) and g_t (of the final
// transmittance T_N, which reaches the output through out = C + T_N * bg),
// it computes dL/dcolors [K, 4] of the forward march (march.cu) at eps 0
// with density 1; the caller folds density_scale into the alpha column.
//
//   forward:   w_s = T_s a_s,   C += w_s c'_s,   T_{s+1} = T_s (1 - a_s)
//   dL/dc_k   += g * w_s * M_s                        (samples in interval k)
//   dL/da_k   += T_s (g . c'_s) - (S_{>s} + T_N g_t) / (1 - a_s)
//   S_{>s}     = sum_{j>s} w_j (g . c'_j)
//
// (M_s = 1 and c' = c unlit.)  One thread marches one ray twice, back to
// back.  Pass A sums total = sum_j w_j (g . c'_j) and T_N.  Pass B marches
// again and keeps the prefix P_s in pass A's float order (the shaded c' by
// the same expression in both passes), so S_{>s} = total - P_s needs no
// per-sample storage.  Where 1 - a_s == 0 the division term is 0, as in the
// TPU kernel.
//
// Every sample of the ray has a gradient (a sample of alpha 0 still has an
// alpha gradient), but most lie off the volume, and there each is one
// constant of the launch: interval k0 (of id0, through the LUT's interval
// table with a LUT), alpha a0 and c'0 (M = 1 and S = 0 when baked, so c'0
// = c0; 0 with channel grids), taken once a block in shared memory, and
// gd0 = g . c'0 once a ray by the expression of every other g . c'.  So
// each ray takes, before pass A, three spans of its samples (box_span,
// march_common.cuh; ops/march_vjp.sample_range mirrors them):
//   * the chain's span: K1's dataset box (S_BOX_LO/HI, tightened to the
//     slab's x planes on a slab), widened by kRangePad (max |o| + |clip|
//     + 2) and one sample at each end: every sample whose chain gives a
//     voxel lies in it.  Its samples run the full bounds-checked chain
//     (bwd_sample), so a span too wide costs time, never a value.
//   * on a slab (kSlab), the ownership span: the samples whose x-clamped
//     voxel index the slab may hold, from the slab's x planes alone
//     (Geom's x0, nx, dim; unbounded on the outer side of the first and the
//     last slab), widened the same way, and inside it the samples that the
//     slab surely owns (the planes narrowed by a leaf, 1/n, and the pad).
//     A sample outside the ownership span is another slab's: the over
//     identity (alpha 0, T and the sums unchanged, no interval), skipped.
//     One in the ownership span but not surely owned runs the full chain,
//     which decides alone.  Off a slab every sample of the unit is owned.
//   * the unit's window [s_start, s_start + spr), which bounds both.
// A sample that is owned and outside the chain's span is the constant.  In
// pass A it adds (T a0) gd0 and multiplies T by 1 - a0, the full
// evaluation's operations, so T_N, the total and pass B's prefix are the
// full evaluation's to the bit.  In pass B it keeps its own w_s, T_s and
// numerator S_{>s} + T_N g_t, but runs no chain, no load and no interval
// loop: its dL/da = T_s gd0 - num_s / (1 - a0) is linear in T_s and num_s
// with constant coefficients, so the ray sums w_s, T_s and num_s and folds
// them into interval k0 once, at the end of the ray (K9's fold, with the
// division taken once, gated as a sample's).  Where a0 == 0 (the TF's
// usual interval 0), such a sample leaves T and the prefix as they are and
// every sample of a run of them has the same dL/da: pass A skips the run,
// pass B adds its length times that dL/da.  The folds regroup float sums,
// so K4 is not bit-exact to march_bwd_plain (chip_smoke.py holds it to
// TOL_GRAD of max |dplain|).  Dividing each sample instead was 19 % slower
// with a0 = 0.05 (harness/ab_march.py; PERF.md).
//
// Per-interval sums stay in registers: the kernel is instantiated for
// K <= 4, 8 and 16, and a sample adds its w_s M_s and dL/da to interval k
// through a select in the unrolled k loop (adding 0 to the other intervals
// is exact); the rgb columns are g times the w M sum, taken once a ray.  At
// the end each block reduces its rays' [K, 4] sums, by shuffles within each
// warp and then over the warps in shared memory in a fixed order
// (block_reduce.cuh), and writes one partial to partials [nblocks, K, 4];
// the caller sums the partials with torch.sum.  No atomics, so every run
// gives the same bits.
//
// What bounds it on an H100: operations, those of the samples in the
// chain's span (some 40 float operations a pass, the dependent one-byte id
// load, which the 50 MB L2 holds whole, 7.2 MB at 182x218x182, and the
// interval selects), which the launch's bound counts, beside the constant
// samples' few operations (none where a0 == 0); a warp runs the chain for
// the union of its rays' spans.  The
// bytes it must move (ids, 16 bytes of cotangent per ray, the partials)
// are far fewer.  The baked variants add two f32 loads per sample inside
// the volume, at the id's voxel, in each pass (M and S are 58 MB at
// 182x218x182, more than L2 holds) and 6 operations for the shade; the LUT
// variants read a two-byte index and one shared-memory byte more; the
// channel variant reads 1 or 3 f32 channel values per sample inside the
// volume.  All per-ray state stays in registers, the colours (and the
// LUT's interval table, at most 1 KB) in shared memory.  Ray setup and the
// sample -> voxel -> id chain are K1's (march_common.cuh).  Tensor cores,
// TMA and clusters do not serve this walk: its loads depend on the ray.

#include "march_common.cuh"
#include "block_reduce.cuh"

namespace {

constexpr int kMaxIntervals = 16;  // the JAX kernel's limit
constexpr int kMaxLut = 1024;      // uint16 LUT indices (tf_lut <= 1024)
// a block's pixels along y (threadIdx.x) and x (threadIdx.y): a warp is 4 x
// 8 neighbouring rays, whose spans overlap more than a 16 x 2 warp's; 4-15 %
// faster than 16 x 16 blocks in every variant and unit on the MNI-dims
// volume on the H100 (harness/ab_march.py; PERF.md)
constexpr int kBlockY = 4, kBlockX = 64;
constexpr int kThreads = kBlockY * kBlockX;
constexpr int kWarps = kThreads / 32;

// What sample i of a ray contributes: its interval, its alpha, its shaded
// colour's g . c' and the factor M of its rgb terms (1 unlit or off the
// volume).  Pass A and pass B call it alike, so both compute g . c' by the
// same expression.
struct Sample {
  int k;
  float a, gd, m;
};

// kMc: the number of channel grids (0: none; 1: grey; 3: rgb); kSlab: the
// grids hold an x-slab (interval ids, plain or baked).  A sample that
// another slab owns comes back as interval -1 with alpha 0: the over
// identity, which no interval's sums take.
template <int KMAX, typename Id, bool kBaked, int kMc, bool kSlab>
__device__ __forceinline__ Sample bwd_sample(
    int i, const float o[3], const float d[3], float ds, float clip,
    const Geom& g, const Id* __restrict__ ids, int id0,
    const float* __restrict__ mgrid, const float* __restrict__ sgrid,
    const float* __restrict__ chans, long long nvox, const float4* s_col,
    const uint8_t* s_itv, float gr, float gg, float gb) {
  int idx;
  float m = 1.0f, sh = 0.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  if constexpr (kSlab) {
    const long long flat = sample_voxel_slab(i, o, d, ds, clip, g);
    if (flat == -2) {  // another slab's sample
      Sample s;
      s.k = -1;
      s.a = 0.0f;
      s.gd = 0.0f;
      s.m = 1.0f;
      return s;
    }
    idx = flat < 0 ? id0 : (int)__ldg(ids + flat);
    if constexpr (kBaked) {
      if (flat >= 0) {
        m = __ldg(mgrid + flat);
        sh = __ldg(sgrid + flat);
      }
    }
  } else if constexpr (kMc > 0) {  // c' from the channel grids, as K1 reads it
    const long long flat = sample_voxel(i, o, d, ds, clip, g);
    idx = flat < 0 ? id0 : (int)__ldg(ids + flat);
    if (flat >= 0) {
      cr = __ldg(chans + flat);
      cg = kMc == 1 ? cr : __ldg(chans + nvox + flat);
      cb = kMc == 1 ? cr : __ldg(chans + 2 * nvox + flat);
    }
  } else if constexpr (kBaked) {
    const long long flat = sample_voxel(i, o, d, ds, clip, g);
    idx = flat < 0 ? id0 : (int)__ldg(ids + flat);
    if (flat >= 0) {
      m = __ldg(mgrid + flat);
      sh = __ldg(sgrid + flat);
    }
  } else {
    idx = sample_id(i, o, d, ds, clip, g, ids, id0);
  }
  Sample s;
  s.k = sizeof(Id) == 1 ? idx : (int)s_itv[idx];
  float4 col = s_col[s.k];
  if constexpr (kBaked) {  // c' = c * M + S, as K1 shades it
    col.x = col.x * m + sh;
    col.y = col.y * m + sh;
    col.z = col.z * m + sh;
  } else if constexpr (kMc > 0) {
    col.x = cr;
    col.y = cg;
    col.z = cb;
  }
  s.a = col.w;
  s.gd = (gr * col.x + gg * col.y) + gb * col.z;
  s.m = m;
  return s;
}

// The spans of the ray (o, d) that K4 takes (the header above): its samples
// [lo, hi] (the unit's window; on a slab, within the ownership span), the
// chain's span [c_lo, c_hi] and the surely owned samples [in_lo, in_hi],
// all clamped to [lo, hi].  Sample i in [lo, hi] runs the full chain where
// c_lo <= i <= c_hi or i < in_lo or i > in_hi, else it is the constant.
// A ray, step or clip that is not finite runs the chain on every sample of
// the window (span_pad).  ops/march_vjp.sample_range mirrors this
// function.
template <bool kSlab>
__device__ __forceinline__ void bwd_spans(const float* __restrict__ scal,
                                          const float o[3], const float d[3],
                                          float ds, float clip, const Geom& g,
                                          int& lo, int& hi, int& c_lo,
                                          int& c_hi, int& in_lo, int& in_hi) {
  lo = g.s_start;
  hi = g.s_start + g.spr - 1;
  c_lo = lo;
  c_hi = hi;
  in_lo = lo;
  in_hi = hi;
  const float pad = span_pad(o, d, ds, clip);
  if (pad < 0.0f) return;
  float blo[3], bhi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    blo[c] = scal[S_BOX_LO + c];
    bhi[c] = scal[S_BOX_HI + c];
  }
  int a, b;
  if constexpr (kSlab) {
    // the slab owns the samples whose x-clamped voxel index lies in
    // [x0, x0 + nx): x in ray space in [(hg + x0) / L, (hg + x0 + nx) / L +
    // 1/n) - 0.5 up to the leaf's rounding, unbounded on an outer face
    float olo[3] = {-INFINITY, -INFINITY, -INFINITY};
    float ohi[3] = {INFINITY, INFINITY, INFINITY};
    const float hx = g.hg[0] + (float)g.x0;
    const float leaf = 1.0f / g.n;
    if (g.x0 > 0) olo[0] = hx / g.L - 0.5f;
    if (g.x0 + g.nx < g.dim[0])
      ohi[0] = ((hx + (float)g.nx) / g.L + leaf) - 0.5f;
    box_span(o, d, olo, ohi, pad, ds, clip, false, a, b);
    lo = max(lo, a);
    hi = min(hi, b);
    olo[0] = olo[0] + leaf;  // owned for sure: a leaf inside each plane
    ohi[0] = ohi[0] - leaf;
    box_span(o, d, olo, ohi, pad, ds, clip, true, a, b);
    in_lo = max(a, lo);
    in_hi = min(b, hi);
  }
  box_span(o, d, blo, bhi, pad, ds, clip, false, a, b);
  c_lo = max(a, lo);
  c_hi = min(b, hi);
}

template <int KMAX, typename Id, bool kBaked, int kMc, bool kSlab>
__global__ void __launch_bounds__(kThreads)
march_bwd_a1_kernel(const float* __restrict__ scal,
                    const float* __restrict__ colors, int num_intervals,
                    const Id* __restrict__ ids,
                    const uint8_t* __restrict__ itv, int lut_n,
                    const float* __restrict__ mgrid,
                    const float* __restrict__ sgrid,
                    const float* __restrict__ chans, Geom g, int conic,
                    const float* __restrict__ g_rgb,
                    const float* __restrict__ g_t,
                    float* __restrict__ partials) {
  __shared__ float4 s_col[KMAX];
  __shared__ uint8_t s_itv[sizeof(Id) == 1 ? 1 : kMaxLut];
  __shared__ float4 s_c0;  // c'0 and a0: every owned sample off the volume
  __shared__ int s_k0;     // and its interval
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < KMAX) {
    s_col[tid] = tid < num_intervals
                     ? make_float4(colors[4 * tid], colors[4 * tid + 1],
                                   colors[4 * tid + 2], colors[4 * tid + 3])
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if constexpr (sizeof(Id) == 2) {
    for (int j = tid; j < lut_n; j += blockDim.x * blockDim.y)
      s_itv[j] = itv[j];
  }
  __syncthreads();
  const int id0 = (int)scal[S_ID0];
  if (tid == 0) {  // bwd_sample's colour of a sample off the volume
    const int k0 = sizeof(Id) == 1 ? id0 : (int)s_itv[id0];
    float4 c0 = s_col[k0];
    if constexpr (kBaked) {  // M = 1, S = 0
      c0.x = c0.x * 1.0f + 0.0f;
      c0.y = c0.y * 1.0f + 0.0f;
      c0.z = c0.z * 1.0f + 0.0f;
    } else if constexpr (kMc > 0) {
      c0.x = c0.y = c0.z = 0.0f;
    }
    s_c0 = c0;
    s_k0 = k0;
  }
  __syncthreads();

  // per interval: the sum of w M (the rgb columns, times g at the end) and
  // of dL/da
  float sw[KMAX], sa[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) sw[k] = sa[k] = 0.0f;
  float gr = 0.0f, gg = 0.0f, gb = 0.0f;

  // threadIdx.x runs along y, as in K1; threads off the image take part in
  // the reduction with zero sums
  const int py = blockIdx.x * blockDim.x + threadIdx.x;
  const int px = blockIdx.y * blockDim.y + threadIdx.y;
  if (px < g.width && py < g.height) {
    float o[3], d[3];
    ray_setup(scal, g, px, py, conic, o, d);
    const float ds = scal[S_DS];
    const float clip = scal[S_CLIP];
    const long long ray = (long long)px * g.height + py;
    gr = g_rgb[3 * ray];
    gg = g_rgb[3 * ray + 1];
    gb = g_rgb[3 * ray + 2];
    const long long nvox = (long long)g.dim[0] * g.dim[1] * g.dim[2];
    const float4 c0 = s_c0;
    const float a0 = c0.w;
    const float gd0 = (gr * c0.x + gg * c0.y) + gb * c0.z;
    const float denom0 = 1.0f - a0;
    const bool a0_zero = a0 == 0.0f;
    int lo, hi, c_lo, c_hi, in_lo, in_hi;
    bwd_spans<kSlab>(scal, o, d, ds, clip, g, lo, hi, c_lo, c_hi, in_lo,
                     in_hi);

    // ---- pass A: total of w (g . c') and the final transmittance ---------
    // (the unit's samples; its T starts at 1)
    float t = 1.0f;
    float total = 0.0f;
    for (int i = lo; i <= hi;) {
      if ((i >= c_lo && i <= c_hi) || i < in_lo || i > in_hi) {
        const Sample s = bwd_sample<KMAX, Id, kBaked, kMc, kSlab>(
            i, o, d, ds, clip, g, ids, id0, mgrid, sgrid, chans, nvox, s_col,
            s_itv, gr, gg, gb);
        const float w = t * s.a;
        total = total + w * s.gd;
        t = t * (1.0f - s.a);
        ++i;
        continue;
      }
      // a run of constant samples, [i, j)
      const int j = min(in_hi + 1, c_lo > i ? c_lo : hi + 1);
      if (!a0_zero) {
        for (; i < j; ++i) {
          const float w = t * a0;
          total = total + w * gd0;
          t = t * denom0;
        }
      }
      i = j;
    }
    const float bg_term = t * g_t[ray];  // T_N * dL/dT_N

    // ---- pass B: prefix re-march and the per-interval terms --------------
    t = 1.0f;
    float pfx = 0.0f;
    // the constant samples' sums: w, dL/da, and where a0 != 0 T and the
    // numerator of the division, which is folded once a ray
    float ow = 0.0f, oda = 0.0f, ot = 0.0f, onum = 0.0f;
    for (int i = lo; i <= hi;) {
      if ((i >= c_lo && i <= c_hi) || i < in_lo || i > in_hi) {
        const Sample s = bwd_sample<KMAX, Id, kBaked, kMc, kSlab>(
            i, o, d, ds, clip, g, ids, id0, mgrid, sgrid, chans, nvox, s_col,
            s_itv, gr, gg, gb);
        const float w = t * s.a;
        pfx = pfx + w * s.gd;  // pass A's order: total - pfx is exact at the end
        const float suffix = total - pfx;
        const float denom = 1.0f - s.a;
        const float num = suffix + bg_term;
        const float da = t * s.gd - (denom != 0.0f ? num / denom : 0.0f);
        t = t * denom;
        const float wm = kBaked ? w * s.m : w;  // dC/dc = w M
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          const bool sel = s.k == k;
          if constexpr (kMc == 0) sw[k] += sel ? wm : 0.0f;
          sa[k] += sel ? da : 0.0f;
        }
        ++i;
        continue;
      }
      const int j = min(in_hi + 1, c_lo > i ? c_lo : hi + 1);
      if (a0_zero) {
        // w = 0: T and the prefix stay, so every sample of the run has the
        // dL/da of its first (1 - a0 == 1 divides exactly)
        const float num = (total - pfx) + bg_term;
        const float da = t * gd0 - num;
        oda = oda + (float)(j - i) * da;
        i = j;
        continue;
      }
      for (; i < j; ++i) {
        const float w = t * a0;
        pfx = pfx + w * gd0;
        ow = ow + w;
        ot = ot + t;
        onum = onum + ((total - pfx) + bg_term);
        t = t * denom0;
      }
    }
    // sum_s T_s gd0 - num_s / (1 - a0), the division gated as a sample's
    oda = oda + (gd0 * ot - (denom0 != 0.0f ? onum / denom0 : 0.0f));

    // ---- the constant samples' terms, folded once ------------------------
    const int k0 = s_k0;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const bool sel = k0 == k;
      sw[k] += sel ? ow : 0.0f;
      sa[k] += sel ? oda : 0.0f;
    }
  }

  // channel rgb is data: no rgb terms, the rgb columns stay 0
  float acc[KMAX][4];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    acc[k][0] = kMc ? 0.0f : gr * sw[k];
    acc[k][1] = kMc ? 0.0f : gg * sw[k];
    acc[k][2] = kMc ? 0.0f : gb * sw[k];
    acc[k][3] = sa[k];
  }
  write_block_partial<KMAX, kWarps>(acc, num_intervals, partials);
}

struct Inputs {
  const float *scal, *colors;
  int K;
  const void* ids;
  const uint8_t* itv;
  int lut_n;
  const float *mgrid, *sgrid, *chans, *g_rgb, *g_t;
  float* partials;
};

template <typename Id, bool kBaked, int kMc, bool kSlab = false>
void launch(const Inputs& in, const Geom& g, int conic, cudaStream_t s) {
  const dim3 block(kBlockY, kBlockX);
  const dim3 grid((g.height + kBlockY - 1) / kBlockY,
                  (g.width + kBlockX - 1) / kBlockX);
  const Id* id = static_cast<const Id*>(in.ids);
  if (in.K <= 4) {
    march_bwd_a1_kernel<4, Id, kBaked, kMc, kSlab><<<grid, block, 0, s>>>(
        in.scal, in.colors, in.K, id, in.itv, in.lut_n, in.mgrid, in.sgrid,
        in.chans, g, conic, in.g_rgb, in.g_t, in.partials);
  } else if (in.K <= 8) {
    march_bwd_a1_kernel<8, Id, kBaked, kMc, kSlab><<<grid, block, 0, s>>>(
        in.scal, in.colors, in.K, id, in.itv, in.lut_n, in.mgrid, in.sgrid,
        in.chans, g, conic, in.g_rgb, in.g_t, in.partials);
  } else {
    march_bwd_a1_kernel<16, Id, kBaked, kMc, kSlab><<<grid, block, 0, s>>>(
        in.scal, in.colors, in.K, id, in.itv, in.lut_n, in.mgrid, in.sgrid,
        in.chans, g, conic, in.g_rgb, in.g_t, in.partials);
  }
}

}  // namespace

// Launches the backward march on `stream`; returns cudaGetLastError()
// (0 = launched).  scal: [32] f32 (ops/march.py layout); colors: [K, 4] f32,
// K <= 16; ids: [d1, d2, d3] (C order), uint8 interval ids (id_bytes 1,
// itv null, lut_n 0) or uint16 LUT indices (id_bytes 2) with itv: [lut_n]
// uint8, the interval of each LUT entry, lut_n <= 1024; mgrid, sgrid:
// [d1, d2, d3] f32, both null unlit; chans: [n_chans, d1, d2, d3] f32
// (n_chans 1 or 3, uint8 ids, unlit) for a 4-D volume, else null; g_rgb:
// [width, height, 3] f32; g_t: [width, height] f32; partials:
// [ceil(width/kBlockX) * ceil(height/kBlockY), K, 4] f32, one [K, 4] sum
// per block of kBlockX x kBlockY pixels.  The work unit: columns [x_offset, x_offset + width) of a
// full_width-wide image, samples [s_start, s_start + spr) of the d1-deep
// geometry's rays, and with slab_x > 0 (interval ids, plain or baked) the
// grids' x-planes [x0, x0 + slab_x): ids, mgrid and sgrid are then
// [slab_x, d2, d3].  g_rgb and g_t are the cotangents of the unit's C and
// final T.
extern "C" int vrp_march_bwd_a1(const float* scal, const float* colors, int K,
                                const void* ids, int id_bytes,
                                const uint8_t* itv, int lut_n,
                                const float* mgrid, const float* sgrid,
                                const float* chans, int n_chans, int d1,
                                int d2, int d3, int depth, int width,
                                int height, int spr, int conic,
                                int x_offset, int full_width, int s_start,
                                int x0, int slab_x, const float* g_rgb,
                                const float* g_t, float* partials,
                                void* stream) {
  const bool lut = id_bytes == 2;
  const bool baked = mgrid != nullptr, mc = chans != nullptr,
             slab = slab_x > 0;
  if ((id_bytes != 1 && id_bytes != 2) || K <= 0 || K > kMaxIntervals ||
      width <= 0 || height <= 0 || spr <= 0 ||
      baked != (sgrid != nullptr) ||
      (lut && (itv == nullptr || lut_n <= 0 || lut_n > kMaxLut)) ||
      (mc && (lut || baked || (n_chans != 1 && n_chans != 3))) ||
      x_offset < 0 || x_offset + width > full_width || s_start < 0 ||
      slab_x < 0 || (slab && (lut || mc || x0 < 0 || x0 + slab_x > d1)))
    return (int)cudaErrorInvalidValue;
  Geom g = make_geom(d1, d2, d3, depth, width, height, spr, 0, 0, 0);
  g.x_off = x_offset;
  g.gwidth = full_width;
  g.s_start = s_start;
  if (slab) {
    g.x0 = x0;
    g.nx = slab_x;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const Inputs in{scal,  colors, K,     ids, itv,     lut_n,
                  mgrid, sgrid,  chans, g_rgb, g_t, partials};
  if (slab && baked)
    launch<uint8_t, true, 0, true>(in, g, conic, s);
  else if (slab)
    launch<uint8_t, false, 0, true>(in, g, conic, s);
  else if (mc && n_chans == 1)
    launch<uint8_t, false, 1>(in, g, conic, s);
  else if (mc)
    launch<uint8_t, false, 3>(in, g, conic, s);
  else if (!lut && !baked)
    launch<uint8_t, false, 0>(in, g, conic, s);
  else if (!lut)
    launch<uint8_t, true, 0>(in, g, conic, s);
  else if (!baked)
    launch<uint16_t, false, 0>(in, g, conic, s);
  else
    launch<uint16_t, true, 0>(in, g, conic, s);
  return (int)cudaGetLastError();
}
