// Shared by the smooth-mode marches (smooth.cu, K8; smooth_bwd.cu, K9): the
// scalar-vector slots of smooth mode, the transfer function in shared
// memory, the chain from a sample index to its RGBA, and each ray's range
// of samples that may touch the volume, written once so that the forward
// and the backward march evaluate and skip every sample alike.
//
// A sample (pallas_smooth.py:103-302, expression by expression):
//   ti  = float(i) * ds + clip
//   vox = ((o + ti * d) + 0.5) * L + voff            modelAux, toVolumeSpace
//   b   = floor(vox), f = vox - b; the 8 corners b + {0,1}^3 read from the
//         f32 volume, 0 out of range; mixed z, then y, then x
//   vn  = v / cal_max                                 IEEE division
//   w_k = s1 * s2, s1 = sig(sharp (vn - lo_k)), s2 = sig(sharp (hi_k - vn)),
//         sig(x) = 1 / (1 + expf(-x)), for k = 1..K-1
//   rgba = c_0 + w_1 (c_1 - c_0) + w_2 (c_2 - c_0) + ...   in k order
// Build with -fmad=false: a contracted product-sum moves the sample.  The
// ray setup is the a1 marches' (march_common.cuh), whose float order is the
// smooth kernel's (_ray_setup, pallas_smooth.py:64-100).
//
// The per-ray range (smooth_sample_range).  A sample has a corner in the
// volume only where every vox_c lies in [-1, dim_c).  Outside that box all
// eight reads are 0, so the sample's intensity is exactly 0 and its RGBA
// is classify(0 / cal_max): one constant of the launch (rgba0 below, with
// its s1, s2 and w), whatever the ray.  Its smooth alpha is not 0, so such
// a sample still composites; it just needs no position, no reads and no
// sigmoids.  Each ray clips itself against that box in ray space, as K1
// clips to the dataset box (march.cu), on a box widened beyond the float
// chain's rounding and by one sample at each end: a sample outside the
// range has no corner in the volume, and a sample inside it runs the full
// bounds-checked chain, so a range that is too wide costs time and never
// changes a value.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "march_common.cuh"

namespace {

// scalar-vector slots of smooth mode (ops/smooth.py S_*); ds, clip, eps and
// the camera slots are the a1 marches' (march_common.cuh)
constexpr int SM_CAL_MAX = 2, SM_SHARP = 4, SM_VOFF = 22, SM_L = 25,
              SM_BG = 26;
constexpr int kSmoothMaxIntervals = 16;  // the JAX kernels' limit
// a block's pixels along y (threadIdx.x) and x (threadIdx.y): a warp is 4 x
// 8 neighbouring rays, whose ranges and corner reads overlap more than a
// 16 x 2 warp's.  Of 16x16, 8x32, 4x64, 2x128 and 32x8 it was the fastest
// for K8 and K9 together on the MNI-dims volume on the H100
// (harness/ab_smooth.py; PERF.md).
constexpr int kSmoothBlockY = 4, kSmoothBlockX = 64;
constexpr int kSmoothThreads = kSmoothBlockY * kSmoothBlockX;
// the range's box is widened by kRangePad (march_common.cuh)

// The smooth scalars of one march, read once per thread.
struct SmoothScalars {
  float ds, clip, L, cal, sharp;
  float voff[3];
};

// The transfer function of one march, in shared memory: bounds, c_0 and the
// differences c_k - c_0 (taken once per block, in float, as the plain
// version takes them).
template <int KMAX>
struct SmoothTF {
  float lo[KMAX], hi[KMAX];
  float4 c0;
  float4 dk[KMAX];
  // the RGBA of intensity 0, which every sample outside its ray's range
  // takes, its s1, s2 and w (slot k; slot 0 unused) and 1 - sum_k w
  float4 rgba0;
  float s1_0[KMAX], s2_0[KMAX], w0[KMAX];
  float base0;
};

__device__ __forceinline__ SmoothScalars
load_smooth_scalars(const float* __restrict__ scal) {
  SmoothScalars s;
  s.ds = scal[S_DS];
  s.clip = scal[S_CLIP];
  s.cal = scal[SM_CAL_MAX];
  s.sharp = scal[SM_SHARP];
  s.L = scal[SM_L];
#pragma unroll
  for (int c = 0; c < 3; ++c) s.voff[c] = scal[SM_VOFF + c];
  return s;
}

__device__ __forceinline__ float smooth_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Where sample i lies: its floor corner b and fractions f.  The float ->
// int conversion is clamped so that a far-off sample stays far off.
__device__ __forceinline__ void smooth_position(int i, const float o[3],
                                                const float d[3],
                                                const SmoothScalars& s, int b[3],
                                                float f[3]) {
  const float ti = (float)i * s.ds + s.clip;  // kernel.cu:54,59
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float vox = ((o[c] + ti * d[c]) + 0.5f) * s.L + s.voff[c];
    const float bf = floorf(vox);
    f[c] = vox - bf;
    b[c] = (int)fminf(fmaxf(bf, -1.0e9f), 1.0e9f);
  }
}

// Zero-padded trilinear intensity at (b, f), mixed z, then y, then x
// (trilinear_intensity_sample, sampling.py:233-276).
__device__ __forceinline__ float smooth_intensity(
    const float* __restrict__ vol, const Geom& g, const int b[3],
    const float f[3]) {
  float v[2][2][2];
#pragma unroll
  for (int ox = 0; ox < 2; ++ox) {
    const int cx = b[0] + ox;
    const bool okx = cx >= 0 && cx < g.dim[0];
#pragma unroll
    for (int oy = 0; oy < 2; ++oy) {
      const int cy = b[1] + oy;
      const bool okxy = okx && cy >= 0 && cy < g.dim[1];
      const long long row = ((long long)cx * g.dim[1] + cy) * g.dim[2];
#pragma unroll
      for (int oz = 0; oz < 2; ++oz) {
        const int cz = b[2] + oz;
        const bool ok = okxy && cz >= 0 && cz < g.dim[2];
        v[ox][oy][oz] = ok ? __ldg(vol + row + cz) : 0.0f;
      }
    }
  }
  const float fx = f[0], fy = f[1], fz = f[2];
  const float c00 = v[0][0][0] * (1.0f - fz) + v[0][0][1] * fz;
  const float c01 = v[0][1][0] * (1.0f - fz) + v[0][1][1] * fz;
  const float c10 = v[1][0][0] * (1.0f - fz) + v[1][0][1] * fz;
  const float c11 = v[1][1][0] * (1.0f - fz) + v[1][1][1] * fz;
  const float c0 = c00 * (1.0f - fy) + c01 * fy;
  const float c1 = c10 * (1.0f - fy) + c11 * fy;
  return c0 * (1.0f - fx) + c1 * fx;
}

// The smooth classify of vn -> rgba; s1, s2 and w of intervals 1..K-1 go to
// the arrays (slot k; slot 0 unused), which the forward march discards.
template <int KMAX>
__device__ __forceinline__ float4 smooth_classify(const SmoothTF<KMAX>& tf,
                                                  int num_intervals,
                                                  float sharp, float vn,
                                                  float s1[KMAX],
                                                  float s2[KMAX],
                                                  float w[KMAX]) {
  float4 rgba = tf.c0;
#pragma unroll
  for (int k = 1; k < KMAX; ++k) {
    if (k < num_intervals) {
      const float a = smooth_sigmoid(sharp * (vn - tf.lo[k]));
      const float b = smooth_sigmoid(sharp * (tf.hi[k] - vn));
      const float wk = a * b;
      s1[k] = a;
      s2[k] = b;
      w[k] = wk;
      const float4 dk = tf.dk[k];
      rgba.x = rgba.x + wk * dk.x;
      rgba.y = rgba.y + wk * dk.y;
      rgba.z = rgba.z + wk * dk.z;
      rgba.w = rgba.w + wk * dk.w;
    }
  }
  return rgba;
}

// Every thread of the block calls this before its march: the bounds, c_0
// and c_k - c_0, then rgba0 = classify(0 / cal_max), taken once through
// the same function as every sample.
template <int KMAX>
__device__ __forceinline__ void load_tf(SmoothTF<KMAX>& tf,
                                        const float* __restrict__ lower,
                                        const float* __restrict__ upper,
                                        const float* __restrict__ colors,
                                        int num_intervals,
                                        const SmoothScalars& s) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < KMAX) {
    const bool in = tid < num_intervals;
    tf.lo[tid] = in ? lower[tid] : 0.0f;
    tf.hi[tid] = in ? upper[tid] : 0.0f;
    const float4 c0 =
        make_float4(colors[0], colors[1], colors[2], colors[3]);
    float4 dk = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (in) {
      const float* c = colors + 4 * tid;
      dk = make_float4(c[0] - c0.x, c[1] - c0.y, c[2] - c0.z, c[3] - c0.w);
    }
    tf.dk[tid] = dk;
    tf.s1_0[tid] = tf.s2_0[tid] = tf.w0[tid] = 0.0f;
    if (tid == 0) tf.c0 = c0;
  }
  __syncthreads();
  if (tid == 0) {
    tf.rgba0 = smooth_classify<KMAX>(tf, num_intervals, s.sharp,
                                     0.0f / s.cal, tf.s1_0, tf.s2_0, tf.w0);
    float wsum = 0.0f;  // in K9's order
#pragma unroll
    for (int k = 1; k < KMAX; ++k)
      if (k < num_intervals) wsum = wsum + tf.w0[k];
    tf.base0 = 1.0f - wsum;
  }
  __syncthreads();
}

// Samples [i_lo, i_hi] of the ray (o, d), clamped to [0, spr): those that
// may have a corner in the volume; i_lo > i_hi where there is none.  The
// box vox_c in [-1, dim_c) is, in ray space (p = (vox - voff) / L - 0.5),
// [(-1 - voff_c) / L - 0.5, (dim_c - voff_c) / L - 0.5], and box_span
// (march_common.cuh) widens it by span_pad and a sample at each end.  A
// ray or scalar that is not finite, or a step that is not positive, takes
// every sample: its chain then decides alone.  ops/smooth.sample_range
// mirrors this function in the same float order.
__device__ __forceinline__ void smooth_sample_range(const float o[3],
                                                    const float d[3],
                                                    const SmoothScalars& s,
                                                    const Geom& g, int& i_lo,
                                                    int& i_hi) {
  i_lo = 0;
  i_hi = g.spr - 1;
  const float pad = span_pad(o, d, s.ds, s.clip);
  bool finite = pad >= 0.0f && isfinite(s.L);
  float lo[3], hi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    finite = finite && isfinite(s.voff[c]);
    lo[c] = (-1.0f - s.voff[c]) / s.L - 0.5f;
    hi[c] = ((float)g.dim[c] - s.voff[c]) / s.L - 0.5f;
  }
  if (!finite) return;
  int a, b;
  box_span(o, d, lo, hi, pad, s.ds, s.clip, false, a, b);
  i_lo = max(i_lo, a);
  i_hi = min(i_hi, b);
}

}  // namespace
