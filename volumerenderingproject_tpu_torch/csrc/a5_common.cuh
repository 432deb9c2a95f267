// Shared by the a5 march kernels (a5.cu, K3; a5_bwd.cu, K6): the scalar-
// vector layout, the sample position, each ray's span of samples and the
// chain from a sample to its 8 corner ids, written once so that the forward
// and the backward march read the same corners with the same weights.
//
// Float order mirrors the JAX reference (models/raycast._a5_positions,
// ops/sampling.trilinear_color_sample) expression by expression.  Build
// with -fmad=false: a contracted product-sum moves a sample across a voxel
// boundary and changes its corners.
//
// The position is the TPU kernel's hoisted chain (pallas_a5.py:186-215):
// prep (ops/a5.stage_matrices) builds modelCam as a scale with a
// translation, rows (s1, 0, 0, o1), (0, s2, 0, o2), (0, 0, s3, 0), and
// toVolume as the scale L with the translation m3, rows (L, 0, 0, m3_0),
// ... , with exact zeros off their diagonals.  Applied in T.apply's order,
// ((p0 r0 + p1 r1) + p2 r2) + t, a product with such a zero adds a signed
// zero to a sum, which changes no finite sum but its sign of zero, and no
// later operation reads that sign: the three stages reduce, bit for bit, to
//   per ray:     q_c = (px s1 + o1) iv[c][0] + (py s2 + o2) iv[c][1]
//   per sample:  p2_c = (q_c + (i s3) iv[c][2]) + iv[c][3]
//                p_c  = p2_c L_c + m3_c
// 16 operations a sample where the matrices take 45.  The kernels read
// those entries from the 41-slot scalar vector, whose layout stays that of
// the three 3x4 matrices; tests/test_torch_a5_chain.py holds the structural
// zeros and the chain against ops/a5.apply_stages on every sample.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// scalar-vector slots (ops/a5.py S_*): three 3x4 stage matrices, row-major
constexpr int S_MC = 0, S_IV = 12, S_TV = 24, S_EPS = 36, S_ID0 = 37,
              S_BG = 38;
constexpr int kScalLen = 41;

// a ray's span is widened by this times the largest magnitude its position
// chain adds (a5_span): about a thousand times what the chain rounds
constexpr float kRangePad = 1.0f / 16384.0f;
// a direction component at most this small is not divided by (a5_span)
constexpr float kTinyStep = 1e-20f;

// A work unit's geometry: the grid, the unit's columns [x_off, x_off +
// width) of the image and its samples [s_start, s_start + spr).
struct A5Geom {
  int dim[3];
  float fdim[3];
  long long total;
  int width, height, spr;
  int x_off, s_start;
};

A5Geom make_a5_geom(int d1, int d2, int d3, int width, int height, int spr,
                    int x_off, int s_start) {
  A5Geom g;
  g.dim[0] = d1;
  g.dim[1] = d2;
  g.dim[2] = d3;
  for (int c = 0; c < 3; ++c) g.fdim[c] = (float)g.dim[c];
  g.total = (long long)d1 * d2 * d3;
  g.width = width;
  g.height = height;
  g.spr = spr;
  g.x_off = x_off;
  g.s_start = s_start;
  return g;
}

// Whether every flat index a corner can form stays below 2^31.  A corner
// index reaches dim + 1: trunc(p + 1) of p < dim is dim, or dim + 1 where
// p + 1 rounds up (p one ulp below a power-of-two dim, a tie), and the
// flat index's y and z terms wrap into the next row and plane.
// ops/a5.index32 mirrors this rule.
bool a5_index32(int d1, int d2, int d3) {
  const long long s1 = (long long)d2 * d3;
  return (long long)(d1 + 1) * s1 + (long long)(d2 + 1) * d3 + (d3 + 1) <
         (1LL << 31);
}

// What the position chain of a launch reads (the header above).
struct A5Chain {
  float s3, iv2[3], iv3[3], L[3], m3[3];
};

__device__ __forceinline__ A5Chain a5_chain(const float* __restrict__ scal) {
  A5Chain ch;
  ch.s3 = scal[S_MC + 10];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ch.iv2[c] = scal[S_IV + 4 * c + 2];
    ch.iv3[c] = scal[S_IV + 4 * c + 3];
    ch.L[c] = scal[S_TV + 5 * c];
    ch.m3[c] = scal[S_TV + 4 * c + 3];
  }
  return ch;
}

// The i-independent part of the chain for the ray of global pixel (px, py).
__device__ __forceinline__ void a5_ray_q(const float* __restrict__ scal,
                                         int px, int py, float q[3]) {
  const float p1x = (float)px * scal[S_MC + 0] + scal[S_MC + 3];
  const float p1y = (float)py * scal[S_MC + 5] + scal[S_MC + 7];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    q[c] = p1x * scal[S_IV + 4 * c] + p1y * scal[S_IV + 4 * c + 1];
}

// Voxel-space position of sample i.
__device__ __forceinline__ void a5_position(const A5Chain& ch,
                                            const float q[3], int i,
                                            float p[3]) {
  const float p1z = (float)i * ch.s3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float p2 = (q[c] + p1z * ch.iv2[c]) + ch.iv3[c];
    p[c] = p2 * ch.L[c] + ch.m3[c];
  }
}

// The ray's span [lo, hi] within the unit's samples: every sample whose
// position may lie in [0, dims).  Along an a5 ray the position is affine in
// the sample index, p_c(i) = A_c + B_c i with B_c = s3 iv[c][2] L_c the same
// for every ray (pallas_a5.py:574-577), up to the chain's rounding.  The
// box is widened by kRangePad (the largest magnitude the chain adds, + 2),
// which bounds that rounding and the rounding of A and B, and the span by
// one sample at each end, which bounds the rounding of the quotients.  An
// axis whose |B_c| is at most kTinyStep is not divided by: the ray's
// position on it moves by less than a billionth of the pad over 2^31
// samples, so A_c alone, against the padded box, says whether the ray is
// inside that axis's slab for every sample.  Where q, A or B is not
// finite the span is every sample.  An empty span is lo = end, hi = end -
// 1 (end = s_start + spr).  ops/a5.sample_range mirrors it in its float
// order.
__device__ __forceinline__ void a5_span(const A5Chain& ch, const float q[3],
                                        const A5Geom& g, int& lo, int& hi) {
  const int end = g.s_start + g.spr;
  lo = g.s_start;
  hi = end - 1;
  const float imax = (float)end;
  float t_lo = -INFINITY, t_hi = INFINITY;
  bool finite = true;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float A = (q[c] + ch.iv3[c]) * ch.L[c] + ch.m3[c];
    const float B = (ch.s3 * ch.iv2[c]) * ch.L[c];
    const float mag =
        ((fabsf(q[c]) + fabsf(ch.s3 * ch.iv2[c]) * imax) + fabsf(ch.iv3[c])) *
            fabsf(ch.L[c]) +
        fabsf(ch.m3[c]);
    finite = finite && isfinite(A) && isfinite(B) && isfinite(mag);
    const float pad = kRangePad * (mag + 2.0f);
    const float l = 0.0f - pad;
    const float h = g.fdim[c] + pad;
    const bool safe = fabsf(B) > kTinyStep;
    const float bv = safe ? B : 1.0f;
    const float ta = (l - A) / bv;
    const float tb = (h - A) / bv;
    const bool in_c = (A >= l) && (A <= h);
    t_lo = fmaxf(t_lo, safe ? fminf(ta, tb) : (in_c ? -INFINITY : INFINITY));
    t_hi = fminf(t_hi, safe ? fmaxf(ta, tb) : (in_c ? INFINITY : -INFINITY));
  }
  if (!finite) return;
  if (!(t_hi >= t_lo)) {
    lo = end;
    hi = end - 1;
    return;
  }
  // clamped in float first: the quotients may be far beyond int
  const float w_lo = (float)g.s_start - 2.0f, w_hi = imax + 1.0f;
  lo = max(lo, (int)floorf(fminf(fmaxf(t_lo, w_lo), w_hi)) - 1);
  hi = min(hi, (int)ceilf(fminf(fmaxf(t_hi, w_lo), w_hi)) + 1);
  if (lo > hi) {
    lo = end;
    hi = end - 1;
  }
}

// Sample i's 8 corner ids in fetch order X1..X8 = (0,0,0), (0,0,1), (0,1,0),
// (0,1,1), (1,0,0), (1,0,1), (1,1,0), (1,1,1) (kernel.cu:129-159) and its
// fractions.  Returns false outside [0, dims), where the sample takes TF(0)'s
// colour and ids/frac are not set.  With `flat0`, the flat index of sample
// i's containing voxel (the first corner, trunc(p)) goes there too.  The
// offsets are added in float before the truncation (trunc(x + 1), not
// trunc(x) + 1), and the only bound guard is flat < total: a y+1 or z+1 tap
// at the last row wraps into the next row, and a corner past the end reads
// intensity 0, whose id is id0.  Idx is the flat index's type: int where
// a5_index32 allows it, else long long.
template <typename Idx>
__device__ __forceinline__ bool a5_corners(const A5Chain& ch,
                                           const float q[3], int i,
                                           const A5Geom& g,
                                           const uint8_t* __restrict__ ids,
                                           int id0, int id8[8],
                                           float frac[3],
                                           Idx* flat0 = nullptr) {
  float p[3];
  a5_position(ch, q, i, p);
  bool inside = true;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    inside = inside && (p[c] >= 0.0f) && (p[c] < g.fdim[c]);
  if (!inside) return false;
  Idx i0[3], i1[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float t0 = truncf(p[c]);
    i0[c] = (Idx)t0;
    i1[c] = (Idx)truncf(p[c] + 1.0f);
    frac[c] = p[c] - t0;  // `difference` kernel.cu:127
  }
  const Idx s1 = (Idx)g.dim[1] * g.dim[2];
  const Idx s2 = g.dim[2];
  const Idx total = (Idx)g.total;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const Idx flat = ((k & 4) ? i1[0] : i0[0]) * s1 +
                     ((k & 2) ? i1[1] : i0[1]) * s2 +
                     ((k & 1) ? i1[2] : i0[2]);
    id8[k] = flat < total ? (int)__ldg(ids + flat) : id0;
    if (k == 0 && flat0 != nullptr) *flat0 = flat;
  }
  return true;
}

}  // namespace
