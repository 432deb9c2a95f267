// Shared by the a1 march kernels (march.cu, K1; march_bwd.cu, K4): the
// scalar-vector layout, the geometry, the ray setup and the chain from a
// sample index to its voxel and colour id, written once so that the forward
// and the backward march put every sample in the same voxel.  The geometry
// also carries a sharded render's work unit (parallel/render_dist.py):
// columns [x_off, x_off + width) of a gwidth-wide image, samples
// [s_start, s_start + spr), and the x-slab [x0, x0 + nx) that the grids
// hold (x0 = 0, nx = dim[0] for the whole volume).
//
// Float order mirrors the JAX reference (models/raycast.py, ops/sampling.py)
// expression by expression.  Build with -fmad=false: a contracted o + t*d
// can move a sample into the next voxel and change its material.  Divisions
// and the square root are the IEEE ones (no fast-math flags).  The one
// place where the chain multiplies instead: floorf(p n) / n, n = 2^depth, is
// floorf(p n) * (1 / n) (Geom::inv_n), bit for bit, since the quotient of an
// integer-valued float (or of 0, inf, NaN) by a power of two is exact;
// tests/test_torch_march_chain.py holds the two against each other.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// scalar-vector slots (ops/march.py S_*)
constexpr int S_DS = 0, S_CLIP = 1, S_EPS = 3, S_FULL = 4, S_POS = 5,
              S_FRONT = 8, S_RIGHT = 11, S_UP = 14, S_TL = 17, S_RSW = 20,
              S_RSH = 21, S_BOX_LO = 22, S_BOX_HI = 25, S_ID0 = 28, S_BG = 29;

// a range's box is widened (or narrowed) by this times (max |o_c| + |clip| +
// 2), in ray space: about a hundred times what the float chain rounds there
constexpr float kRangePad = 1.0f / 16384.0f;
// an index beyond every sample: an empty span is [kNoSample, -kNoSample]
constexpr int kNoSample = 1000000000;

struct Geom {
  int dim[3];
  int nb[3];
  int width, height, spr;
  float n, inv_n, L, halfL;  // n = 2^depth, inv_n = 1 / n (exact)
  float hg[3], hg_hi[3], halfd[3];
  int x_off, gwidth, s_start, x0, nx;
};

Geom make_geom(int d1, int d2, int d3, int depth, int width, int height,
               int spr, int nbx, int nby, int nbz) {
  Geom g;
  g.dim[0] = d1;
  g.dim[1] = d2;
  g.dim[2] = d3;
  g.nb[0] = nbx;
  g.nb[1] = nby;
  g.nb[2] = nbz;
  g.width = width;
  g.height = height;
  g.spr = spr;
  const int longest = d1 > d2 ? (d1 > d3 ? d1 : d3) : (d2 > d3 ? d2 : d3);
  g.L = (float)longest;
  g.n = (float)(1LL << depth);
  g.inv_n = 1.0f / g.n;
  g.halfL = g.L * 0.5f;  // exact half
  for (int c = 0; c < 3; ++c) {
    g.halfd[c] = (float)g.dim[c] * 0.5f;
    g.hg[c] = g.halfL - g.halfd[c];
    g.hg_hi[c] = g.hg[c] + (float)g.dim[c];
  }
  g.x_off = 0;
  g.gwidth = width;
  g.s_start = 0;
  g.x0 = 0;
  g.nx = d1;
  return g;
}

// Origin and direction of pixel (px, py)'s ray (rayDirectionKernel
// kernel.cu:20-38 float order); px is the unit's column, the ray is that of
// the global column px + x_off of the gwidth-wide image.
__device__ __forceinline__ void ray_setup(const float* __restrict__ scal,
                                          const Geom& g, int px, int py,
                                          int conic, float o[3], float d[3]) {
  const float xs = ((float)(px + g.x_off) * scal[S_RSW]) / (float)g.gwidth;
  const float ys = ((float)py * scal[S_RSH]) / (float)g.height;
  if (conic) {
    float rd[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float xt = xs * scal[S_RIGHT + c];
      const float yt = ys * (-scal[S_UP + c]);
      o[c] = scal[S_POS + c];
      rd[c] = ((scal[S_TL + c] + xt) + yt) - scal[S_POS + c];
    }
    // correctly rounded 1/sqrt: taken in double, rounded once (as
    // utils/transforms.rsqrt does; rsqrtf is approximate)
    const float ss = (rd[0] * rd[0] + rd[1] * rd[1]) + rd[2] * rd[2];
    const float inv = (float)(1.0 / sqrt((double)ss));
#pragma unroll
    for (int c = 0; c < 3; ++c) d[c] = rd[c] * inv;
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float xt = xs * scal[S_RIGHT + c];
      const float yt = ys * (-scal[S_UP + c]);
      o[c] = (scal[S_TL + c] + xt) + yt;
      d[c] = scal[S_FRONT + c];
    }
  }
}

// float -> int for values that may be +-inf or huge (NaN -> -1e9)
__device__ __forceinline__ int to_int_clamped(float v) {
  return (int)fminf(fmaxf(v, -1.0e9f), 1.0e9f);
}

// The pad of the ray (o, d)'s spans (box_span): kRangePad (max |o_c| +
// |clip| + 2), which bounds every term the chain rounds near the box (there
// |ti d| is at most |o| + 1); -1 where the ray, the step or the clip is
// not finite or the step is not positive: a span then holds every sample.
__device__ __forceinline__ float span_pad(const float o[3], const float d[3],
                                          float ds, float clip) {
  bool finite = ds > 0.0f && isfinite(ds) && isfinite(clip);
  float mag = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    finite = finite && isfinite(o[c]) && isfinite(d[c]);
    mag = fmaxf(mag, fabsf(o[c]));
  }
  return finite ? kRangePad * ((mag + fabsf(clip)) + 2.0f) : -1.0f;
}

// Samples [i_lo, i_hi] of the ray (o, d) whose position o + ti d may lie in
// the box [lo, hi] (ray space, per axis; an infinite bound bounds nothing),
// or with `inward` those whose position surely lies in it.  The box is
// widened (narrowed) by `pad`, which bounds the float chain's rounding of
// the position, and the span by one sample at each end, which bounds the
// rounding of ti and of the quotients below.  A direction component of
// magnitude at most 1e-12 is not divided by: the ray is then inside or
// outside that axis's slab for every sample (K1's `safe`).  An empty span
// is [kNoSample, -kNoSample].  `pad` comes from span_pad, which checks
// that the inputs are finite.  ops/march.box_span mirrors it in its float
// order.
__device__ __forceinline__ void box_span(const float o[3], const float d[3],
                                         const float lo[3], const float hi[3],
                                         float pad, float ds, float clip,
                                         bool inward, int& i_lo, int& i_hi) {
  float t_lo = -INFINITY, t_hi = INFINITY;
  bool empty = false;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float l = inward ? lo[c] + pad : lo[c] - pad;
    const float h = inward ? hi[c] - pad : hi[c] + pad;
    empty = empty || !(h >= l);
    const bool safe = fabsf(d[c]) > 1e-12f;
    const float dv = safe ? d[c] : 1.0f;
    const float ta = (l - o[c]) / dv;
    const float tb = (h - o[c]) / dv;
    const bool in_c = (o[c] >= l) && (o[c] <= h);
    t_lo = fmaxf(t_lo, safe ? fminf(ta, tb) : (in_c ? -INFINITY : INFINITY));
    t_hi = fminf(t_hi, safe ? fmaxf(ta, tb) : (in_c ? INFINITY : -INFINITY));
  }
  if (empty || !(t_hi >= t_lo)) {
    i_lo = kNoSample;
    i_hi = -kNoSample;
    return;
  }
  const float f_lo = (t_lo - clip) / ds;
  const float f_hi = (t_hi - clip) / ds;
  if (inward) {
    i_lo = to_int_clamped(ceilf(f_lo)) + 1;
    i_hi = to_int_clamped(floorf(f_hi)) - 1;
  } else {
    i_lo = to_int_clamped(floorf(f_lo)) - 1;
    i_hi = to_int_clamped(ceilf(f_hi)) + 1;
  }
}

// The chain from sample i to its voxel, written once for every a1 march:
// modelAux (+0.5) -> octree nearest voxel -> flat index `flat`, clamped into
// range; a sample off the volume makes the function `return off`.  `flat`
// has the function's index type Idx: 64-bit unless the caller takes 32
// (K1 where vrp_march_a1_index32 allows it, march.cu).  It
// expands inside the two functions below, whose parameters it reads.  A
// macro, not a function: sample_id built on a function that returned a
// validity flag compiled into slower code (K1 plain 5 % on the H100,
// harness/ab_march.py), while this expansion gives both functions the code
// of a hand-written copy of the chain.
#define VRP_SAMPLE_VOXEL(off)                                              \
  const float ti = (float)i * ds + clip; /* kernel.cu:54,59 */             \
  bool valid = true;                                                        \
  int ijk[3];                                                               \
  _Pragma("unroll") for (int c = 0; c < 3; ++c) {                           \
    const float p = (o[c] + ti * d[c]) + 0.5f; /* modelAux kernel.cu:1050 */ \
    const float res = (floorf(p * g.n) * g.inv_n) * g.L;                    \
    valid = valid && (p >= 0.0f) && (p < 1.0f) && (res >= g.hg[c]) &&       \
            (res < g.hg_hi[c]);                                             \
    ijk[c] = valid ? (int)truncf((res + g.halfd[c]) - g.halfL) : 0;         \
  }                                                                         \
  if (!valid) return off;                                                   \
  Idx flat = ((Idx)ijk[0] * g.dim[1] + ijk[1]) * g.dim[2] + ijk[2];         \
  const Idx last = (Idx)g.dim[0] * g.dim[1] * g.dim[2] - 1;                 \
  flat = flat < 0 ? 0 : (flat > last ? last : flat)

// Flat index of sample i's voxel; -1 when the sample lies off the volume.
// The baked-light march reads the id, M and S there.
template <typename Idx = long long>
__device__ __forceinline__ Idx sample_voxel(int i, const float o[3],
                                            const float d[3], float ds,
                                            float clip, const Geom& g) {
  VRP_SAMPLE_VOXEL(-1);
  return flat;
}

// Flat index of sample i's voxel as sample_voxel gives it, and the voxel's
// indices as the chain computes them in `out`: the in-kernel lighting
// variant reads the six neighbours there.
template <typename Idx = long long>
__device__ __forceinline__ Idx sample_voxel_ijk(int i, const float o[3],
                                                const float d[3], float ds,
                                                float clip, const Geom& g,
                                                int out[3]) {
  VRP_SAMPLE_VOXEL(-1);
  out[0] = ijk[0];
  out[1] = ijk[1];
  out[2] = ijk[2];
  return flat;
}

// Colour id of sample i (an interval id, uint8, or a LUT index, uint16); a
// sample off the volume takes id0, the id of intensity 0.
template <typename Id, typename Idx = long long>
__device__ __forceinline__ int sample_id(int i, const float o[3],
                                         const float d[3], float ds,
                                         float clip, const Geom& g,
                                         const Id* __restrict__ ids,
                                         int id0) {
  VRP_SAMPLE_VOXEL(id0);
  return __ldg(ids + flat);
}

#undef VRP_SAMPLE_VOXEL

// The chain of VRP_SAMPLE_VOXEL on an x-slab [g.x0, g.x0 + g.nx): the
// sample belongs to the slab that holds its x-clamped voxel index, which is
// computed off the volume too (sampling.py:105-140), so that each sample
// is composited by one slab.  Returns the slab-local flat index of an owned
// sample inside the volume, -1 for an owned sample off it (it takes id0),
// -2 for a sample that another slab owns (it leaves (C, T) as it is).
template <typename Idx = long long>
__device__ __forceinline__ Idx sample_voxel_slab(int i, const float o[3],
                                                 const float d[3], float ds,
                                                 float clip, const Geom& g) {
  const float ti = (float)i * ds + clip;  // kernel.cu:54,59
  bool valid = true;
  int ijk[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float p = (o[c] + ti * d[c]) + 0.5f;  // modelAux kernel.cu:1050
    const float res = (floorf(p * g.n) * g.inv_n) * g.L;
    valid = valid && (p >= 0.0f) && (p < 1.0f) && (res >= g.hg[c]) &&
            (res < g.hg_hi[c]);
    ijk[c] = (int)truncf((res + g.halfd[c]) - g.halfL);
  }
  const int gx = min(max(ijk[0], 0), g.dim[0] - 1);
  if (gx < g.x0 || gx >= g.x0 + g.nx) return -2;
  if (!valid) return -1;
  Idx flat = ((Idx)(ijk[0] - g.x0) * g.dim[1] + ijk[1]) * g.dim[2] + ijk[2];
  const Idx last = (Idx)g.nx * g.dim[1] * g.dim[2] - 1;
  return flat < 0 ? 0 : (flat > last ? last : flat);
}

}  // namespace
