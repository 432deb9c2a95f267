// Shared by the a1 march kernels (march.cu, K1; march_bwd.cu, K4): the
// scalar-vector layout, the geometry, the ray setup and the chain from a
// sample index to its voxel and colour id, written once so that the forward
// and the backward march put every sample in the same voxel.
//
// Float order mirrors the JAX reference (models/raycast.py, ops/sampling.py)
// expression by expression.  Build with -fmad=false: a contracted o + t*d
// can move a sample into the next voxel and change its material.  Divisions
// and the square root are the IEEE ones (no fast-math flags).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// scalar-vector slots (ops/march.py S_*)
constexpr int S_DS = 0, S_CLIP = 1, S_EPS = 3, S_FULL = 4, S_POS = 5,
              S_FRONT = 8, S_RIGHT = 11, S_UP = 14, S_TL = 17, S_RSW = 20,
              S_RSH = 21, S_BOX_LO = 22, S_BOX_HI = 25, S_ID0 = 28, S_BG = 29;

struct Geom {
  int dim[3];
  int nb[3];
  int width, height, spr;
  float n, L, halfL;
  float hg[3], hg_hi[3], halfd[3];
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
  g.halfL = g.L * 0.5f;  // exact half
  for (int c = 0; c < 3; ++c) {
    g.halfd[c] = (float)g.dim[c] * 0.5f;
    g.hg[c] = g.halfL - g.halfd[c];
    g.hg_hi[c] = g.hg[c] + (float)g.dim[c];
  }
  return g;
}

// Origin and direction of pixel (px, py)'s ray (rayDirectionKernel
// kernel.cu:20-38 float order).
__device__ __forceinline__ void ray_setup(const float* __restrict__ scal,
                                          const Geom& g, int px, int py,
                                          int conic, float o[3], float d[3]) {
  const float xs = ((float)px * scal[S_RSW]) / (float)g.width;
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

// The chain from sample i to its voxel, written once for every a1 march:
// modelAux (+0.5) -> octree nearest voxel -> flat index `flat`, clamped into
// range; a sample off the volume makes the function `return off`.  It
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
    const float res = (floorf(p * g.n) / g.n) * g.L;                        \
    valid = valid && (p >= 0.0f) && (p < 1.0f) && (res >= g.hg[c]) &&       \
            (res < g.hg_hi[c]);                                             \
    ijk[c] = valid ? (int)truncf((res + g.halfd[c]) - g.halfL) : 0;         \
  }                                                                         \
  if (!valid) return off;                                                   \
  long long flat =                                                          \
      ((long long)ijk[0] * g.dim[1] + ijk[1]) * g.dim[2] + ijk[2];          \
  const long long last = (long long)g.dim[0] * g.dim[1] * g.dim[2] - 1;     \
  flat = flat < 0 ? 0 : (flat > last ? last : flat)

// Flat index of sample i's voxel; -1 when the sample lies off the volume.
// The baked-light march reads the id, M and S there.
__device__ __forceinline__ long long sample_voxel(int i, const float o[3],
                                                  const float d[3], float ds,
                                                  float clip, const Geom& g) {
  VRP_SAMPLE_VOXEL(-1);
  return flat;
}

// Colour id of sample i (an interval id, uint8, or a LUT index, uint16); a
// sample off the volume takes id0, the id of intensity 0.
template <typename Id>
__device__ __forceinline__ int sample_id(int i, const float o[3],
                                         const float d[3], float ds,
                                         float clip, const Geom& g,
                                         const Id* __restrict__ ids,
                                         int id0) {
  VRP_SAMPLE_VOXEL(id0);
  return __ldg(ids + flat);
}

#undef VRP_SAMPLE_VOXEL

}  // namespace
