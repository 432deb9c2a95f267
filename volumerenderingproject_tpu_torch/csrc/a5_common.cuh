// Shared by the a5 march kernels (a5.cu, K3; a5_bwd.cu, K6): the scalar-
// vector layout, the sample position and the chain from a sample to its 8
// corner ids, written once so that the forward and the backward march read
// the same corners with the same weights.
//
// Float order mirrors the JAX reference (models/raycast._a5_positions,
// ops/sampling.trilinear_color_sample) expression by expression.  Build
// with -fmad=false: a contracted product-sum moves a sample across a voxel
// boundary and changes its corners.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// scalar-vector slots (ops/a5.py S_*): three 3x4 stage matrices, row-major
constexpr int S_MC = 0, S_IV = 12, S_TV = 24, S_EPS = 36, S_ID0 = 37,
              S_BG = 38;
constexpr int kScalLen = 41;

struct A5Geom {
  int dim[3];
  float fdim[3];
  long long total;
  int width, height, spr;
};

A5Geom make_a5_geom(int d1, int d2, int d3, int width, int height, int spr) {
  A5Geom g;
  g.dim[0] = d1;
  g.dim[1] = d2;
  g.dim[2] = d3;
  for (int c = 0; c < 3; ++c) g.fdim[c] = (float)g.dim[c];
  g.total = (long long)d1 * d2 * d3;
  g.width = width;
  g.height = height;
  g.spr = spr;
  return g;
}

// The three stage matrices in registers, and the i-independent part of the
// first stage for one ray.
struct A5Ray {
  float m[36];
  float p1xy[3];  // x * mc[c][0] + y * mc[c][1]
};

__device__ __forceinline__ void a5_ray_setup(const float* __restrict__ scal,
                                             int px, int py, A5Ray& r) {
#pragma unroll
  for (int k = 0; k < 36; ++k) r.m[k] = scal[k];
  const float x = (float)px, y = (float)py;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    r.p1xy[c] = x * r.m[S_MC + 4 * c] + y * r.m[S_MC + 4 * c + 1];
}

// Voxel-space position of sample i: each stage applied in T.apply's order,
// ((p0 r0 + p1 r1) + p2 r2) + t (kernel.cu:100-115).
__device__ __forceinline__ void a5_position(const A5Ray& r, int i,
                                            float p[3]) {
  const float fi = (float)i;
  float p1[3], p2[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    p1[c] = (r.p1xy[c] + fi * r.m[S_MC + 4 * c + 2]) + r.m[S_MC + 4 * c + 3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* row = r.m + S_IV + 4 * c;
    p2[c] = ((p1[0] * row[0] + p1[1] * row[1]) + p1[2] * row[2]) + row[3];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* row = r.m + S_TV + 4 * c;
    p[c] = ((p2[0] * row[0] + p2[1] * row[1]) + p2[2] * row[2]) + row[3];
  }
}

// Sample i's 8 corner ids in fetch order X1..X8 = (0,0,0), (0,0,1), (0,1,0),
// (0,1,1), (1,0,0), (1,0,1), (1,1,0), (1,1,1) (kernel.cu:129-159) and its
// fractions.  Returns false outside [0, dims), where the sample takes TF(0)'s
// colour and ids/frac are not set.  The offsets are added in float before
// the truncation (trunc(x + 1), not trunc(x) + 1), and the only bound guard
// is flat < total: a y+1 or z+1 tap at the last row wraps into the next row,
// and a corner past the end reads intensity 0, whose id is id0.
__device__ __forceinline__ bool a5_corners(const A5Ray& r, int i,
                                           const A5Geom& g,
                                           const uint8_t* __restrict__ ids,
                                           int id0, int id8[8],
                                           float frac[3]) {
  float p[3];
  a5_position(r, i, p);
  bool inside = true;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    inside = inside && (p[c] >= 0.0f) && (p[c] < g.fdim[c]);
  if (!inside) return false;
  long long i0[3], i1[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float t0 = truncf(p[c]);
    i0[c] = (long long)t0;
    i1[c] = (long long)truncf(p[c] + 1.0f);
    frac[c] = p[c] - t0;  // `difference` kernel.cu:127
  }
  const long long s1 = (long long)g.dim[1] * g.dim[2];
  const long long s2 = g.dim[2];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const long long flat = ((k & 4) ? i1[0] : i0[0]) * s1 +
                           ((k & 2) ? i1[1] : i0[1]) * s2 +
                           ((k & 1) ? i1[2] : i0[2]);
    id8[k] = flat < g.total ? (int)__ldg(ids + flat) : id0;
  }
  return true;
}

}  // namespace
