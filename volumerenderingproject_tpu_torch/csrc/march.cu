// Fused a1/VRC ray march for NVIDIA Hopper (sm_90a).
//
// Replaces volumerenderingproject_tpu/ops/pallas_march.py:_march_kernel in
// resident mode with the packed material-id grid: ortho or conic rays,
// nearest-voxel sampling, classification by interval id, density_scale,
// front-to-back (C, T) compositing and early ray termination.  The lut,
// lighting, baked-light, multichannel, segment and streamed variants of that
// kernel are not here.
//
// One thread marches one ray:
//   ray setup -> clip of the sample range to the dataset box (+-1 sample)
//   -> for each run of kChunk samples, skip it when every 8^3 brick its
//      voxel box touches is transparent
//   -> per sample: modelAux (+0.5) -> octree nearest voxel -> uint8 interval
//      id -> RGBA from shared memory -> C += T*a*rgb, T *= 1 - a
//   -> stop before the first sample with T <= eps
//   -> out = (C + T * background, 1).
// Every skip is exact (a skipped sample has alpha 0); all of them turn off
// when TF(0).alpha > 0 (scal[4] set), as `alpha0` does in the TPU kernel.
//
// What bounds it on an H100: operations, not bytes.  The id grid takes one
// byte per voxel (7.2 MB at 182x218x182) and stays in the 50 MB L2; the
// image is 16 bytes per ray.  Each sample costs some forty float and integer
// operations and one dependent byte load, so the time goes to issuing those
// operations and to the latency of the load chain.  The design answers
// with 16x16 pixel blocks (neighbouring rays read neighbouring voxels, so a
// warp's loads share cache lines), colours in shared memory, a one-byte grid
// that the caches hold whole, and the box clip, brick skip and early
// termination, which drop samples that cannot change the image.
//
// Float order mirrors the JAX reference (models/raycast.py, ops/sampling.py)
// expression by expression.  Build with -fmad=false: a contracted o + t*d
// can move a sample into the next voxel and change its material.  Divisions
// and the square root are the IEEE ones (no fast-math flags).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8;          // samples per brick-occupancy test
constexpr int kBrick = 8;          // brick edge in voxels
constexpr int kMaxIntervals = 256; // ids are uint8

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

// float -> int for values that may be +-inf or huge
__device__ __forceinline__ int to_int_clamped(float v) {
  return (int)fminf(fmaxf(v, -1.0e9f), 1.0e9f);
}

// Conservative test of samples [i0, i1] of one ray: does the voxel box they
// can reach touch any brick with an alpha > 0 voxel?  Every step below is
// monotone, so pushing the end points (widened by 1e-5) through the index
// chain bounds the voxels of every sample between them
// (pallas_march.py:387-445, for one ray instead of a tile).
__device__ bool chunk_occupied(int i0, int i1, const float o[3],
                               const float d[3], float ds, float clip,
                               const Geom& g, const int32_t* __restrict__ occ) {
  const float t0 = (float)i0 * ds + clip;
  const float t1 = (float)i1 * ds + clip;
  int blo[3], bhi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float a = t0 * d[c], b = t1 * d[c];
    const float plo = ((o[c] + fminf(a, b)) + 0.5f) - 1e-5f;
    const float phi = ((o[c] + fmaxf(a, b)) + 0.5f) + 1e-5f;
    const float alo = fmaxf(plo, 0.0f);
    const float ahi = fminf(phi, 1.0f - 5.9604645e-8f);  // 1 - 2^-24
    if (!(alo <= ahi)) return false;
    const float rlo = fmaxf((floorf(alo * g.n) / g.n) * g.L, g.hg[c]);
    const float rhi = fminf((floorf(ahi * g.n) / g.n) * g.L, g.hg_hi[c]);
    if (!(rlo < g.hg_hi[c]) || !(rhi >= g.hg[c])) return false;
    const int ilo = (int)truncf((rlo + g.halfd[c]) - g.halfL);
    const int ihi = (int)truncf((rhi + g.halfd[c]) - g.halfL);
    blo[c] = min(max(ilo, 0), g.dim[c] - 1) / kBrick;
    bhi[c] = min(max(ihi, 0), g.dim[c] - 1) / kBrick;
  }
  for (int bx = blo[0]; bx <= bhi[0]; ++bx)
    for (int by = blo[1]; by <= bhi[1]; ++by)
      for (int bz = blo[2]; bz <= bhi[2]; ++bz)
        if (__ldg(occ + (bx * g.nb[1] + by) * g.nb[2] + bz)) return true;
  return false;
}

__global__ void __launch_bounds__(256)
march_a1_kernel(const float* __restrict__ scal,
                const float* __restrict__ colors, int num_intervals,
                const uint8_t* __restrict__ ids,
                const int32_t* __restrict__ occ, Geom g, int conic,
                int scale_alpha, float density_scale,
                float* __restrict__ out) {
  __shared__ float4 s_col[kMaxIntervals];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = tid; k < num_intervals; k += blockDim.x * blockDim.y) {
    float4 c = make_float4(colors[4 * k], colors[4 * k + 1],
                           colors[4 * k + 2], colors[4 * k + 3]);
    if (scale_alpha) c.w = fminf(fmaxf(c.w * density_scale, 0.0f), 1.0f);
    s_col[k] = c;
  }
  __syncthreads();

  // threadIdx.x runs along y: out is [W, H, 4], y fastest
  const int py = blockIdx.x * blockDim.x + threadIdx.x;
  const int px = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= g.width || py >= g.height) return;

  // ---- ray setup (rayDirectionKernel kernel.cu:20-38 float order) --------
  const float xs = ((float)px * scal[S_RSW]) / (float)g.width;
  const float ys = ((float)py * scal[S_RSH]) / (float)g.height;
  float o[3], d[3];
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

  const float ds = scal[S_DS];
  const float clip = scal[S_CLIP];
  const float eps = fmaxf(scal[S_EPS], 0.0f);
  const bool full = scal[S_FULL] > 0.0f;
  const int id0 = (int)scal[S_ID0];

  // ---- sample range inside the dataset box, +-1 sample of slop -----------
  int s_lo = 0, s_hi = g.spr - 1;
  if (!full) {
    float t_lo = -INFINITY, t_hi = INFINITY;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float lo = scal[S_BOX_LO + c], hi = scal[S_BOX_HI + c];
      const bool safe = fabsf(d[c]) > 1e-12f;
      const float dv = safe ? d[c] : 1.0f;
      const float ta = (lo - o[c]) / dv;
      const float tb = (hi - o[c]) / dv;
      const bool in_c = (o[c] >= lo) && (o[c] <= hi);
      const float lo_c = safe ? fminf(ta, tb) : (in_c ? -INFINITY : INFINITY);
      const float hi_c = safe ? fmaxf(ta, tb) : (in_c ? INFINITY : -INFINITY);
      t_lo = fmaxf(t_lo, lo_c);
      t_hi = fminf(t_hi, hi_c);
    }
    if (t_hi >= t_lo) {
      s_lo = max(s_lo, to_int_clamped(floorf((t_lo - clip) / ds)) - 1);
      s_hi = min(s_hi, to_int_clamped(ceilf((t_hi - clip) / ds)) + 1);
    } else {
      s_hi = -1;
    }
  }

  // ---- march ---------------------------------------------------------------
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, t = 1.0f;
  for (int s0 = s_lo; s0 <= s_hi && t > eps; s0 += kChunk) {
    const int s1 = min(s0 + kChunk - 1, s_hi);
    if (!full && !chunk_occupied(s0, s1, o, d, ds, clip, g, occ)) continue;
    for (int i = s0; i <= s1; ++i) {
      if (!(t > eps)) break;
      const float ti = (float)i * ds + clip;  // kernel.cu:54,59
      bool valid = true;
      int ijk[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float p = (o[c] + ti * d[c]) + 0.5f;  // modelAux kernel.cu:1050
        const float res = (floorf(p * g.n) / g.n) * g.L;
        valid = valid && (p >= 0.0f) && (p < 1.0f) && (res >= g.hg[c]) &&
                (res < g.hg_hi[c]);
        ijk[c] = valid ? (int)truncf((res + g.halfd[c]) - g.halfL) : 0;
      }
      int mid = id0;
      if (valid) {
        long long flat =
            ((long long)ijk[0] * g.dim[1] + ijk[1]) * g.dim[2] + ijk[2];
        const long long last = (long long)g.dim[0] * g.dim[1] * g.dim[2] - 1;
        flat = flat < 0 ? 0 : (flat > last ? last : flat);
        mid = __ldg(ids + flat);
      }
      const float4 col = s_col[mid];
      const float w = t * col.w;
      cr = cr + w * col.x;
      cg = cg + w * col.y;
      cb = cb + w * col.z;
      t = t * (1.0f - col.w);
    }
  }

  float4 px_out;
  px_out.x = cr + t * scal[S_BG];
  px_out.y = cg + t * scal[S_BG + 1];
  px_out.z = cb + t * scal[S_BG + 2];
  px_out.w = 1.0f;
  reinterpret_cast<float4*>(out)[(long long)px * g.height + py] = px_out;
}

}  // namespace

// Launches the march on `stream`; returns cudaGetLastError() (0 = launched).
// scal: [32] f32; colors: [K, 4] f32; ids: [d1, d2, d3] uint8 (C order);
// occ: [nbx * nby * nbz] int32; out: [width, height, 4] f32.
extern "C" int vrp_march_a1(const float* scal, const float* colors, int K,
                            const uint8_t* ids, const int32_t* occ, int nbx,
                            int nby, int nbz, int d1, int d2, int d3,
                            int depth, int width, int height, int spr,
                            int conic, float density_scale, float* out,
                            void* stream) {
  if (K <= 0 || K > kMaxIntervals || width <= 0 || height <= 0 || spr <= 0)
    return (int)cudaErrorInvalidValue;
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
  const dim3 block(16, 16);
  const dim3 grid((height + 15) / 16, (width + 15) / 16);
  march_a1_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      scal, colors, K, ids, occ, g, conic, density_scale != 1.0f ? 1 : 0,
      density_scale, out);
  return (int)cudaGetLastError();
}
