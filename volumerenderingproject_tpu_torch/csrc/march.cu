// Fused a1/VRC ray march for NVIDIA Hopper (sm_90a).
//
// Replaces volumerenderingproject_tpu/ops/pallas_march.py:_march_kernel in
// resident mode: ortho or conic rays, nearest-voxel sampling,
// classification by colour id, density_scale, front-to-back (C, T)
// compositing and early ray termination, in three variants, template
// parameters of the one kernel:
//   * plain: uint8 interval ids (the packed material-id grid), <= 256
//     colours;
//   * LUT (`lut_n`/`lut_packed`): uint16 indices into the dense TF LUT
//     (config.tf_lut), <= 1024 colours (16 KB of shared memory);
//   * baked light (`baked_light`): per-voxel Blinn-Phong factor grids M and
//     S (f32, in HBM), rgb <- rgb * M + S at the sample's voxel; a sample
//     off the volume takes M = 1, S = 0 (pallas_march.py:671-680).
// LUT and baked light compose.  The in-kernel (conic) `lighting`,
// multichannel, segment and streamed variants of that kernel are not here.
//
// One thread marches one ray:
//   ray setup -> clip of the sample range to the dataset box (+-1 sample)
//   -> for each run of kChunk samples, skip it when every 8^3 brick its
//      voxel box touches is transparent
//   -> per sample: modelAux (+0.5) -> octree nearest voxel -> colour id ->
//      RGBA from shared memory [-> rgb * M + S] -> C += T*a*rgb,
//      T *= 1 - a
//   -> stop before the first sample with T <= eps
//   -> out = (C + T * background, 1).
// Every skip is exact (a skipped sample has alpha 0; shading never touches
// alpha); all of them turn off when the alpha of id0 is not 0 (scal[4]
// set), since samples off the volume then change (C, T).
//
// What bounds it on an H100: operations, not bytes.  The id grid takes one
// byte per voxel (7.2 MB at 182x218x182) and stays in the 50 MB L2; the
// image is 16 bytes per ray.  Each sample costs some forty float and integer
// operations and one dependent byte load, so the time goes to issuing those
// operations and to the latency of the load chain.  The design answers
// with 16x16 pixel blocks (neighbouring rays read neighbouring voxels, so a
// warp's loads share cache lines), colours in shared memory, a one-byte grid
// that the caches hold whole, and the box clip, brick skip and early
// termination, which drop samples that cannot change the image.  The baked
// variants are bound by bytes instead: M and S take 8 bytes per voxel (58 MB
// at 182x218x182, more than L2 holds), read per sample inside the volume
// beside the id; neighbouring rays read neighbouring voxels of them too.
// The LUT variants' uint16 grid takes two bytes a voxel.
//
// Ray setup and the sample -> voxel -> id chain are in march_common.cuh,
// shared with the backward march (march_bwd.cu).

#include "march_common.cuh"

namespace {

constexpr int kChunk = 8;          // samples per brick-occupancy test
constexpr int kBrick = 8;          // brick edge in voxels
constexpr int kMaxIntervals = 256;  // uint8 interval ids
constexpr int kMaxLut = 1024;       // uint16 LUT indices (tf_lut <= 1024)

// float -> int for values that may be +-inf or huge
__device__ __forceinline__ int to_int_clamped(float v) {
  return (int)fminf(fmaxf(v, -1.0e9f), 1.0e9f);
}

// Conservative test of samples [i0, i1] of one ray: does the voxel box they
// can reach touch any brick with an alpha != 0 voxel?  Every step below is
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

template <typename Id, bool kBaked>
__global__ void __launch_bounds__(256)
march_a1_kernel(const float* __restrict__ scal,
                const float* __restrict__ colors, int num_colors,
                const Id* __restrict__ ids, const int32_t* __restrict__ occ,
                const float* __restrict__ mgrid,
                const float* __restrict__ sgrid, Geom g, int conic,
                int scale_alpha, float density_scale,
                float* __restrict__ out) {
  __shared__ float4 s_col[sizeof(Id) == 1 ? kMaxIntervals : kMaxLut];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = tid; k < num_colors; k += blockDim.x * blockDim.y) {
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

  float o[3], d[3];
  ray_setup(scal, g, px, py, conic, o, d);

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
      float4 col;
      if constexpr (kBaked) {
        const long long flat = sample_voxel(i, o, d, ds, clip, g);
        col = s_col[flat < 0 ? id0 : (int)__ldg(ids + flat)];
        const float m = flat < 0 ? 1.0f : __ldg(mgrid + flat);
        const float sh = flat < 0 ? 0.0f : __ldg(sgrid + flat);
        col.x = col.x * m + sh;
        col.y = col.y * m + sh;
        col.z = col.z * m + sh;
      } else {
        col = s_col[sample_id(i, o, d, ds, clip, g, ids, id0)];
      }
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

template <typename Id, bool kBaked>
void launch(const float* scal, const float* colors, int K, const void* ids,
            const int32_t* occ, const float* mgrid, const float* sgrid,
            const Geom& g, int conic, float density_scale, float* out,
            cudaStream_t stream) {
  const dim3 block(16, 16);
  const dim3 grid((g.height + 15) / 16, (g.width + 15) / 16);
  march_a1_kernel<Id, kBaked><<<grid, block, 0, stream>>>(
      scal, colors, K, static_cast<const Id*>(ids), occ, mgrid, sgrid, g,
      conic, density_scale != 1.0f ? 1 : 0, density_scale, out);
}

}  // namespace

// Launches the march on `stream`; returns cudaGetLastError() (0 = launched).
// scal: [32] f32; colors: [K, 4] f32; ids: [d1, d2, d3] (C order), uint8
// interval ids (id_bytes 1, K <= 256) or uint16 LUT indices (id_bytes 2,
// K <= 1024); occ: [nbx * nby * nbz] int32; mgrid, sgrid: [d1, d2, d3] f32,
// both null for an unlit march; out: [width, height, 4] f32.
extern "C" int vrp_march_a1(const float* scal, const float* colors, int K,
                            const void* ids, int id_bytes,
                            const int32_t* occ, int nbx, int nby, int nbz,
                            int d1, int d2, int d3, int depth, int width,
                            int height, int spr, int conic,
                            float density_scale, const float* mgrid,
                            const float* sgrid, float* out, void* stream) {
  const int max_k = id_bytes == 1 ? kMaxIntervals : kMaxLut;
  if ((id_bytes != 1 && id_bytes != 2) || K <= 0 || K > max_k ||
      width <= 0 || height <= 0 || spr <= 0 ||
      (mgrid == nullptr) != (sgrid == nullptr))
    return (int)cudaErrorInvalidValue;
  const Geom g =
      make_geom(d1, d2, d3, depth, width, height, spr, nbx, nby, nbz);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool baked = mgrid != nullptr;
  if (id_bytes == 1 && !baked)
    launch<uint8_t, false>(scal, colors, K, ids, occ, mgrid, sgrid, g, conic,
                           density_scale, out, s);
  else if (id_bytes == 1)
    launch<uint8_t, true>(scal, colors, K, ids, occ, mgrid, sgrid, g, conic,
                          density_scale, out, s);
  else if (!baked)
    launch<uint16_t, false>(scal, colors, K, ids, occ, mgrid, sgrid, g,
                            conic, density_scale, out, s);
  else
    launch<uint16_t, true>(scal, colors, K, ids, occ, mgrid, sgrid, g, conic,
                           density_scale, out, s);
  return (int)cudaGetLastError();
}
