// Fused a1/VRC ray march for NVIDIA Hopper (sm_90a).
//
// Replaces volumerenderingproject_tpu/ops/pallas_march.py:_march_kernel in
// resident mode: ortho or conic rays, nearest-voxel sampling,
// classification by colour id, density_scale, front-to-back (C, T)
// compositing and early ray termination, in these variants, template
// parameters of the one kernel:
//   * plain: uint8 interval ids (the packed material-id grid), <= 256
//     colours;
//   * LUT (`lut_n`/`lut_packed`): uint16 indices into the dense TF LUT
//     (config.tf_lut), <= 1024 colours (16 KB of shared memory);
//   * baked light (`baked_light`): per-voxel Blinn-Phong factor grids M and
//     S (f32, in HBM), rgb <- rgb * M + S at the sample's voxel; a sample
//     off the volume takes M = 1, S = 0 (pallas_march.py:671-680).  The
//     single-scattering term rides S (pallas_march.py:1685-1692).
//   * in-kernel light (`lighting`): Blinn-Phong on the central-difference
//     normal of the raw f32 volume (0 past a face), the six neighbours read
//     through the read-only cache, the light [10] in shared memory and the
//     view direction -d of each ray, so conic rays and any light colour
//     work (pallas_march.py:503-556, 594-620);
//   * channel grids (`mc_grids`, 4-D volumes): the uint8 ids are the
//     intervals of the channel mean and give alpha only; rgb is read from
//     the 1 (grey) or 3 normalised channel grids at the sample's voxel, 0
//     off the volume (pallas_march.py:659-672).
// LUT composes with baked or in-kernel light.  The same kernel takes the
// volumes that the TPU kernel's streamed modes (K2: HBM->VMEM x-blocks, u8
// (M, S)) stage block by block: here the whole volume stays in device
// memory, and grids past 2^31 elements take 64-bit voxel indices.
//
// A sharded render (parallel/render_dist.py) launches it once per rank on
// that rank's work unit (`render_vrc_pallas_segment`, pallas_march.py:1837):
//   * segment: columns [x_offset, x_offset + width) of a full_width-wide
//     image and samples [s_start, s_start + spr) of each ray.  Rays keep
//     their global column in the ray setup, samples their global index in
//     t = i * ds + clip and in the brick test; the box clip's range is
//     intersected with the segment's, so a ray whose clip range misses it
//     returns (0, 1).  Early termination acts on the unit's own T, which
//     starts at 1.  With `segment` set the output is (C, T), no background.
//   * slab (`kSlab`, with the plain, LUT, channel-grid and baked-light
//     variants): the id grid, the brick map, the channel grids and the
//     baked (M, S) hold x-planes [x0, x0 + slab_x) only.  A sample belongs
//     to the slab that holds its x-clamped voxel index, off the volume too
//     (sample_voxel_slab), so each sample is composited by one slab; the
//     bricks lie on the slab's own x grid (pallas_march.py:419-422,
//     466-474).  The host tightens the box clip's x extent to the slab
//     (ops/march.py _box).  The baked slab is the forward of a lit slab's
//     differentiable work unit (pallas_march_vjp.py:568 with slab_x and
//     baked_light): its (M, S) are the whole volume's bake, cropped to the
//     slab (ops/march_vjp.prepare_diff), since the normals cross the
//     slab's faces.  In-kernel lighting on a slab is not here.
//
// One thread marches one ray:
//   ray setup -> clip of the sample range to the dataset box, widened by
//      kRangePad (max |o| + |clip| + 2) and one sample at each end
//      (box_span, march_common.cuh; without the pad a ray within 1e-7 of
//      parallel to a face lost samples that have a voxel)
//   -> for each run of kChunk samples, skip it when every 8^3 brick its
//      voxel box touches is transparent
//   -> in batches of kBatch samples: each sample's voxel, modelAux (+0.5)
//      -> octree nearest voxel, and its loads (id [, M and S] [, the
//      channels]), issued together; then in order per sample: RGBA from
//      shared memory [-> rgb * M + S | the channels | the shade] ->
//      C += T*a*rgb, T *= 1 - a
//   -> stop before the first sample with |T| <= eps (a sample of alpha
//      > 1 makes T negative, and the ray goes on compositing)
//   -> out = (C + T * background, 1).
// Every skip is exact (a skipped sample has alpha 0; shading never touches
// alpha); all of them turn off when the alpha of id0 is not 0 (scal[4]
// set), since samples off the volume then change (C, T).  A batch loads
// samples past the one where the ray stops and drops them, so the result
// is the per-sample loop's, bit for bit.
//
// What bounds it on an H100: issuing instructions.  The id grid takes one
// byte per voxel (7.2 MB at 182x218x182) and stays in the 50 MB L2; the
// image is 16 bytes per ray.  Each visited sample issues the 38 float
// operations the bound counts, the comparisons, conversions, index
// arithmetic and loop control around them, and one byte load, and at
// 32-48 registers enough warps share an SM to hide the loads' latency:
// the time is the instructions of every sample a warp visits, which is
// the union of its rays' spans.  So the design cuts instructions and the
// union: the chain multiplies by the exact 1 / 2^depth where the
// reference divides (march_common.cuh; without the three IEEE division
// routines a sample K1 took a quarter less time), voxel indices are
// 32-bit wherever the grids allow (vrp_march_a1_index32; 64-bit beyond),
// a block is 4 x 64 pixels (a warp 4 x 8, whose rays' spans differ less
// than a 16 x 2 warp's), colours sit in shared memory, and the box clip,
// brick skip and early termination drop samples that cannot change the
// image.  Batching a sample's loads ahead of compositing pays only where a
// sample issues several loads, so kBatch is 8 with the channel grids
// (three or four loads a sample) and 1 elsewhere: a batch holds its
// samples' ids and operands in registers, and at 8 for every variant the
// registers (60-100) cut the warps an SM holds and K1 ran slower
// (PERF.md, PR 13).  The baked
// variants also move bytes: M and S take 8 bytes per voxel (58 MB at
// 182x218x182, more than L2 holds), read per sample inside the volume
// beside the id.  The in-kernel light reads the f32 volume (29 MB at
// 182x218x182) at six neighbours of each sample inside the volume, loads
// issued together, and spends some 50 float operations and a powf on its
// shade; reusing the shade of a repeated voxel ran slower, since a
// warp's other rays shade on (SIMT).  The channel grids take 4 bytes a
// voxel each, read at the sample's voxel like M and S.
//
// Ray setup and the sample -> voxel -> id chain are in march_common.cuh,
// shared with the backward march (march_bwd.cu).

#include "march_common.cuh"

namespace {

constexpr int kChunk = 8;  // samples per brick-occupancy test
// pixels a block, y x x (threadIdx.x runs along y)
constexpr int kBlockY = 4, kBlockX = 64;
constexpr int kThreads = kBlockY * kBlockX;
constexpr int kMcBatch = 8;  // samples a batch of loads with channel grids
constexpr int kBrick = 8;          // brick edge in voxels
constexpr int kMaxIntervals = 256;  // uint8 interval ids
constexpr int kMaxLut = 1024;       // uint16 LUT indices (tf_lut <= 1024)

// Conservative test of samples [i0, i1] of one ray: does the voxel box they
// can reach touch any brick with an alpha != 0 voxel?  Every step below is
// monotone, so pushing the end points (widened by 1e-5) through the index
// chain bounds the voxels of every sample between them
// (pallas_march.py:387-445, for one ray instead of a tile).
// On an x-slab (kSlab) the bricks lie on the slab's own x grid: the x range
// is shifted by x0 and a range that misses the slab is transparent.
template <bool kSlab>
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
    const float rlo = fmaxf((floorf(alo * g.n) * g.inv_n) * g.L, g.hg[c]);
    const float rhi = fminf((floorf(ahi * g.n) * g.inv_n) * g.L, g.hg_hi[c]);
    if (!(rlo < g.hg_hi[c]) || !(rhi >= g.hg[c])) return false;
    int ilo = (int)truncf((rlo + g.halfd[c]) - g.halfL);
    int ihi = (int)truncf((rhi + g.halfd[c]) - g.halfL);
    int ext = g.dim[c];
    if (kSlab && c == 0) {
      ilo -= g.x0;
      ihi -= g.x0;
      if (ihi < 0 || ilo >= g.nx) return false;
      ext = g.nx;
    }
    blo[c] = min(max(ilo, 0), ext - 1) / kBrick;
    bhi[c] = min(max(ihi, 0), ext - 1) / kBrick;
  }
  for (int bx = blo[0]; bx <= bhi[0]; ++bx)
    for (int by = blo[1]; by <= bhi[1]; ++by)
      for (int bz = blo[2]; bz <= bhi[2]; ++bz)
        if (__ldg(occ + (bx * g.nb[1] + by) * g.nb[2] + bz)) return true;
  return false;
}

// The zero-padded neighbour of a sample's voxel `flat` along one axis: the
// voxel `step` away in flat order when its index `idx` on that axis lies in
// [0, dim), else 0 (conv3d's zero padding, pallas_march.py:524-546).  The
// load is unconditional (the address is clamped into the volume), so the
// six loads of a shade are in flight together.
template <typename Idx>
__device__ __forceinline__ float neighbour(const float* __restrict__ vol,
                                           Idx flat, Idx step, int idx,
                                           int dim, Idx last) {
  Idx f = flat + step;
  f = f < 0 ? 0 : (f > last ? last : f);
  const float v = __ldg(vol + f);
  return (idx < 0 || idx >= dim) ? 0.0f : v;
}

// Blinn-Phong of a sample inside the volume, in the TPU kernel's float
// order (pallas_march.py:594-620): l = light[0:3] (unit), colour
// light[3:6], ambient, diffuse, specular, shininess light[6:10]; (hx, hy,
// hz) = l - d and hinv = 1 / max(|h|, 1e-8) are the ray's.
template <typename Idx>
__device__ __forceinline__ void shade(float4& col,
                                      const float* __restrict__ vol,
                                      Idx flat, const int ijk[3],
                                      const Geom& g, Idx last,
                                      const float* s_light, float hx,
                                      float hy, float hz, float hinv) {
  const Idx sx = (Idx)g.dim[1] * g.dim[2];
  const Idx sy = g.dim[2];
  const float xp = neighbour(vol, flat, sx, ijk[0] + 1, g.dim[0], last);
  const float xm = neighbour(vol, flat, -sx, ijk[0] - 1, g.dim[0], last);
  const float yp = neighbour(vol, flat, sy, ijk[1] + 1, g.dim[1], last);
  const float ym = neighbour(vol, flat, -sy, ijk[1] - 1, g.dim[1], last);
  const float zp = neighbour(vol, flat, (Idx)1, ijk[2] + 1, g.dim[2], last);
  const float zm = neighbour(vol, flat, (Idx)-1, ijk[2] - 1, g.dim[2], last);
  const float gx = 0.5f * (xp - xm);
  const float gy = 0.5f * (yp - ym);
  const float gz = 0.5f * (zp - zm);
  const float nn = sqrtf((gx * gx + gy * gy) + gz * gz);
  const float ninv = 1.0f / fmaxf(nn, 1e-8f);
  const float nx = gx * ninv, ny = gy * ninv, nz = gz * ninv;
  const float ndotl =
      fabsf((nx * s_light[0] + ny * s_light[1]) + nz * s_light[2]);
  const float ndoth = fabsf(((nx * hx + ny * hy) + nz * hz) * hinv);
  const float spec = s_light[8] * powf(ndoth, s_light[9]);
  const float w = fminf(fmaxf(nn * 1000.0f, 0.0f), 1.0f);
  const float dl = s_light[7] * ndotl;
  const float amb = s_light[6];
  col.x = w * ((amb * col.x + (dl * col.x) * s_light[3]) + spec * s_light[3]) +
          (1.0f - w) * col.x;
  col.y = w * ((amb * col.y + (dl * col.y) * s_light[4]) + spec * s_light[4]) +
          (1.0f - w) * col.y;
  col.z = w * ((amb * col.z + (dl * col.z) * s_light[5]) + spec * s_light[5]) +
          (1.0f - w) * col.z;
}

// kMc: the number of channel grids (0: none; 1: grey; 3: rgb); kSlab: the
// grids hold an x-slab (no in-kernel light)
template <typename Id, bool kBaked, bool kLit, int kMc, bool kSlab,
          typename Idx>
__global__ void __launch_bounds__(kThreads)
march_a1_kernel(const float* __restrict__ scal,
                const float* __restrict__ colors, int num_colors,
                const Id* __restrict__ ids, const int32_t* __restrict__ occ,
                const float* __restrict__ mgrid,
                const float* __restrict__ sgrid,
                const float* __restrict__ vol,
                const float* __restrict__ lvec,
                const float* __restrict__ chans, Geom g, int conic,
                int scale_alpha, float density_scale, int segment,
                float* __restrict__ out) {
  static_assert(!kSlab || !kLit, "a slab takes no in-kernel light");
  // samples whose loads are issued together: the channel grids' (three or
  // four loads a sample); one elsewhere
  constexpr int kBatch = kMc > 0 ? kMcBatch : 1;
  // plain and LUT: a sample reads its id alone
  constexpr bool kIdOnly = !kBaked && !kLit && kMc == 0 && !kSlab;
  __shared__ float4 s_col[sizeof(Id) == 1 ? kMaxIntervals : kMaxLut];
  __shared__ float s_light[kLit ? 10 : 1];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = tid; k < num_colors; k += blockDim.x * blockDim.y) {
    float4 c = make_float4(colors[4 * k], colors[4 * k + 1],
                           colors[4 * k + 2], colors[4 * k + 3]);
    if (scale_alpha) c.w = fminf(fmaxf(c.w * density_scale, 0.0f), 1.0f);
    s_col[k] = c;
  }
  if constexpr (kLit) {
    if (tid < 10) s_light[tid] = lvec[tid];
  }
  __syncthreads();

  // threadIdx.x runs along y: out is [W, H, 4], y fastest
  const int py = blockIdx.x * kBlockY + threadIdx.x;
  const int px = blockIdx.y * kBlockX + threadIdx.y;
  if (px >= g.width || py >= g.height) return;

  float o[3], d[3];
  ray_setup(scal, g, px, py, conic, o, d);

  const float ds = scal[S_DS];
  const float clip = scal[S_CLIP];
  const float eps = fmaxf(scal[S_EPS], 0.0f);
  const bool full = scal[S_FULL] > 0.0f;
  const int id0 = (int)scal[S_ID0];
  // voxels a grid holds (the slab's planes on a slab): the channel stride
  const Idx nvox = (Idx)(kSlab ? g.nx : g.dim[0]) * g.dim[1] * g.dim[2];

  // the in-kernel light's half vector h = l - d (the view direction is -d)
  float hx = 0.0f, hy = 0.0f, hz = 0.0f, hinv = 0.0f;
  if constexpr (kLit) {
    hx = s_light[0] - d[0];
    hy = s_light[1] - d[1];
    hz = s_light[2] - d[2];
    hinv = 1.0f / fmaxf(sqrtf((hx * hx + hy * hy) + hz * hz), 1e-8f);
  }

  // ---- the unit's samples that may lie in the dataset box -----------------
  int s_lo = g.s_start, s_hi = g.s_start + g.spr - 1;
  const float pad = span_pad(o, d, ds, clip);
  if (!full && pad >= 0.0f) {
    float blo[3], bhi[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      blo[c] = scal[S_BOX_LO + c];
      bhi[c] = scal[S_BOX_HI + c];
    }
    int a, b;
    box_span(o, d, blo, bhi, pad, ds, clip, false, a, b);
    s_lo = max(s_lo, a);
    s_hi = min(s_hi, b);
  }

  // ---- march ---------------------------------------------------------------
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, t = 1.0f;
  for (int s0 = s_lo; s0 <= s_hi && fabsf(t) > eps; s0 += kChunk) {
    const int s1 = min(s0 + kChunk - 1, s_hi);
    if (!full && !chunk_occupied<kSlab>(s0, s1, o, d, ds, clip, g, occ))
      continue;
    for (int b0 = s0; b0 <= s1 && fabsf(t) > eps; b0 += kBatch) {
      // 1. the voxels of kBatch samples, and their loads, in flight
      // together: the id (-1 for a sample that another slab owns), and M
      // and S, or the channels, or the voxel's indices for the light
      int id[kBatch];
      float m[kBaked ? kBatch : 1], sh[kBaked ? kBatch : 1];
      float ch[kMc > 0 ? kMc : 1][kBatch];
      Idx lflat[kLit ? kBatch : 1];
      int vox[kLit ? kBatch : 1][3];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = b0 + j;
        if (i > s1) break;
        if constexpr (kIdOnly) {  // the chain returns the id itself
          id[j] = sample_id<Id, Idx>(i, o, d, ds, clip, g, ids, id0);
        } else {
          Idx flat;
          if constexpr (kSlab) {
            flat = sample_voxel_slab<Idx>(i, o, d, ds, clip, g);
          } else if constexpr (kLit) {
            flat = sample_voxel_ijk<Idx>(i, o, d, ds, clip, g, vox[j]);
            lflat[j] = flat;
          } else {
            flat = sample_voxel<Idx>(i, o, d, ds, clip, g);
          }
          id[j] = flat == -2 ? -1 : id0;
          if (flat >= 0) id[j] = (int)__ldg(ids + flat);
          if constexpr (kBaked) {  // M = 1, S = 0 off the volume
            m[j] = flat < 0 ? 1.0f : __ldg(mgrid + flat);
            sh[j] = flat < 0 ? 0.0f : __ldg(sgrid + flat);
          }
          if constexpr (kMc > 0) {  // rgb 0 off the volume
#pragma unroll
            for (int c = 0; c < kMc; ++c)
              ch[c][j] = flat < 0 ? 0.0f : __ldg(chans + c * nvox + flat);
          }
        }
      }
      // 2. composite them in order, up to the first sample with |T| <= eps
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (b0 + j > s1 || !(fabsf(t) > eps)) break;
        if constexpr (kSlab) {
          if (id[j] < 0) continue;  // another slab's sample
        }
        float4 col = s_col[id[j]];
        if constexpr (kBaked) {
          col.x = col.x * m[j] + sh[j];
          col.y = col.y * m[j] + sh[j];
          col.z = col.z * m[j] + sh[j];
        }
        if constexpr (kMc == 1) {
          col.x = col.y = col.z = ch[0][j];
        } else if constexpr (kMc == 3) {
          col.x = ch[0][j];
          col.y = ch[1][j];
          col.z = ch[2][j];
        }
        if constexpr (kLit) {
          // off the volume the normal is 0, so w = 0 and rgb stays
          if (lflat[j] >= 0)
            shade(col, vol, lflat[j], vox[j], g, nvox - 1, s_light, hx, hy,
                  hz, hinv);
        }
        const float w = t * col.w;
        cr = cr + w * col.x;
        cg = cg + w * col.y;
        cb = cb + w * col.z;
        t = t * (1.0f - col.w);
      }
    }
  }

  float4 px_out;
  if (segment) {  // the unit's raw (C, T)
    px_out = make_float4(cr, cg, cb, t);
  } else {
    px_out.x = cr + t * scal[S_BG];
    px_out.y = cg + t * scal[S_BG + 1];
    px_out.z = cb + t * scal[S_BG + 2];
    px_out.w = 1.0f;
  }
  reinterpret_cast<float4*>(out)[(long long)px * g.height + py] = px_out;
}

struct Inputs {
  const float *scal, *colors;
  int K;
  const void* ids;
  const int32_t* occ;
  const float *mgrid, *sgrid, *vol, *lvec, *chans;
};

template <typename Id, bool kBaked, bool kLit, int kMc, bool kSlab = false>
void launch(const Inputs& in, const Geom& g, int conic, float density_scale,
            int segment, float* out, cudaStream_t stream, bool index32) {
  const dim3 block(kBlockY, kBlockX);
  const dim3 grid((g.height + kBlockY - 1) / kBlockY,
                  (g.width + kBlockX - 1) / kBlockX);
  if (index32)
    march_a1_kernel<Id, kBaked, kLit, kMc, kSlab, int>
        <<<grid, block, 0, stream>>>(
            in.scal, in.colors, in.K, static_cast<const Id*>(in.ids), in.occ,
            in.mgrid, in.sgrid, in.vol, in.lvec, in.chans, g, conic,
            density_scale != 1.0f ? 1 : 0, density_scale, segment, out);
  else
    march_a1_kernel<Id, kBaked, kLit, kMc, kSlab, long long>
        <<<grid, block, 0, stream>>>(
            in.scal, in.colors, in.K, static_cast<const Id*>(in.ids), in.occ,
            in.mgrid, in.sgrid, in.vol, in.lvec, in.chans, g, conic,
            density_scale != 1.0f ? 1 : 0, density_scale, segment, out);
}

}  // namespace

// Whether the march takes 32-bit voxel indices: where every flat index it
// forms stays below 2^31.  The largest grid it reads, times its channels
// (the ids and M, S: slab_x or d1 planes; the channel grids: n_chans of
// them; the in-kernel light's volume: d1 planes), plus one plane and one
// row (a voxel index one past a face, or a neighbour's step), below 2^31.
// ops/march.index32 mirrors it.
extern "C" int vrp_march_a1_index32(int d1, int d2, int d3, int slab_x,
                                    int n_chans, int lit) {
  long long elems = (long long)(slab_x > 0 ? slab_x : d1) * d2 * d3 *
                    (n_chans > 0 ? n_chans : 1);
  const long long vol = (long long)d1 * d2 * d3;
  if (lit && vol > elems) elems = vol;
  return elems + (long long)d2 * d3 + d3 < (1LL << 31) ? 1 : 0;
}

// Launches the march on `stream`; returns cudaGetLastError() (0 = launched).
// scal: [32] f32; colors: [K, 4] f32; ids: [nx, d2, d3] (C order; nx =
// slab_x on a slab, else d1), uint8 interval ids (id_bytes 1, K <= 256) or
// uint16 LUT indices (id_bytes 2, K <= 1024); occ: [nbx * nby * nbz] int32
// on the same grid.  At most one of: mgrid, sgrid ([nx, d2, d3] f32 each,
// baked light); vol ([d1, d2, d3] f32, the raw volume) and lvec ([10] f32,
// the light), in-kernel light; chans ([n_chans, nx, d2, d3] f32, n_chans 1
// or 3, uint8 ids only), a 4-D volume's channel grids.  The work unit:
// columns [x_offset, x_offset + width) of a full_width-wide image, samples
// [s_start, s_start + spr) of the d1-deep geometry's rays, and with slab_x
// > 0 (no in-kernel light; baked light with uint8 ids) the grids' x-planes
// [x0, x0 + slab_x).  out: [width, height, 4] f32, (C + T bg, 1), or with
// segment set (C, T).
extern "C" int vrp_march_a1(const float* scal, const float* colors, int K,
                            const void* ids, int id_bytes,
                            const int32_t* occ, int nbx, int nby, int nbz,
                            int d1, int d2, int d3, int depth, int width,
                            int height, int spr, int conic,
                            float density_scale, const float* mgrid,
                            const float* sgrid, const float* vol,
                            const float* lvec, const float* chans,
                            int n_chans, int x_offset, int full_width,
                            int s_start, int x0, int slab_x, int segment,
                            float* out, void* stream) {
  const int max_k = id_bytes == 1 ? kMaxIntervals : kMaxLut;
  const bool baked = mgrid != nullptr, lit = vol != nullptr,
             mc = chans != nullptr, slab = slab_x > 0;
  if ((id_bytes != 1 && id_bytes != 2) || K <= 0 || K > max_k ||
      width <= 0 || height <= 0 || spr <= 0 ||
      baked != (sgrid != nullptr) || lit != (lvec != nullptr) ||
      (int)baked + (int)lit + (int)mc > 1 ||
      (mc && (id_bytes != 1 || (n_chans != 1 && n_chans != 3))) ||
      x_offset < 0 || x_offset + width > full_width || s_start < 0 ||
      slab_x < 0 ||
      (slab && (lit || (baked && id_bytes != 1) || x0 < 0 ||
                x0 + slab_x > d1)))
    return (int)cudaErrorInvalidValue;
  Geom g = make_geom(d1, d2, d3, depth, width, height, spr, nbx, nby, nbz);
  g.x_off = x_offset;
  g.gwidth = full_width;
  g.s_start = s_start;
  if (slab) {
    g.x0 = x0;
    g.nx = slab_x;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const bool index32 =
      vrp_march_a1_index32(d1, d2, d3, slab_x, mc ? n_chans : 0, lit ? 1 : 0);
  const Inputs in{scal, colors, K, ids, occ, mgrid, sgrid, vol, lvec, chans};
  if (slab && baked)
    launch<uint8_t, true, false, 0, true>(in, g, conic, density_scale,
                                          segment, out, s, index32);
  else if (slab && mc && n_chans == 1)
    launch<uint8_t, false, false, 1, true>(in, g, conic, density_scale,
                                           segment, out, s, index32);
  else if (slab && mc)
    launch<uint8_t, false, false, 3, true>(in, g, conic, density_scale,
                                           segment, out, s, index32);
  else if (slab && id_bytes == 1)
    launch<uint8_t, false, false, 0, true>(in, g, conic, density_scale,
                                           segment, out, s, index32);
  else if (slab)
    launch<uint16_t, false, false, 0, true>(in, g, conic, density_scale,
                                            segment, out, s, index32);
  else if (mc && n_chans == 1)
    launch<uint8_t, false, false, 1>(in, g, conic, density_scale, segment,
                                     out, s, index32);
  else if (mc)
    launch<uint8_t, false, false, 3>(in, g, conic, density_scale, segment,
                                     out, s, index32);
  else if (lit && id_bytes == 1)
    launch<uint8_t, false, true, 0>(in, g, conic, density_scale, segment,
                                    out, s, index32);
  else if (lit)
    launch<uint16_t, false, true, 0>(in, g, conic, density_scale, segment,
                                     out, s, index32);
  else if (id_bytes == 1 && !baked)
    launch<uint8_t, false, false, 0>(in, g, conic, density_scale, segment,
                                     out, s, index32);
  else if (id_bytes == 1)
    launch<uint8_t, true, false, 0>(in, g, conic, density_scale, segment,
                                    out, s, index32);
  else if (!baked)
    launch<uint16_t, false, false, 0>(in, g, conic, density_scale, segment,
                                      out, s, index32);
  else
    launch<uint16_t, true, false, 0>(in, g, conic, density_scale, segment,
                                     out, s, index32);
  return (int)cudaGetLastError();
}
