// Backward of the smooth-mode a1 march (K9) for NVIDIA Hopper (sm_90a).
//
// Replaces volumerenderingproject_tpu/ops/pallas_smooth.py:
// _smooth_bwd_kernel and its XLA epilogue _splat_volume_grad.  Given the
// per-ray cotangents g (of the rgb output) and g_t (of the final
// transmittance T_N, which reaches the output through out = C + T_N * bg),
// it computes, for the forward march of smooth.cu at eps 0,
//   dL/dcolors [K, 4], dL/dlower [K], dL/dupper [K]   (always), and
//   dL/dvolume [X, Y, Z]                               (when dvol is given).
//
// Per sample s (a, rgb its smooth RGBA, T_s its transmittance):
//   w_s = T_s a,  gd = g . rgb,  da = T_s gd - (S_{>s} + T_N g_t) / (1 - a)
//   (K4's two passes: pass A sums total = sum_j w_j gd_j and T_N; pass B
//   keeps the prefix, S_{>s} = total - P_s; where 1 - a == 0 the division
//   term is 0, pallas_smooth.py:412-416), then for k = 1..K-1:
//   dL/dw_k = w_s (g . (c_k - c_0)) + da (a_k - a_0)
//   q       = (dL/dw_k * sharp) * w_k
//   dL/dvn += q (s2 - s1)       dL/dlo_k -= q (1 - s1)    dL/dhi_k += q (1 - s2)
//   dL/dc_k += w_k (w_s g | da),   dL/dc_0 += (1 - sum_k w_k) (w_s g | da)
// (the signs of pallas_smooth.py:424-450).  The colour terms are kept per
// ray as sums of w_k w_s and w_k da and multiplied by g at the end of the
// ray.
//
// One thread marches one ray through both passes, clipped as K8 is to the
// samples that may have a corner in the volume (smooth_sample_range,
// smooth_common.cuh).  A sample outside that range takes the launch's
// constant rgba0 = classify(0 / cal_max) and its s1, s2, w (shared memory,
// once per block); its alpha is not 0, so it still carries an alpha
// gradient.  Pass A adds (T a0) gd0 to the total, gd0 = g . rgb0 taken once
// per ray in the order of every gd, so pass A and the prefix of pass B are
// the full evaluation's to the bit.  In pass B such a sample keeps its own
// w_s and dL/da, the division included, but runs no interval loop: its
// terms are linear in w_s and dL/da with constant w_k, s1 and s2, so the
// ray sums its off-range w_s and dL/da and folds the two sums into every
// interval once, at the end:
//   q_k = ((sum w_s (g . (c_k - c_0)) + sum dL/da (a_k - a_0)) sharp) w0_k.
// That regroups the float sums, so K9 is not bit-exact to
// march_smooth_bwd_plain (chip_smoke.py holds it to 5e-3 of max |dplain|;
// it stays near 2e-5).  Such a sample's dL/dvn reaches no voxel (every
// corner is out of range): it splats nothing.
// The per-interval sums sit in registers (instantiated for K <= 4, 8, 16);
// at the end each block reduces its rays' [K, 6] sums in a fixed order
// (block_reduce.cuh) into partials [nblocks, K, 6], which the caller adds
// with torch.sum: no atomics there, the same bits every run.
//
// The volume gradient is the trilinear adjoint fused into pass B: each
// sample in the range adds (dL/dvn / cal_max) wx wy wz into a zeroed f32
// [X*Y*Z] buffer with atomicAdd, at its eight corners in range, at the
// position the forward took (one position chain, smooth_common.cuh).  The
// TPU kernel wrote a per-sample dL/dvn plane instead (980 MB at 700x700x500)
// and scattered it in XLA.  Atomic adds land in an order that changes from
// run to run, so dL/dvolume varies by ulps between runs.
//
// What bounds it on an H100: operations, those of the samples in the range
// (some 60 per sample plus about 40 per interval: the smooth sample of K8
// evaluated in both passes, the chain, the bound and colour terms), which
// the launch's bound counts, beside K4's chain and two sums for the rest
// (its IEEE division included); a warp runs the full chain for the union
// of its rays' ranges; with the volume gradient, the atomic adds, eight per
// sample inside the volume, which contend where many rays cross one voxel.
// Bytes (the volume, 16 bytes of cotangent per ray, the partials, the
// volume gradient) are far fewer.  Tensor cores, TMA and clusters do not
// serve this walk: its corner reads and adds depend on the ray.

#include "block_reduce.cuh"
#include "smooth_common.cuh"

namespace {

constexpr int kWarps = kSmoothThreads / 32;

template <int KMAX>
__global__ void __launch_bounds__(kSmoothThreads)
smooth_bwd_kernel(const float* __restrict__ scal,
                  const float* __restrict__ lower,
                  const float* __restrict__ upper,
                  const float* __restrict__ colors, int num_intervals,
                  const float* __restrict__ vol, Geom g, int conic,
                  const float* __restrict__ g_rgb,
                  const float* __restrict__ g_t,
                  float* __restrict__ partials, float* __restrict__ dvol) {
  __shared__ SmoothTF<KMAX> tf;
  const SmoothScalars s = load_smooth_scalars(scal);
  load_tf<KMAX>(tf, lower, upper, colors, num_intervals, s);

  // per interval: sum of w_k w_s, of w_k da, dL/dlo_k, dL/dhi_k
  float sw[KMAX], sda[KMAX], dlo[KMAX], dhi[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) sw[k] = sda[k] = dlo[k] = dhi[k] = 0.0f;
  float gr = 0.0f, gg = 0.0f, gb = 0.0f;

  // threadIdx.x runs along y, as in K8; threads off the image take part in
  // the reduction with zero sums
  const int py = blockIdx.x * blockDim.x + threadIdx.x;
  const int px = blockIdx.y * blockDim.y + threadIdx.y;
  if (px < g.width && py < g.height) {
    float o[3], d[3];
    ray_setup(scal, g, px, py, conic, o, d);
    const long long ray = (long long)px * g.height + py;
    gr = g_rgb[3 * ray];
    gg = g_rgb[3 * ray + 1];
    gb = g_rgb[3 * ray + 2];
    int i_lo, i_hi;
    smooth_sample_range(o, d, s, g, i_lo, i_hi);
    const float4 rgba0 = tf.rgba0;
    const float gd0 = (gr * rgba0.x + gg * rgba0.y) + gb * rgba0.z;
    float s1[KMAX], s2[KMAX], w[KMAX];

    // ---- pass A: total of w (g . rgb) and the final transmittance -------
    float t = 1.0f;
    float total = 0.0f;
    for (int i = 0; i < g.spr; ++i) {
      float a = rgba0.w, gd = gd0;
      if (i >= i_lo && i <= i_hi) {
        int b[3];
        float f[3];
        smooth_position(i, o, d, s, b, f);
        const float vn = smooth_intensity(vol, g, b, f) / s.cal;
        const float4 col =
            smooth_classify<KMAX>(tf, num_intervals, s.sharp, vn, s1, s2, w);
        a = col.w;
        gd = (gr * col.x + gg * col.y) + gb * col.z;
      }
      total = total + (t * a) * gd;
      t = t * (1.0f - a);
    }
    const float bg_term = t * g_t[ray];  // dL/dT_N * T_N, through + T_N*bg

    // ---- pass B: prefix re-march, the per-interval terms, the splat -------
    t = 1.0f;
    float pfx = 0.0f;
    float ows = 0.0f, oda = 0.0f;  // sums of w_s and da off the range
    for (int i = 0; i < g.spr; ++i) {
      const bool in = i >= i_lo && i <= i_hi;
      int b[3];
      float f[3];
      float a = rgba0.w, gd = gd0;
      if (in) {
        smooth_position(i, o, d, s, b, f);
        const float vn = smooth_intensity(vol, g, b, f) / s.cal;
        const float4 col =
            smooth_classify<KMAX>(tf, num_intervals, s.sharp, vn, s1, s2, w);
        a = col.w;
        gd = (gr * col.x + gg * col.y) + gb * col.z;
      }
      const float ws = t * a;
      pfx = pfx + ws * gd;  // pass A's order: total - pfx is exact at the end
      const float suffix = total - pfx;
      const float denom = 1.0f - a;
      const float num = suffix + bg_term;
      const float da = t * gd - (denom != 0.0f ? num / denom : 0.0f);
      t = t * denom;
      if (!in) {
        ows = ows + ws;
        oda = oda + da;
        continue;
      }

      float dvn = 0.0f, wsum = 0.0f;
#pragma unroll
      for (int k = 1; k < KMAX; ++k) {
        if (k < num_intervals) {
          const float4 dk = tf.dk[k];
          const float gdk = (gr * dk.x + gg * dk.y) + gb * dk.z;
          const float dldw = ws * gdk + da * dk.w;
          const float q = (dldw * s.sharp) * w[k];
          dvn = dvn + q * (s2[k] - s1[k]);
          wsum = wsum + w[k];
          dlo[k] = dlo[k] - q * (1.0f - s1[k]);
          dhi[k] = dhi[k] + q * (1.0f - s2[k]);
          sw[k] = sw[k] + w[k] * ws;
          sda[k] = sda[k] + w[k] * da;
        }
      }
      const float base = 1.0f - wsum;  // interval 0's coefficient
      sw[0] = sw[0] + base * ws;
      sda[0] = sda[0] + base * da;

      if (dvol != nullptr && dvn != 0.0f) {
        const float gv = dvn / s.cal;  // vn = v / cal_max
#pragma unroll
        for (int ox = 0; ox < 2; ++ox) {
          const int cx = b[0] + ox;
          if (cx < 0 || cx >= g.dim[0]) continue;
          const float wx = ox ? f[0] : 1.0f - f[0];
#pragma unroll
          for (int oy = 0; oy < 2; ++oy) {
            const int cy = b[1] + oy;
            if (cy < 0 || cy >= g.dim[1]) continue;
            const float wy = oy ? f[1] : 1.0f - f[1];
            const long long row = ((long long)cx * g.dim[1] + cy) * g.dim[2];
#pragma unroll
            for (int oz = 0; oz < 2; ++oz) {
              const int cz = b[2] + oz;
              if (cz < 0 || cz >= g.dim[2]) continue;
              const float wz = oz ? f[2] : 1.0f - f[2];
              const float val = ((gv * wx) * wy) * wz;
              if (val != 0.0f) atomicAdd(dvol + row + cz, val);
            }
          }
        }
      }
    }

    // ---- the off-range samples' terms, folded once ------------------------
#pragma unroll
    for (int k = 1; k < KMAX; ++k) {
      if (k < num_intervals) {
        const float4 dk = tf.dk[k];
        const float gdk = (gr * dk.x + gg * dk.y) + gb * dk.z;
        const float dldw = ows * gdk + oda * dk.w;
        const float q = (dldw * s.sharp) * tf.w0[k];
        dlo[k] = dlo[k] - q * (1.0f - tf.s1_0[k]);
        dhi[k] = dhi[k] + q * (1.0f - tf.s2_0[k]);
        sw[k] = sw[k] + tf.w0[k] * ows;
        sda[k] = sda[k] + tf.w0[k] * oda;
      }
    }
    sw[0] = sw[0] + tf.base0 * ows;
    sda[0] = sda[0] + tf.base0 * oda;
  }

  float acc[KMAX][6];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    acc[k][0] = gr * sw[k];
    acc[k][1] = gg * sw[k];
    acc[k][2] = gb * sw[k];
    acc[k][3] = sda[k];
    acc[k][4] = dlo[k];
    acc[k][5] = dhi[k];
  }
  write_block_partial<KMAX, kWarps>(acc, num_intervals, partials);
}

template <int KMAX>
void launch(const float* scal, const float* lower, const float* upper,
            const float* colors, int K, const float* vol, const Geom& g,
            int conic, const float* g_rgb, const float* g_t, float* partials,
            float* dvol, cudaStream_t stream) {
  const dim3 block(kSmoothBlockY, kSmoothBlockX);
  const dim3 grid((g.height + kSmoothBlockY - 1) / kSmoothBlockY,
                  (g.width + kSmoothBlockX - 1) / kSmoothBlockX);
  smooth_bwd_kernel<KMAX><<<grid, block, 0, stream>>>(
      scal, lower, upper, colors, K, vol, g, conic, g_rgb, g_t, partials,
      dvol);
}

}  // namespace

// Launches the smooth backward march on `stream`; returns cudaGetLastError()
// (0 = launched).  scal: [29] f32 (ops/smooth.py layout); lower, upper: [K]
// f32; colors: [K, 4] f32, K <= 16; vol: [d1, d2, d3] f32 (C order); g_rgb:
// [width, height, 3] f32; g_t: [width, height] f32; partials:
// [ceil(width/64) * ceil(height/4), K, 6] f32, one [K, 6] sum per block of
// 64 x 4 pixels (columns dr, dg, db, da, dlower, dupper); dvol: [d1, d2, d3]
// f32 zeroed by the caller, or null for no volume gradient.
extern "C" int vrp_smooth_bwd(const float* scal, const float* lower,
                              const float* upper, const float* colors, int K,
                              const float* vol, int d1, int d2, int d3,
                              int width, int height, int spr, int conic,
                              const float* g_rgb, const float* g_t,
                              float* partials, float* dvol, void* stream) {
  if (K <= 0 || K > kSmoothMaxIntervals || width <= 0 || height <= 0 ||
      spr <= 0 || d1 <= 0 || d2 <= 0 || d3 <= 0)
    return (int)cudaErrorInvalidValue;
  const Geom g = make_geom(d1, d2, d3, 0, width, height, spr, 0, 0, 0);
  const cudaStream_t st = (cudaStream_t)stream;
  if (K <= 4)
    launch<4>(scal, lower, upper, colors, K, vol, g, conic, g_rgb, g_t,
              partials, dvol, st);
  else if (K <= 8)
    launch<8>(scal, lower, upper, colors, K, vol, g, conic, g_rgb, g_t,
              partials, dvol, st);
  else
    launch<16>(scal, lower, upper, colors, K, vol, g, conic, g_rgb, g_t,
               partials, dvol, st);
  return (int)cudaGetLastError();
}
