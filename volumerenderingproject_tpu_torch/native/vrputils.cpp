// Native host runtime of volumerenderingproject_tpu_torch.
//
// C++ equivalents of the reference's host-side C++/CUDA components, exposed
// through a C ABI for ctypes (native/__init__.py):
//
//   * NIfTI-1/2 loader (reference: BinaryLoader.cu:273-335) — header parse,
//     endian handling, dtype conversion to float32, multithreaded payload
//     conversion.  The hot path for large volumes (MNI152 1mm is ~58 MB).
//   * min/max pyramid construction (reference: Octree.cu:30-156 recursive build)
//     — iterative, multithreaded leaf fill + 2x pooling (same float32
//     expression order as Octree.cu's updateNode).
//   * exact GL point rasterizer (vrp_point_rasterize): the a0 voxel cloud
//     with draw-order blending and depth writes.
//   * 3-D zero-padded convolution (reference: Convolution.cpp:160-205).
//
// Built at first use by native/build.py (g++ -O3 -std=c++17 -fPIC -shared
// -pthread) into build/native/ at the repository root.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// NIfTI loading
// ---------------------------------------------------------------------------

struct NiftiInfo {
  int32_t sizeof_hdr;
  int32_t datatype;
  int32_t bitpix;
  int64_t dim[8];
  double pixdim[8];
  int64_t vox_offset;
  double scl_slope;
  double scl_inter;
  double cal_max;
  double cal_min;
  int32_t swapped;  // 1 if byte-swapped relative to host
};

static uint16_t bswap16(uint16_t v) { return __builtin_bswap16(v); }
static uint32_t bswap32(uint32_t v) { return __builtin_bswap32(v); }
static uint64_t bswap64(uint64_t v) { return __builtin_bswap64(v); }

template <typename T>
static T rd(const uint8_t* p, bool swap) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  if (swap) {
    if (sizeof(T) == 2) { uint16_t u; std::memcpy(&u, &v, 2); u = bswap16(u); std::memcpy(&v, &u, 2); }
    if (sizeof(T) == 4) { uint32_t u; std::memcpy(&u, &v, 4); u = bswap32(u); std::memcpy(&v, &u, 4); }
    if (sizeof(T) == 8) { uint64_t u; std::memcpy(&u, &v, 8); u = bswap64(u); std::memcpy(&v, &u, 8); }
  }
  return v;
}

// Parses the header; returns 0 on success, nonzero error code otherwise.
extern "C" int vrp_nifti_header(const char* path, NiftiInfo* info) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  uint8_t buf[540];
  size_t got = std::fread(buf, 1, sizeof(buf), f);
  std::fclose(f);
  if (got < 348) return 2;

  int32_t size_le = rd<int32_t>(buf, false);
  bool swap = false;
  int32_t size = size_le;
  if (size != 348 && size != 540) {
    size = rd<int32_t>(buf, true);
    swap = true;
    if (size != 348 && size != 540) return 3;  // BinaryLoader.cu:299-301
  }
  std::memset(info, 0, sizeof(*info));
  info->sizeof_hdr = size;
  info->swapped = swap ? 1 : 0;
  if (size == 540) {  // nifti2.h:59-96 offsets
    info->datatype = rd<int16_t>(buf + 12, swap);
    info->bitpix = rd<int16_t>(buf + 14, swap);
    for (int i = 0; i < 8; i++) info->dim[i] = rd<int64_t>(buf + 16 + 8 * i, swap);
    for (int i = 0; i < 8; i++) info->pixdim[i] = rd<double>(buf + 104 + 8 * i, swap);
    info->vox_offset = rd<int64_t>(buf + 168, swap);
    info->scl_slope = rd<double>(buf + 176, swap);
    info->scl_inter = rd<double>(buf + 184, swap);
    info->cal_max = rd<double>(buf + 192, swap);
    info->cal_min = rd<double>(buf + 200, swap);
  } else {  // nifti1.h offsets
    info->datatype = rd<int16_t>(buf + 70, swap);
    info->bitpix = rd<int16_t>(buf + 72, swap);
    for (int i = 0; i < 8; i++) info->dim[i] = rd<int16_t>(buf + 40 + 2 * i, swap);
    for (int i = 0; i < 8; i++) info->pixdim[i] = rd<float>(buf + 76 + 4 * i, swap);
    info->vox_offset = (int64_t)rd<float>(buf + 108, swap);
    info->scl_slope = rd<float>(buf + 112, swap);
    info->scl_inter = rd<float>(buf + 116, swap);
    info->cal_max = rd<float>(buf + 124, swap);
    info->cal_min = rd<float>(buf + 128, swap);
  }
  return 0;
}

template <typename T>
static void convert_block(const uint8_t* src, float* dst, int64_t n, bool swap) {
  for (int64_t i = 0; i < n; i++) {
    T v = rd<T>(src + i * sizeof(T), swap);
    dst[i] = (float)v;
  }
}

// Reads `count` voxels starting at vox_offset, converting to float32 with
// `nthreads` workers.  Returns 0 on success.
extern "C" int vrp_nifti_read(const char* path, const NiftiInfo* info,
                              float* out, int64_t count, int nthreads) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  int esz = info->bitpix / 8;
  if (esz <= 0) { std::fclose(f); return 4; }
  std::vector<uint8_t> raw((size_t)count * esz);
  if (std::fseek(f, (long)info->vox_offset, SEEK_SET) != 0) { std::fclose(f); return 5; }
  size_t got = std::fread(raw.data(), 1, raw.size(), f);
  std::fclose(f);
  if (got < raw.size()) return 6;

  bool swap = info->swapped != 0;
  int dt = info->datatype;
  if (nthreads < 1) nthreads = 1;
  std::vector<std::thread> workers;
  int64_t chunk = (count + nthreads - 1) / nthreads;
  std::atomic<int> err{0};
  for (int t = 0; t < nthreads; t++) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(count, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back([&, lo, hi] {
      const uint8_t* src = raw.data() + (size_t)lo * esz;
      float* dst = out + lo;
      int64_t n = hi - lo;
      switch (dt) {
        case 2: convert_block<uint8_t>(src, dst, n, swap); break;
        case 4: convert_block<int16_t>(src, dst, n, swap); break;
        case 8: convert_block<int32_t>(src, dst, n, swap); break;
        case 16: convert_block<float>(src, dst, n, swap); break;
        case 64: convert_block<double>(src, dst, n, swap); break;
        case 256: convert_block<int8_t>(src, dst, n, swap); break;
        case 512: convert_block<uint16_t>(src, dst, n, swap); break;
        case 768: convert_block<uint32_t>(src, dst, n, swap); break;
        default: err.store(7);
      }
    });
  }
  for (auto& w : workers) w.join();
  return err.load();
}

// ---------------------------------------------------------------------------
// Min/max pyramid (octree-equivalent acceleration structure)
// ---------------------------------------------------------------------------

// Leaf grid: n = 2^depth cells per axis; cell k holds the centered
// nearest-voxel value (Octree.cu:85-108 float expression order), negatives
// clamped to 0 (the descent's `aux > res` combine, Octree.cu:172-177).
extern "C" void vrp_leaf_grid(const float* vol, int d1, int d2, int d3,
                              int depth, float* out, int nthreads) {
  int n = 1 << depth;
  int L = std::max(d1, std::max(d2, d3));
  float Lf = (float)L;
  int dims[3] = {d1, d2, d3};

  std::vector<int> idx[3];
  std::vector<uint8_t> ok[3];
  for (int ax = 0; ax < 3; ax++) {
    idx[ax].resize(n);
    ok[ax].resize(n);
    float half_gap = Lf / 2.0f - dims[ax] / 2.0f;
    for (int k = 0; k < n; k++) {
      float res = ((float)k / (float)n) * Lf;
      bool inside = res >= half_gap && res < half_gap + dims[ax];
      ok[ax][k] = inside;
      float t = (res + dims[ax] / 2.0f) - Lf / 2.0f;
      int v = (int)t;
      idx[ax][k] = std::clamp(v, 0, dims[ax] - 1);
    }
  }

  if (nthreads < 1) nthreads = 1;
  std::vector<std::thread> workers;
  int chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; t++) {
    int lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back([&, lo, hi] {
      for (int x = lo; x < hi; x++) {
        for (int y = 0; y < n; y++) {
          float* dst = out + ((size_t)x * n + y) * n;
          if (!(ok[0][x] && ok[1][y])) {
            std::memset(dst, 0, n * sizeof(float));
            continue;
          }
          const float* row =
              vol + ((size_t)idx[0][x] * d2 + idx[1][y]) * d3;
          for (int z = 0; z < n; z++) {
            float v = ok[2][z] ? row[idx[2][z]] : 0.0f;
            dst[z] = v > 0.0f ? v : 0.0f;
          }
        }
      }
    });
  }
  for (auto& w : workers) w.join();
}

// One 2x min/max pooling step: in is [n,n,n], outs are [n/2,n/2,n/2].
extern "C" void vrp_pool2(const float* in_min, const float* in_max, int n,
                          float* out_min, float* out_max) {
  int m = n / 2;
  for (int x = 0; x < m; x++)
    for (int y = 0; y < m; y++)
      for (int z = 0; z < m; z++) {
        float lo = INFINITY, hi = -INFINITY;
        for (int dx = 0; dx < 2; dx++)
          for (int dy = 0; dy < 2; dy++)
            for (int dz = 0; dz < 2; dz++) {
              size_t i = ((size_t)(2 * x + dx) * n + (2 * y + dy)) * n +
                         (2 * z + dz);
              lo = std::min(lo, in_min[i]);
              hi = std::max(hi, in_max[i]);
            }
        size_t o = ((size_t)x * m + y) * m + z;
        out_min[o] = lo;
        out_max[o] = hi;
      }
}

// ---------------------------------------------------------------------------
// 3-D zero-padded convolution (Convolution.cpp:160-205 semantics)
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// Exact GL point rasterization (POINT / a0 mode)
// ---------------------------------------------------------------------------

// Emulates the reference's GL state for the voxel point cloud
// (myApp.cu:158-162, 955-981): depth test LESS with depth writes, alpha
// blending GL_SRC_ALPHA / GL_ONE_MINUS_SRC_ALPHA, fragments with alpha == 0
// discarded by the shader (3.3.point_shader.fs:6-8), points drawn in voxel
// iteration order.  ndc: [N,3] clip-space positions (w==1, ortho), rgba:
// [N,4].  out: [W*H*4] image in column-major pixel order (x*H + y, y from
// the top), initialized to the background by this function.
extern "C" void vrp_point_rasterize(const float* ndc, const float* rgba,
                                    int64_t n, int width, int height,
                                    const float* background, float* out) {
  std::vector<float> depth((size_t)width * height, 1.0f);
  for (int i = 0; i < width * height; i++) {
    out[i * 4 + 0] = background[0];
    out[i * 4 + 1] = background[1];
    out[i * 4 + 2] = background[2];
    out[i * 4 + 3] = background[3];
  }
  for (int64_t i = 0; i < n; i++) {
    float x = ndc[i * 3 + 0], y = ndc[i * 3 + 1], z = ndc[i * 3 + 2];
    float a = rgba[i * 4 + 3];
    if (a == 0.0f) continue;  // shader discard
    if (x < -1.0f || x >= 1.0f || y < -1.0f || y >= 1.0f || z < -1.0f ||
        z > 1.0f)
      continue;
    int px = (int)std::floor((x + 1.0f) * 0.5f * width);
    int wy = (int)std::floor((y + 1.0f) * 0.5f * height);  // from bottom
    if (px < 0 || px >= width || wy < 0 || wy >= height) continue;
    int py = height - 1 - wy;  // image rows from the top
    size_t pix = (size_t)px * height + py;
    float d = (z + 1.0f) * 0.5f;
    if (!(d < depth[pix])) continue;  // GL_LESS
    depth[pix] = d;                   // depth write (glDepthMask default)
    float* dst = out + pix * 4;
    for (int c = 0; c < 3; c++)
      dst[c] = rgba[i * 4 + c] * a + dst[c] * (1.0f - a);
    dst[3] = a * a + dst[3] * (1.0f - a);
  }
}

extern "C" void vrp_conv3d(const float* vol, int d1, int d2, int d3,
                           const float* kern, int k1, int k2, int k3,
                           float* out, int nthreads) {
  int r1 = k1 / 2, r2 = k2 / 2, r3 = k3 / 2;
  if (nthreads < 1) nthreads = 1;
  std::vector<std::thread> workers;
  int chunk = (d1 + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; t++) {
    int lo = t * chunk, hi = std::min(d1, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back([&, lo, hi] {
      for (int x = lo; x < hi; x++)
        for (int y = 0; y < d2; y++)
          for (int z = 0; z < d3; z++) {
            float acc = 0.0f;
            for (int a = 0; a < k1; a++) {
              int xx = x + a - r1;
              if (xx < 0 || xx >= d1) continue;
              for (int b = 0; b < k2; b++) {
                int yy = y + b - r2;
                if (yy < 0 || yy >= d2) continue;
                for (int c = 0; c < k3; c++) {
                  int zz = z + c - r3;
                  if (zz < 0 || zz >= d3) continue;
                  acc += vol[((size_t)xx * d2 + yy) * d3 + zz] *
                         kern[((size_t)a * k2 + b) * k3 + c];
                }
              }
            }
            out[((size_t)x * d2 + y) * d3 + z] = acc;
          }
    });
  }
  for (auto& w : workers) w.join();
}
