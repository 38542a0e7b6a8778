// Host BEV rasterizer: the C++ twin of the port's numpy raster
// mv3d_tf_tpu_torch/ops/bev.py:point_cloud_2_top_np (itself the twin of
// the reference's tools/read_lidar.py:10-115 loop), after the JAX
// package's native/bev_raster.cc.
//
// Used for offline dataset preparation (tools/read_lidar.py --host,
// synthetic dataset generation), where the numpy per-slice loop is the
// host's bottleneck. The device path (csrc/bev_place.cu) is unrelated.
//
// Exact-parity notes (tests/test_torch_native.py pins bit-equality with
// the numpy twin and the device paths):
//   * pixel coords use float32 division by float32(res) then int32
//     truncation toward zero, as numpy divides a float32 array by a
//     Python float;
//   * slice membership compares the float32 z with the caller's float32
//     bounds lo[s] <= z < hi[s] (ops/bev.py:_SLICE_BOUNDS). The JAX
//     package's raster resolves slices in float64 and lands a z that sits
//     exactly on a bound one slice off; this one does not recompute them;
//   * last-write-wins in file order per slice, channel C-1 (reflectance)
//     overwritten per slice loop iteration: the winner is the last point
//     of the highest-indexed slice touching the cell.
//
// Plain C ABI for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Grid {
  float res;
  float x_min, x_max;   // forward range (0, 60)
  float y_abs;          // side half-range (30)
  float h_min;          // height origin of channels 0..n_slices-1 (-2)
  const float* lo;      // n_slices float32 lower bounds (inclusive)
  const float* hi;      // n_slices float32 upper bounds (exclusive)
  int32_t H, W, C;      // 601, 601, 9
  int32_t n_slices;     // 8
  int32_t x_shift, y_shift;  // +300, +600
};

inline void raster_one(const float* pts, int64_t n, const Grid& g,
                       float* out) {
  // out: H*W*C float32, caller-zeroed.
  //
  // One bucketing pass, then slice-major writes: the write ORDER must be
  // slice-major, file order within a slice, to reproduce the reference's
  // channel-C-1 winner. A point joins every slice whose bounds hold it,
  // as the numpy twin's per-slice masks do.
  const int64_t rowc = static_cast<int64_t>(g.W) * g.C;
  std::vector<std::vector<int64_t>> buckets(
      static_cast<size_t>(g.n_slices));
  for (auto& b : buckets) b.reserve(static_cast<size_t>(n / 8));

  for (int64_t i = 0; i < n; ++i) {
    const float x = pts[i * 4 + 0];
    const float y = pts[i * 4 + 1];
    if (!(x > g.x_min && x < g.x_max && y > -g.y_abs && y < g.y_abs))
      continue;
    const float z = pts[i * 4 + 2];
    for (int32_t s = 0; s < g.n_slices; ++s) {
      if (z >= g.lo[s] && z < g.hi[s])
        buckets[static_cast<size_t>(s)].push_back(i);
    }
  }

  for (int32_t s = 0; s < g.n_slices; ++s) {
    for (const int64_t i : buckets[static_cast<size_t>(s)]) {
      const float x = pts[i * 4 + 0];
      const float y = pts[i * 4 + 1];
      const float z = pts[i * 4 + 2];
      const float r = pts[i * 4 + 3];
      const int32_t xi = static_cast<int32_t>(-y / g.res) + g.x_shift;
      const int32_t yi = static_cast<int32_t>(-x / g.res) + g.y_shift;
      if (xi < 0 || xi >= g.W || yi < 0 || yi >= g.H) continue;
      float* cell = out + yi * rowc + static_cast<int64_t>(xi) * g.C;
      // float32 arithmetic, as numpy computes z - HEIGHT_MIN on float32
      cell[s] = z - g.h_min;
      cell[g.C - 1] = r;
    }
  }
}

}  // namespace

extern "C" {

// Rasterize one in-memory point cloud (n x 4 f32) into out (H*W*C f32,
// zero-initialized by the caller). lo, hi: n_slices float32 bounds each.
void bev_raster(const float* pts, int64_t n, float res, float x_min,
                float x_max, float y_abs, float h_min, const float* lo,
                const float* hi, int32_t H, int32_t W, int32_t C,
                int32_t n_slices, int32_t x_shift, int32_t y_shift,
                float* out) {
  Grid g{res, x_min, x_max, y_abs, h_min, lo, hi,
         H, W, C, n_slices, x_shift, y_shift};
  raster_one(pts, n, g, out);
}

// Read many velodyne .bin files and rasterize each, with a thread pool.
// paths: NUL-separated; out: n_files*H*W*C f32 (caller-zeroed);
// counts[i] = points read, or -1 on IO error.
void bev_raster_files(const char* paths, int64_t n_files, float res,
                      float x_min, float x_max, float y_abs, float h_min,
                      const float* lo, const float* hi, int32_t H,
                      int32_t W, int32_t C, int32_t n_slices,
                      int32_t x_shift, int32_t y_shift, float* out,
                      int64_t* counts, int64_t n_threads) {
  std::vector<const char*> files;
  const char* p = paths;
  for (int64_t i = 0; i < n_files; ++i) {
    files.push_back(p);
    p += std::strlen(p) + 1;
  }
  Grid g{res, x_min, x_max, y_abs, h_min, lo, hi,
         H, W, C, n_slices, x_shift, y_shift};
  const int64_t frame = static_cast<int64_t>(H) * W * C;
  const int64_t nt = n_threads > 0 ? n_threads : 1;

  auto work = [&](int64_t t) {
    std::vector<float> buf;
    for (int64_t i = t; i < n_files; i += nt) {
      FILE* f = std::fopen(files[i], "rb");
      if (f == nullptr) { counts[i] = -1; continue; }
      std::fseek(f, 0, SEEK_END);
      const long bytes = std::ftell(f);
      std::fseek(f, 0, SEEK_SET);
      const int64_t n = bytes / (4 * sizeof(float));
      buf.resize(static_cast<size_t>(n) * 4);
      const int64_t got = static_cast<int64_t>(
          std::fread(buf.data(), 4 * sizeof(float), n, f));
      std::fclose(f);
      if (got != n) { counts[i] = -1; continue; }
      counts[i] = n;
      raster_one(buf.data(), n, g, out + i * frame);
    }
  };
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < nt; ++t) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
}

}  // extern "C"
