// Host velodyne loader of mv3d_tf_tpu_torch, a copy of the JAX package's
// native/mv3d_loader.cc.
//
// Reads velodyne .bin scans and packs them into the fixed-size
// (bucket, 4) + validity-mask buffers the batched BEV front end takes,
// with raw file IO and a std::thread pool
// (mv3d_tf_tpu_torch/utils/native.py binds it; its numpy twin is
// load_velodyne_batch_np there).
//
// Plain C ABI for ctypes.

#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// Read one velodyne .bin (N x 4 float32) into a fixed bucket.
// out: bucket*4 floats (zero-padded), valid: bucket bytes (0/1).
// Returns the number of points stored (min(N, bucket)), or -1 on error.
long load_velodyne_padded(const char* path, float* out,
                          unsigned char* valid, long bucket) {
  FILE* f = std::fopen(path, "rb");
  if (f == nullptr) return -1;
  std::fseek(f, 0, SEEK_END);
  long bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  long n = bytes / (4 * sizeof(float));
  long keep = n < bucket ? n : bucket;
  long got = static_cast<long>(
      std::fread(out, 4 * sizeof(float), keep, f));
  std::fclose(f);
  if (got != keep) return -1;
  std::memset(out + keep * 4, 0, (bucket - keep) * 4 * sizeof(float));
  std::memset(valid, 1, keep);
  std::memset(valid + keep, 0, bucket - keep);
  return keep;
}

// Batched, multi-threaded variant: paths is n_scans concatenated
// NUL-terminated strings; out is (n_scans, bucket, 4); valid is
// (n_scans, bucket). counts receives per-scan point counts (-1 = error).
void load_velodyne_batch(const char* paths, long n_scans, float* out,
                         unsigned char* valid, long bucket, long* counts,
                         long n_threads) {
  std::vector<const char*> ptrs;
  ptrs.reserve(n_scans);
  const char* p = paths;
  for (long i = 0; i < n_scans; ++i) {
    ptrs.push_back(p);
    p += std::strlen(p) + 1;
  }
  if (n_threads <= 0) n_threads = 4;
  if (n_threads > n_scans) n_threads = n_scans;
  std::vector<std::thread> workers;
  for (long t = 0; t < n_threads; ++t) {
    workers.emplace_back([&, t]() {
      for (long i = t; i < n_scans; i += n_threads) {
        counts[i] = load_velodyne_padded(
            ptrs[i], out + i * bucket * 4, valid + i * bucket, bucket);
      }
    });
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"
