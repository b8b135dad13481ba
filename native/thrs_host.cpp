// Native host-side oracle & key transforms for tinyhipradixsort_tpu.
//
// Analogue of the reference's host components: the fpKey.hpp
// key-bit mirror (reference: fpKey.hpp:1-38) and the parallel CPU radix-sort
// oracle its benches verify against (reference: main.cpp:195,
// unittest.cpp:526 — concurrency::parallel_radixsort). Used from Python via
// ctypes (tinyhipradixsort_tpu/utils/native_oracle.py) to verify multi-GB
// device sorts at memory speed instead of np.argsort speed.
//
// Algorithm: stable parallel LSD radix sort, 8-bit digits. Per pass:
// per-thread-chunk 256-bin histograms, a (thread, bucket) exclusive scan in
// bucket-major order (the reference's counter layout, kernel.cu:97), then
// each thread scatters its chunk through its own cursor row — stable because
// chunk order is preserved within each bucket. OpenMP when available.

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline int num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

// Order-preserving key-bit transforms (mirror of the device transforms).
inline uint32_t key_bits_f32(float f) {
  if (f == 0.0f) f = 0.0f;  // normalize -0.0
  uint32_t u;
  std::memcpy(&u, &f, 4);
  uint32_t flip = static_cast<uint32_t>(static_cast<int32_t>(u) >> 31) | 0x80000000u;
  return u ^ flip;
}

inline uint64_t key_bits_f64(double f) {
  if (f == 0.0) f = 0.0;
  uint64_t u;
  std::memcpy(&u, &f, 8);
  uint64_t flip = static_cast<uint64_t>(static_cast<int64_t>(u) >> 63) | 0x8000000000000000ull;
  return u ^ flip;
}

// One stable LSD pass over an arbitrary digit extractor.
template <typename T, typename Idx, typename Digit>
void radix_pass(const T* src, T* dst, const Idx* src_idx, Idx* dst_idx,
                int64_t n, Digit digit) {
  const int nt = num_threads();
  const int64_t chunk = (n + nt - 1) / nt;
  std::vector<int64_t> hist(static_cast<size_t>(nt) * 256, 0);

#pragma omp parallel num_threads(nt)
  {
#ifdef _OPENMP
    const int t = omp_get_thread_num();
#else
    const int t = 0;
#endif
    const int64_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
    int64_t* h = hist.data() + static_cast<size_t>(t) * 256;
    for (int64_t i = lo; i < hi; ++i) ++h[digit(src[i])];
  }

  // bucket-major exclusive scan over (bucket, thread)
  int64_t sum = 0;
  for (int b = 0; b < 256; ++b)
    for (int t = 0; t < nt; ++t) {
      int64_t& c = hist[static_cast<size_t>(t) * 256 + b];
      int64_t v = c;
      c = sum;
      sum += v;
    }

#pragma omp parallel num_threads(nt)
  {
#ifdef _OPENMP
    const int t = omp_get_thread_num();
#else
    const int t = 0;
#endif
    const int64_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
    int64_t* cur = hist.data() + static_cast<size_t>(t) * 256;
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t d = cur[digit(src[i])]++;
      dst[d] = src[i];
      if (src_idx) dst_idx[d] = src_idx[i];
    }
  }
}

template <typename T>
void radix_sort(T* keys, uint64_t* idx, int64_t n, int start_byte, int end_byte) {
  std::vector<T> tmp(static_cast<size_t>(n));
  std::vector<uint64_t> tmp_idx(idx ? static_cast<size_t>(n) : 0);
  T* a = keys;
  T* b = tmp.data();
  uint64_t* ia = idx;
  uint64_t* ib = idx ? tmp_idx.data() : nullptr;
  for (int byte = start_byte; byte < end_byte; ++byte) {
    const int shift = byte * 8;
    radix_pass(a, b, ia, ib, n,
               [shift](T v) { return static_cast<int>((v >> shift) & 0xFF); });
    std::swap(a, b);
    std::swap(ia, ib);
  }
  if (a != keys) {  // odd pass count: copy back (reference hpp:936-943)
    std::memcpy(keys, a, static_cast<size_t>(n) * sizeof(T));
    if (idx) std::memcpy(idx, ia, static_cast<size_t>(n) * 8);
  }
}

}  // namespace

extern "C" {

// keys: u32/u64 *transformed bits* (use the transforms below for floats).
// idx: optional (may be null) u64 payload permuted alongside — pass iota to
// recover the stable sorting permutation. start/end select the byte window.
void thrs_radix_sort_u32(uint32_t* keys, uint64_t* idx, int64_t n,
                         int start_byte, int end_byte) {
  radix_sort<uint32_t>(keys, idx, n, start_byte, end_byte);
}

void thrs_radix_sort_u64(uint64_t* keys, uint64_t* idx, int64_t n,
                         int start_byte, int end_byte) {
  radix_sort<uint64_t>(keys, idx, n, start_byte, end_byte);
}

// Vectorized key-bit transforms (host mirror; reference fpKey.hpp).
void thrs_key_bits_f32(const float* in, uint32_t* out, int64_t n) {
#pragma omp parallel for
  for (int64_t i = 0; i < n; ++i) out[i] = key_bits_f32(in[i]);
}

void thrs_key_bits_f64(const double* in, uint64_t* out, int64_t n) {
#pragma omp parallel for
  for (int64_t i = 0; i < n; ++i) out[i] = key_bits_f64(in[i]);
}

void thrs_key_bits_i32(const int32_t* in, uint32_t* out, int64_t n) {
#pragma omp parallel for
  for (int64_t i = 0; i < n; ++i)
    out[i] = static_cast<uint32_t>(in[i]) ^ 0x80000000u;
}

void thrs_key_bits_i64(const int64_t* in, uint64_t* out, int64_t n) {
#pragma omp parallel for
  for (int64_t i = 0; i < n; ++i)
    out[i] = static_cast<uint64_t>(in[i]) ^ 0x8000000000000000ull;
}

int thrs_version() { return 1; }

}  // extern "C"
