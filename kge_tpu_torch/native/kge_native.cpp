// Host-side data plane of kge_tpu_torch: triple-file parsing, set
// membership and filtered negative resampling, run on the host's cores
// while the card computes. The package's own copy of
// kge_tpu/native/kge_native.cpp (the JAX package's replacement for the
// reference's Numba kernels, kge/indexing.py:58-155,415-428 and
// kge/util/sampler.py:700-752): the grammar it parses and the draws it makes
// must stay equal to that file's. Built with g++ into a plain shared library
// and bound with ctypes (kge_tpu_torch/native/__init__.py), which keeps a
// numpy version of every entry point.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <unordered_set>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

// splitmix64: fast, well-distributed 64-bit PRNG for resampling
inline uint64_t splitmix64(uint64_t& state) {
  uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

inline int64_t draw_uniform(uint64_t& state, int64_t vocab) {
  // rejection-free modulo bias is negligible for vocab << 2^64
  return static_cast<int64_t>(splitmix64(state) % static_cast<uint64_t>(vocab));
}

inline int64_t draw_cdf(uint64_t& state, const double* cdf, int64_t vocab) {
  // inverse-CDF sampling: cdf is an inclusive cumulative distribution of
  // length vocab with cdf[vocab-1] == 1.0
  double u = (splitmix64(state) >> 11) * (1.0 / 9007199254740992.0);  // [0,1)
  int64_t lo = 0, hi = vocab - 1;
  while (lo < hi) {
    int64_t mid = lo + (hi - lo) / 2;
    if (cdf[mid] <= u) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

}  // namespace

extern "C" {

// Parse a TSV/whitespace triple file: three integer columns per non-empty
// line. When out == nullptr only counts rows. Returns the number of triples,
// -1 on IO error, or -(2+line) when a line is malformed.
int64_t kge_parse_triples(const char* path, int32_t* out, int64_t cap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
  std::fclose(f);
  buf[got] = '\0';

  const char* p = buf.data();
  const char* end = p + got;
  int64_t row = 0;
  while (p < end) {
    // skip blank lines
    while (p < end && (*p == '\n' || *p == '\r')) ++p;
    if (p >= end) break;
    int32_t vals[3];
    int col = 0;
    while (col < 3) {
      while (p < end && (*p == ' ' || *p == '\t')) ++p;
      bool neg = false;
      if (p < end && *p == '-') { neg = true; ++p; }
      if (p >= end || *p < '0' || *p > '9') return -(2 + row);
      int64_t v = 0;
      while (p < end && *p >= '0' && *p <= '9') {
        v = v * 10 + (*p - '0');
        ++p;
      }
      vals[col++] = static_cast<int32_t>(neg ? -v : v);
    }
    // skip the rest of the line (extra columns allowed)
    while (p < end && *p != '\n') ++p;
    if (out) {
      if (row >= cap) return -1;
      out[row * 3 + 0] = vals[0];
      out[row * 3 + 1] = vals[1];
      out[row * 3 + 2] = vals[2];
    }
    ++row;
  }
  return row;
}

// mask[i] = 1 iff x[i] is (not, when not_in) contained in y
void kge_where_in(const int64_t* x, int64_t n, const int64_t* y, int64_t m,
                  uint8_t* mask, int not_in) {
  std::unordered_set<int64_t> set(y, y + m);
  for (int64_t i = 0; i < n; ++i) {
    bool in = set.count(x[i]) != 0;
    mask[i] = (in != (not_in != 0)) ? 1 : 0;
  }
}

// Filtered negative resampling over a batch (reference sampler.py:726-752):
// samples is [n, m] row-major; rows_idx[i] indexes the CSR positives of
// row i (offsets/values, -1 = no positives); collisions are resampled
// (uniform over [0, vocab), or from cdf when non-null) until no sample of a
// row is a known positive. Returns the total number of replacements.
int64_t kge_filter_resample(int64_t* samples, int64_t n, int64_t m,
                            const int64_t* rows_idx, const int64_t* offsets,
                            const int32_t* values, int64_t vocab,
                            const double* cdf, uint64_t seed) {
  int64_t total_replaced = 0;
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic, 64) reduction(+ : total_replaced)
#endif
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = rows_idx[i];
    if (r < 0) continue;
    int64_t lo = offsets[r], hi = offsets[r + 1];
    int64_t npos = hi - lo;
    if (npos <= 0) continue;
    // per-row positives lookup: linear scan for tiny lists, hash otherwise
    std::unordered_set<int64_t> set;
    const bool use_set = npos > 16;
    if (use_set) {
      set.reserve(static_cast<size_t>(npos) * 2);
      for (int64_t k = lo; k < hi; ++k) set.insert(values[k]);
    }
    auto is_pos = [&](int64_t v) -> bool {
      if (use_set) return set.count(v) != 0;
      for (int64_t k = lo; k < hi; ++k)
        if (values[k] == v) return true;
      return false;
    };
    uint64_t state = seed ^ (0x2545F4914F6CDD1DULL * (uint64_t)(i + 1));
    int64_t* row = samples + i * m;
    for (int64_t j = 0; j < m; ++j) {
      if (!is_pos(row[j])) continue;
      // resample until clean; positives never cover the whole vocabulary
      // in practice, but bound the loop defensively
      for (int attempt = 0; attempt < 1000000; ++attempt) {
        int64_t v = cdf ? draw_cdf(state, cdf, vocab)
                        : draw_uniform(state, vocab);
        if (!is_pos(v)) {
          row[j] = v;
          break;
        }
      }
      ++total_replaced;
    }
  }
  return total_replaced;
}

}  // extern "C"
