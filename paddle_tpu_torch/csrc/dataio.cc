// Native data-pipeline core of paddle_tpu_torch: a copy of the JAX
// package's csrc/dataio.cc, entry point for entry point, so both packages'
// native paths give the same bytes.
//
// Host-side analog of the reference's C++ data-provider machinery
// (reference: paddle/gserver/dataproviders/PyDataProvider2.cpp — background
// batch assembly, shuffle pool, DataBatch construction; and the flat-sequence
// Argument packing in paddle/parameter/Argument.cpp).  The Python feeder calls
// into this library via ctypes for the per-batch hot path: shuffling, length
// bucketing, and padded batch assembly into preallocated buffers, so the
// host keeps the card's input queue fed without a Python inner loop.
//
// Build (paddle_tpu_torch/data/native.py does it at first use, into
// paddle_tpu_torch/_build/): g++ -O3 -shared -fPIC -std=c++17 -o <lib>.so dataio.cc
// Pure C ABI; no dependencies.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <random>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// shuffle
// ---------------------------------------------------------------------------

// Fisher–Yates permutation of [0, n) with a deterministic seed.
void ptd_shuffle_indices(int32_t n, uint64_t seed, int32_t* out) {
  for (int32_t i = 0; i < n; ++i) out[i] = i;
  std::mt19937_64 rng(seed);
  for (int32_t i = n - 1; i > 0; --i) {
    std::uniform_int_distribution<int32_t> dist(0, i);
    std::swap(out[i], out[dist(rng)]);
  }
}

// ---------------------------------------------------------------------------
// length bucketing
// ---------------------------------------------------------------------------

// For each length, the smallest bucket >= len (last bucket if none). Returns
// bucket *index* per row; used to group rows so XLA sees few shapes.
void ptd_bucket_by_length(const int32_t* lens, int32_t n, const int32_t* buckets,
                          int32_t n_buckets, int32_t* bucket_idx_out) {
  for (int32_t i = 0; i < n; ++i) {
    int32_t b = n_buckets - 1;
    for (int32_t j = 0; j < n_buckets; ++j) {
      if (lens[i] <= buckets[j]) { b = j; break; }
    }
    bucket_idx_out[i] = b;
  }
}

// Argsort rows by length (stable) — batch rows of similar length together
// (the reference sorts by length inside SequenceToBatch; here it minimizes
// padding waste per bucket).
void ptd_argsort_by_length(const int32_t* lens, int32_t n, int32_t* order_out) {
  for (int32_t i = 0; i < n; ++i) order_out[i] = i;
  std::stable_sort(order_out, order_out + n,
                   [&](int32_t a, int32_t b) { return lens[a] < lens[b]; });
}

// ---------------------------------------------------------------------------
// padded batch assembly
// ---------------------------------------------------------------------------

// Pack n variable-length int32 id sequences (concatenated in `flat`, row i
// spanning offsets[i]..offsets[i+1]) into out[n, maxT] zero-padded, clipping
// at maxT. out_lens receives the (clipped) lengths.
void ptd_pad_batch_i32(const int32_t* flat, const int64_t* offsets, int32_t n,
                       int32_t maxT, int32_t* out, int32_t* out_lens) {
  std::memset(out, 0, sizeof(int32_t) * (size_t)n * (size_t)maxT);
  for (int32_t i = 0; i < n; ++i) {
    int64_t start = offsets[i];
    int32_t len = (int32_t)std::min<int64_t>(offsets[i + 1] - start, maxT);
    std::memcpy(out + (size_t)i * maxT, flat + start, sizeof(int32_t) * (size_t)len);
    out_lens[i] = len;
  }
}

// Same for float rows with feature dim D: flat is [sum_len, D] row-major.
void ptd_pad_batch_f32(const float* flat, const int64_t* offsets, int32_t n,
                       int32_t maxT, int32_t D, float* out, int32_t* out_lens) {
  std::memset(out, 0, sizeof(float) * (size_t)n * (size_t)maxT * (size_t)D);
  for (int32_t i = 0; i < n; ++i) {
    int64_t start = offsets[i];
    int32_t len = (int32_t)std::min<int64_t>(offsets[i + 1] - start, maxT);
    std::memcpy(out + (size_t)i * maxT * D, flat + start * D,
                sizeof(float) * (size_t)len * (size_t)D);
    out_lens[i] = len;
  }
}

// ---------------------------------------------------------------------------
// sequence packing (segment ids) — long-context path
// ---------------------------------------------------------------------------

// Greedy first-fit packing of sequences into `n_rows` rows of capacity `T`.
// Writes packed ids, segment ids (1-based; 0 = padding) and per-row used
// lengths. Returns number of sequences that fit.
int32_t ptd_pack_sequences(const int32_t* flat, const int64_t* offsets,
                           int32_t n, int32_t n_rows, int32_t T,
                           int32_t* out_ids, int32_t* out_seg,
                           int32_t* row_used) {
  std::memset(out_ids, 0, sizeof(int32_t) * (size_t)n_rows * T);
  std::memset(out_seg, 0, sizeof(int32_t) * (size_t)n_rows * T);
  std::memset(row_used, 0, sizeof(int32_t) * (size_t)n_rows);
  int32_t placed = 0;
  for (int32_t i = 0; i < n; ++i) {
    int32_t len = (int32_t)(offsets[i + 1] - offsets[i]);
    if (len > T) continue;
    for (int32_t r = 0; r < n_rows; ++r) {
      if (row_used[r] + len <= T) {
        int32_t off = row_used[r];
        std::memcpy(out_ids + (size_t)r * T + off, flat + offsets[i],
                    sizeof(int32_t) * (size_t)len);
        for (int32_t t = 0; t < len; ++t)
          out_seg[(size_t)r * T + off + t] = placed + 1;
        row_used[r] += len;
        ++placed;
        break;
      }
    }
  }
  return placed;
}

// ---------------------------------------------------------------------------
// vocab / token stats (corpus preprocessing)
// ---------------------------------------------------------------------------

// Count token frequencies below `vocab_cap` into counts (caller-zeroed).
void ptd_count_tokens(const int32_t* flat, int64_t n_tokens, int32_t vocab_cap,
                      int64_t* counts) {
  for (int64_t i = 0; i < n_tokens; ++i) {
    int32_t t = flat[i];
    if (t >= 0 && t < vocab_cap) ++counts[t];
  }
}

int32_t ptd_version() { return 1; }

}  // extern "C"
