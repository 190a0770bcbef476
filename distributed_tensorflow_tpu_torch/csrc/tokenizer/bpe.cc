// Byte-pair-encoding tokenizer core: the hot loops of the LM data pipeline.
//
// A copy of the JAX package's distributed_tensorflow_tpu/csrc/tokenizer/
// bpe.cc, built from this tree by distributed_tensorflow_tpu_torch/data/
// tokenizer.py (g++, loaded over ctypes, as csrc/coordination/coord.cc).
// BPE training (pair counting and merge compaction over the whole corpus)
// and corpus encoding run here, reached from Python over a C ABI.
//
// Token model: byte-level BPE. Base vocabulary is the 256 byte values; merge
// rank r creates token id 256+r from the adjacent pair (left, right). Both
// training and encoding apply merges greedily left-to-right, rank by rank —
// deterministic for a fixed corpus, ties broken toward the numerically
// smallest (left, right) pair.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// Non-overlapping left-to-right replacement of (a, b) -> id, in place.
// Returns the new length.
int64_t merge_pass(std::vector<int32_t>& seq, int64_t n, int32_t a, int32_t b,
                   int32_t id) {
  int64_t w = 0, i = 0;
  while (i < n) {
    if (i + 1 < n && seq[i] == a && seq[i + 1] == b) {
      seq[w++] = id;
      i += 2;
    } else {
      seq[w++] = seq[i++];
    }
  }
  return w;
}

inline uint64_t pair_key(int32_t a, int32_t b) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
         static_cast<uint32_t>(b);
}

}  // namespace

extern "C" {

// Train BPE on a byte corpus.  Writes up to max_merges (left, right) pairs
// into merges_out (layout [max_merges][2]) and returns the number actually
// produced.  Training stops early when the best remaining pair occurs fewer
// than min_pair_count times (pass 2 to stop at singleton pairs).
int dtf_bpe_train(const uint8_t* data, int64_t n, int max_merges,
                  int min_pair_count, int32_t* merges_out) {
  std::vector<int32_t> seq(n);
  for (int64_t i = 0; i < n; ++i) seq[i] = data[i];
  int64_t len = n;
  if (min_pair_count < 2) min_pair_count = 2;

  std::unordered_map<uint64_t, int64_t> counts;
  counts.reserve(1 << 16);
  int produced = 0;
  for (; produced < max_merges; ++produced) {
    counts.clear();
    for (int64_t i = 0; i + 1 < len; ++i) {
      ++counts[pair_key(seq[i], seq[i + 1])];
    }
    int64_t best_count = 0;
    uint64_t best_key = 0;
    for (const auto& kv : counts) {
      if (kv.second > best_count ||
          (kv.second == best_count && kv.first < best_key)) {
        best_count = kv.second;
        best_key = kv.first;
      }
    }
    if (best_count < min_pair_count) break;
    const int32_t a = static_cast<int32_t>(best_key >> 32);
    const int32_t b = static_cast<int32_t>(best_key & 0xffffffffu);
    merges_out[2 * produced] = a;
    merges_out[2 * produced + 1] = b;
    len = merge_pass(seq, len, a, b, 256 + produced);
  }
  return produced;
}

// Encode a byte corpus with a trained merge table (rank order).  out must
// have capacity for n ids; returns the encoded length (<= n).
int64_t dtf_bpe_encode(const uint8_t* data, int64_t n, const int32_t* merges,
                       int n_merges, int32_t* out) {
  std::vector<int32_t> seq(n);
  for (int64_t i = 0; i < n; ++i) seq[i] = data[i];
  int64_t len = n;
  for (int r = 0; r < n_merges && len > 1; ++r) {
    len = merge_pass(seq, len, merges[2 * r], merges[2 * r + 1], 256 + r);
  }
  std::memcpy(out, seq.data(), len * sizeof(int32_t));
  return len;
}

}  // extern "C"
