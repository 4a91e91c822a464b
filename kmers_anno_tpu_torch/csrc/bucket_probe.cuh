// One lookup in the 8-slot bucket table, shared by hash_chunk.cu,
// apply_flat.cu and dna_probe.cu.
//
// Table layout, as built by ops/hashtable.build_table: buckets of 24 uint32
// words, [8 lo keys | 8 hi keys | 8 payloads], EMPTY = 0xFFFFFFFF in a free
// key slot; the home bucket of a key is fmix32(lo ^ fmix32(hi ^ GOLDEN))
// & (buckets - 1), the unsalted murmur3 mix of ops/hashing.py.  A key whose
// home bucket was full sits in one of the next max_probes - 1 buckets
// (wrapping from the last bucket to bucket 0), and every bucket before it on
// its walk is full, so a walk stops at its hit or at the first bucket with a
// free slot.  Keys are unique, but a bucket may hold several keys with one
// lo word: every slot whose lo matches has its hi checked.
//
// A bucket's 8 lo keys are one 32-byte sector, read as two 16-byte loads
// (every bucket starts 16-byte aligned when the table does); its hi and
// payload words are read only for a slot whose lo matches.
#pragma once

#include <cstdint>

#include "wide_probe.cuh"   // kan::fmix32

namespace kan {

constexpr int kBucketSlots = 8;
constexpr int kBucketWords = 3 * kBucketSlots;
constexpr uint32_t kHashGolden = 0x9E3779B9u;
constexpr uint32_t kEmptyKey = 0xFFFFFFFFu;

// The payload stored under (lo, hi), or -1.
__device__ __forceinline__ int32_t probe_bucket_key(
    const uint32_t* __restrict__ table, uint32_t mask, uint32_t lo,
    uint32_t hi, int max_probes) {
  uint32_t b = fmix32(lo ^ fmix32(hi ^ kHashGolden)) & mask;
  for (int probe = 0; probe < max_probes; ++probe) {
    const uint32_t* bucket = table + static_cast<size_t>(b) * kBucketWords;
    const uint4* bucket4 = reinterpret_cast<const uint4*>(bucket);
    const uint4 a = __ldg(bucket4);
    const uint4 c = __ldg(bucket4 + 1);
    const uint32_t keys[kBucketSlots] = {a.x, a.y, a.z, a.w,
                                         c.x, c.y, c.z, c.w};
    bool full = true;
#pragma unroll
    for (int s = 0; s < kBucketSlots; ++s) {
      if (keys[s] == lo) {
        const uint32_t h = __ldg(bucket + kBucketSlots + s);
        const uint32_t v = __ldg(bucket + 2 * kBucketSlots + s);
        if (h == hi) return static_cast<int32_t>(v);
      }
      full &= keys[s] != kEmptyKey;
    }
    if (!full) return -1;
    b = (b + 1) & mask;
  }
  return -1;
}

}  // namespace kan
