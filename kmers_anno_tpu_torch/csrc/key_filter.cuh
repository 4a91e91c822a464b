// The key filter (ops/key_filter.py) read in front of an 8-slot table walk,
// shared by apply_flat.cu and dna_probe.cu.
//
// A split-block Bloom filter of the table's own keys, 16 bits a key: each
// key sets one bit in each of the 8 words of one 32-byte sector, the sector
// chosen by fmix32(lo ^ fmix32(hi ^ salt)) scaled to the sector count, the
// bits by fmix32(hi ^ fmix32(lo ^ salt')) times one odd constant a word,
// top 5 bits; both hashes are independent of the bucket hash.  A query
// whose sector lacks one of its bits is surely absent; a Bloom filter has
// no false negatives, so filtering changes no output.
#pragma once

#include <cstdint>

#include "wide_probe.cuh"   // kan::fmix32

namespace kan {

constexpr uint32_t kFilterSectorSalt = 0x3C6EF372u;
constexpr uint32_t kFilterBitSalt = 0xA54FF53Au;

// n_sectors 32-byte sectors of 8 words; none when n_sectors is 0
struct KeyFilter {
  const uint4* sectors;
  uint32_t n_sectors;
};

// The filter of a C entry point's (pointer, sector count); a null pointer
// is no filter.
inline KeyFilter make_key_filter(const int32_t* filter, int64_t n_sectors) {
  return KeyFilter{reinterpret_cast<const uint4*>(filter),
                   filter ? static_cast<uint32_t>(n_sectors) : 0u};
}

// False when the table surely lacks (lo, hi): a bit of its sector is
// clear.  True without a filter.
__device__ __forceinline__ bool may_hold(const KeyFilter& f, uint32_t lo,
                                         uint32_t hi) {
  if (!f.n_sectors) return true;
  const uint32_t hs = fmix32(lo ^ fmix32(hi ^ kFilterSectorSalt));
  const size_t s = static_cast<size_t>(
      (static_cast<uint64_t>(hs) * f.n_sectors) >> 32);
  const uint4 a = __ldg(f.sectors + 2 * s);
  const uint4 c = __ldg(f.sectors + 2 * s + 1);
  const uint32_t words[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
  const uint32_t salts[8] = {0x47B6137Bu, 0x44974D91u, 0x8824AD5Bu,
                             0xA2B7289Du, 0x705495C7u, 0x2DF1424Bu,
                             0x9EFC4947u, 0x5C6BFB31u};
  const uint32_t hb = fmix32(hi ^ fmix32(lo ^ kFilterBitSalt));
  uint32_t all = 1u;
#pragma unroll
  for (int i = 0; i < 8; ++i) all &= words[i] >> ((hb * salts[i]) >> 27);
  return all & 1u;
}

}  // namespace kan
