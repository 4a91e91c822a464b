// One lookup in the wide-bucket table, shared by probe_wide.cu and
// apply_rows.cu.
//
// Table layout, as built by build_wide_table: rows of 72 uint32 words,
// [24 lo keys | 24 hi keys | 24 payloads], EMPTY = 0xFFFFFFFF; the home row
// of a key is fmix32(lo ^ fmix32(hi ^ salt)) & (rows - 1) and a key that
// overflowed its home row sits in one of the next max_probes - 1 rows
// (wrapping from the last row to row 0).  Keys are unique, so at most one
// slot matches, but a row may hold several keys with one lo and different
// hi words: every slot whose lo matches has its hi checked.
//
// What bounds a lookup on this card: the L2 cache.  Rows are 288 bytes, so
// a row's 96 bytes of lo keys are exactly three 32-byte sectors; the main
// path's tables (37.7 MB or less) stay in the 50 MB L2, and every lookup
// reads its row's three lo-key sectors from there, whatever the number of
// load instructions that fetch them.  The rate is set by how many of those
// sector reads are in flight per SM against L2's latency.
//
// Design: one thread per key.  The 24 lo keys are read as six independent
// 16-byte loads through the read-only cache (every row starts 16-byte
// aligned when the table does); the hi and payload words are read only for
// a slot whose lo matches.  At about 30 registers a thread an SM holds
// many warps of such loads in flight.  Lookups that read a row with a group
// of 8 or 16 lanes (one 16-byte piece a lane, a ballot to find the match)
// read the same sectors with fewer instructions but need 54-106 registers
// a thread, hold fewer reads in flight, and were measured 1.5-3.3x slower
// on the union table and the apply batches (the 8-lane form tied on the
// close tables; PERF.md, Findings).
#pragma once

#include <cstdint>

namespace kan {

constexpr int kSlots = 24;
constexpr int kRowWords = 3 * kSlots;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ void match_slot(uint32_t key_lo, uint32_t slot_lo,
                                           uint32_t key_hi,
                                           const uint32_t* row, int slot,
                                           int32_t& res) {
  if (slot_lo == key_lo && __ldg(row + kSlots + slot) == key_hi)
    res = static_cast<int32_t>(__ldg(row + 2 * kSlots + slot));
}

// The payload stored under (lo, hi), or -1 when the key is absent.
__device__ __forceinline__ int32_t probe_wide_key(
    const uint32_t* __restrict__ table, uint32_t row_mask, uint32_t lo,
    uint32_t hi, uint32_t salt, int max_probes) {
  uint32_t b = fmix32(lo ^ fmix32(hi ^ salt)) & row_mask;
  int32_t res = -1;
  for (int probe = 0; probe < max_probes && res < 0; ++probe) {
    const uint32_t* row = table + static_cast<size_t>(b) * kRowWords;
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
#pragma unroll
    for (int v = 0; v < kSlots / 4; ++v) {
      const uint4 w = __ldg(row4 + v);
      match_slot(lo, w.x, hi, row, 4 * v + 0, res);
      match_slot(lo, w.y, hi, row, 4 * v + 1, res);
      match_slot(lo, w.z, hi, row, 4 * v + 2, res);
      match_slot(lo, w.w, hi, row, 4 * v + 3, res);
    }
    b = (b + 1) & row_mask;
  }
  return res;
}

}  // namespace kan
