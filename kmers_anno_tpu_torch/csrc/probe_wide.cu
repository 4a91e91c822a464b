// Wide-bucket table probe: one query key -> stored payload or -1.
//
// Replaces kmers_anno_tpu/ops/widetable.py · probe_wide (an XLA gather on
// the TPU).  Table layout, as built by build_wide_table: rows of 72 uint32
// words, [24 lo keys | 24 hi keys | 24 payloads], EMPTY = 0xFFFFFFFF; the
// home row of a key is fmix32(lo ^ fmix32(hi ^ salt)) & (rows - 1) and a
// key that overflowed its home row sits in one of the next max_probes - 1
// rows (wrapping).  Keys are unique, so at most one slot matches.
//
// What bounds it: memory latency.  Each valid query reads one random
// 288-byte row (96 bytes of lo keys, then 4-byte hi / payload words only
// for a slot whose lo matches), so the kernel is a random gather; the
// arithmetic is two fmix32 and 24 compares.  Design: one thread per query,
// the 24 lo keys read as six 16-byte vector loads through the read-only
// cache; an invalid query writes -1 without touching the table.  The
// TPU's lane-major (Q/128, 72, 128) retile of gathered rows is a VPU
// trick with no counterpart here, and no (Q, 72) row buffer is ever
// materialised in device memory, which the plain version must do.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
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

__device__ __forceinline__ void match(uint32_t key_lo, uint32_t slot_lo,
                                      uint32_t key_hi, const uint32_t* row,
                                      int slot, int32_t& res) {
  if (slot_lo == key_lo && __ldg(row + kSlots + slot) == key_hi)
    res = static_cast<int32_t>(__ldg(row + 2 * kSlots + slot));
}

__global__ void __launch_bounds__(kThreads)
probe_wide_kernel(const uint32_t* __restrict__ table, uint32_t row_mask,
                  const uint32_t* __restrict__ q_lo,
                  const uint32_t* __restrict__ q_hi,
                  const uint8_t* __restrict__ valid, int64_t q,
                  uint32_t salt, int max_probes,
                  int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= q) return;
  if (!valid[i]) {
    out[i] = -1;
    return;
  }
  const uint32_t l = q_lo[i], h = q_hi[i];
  uint32_t b = fmix32(l ^ fmix32(h ^ salt)) & row_mask;
  int32_t res = -1;
  for (int probe = 0; probe < max_probes && res < 0; ++probe) {
    const uint32_t* row = table + static_cast<size_t>(b) * kRowWords;
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
#pragma unroll
    for (int v = 0; v < kSlots / 4; ++v) {
      const uint4 w = __ldg(row4 + v);
      match(l, w.x, h, row, 4 * v + 0, res);
      match(l, w.y, h, row, 4 * v + 1, res);
      match(l, w.z, h, row, 4 * v + 2, res);
      match(l, w.w, h, row, 4 * v + 3, res);
    }
    b = (b + 1) & row_mask;
  }
  out[i] = res;
}

}  // namespace

// table: (n_rows, 72) 32-bit words, n_rows a power of two, 16-byte aligned;
// q_lo / q_hi: (q,) 32-bit keys; valid: (q,) bytes; out: (q,) int32.
extern "C" int kan_probe_wide(const int32_t* table, int64_t n_rows,
                              const int32_t* q_lo, const int32_t* q_hi,
                              const uint8_t* valid, int64_t q, uint32_t salt,
                              int max_probes, int32_t* out, void* stream) {
  const int64_t blocks = (q + kThreads - 1) / kThreads;
  probe_wide_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(table),
      static_cast<uint32_t>(n_rows - 1),
      reinterpret_cast<const uint32_t*>(q_lo),
      reinterpret_cast<const uint32_t*>(q_hi), valid, q, salt, max_probes,
      out);
  return static_cast<int>(cudaGetLastError());
}
