// Wide-bucket table probe: one query key -> stored payload or -1.
//
// Replaces kmers_anno_tpu/ops/widetable.py · probe_wide (an XLA gather on
// the TPU).  The table layout and the lookup are in wide_probe.cuh.
//
// What bounds it on this card: the L2 cache.  A query reads 9 bytes and
// writes 4 (from and to device memory, coalesced), and its lookup reads its
// row's three 32-byte sectors of lo keys from L2, where the main path's
// tables (37.7 MB or less) stay; the rate is the lookups' reads in flight
// against L2's latency (wide_probe.cuh).  Design: one thread per query; an
// invalid query writes -1 without touching the table.  The TPU's lane-major
// (Q/128, 72, 128) retile of gathered rows is a VPU trick with no
// counterpart here, and no (Q, 72) row buffer is ever materialised in
// device memory, which the plain version must do.

#include <cstdint>
#include <cuda_runtime.h>

#include "wide_probe.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
probe_wide_kernel(const uint32_t* __restrict__ table, uint32_t row_mask,
                  const uint32_t* __restrict__ q_lo,
                  const uint32_t* __restrict__ q_hi,
                  const uint8_t* __restrict__ valid, int64_t q,
                  uint32_t salt, int max_probes,
                  int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= q) return;
  out[i] = valid[i] ? kan::probe_wide_key(table, row_mask, q_lo[i], q_hi[i],
                                          salt, max_probes)
                    : -1;
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
