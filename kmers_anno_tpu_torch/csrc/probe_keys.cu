// Key lookup of the mesh's table shards: every valid packed key (lo, hi)
// of a flat array looked up in one 8-slot bucket table.
//
// Replaces kmers_anno_tpu/ops/hashtable.py · probe_table (:186), an XLA
// kernel on the TPU, as the mesh steps call it (parallel/mesh.py:223 in the
// broadcast-sharded step, :343 on the keys a routed step's owner receives).
// Plain version: ops/hashtable.probe_table, through ops/probe_keys.
//
// The function: key i's output is -1 unless it is valid; a valid key gives
// the payload stored under (lo[i], hi[i]), or -1.  Validity is valid[i]
// when the caller passes a flag array, else lo[i] != EMPTY (0xFFFFFFFF),
// as for a routed buffer, whose empty slots hold EMPTY and whose packed
// keys are below 2^30.  The payload word comes back untouched (fp16 << 16 |
// role in a weighted table).  The keys arrive packed, in any order: after
// the routed exchange they lie in owner-bucket order, so this kernel reads
// no codes and needs no segment order, unlike the flat apply kernels.
//
// What bounds it on this card: the table reads.  A key reads its 32-byte
// lo-key sector at a random bucket (a hit also its hi key and payload),
// and a shard of a 10M-key table is 100-400 MB, past the 50 MB L2.  The
// design for this first port is the simple one: one thread a key, the
// shard's key filter (key_filter.cuh), when given, in front of the walk of
// kan::probe_bucket_key (bucket_probe.cuh), which wraps from the last
// bucket to bucket 0.  The filter answers most misses from an array a
// fifth of the lo-key sectors' size.

#include <cstdint>
#include <cuda_runtime.h>

#include "bucket_probe.cuh"
#include "key_filter.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
probe_keys_kernel(const uint32_t* __restrict__ table, uint32_t mask,
                  int max_probes, kan::KeyFilter f,
                  const uint32_t* __restrict__ lo,
                  const uint32_t* __restrict__ hi,
                  const uint8_t* __restrict__ valid, int64_t n,
                  int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t l = __ldg(lo + i);
  const bool v = valid ? __ldg(valid + i) != 0 : l != kan::kEmptyKey;
  int32_t r = -1;
  if (v) {
    const uint32_t h = __ldg(hi + i);
    if (kan::may_hold(f, l, h))
      r = kan::probe_bucket_key(table, mask, l, h, max_probes);
  }
  out[i] = r;
}

}  // namespace

// table: (n_buckets, 24) 32-bit words, n_buckets a power of two, 16-byte
// aligned; filter: (n_sectors, 8) 32-bit words (ops/key_filter.py),
// 16-byte aligned, or null (no filter); lo / hi: (n,) 32-bit keys; valid:
// (n,) bytes, or null (valid where lo != EMPTY); out: (n,) int32, written.
extern "C" int kan_probe_keys(const int32_t* table, int64_t n_buckets,
                              int max_probes, const int32_t* filter,
                              int64_t n_sectors, const int32_t* lo,
                              const int32_t* hi, const uint8_t* valid,
                              int64_t n, int32_t* out, void* stream) {
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) /
                                                  kThreads);
    probe_keys_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const uint32_t*>(table),
        static_cast<uint32_t>(n_buckets - 1), max_probes,
        kan::make_key_filter(filter, n_sectors),
        reinterpret_cast<const uint32_t*>(lo),
        reinterpret_cast<const uint32_t*>(hi), valid, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
