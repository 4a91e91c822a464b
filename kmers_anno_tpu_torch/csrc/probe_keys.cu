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
// when the caller passes a flag array, else lo[i] != EMPTY (0xFFFFFFFF);
// packed keys are below 2^30, so a live key is never EMPTY.  The payload
// word comes back untouched (fp16 << 16 | role in a weighted table).  The
// keys arrive packed, in any order: after the routed exchange they lie in
// owner order, so this kernel reads no codes and needs no segment order,
// unlike the flat apply kernels.
//
// Its inputs: the routed step's keys, dense since the exchange sends each
// owner only its live keys (parallel/mesh.exchange_keys), and the
// broadcast step's window stream with flags (57% live on a genome row of
// the mesh cell: the stream is padded to its width bucket).
//
// What bounds it on this card: the table's sectors.  A valid key reads its
// filter sector (key_filter.cuh; the filter of a shard fits the L2), then
// the 32-byte lo-key sector of a random bucket of a shard of 100-400 MB,
// and a hit also its hi-key and payload sectors.  On a routed 2x2 member's
// 4,797,979 keys those are 5,122,852 bucket reads and 1,850,088 hits, 282
// MB of 32-byte sectors beside the 58 MB of keys and outputs: at the
// kernel's 0.1020 ms, 3.3 TB/s, the card's memory rate, unless the L2
// serves the buckets that several keys read (PERF.md, Findings; NVIDIA
// H100 80GB HBM3, 700 W).  The design is the simple one: one
// thread a key, the filter, the walk of kan::probe_bucket_key
// (bucket_probe.cuh), which wraps from the last bucket to bucket 0.
//
// What was measured against it, in turns on one card: designs that keep
// every resident thread on a live key lost on every input, because the
// dead slots were never what held it back (the sectors were).  Tiles of
// 2,048 slots a block staged by cp.async, double buffered, compacted in
// shared memory on a persistent grid (commit 8dd582c): 1.7-2.0x slower;
// a warp's own tiles of 256 or 128 slots (commit b3a3f95): 1.1-2.1x; a
// warp's compaction from registers through 5 KB of shared memory (commit
// e70ba1d): 1.06-1.13x.  The gain went to the exchange instead: the
// routed member's lookup on its dense keys takes 0.1020 ms against 0.1491
// on the padded buffer the exchange sent before, 71% empty slots.

#include <cstdint>
#include <cuda_runtime.h>

#include "bucket_probe.cuh"
#include "key_filter.cuh"

namespace {

constexpr int kThreads = 256;   // keys a block: ops/probe_keys.KERNEL_TILE

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
