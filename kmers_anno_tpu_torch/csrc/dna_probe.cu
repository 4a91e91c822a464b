// DNA window probe: for every window start of a flat DNA code stream (the
// two strands of every contig of a genome back to back), pack its k-mer in
// 2 bits a base and look it up in the 8-slot bucket table.
//
// Replaces kmers_anno_tpu/engine/dna_apply.py · probe_dna_flat (:48-58), an
// XLA kernel on the TPU: ops/dna_kmers.pack_dna_windows, then
// ops/hashtable.probe_table.  Plain version: ops/dna_probe.probe_dna_plain.
//
// kan_dna_probe: one thread a window start, the threads of a grid-stride
// loop on consecutive starts.  A thread reads its validity flag; an invalid
// window writes -1 and reads nothing more.  The host's flag is the only
// test: a window that crosses from one strand or contig into the next holds
// only unambiguous codes and is still invalid, so validity is never derived
// from the codes.  A valid window packs lo = (1 << 2k) | sum((c_j & 3) <<
// 2j) over codes[i .. i+k-1] (a code at or past the stream's end reads 0,
// as the plain version's padding does, so no read leaves the stream), hi =
// 0, and walks the table with kan::probe_bucket_key (bucket_probe.cuh); it
// writes the payload found or -1.  k is 4..15, so lo < 2^31.
//
// What bounds it on this card: the walk.  Each valid window reads its home
// bucket's 32-byte lo-key sector at a random place in the table; a table of
// a few million keys (100-200 MB) lies past the 50 MB L2, so most windows,
// which miss, wait on one read from device memory, and the bytes that the
// function needs (a flag, a code and an output a window, a sector a
// distinct bucket) are far fewer than the sectors the walks fetch.  A
// window's codes are its neighbours', read through L1; each thread packs
// its k codes anew (no rolling pack) and has one lookup in flight.  The
// simple design: a rolling pack, several windows a thread and the key
// filter of apply_flat.cu in front of the walk are left for the kernel's
// redesign.

#include <cstdint>
#include <cuda_runtime.h>

#include "bucket_probe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 64;   // 64 blocks an SM fill the grid-stride

__global__ void __launch_bounds__(kThreads)
dna_probe_kernel(const uint32_t* __restrict__ table, uint32_t mask,
                 int max_probes, const uint8_t* __restrict__ codes,
                 const uint8_t* __restrict__ valid, int64_t n_windows, int k,
                 int32_t* __restrict__ out) {
  const uint32_t marker = 1u << (2 * k);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_windows; i += stride) {
    int32_t payload = -1;
    if (__ldg(valid + i)) {
      uint32_t lo = marker;
      for (int j = 0; j < k; ++j) {
        const uint32_t code = i + j < n_windows ? __ldg(codes + i + j) : 0u;
        lo |= (code & 3u) << (2 * j);
      }
      payload = kan::probe_bucket_key(table, mask, lo, 0u, max_probes);
    }
    out[i] = payload;
  }
}

}  // namespace

// table: (n_buckets, 24) 32-bit words, n_buckets a power of two, 16-byte
// aligned; codes / valid: (n_windows,) bytes; out: (n_windows,) int32,
// written.  k in 4..15.
extern "C" int kan_dna_probe(const int32_t* table, int64_t n_buckets,
                             int max_probes, const uint8_t* codes,
                             const uint8_t* valid, int64_t n_windows, int k,
                             int32_t* out, void* stream) {
  if (n_windows > 0) {
    const int64_t want = (n_windows + kThreads - 1) / kThreads;
    const unsigned blocks =
        static_cast<unsigned>(want < kMaxBlocks ? want : kMaxBlocks);
    dna_probe_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const uint32_t*>(table),
        static_cast<uint32_t>(n_buckets - 1), max_probes, codes, valid,
        n_windows, k, out);
  }
  return static_cast<int>(cudaGetLastError());
}
