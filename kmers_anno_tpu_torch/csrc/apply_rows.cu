// Row-layout unanimity apply step, fused: for every protein row, pack each
// valid kmer window, look it up in the wide-bucket table and reduce the hits
// to the row's called role and hit count.
//
// Replaces kmers_anno_tpu/engine/apply_engine.py · apply_rows, an XLA fusion
// on the TPU of ops/kmers.pack_kmer_windows (5 bits per residue, residues
// 0..5 in lo and 6..11 in hi), ops/widetable.probe_wide and
// ops/vote.unanimous_vote.  Output, as there: role = the unanimous role when
// the row has >= min_hits hits that all agree, else -1; count = the hit
// count of a unanimous row (even below min_hits), else 0.
//
// What bounds it on this card: the table lookups' reads from the L2 cache.
// The codes and the mask are read once (k bytes a window through L1), the
// output is 8 bytes a row, and each valid window's lookup reads its row's
// three 32-byte sectors of lo keys from L2, where the 1M-key table (37.7 MB)
// stays (wide_probe.cuh).  The unfused composition also writes and re-reads
// the (rows, width) lo, hi and role arrays, which this kernel keeps in
// registers.
//
// Design: one warp per row.  The lanes stride over the row's window
// positions; a lane packs its window from the codes, probes only when the
// window is valid, and keeps (hits, min role, max role).  Three warp
// reductions give the row's totals and lane 0 writes them.  Any width works
// (a window reaching past the row end reads the pad code, as the plain
// version does); a row with no valid window gets role -1 and count 0.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "wide_probe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
apply_rows_kernel(const uint32_t* __restrict__ table, uint32_t row_mask,
                  const uint8_t* __restrict__ codes,
                  const uint8_t* __restrict__ valid, int64_t n_rows,
                  int64_t width, int k, uint32_t pad, uint32_t salt,
                  int max_probes, int min_hits,
                  int32_t* __restrict__ role_out,
                  int32_t* __restrict__ count_out) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // row is warp-uniform: whole warps leave
  const uint8_t* c = codes + row * width;
  const uint8_t* v = valid + row * width;
  int hits = 0;
  int rmin = INT_MAX;
  int rmax = -1;
  for (int64_t p = lane; p < width; p += 32) {
    if (!__ldg(v + p)) continue;
    uint32_t lo = 0, hi = 0;
    for (int j = 0; j < k; ++j) {
      const uint32_t code = p + j < width ? __ldg(c + p + j) : pad;
      if (j < 6)
        lo |= code << (5 * j);
      else
        hi |= code << (5 * (j - 6));
    }
    const int32_t r =
        kan::probe_wide_key(table, row_mask, lo, hi, salt, max_probes);
    if (r >= 0) {
      ++hits;
      rmin = min(rmin, r);
      rmax = max(rmax, r);
    }
  }
  hits = __reduce_add_sync(kFullMask, hits);
  rmin = __reduce_min_sync(kFullMask, rmin);
  rmax = __reduce_max_sync(kFullMask, rmax);
  if (lane == 0) {
    const bool unanimous = hits > 0 && rmin == rmax;
    role_out[row] = unanimous && hits >= min_hits ? rmax : -1;
    count_out[row] = unanimous ? hits : 0;
  }
}

}  // namespace

// table: (n_table_rows, 72) 32-bit words, n_table_rows a power of two,
// 16-byte aligned; codes / valid: (n_rows, width) bytes, row-major;
// role / count: (n_rows,) int32.  k in 1..12; pad is the code read past a
// row's end.
extern "C" int kan_apply_rows(const int32_t* table, int64_t n_table_rows,
                              const uint8_t* codes, const uint8_t* valid,
                              int64_t n_rows, int64_t width, int k, int pad,
                              uint32_t salt, int max_probes, int min_hits,
                              int32_t* role, int32_t* count, void* stream) {
  const int64_t blocks = (n_rows + kWarps - 1) / kWarps;
  apply_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(table),
      static_cast<uint32_t>(n_table_rows - 1), codes, valid, n_rows, width, k,
      static_cast<uint32_t>(pad), salt, max_probes, min_hits, role, count);
  return static_cast<int>(cudaGetLastError());
}
