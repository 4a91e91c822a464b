// DNA window probe: for every window start of a flat DNA code stream (the
// two strands of every contig of a genome back to back), pack its k-mer in
// 2 bits a base and look it up in the 8-slot bucket table.
//
// Replaces kmers_anno_tpu/engine/dna_apply.py · probe_dna_flat (:48-58), an
// XLA kernel on the TPU: ops/dna_kmers.pack_dna_windows, then
// ops/hashtable.probe_table.  Plain version: ops/dna_probe.probe_dna_plain.
//
// The function: window i's output is -1 unless valid[i]; a valid window
// packs lo = (1 << 2k) | sum((codes[i+j] & 3) << 2j), j < k (a code at or
// past the stream's end reads 0, as the plain version pads), hi = 0, and
// gives the payload stored under (lo, 0), or -1.  The host's flag is the
// only test of validity: a window that crosses from one strand or contig
// into the next holds only unambiguous codes and is still invalid.  The
// payload word comes back untouched (fp16 << 16 | role in a weighted
// table).  k is 4..15, so lo < 2^31.
//
// What bounds it on this card: the table reads.  A contig's windows mostly
// miss (about 15,000 hits in 8.4M windows of a random 4 Mb contig), so
// nearly every valid window reads one 32-byte lo-key sector at a random
// bucket and stops at a free slot; a hit also reads its hi key and
// payload.  The bytes the function needs (a code, a flag and an output a
// window, a sector a distinct bucket) are far fewer than the sectors the
// lookups fetch.  A 2M-key table's lo-key sectors take 16.8 MB and a 3.7M-
// key table's 33.5 MB of the 50 MB L2, and those reads set the time; the
// key filter in front of the lookup answers almost every miss from a
// filter a quarter that size.  The design:
//
//  * A tile a block.  Each block of kThreads threads takes kTile
//    consecutive window starts.  It stages the tile's codes plus the k-1
//    halo, and the tile's flags, into shared memory with 16-byte loads from
//    the 16-byte boundary at or below the tile (the wrapper takes any
//    contiguous tensor, a slice at any byte offset included); vectors that
//    cross either end of the stream are filled byte by byte, code 0 and
//    flag 0 outside it.
//  * A rolling pack.  Each thread takes a run of kRun consecutive windows.
//    It packs the run's kRun + k - 1 codes once, 2 bits a base, into one
//    64-bit word; window i's key is that word shifted right by 2i, cut to
//    2k bits, with the marker set.  So each next window shifts one new code
//    in (lo' = ((lo & ~marker) >> 2) | (c << 2(k-1)) | marker), and a code
//    is read from shared memory once a run, not k times.  The key rolls
//    through invalid windows; only valid ones probe.
//  * The key filter (key_filter.cuh), kan_dna_probe_filtered only: a valid
//    window whose filter sector lacks one of its bits is a miss and reads
//    no bucket.  Then the walk of kan::probe_bucket_key (bucket_probe.cuh),
//    which wraps from the last bucket to bucket 0, one window at a time.
//  * Coalesced writes.  A run of 4 windows is one 16-byte store of its
//    payloads, neighbouring threads on neighbouring addresses, so a warp
//    writes 512 contiguous bytes (a 4-byte store a window where the output
//    is not 16-byte aligned or the run crosses the stream's end).
//
// What was measured against it (PERF.md, Findings, PR 11; NVIDIA H100 80GB
// HBM3, 700 W): the filter takes a 4 Mb contig's probe from 0.133 to 0.072
// ms on a 2M-key table and from 0.234 to 0.131 ms on a 3.7M-key one.  Runs
// of 8 or 16 windows, 256-thread blocks, 2 or 4 home-bucket reads issued
// before any compare, and the payloads staged in shared memory for the
// tile's write all ran slower (commit cdcfd7d): extra registers cost more
// threads than the reads in flight gained.  The simple design with the
// filter (commit 6c1eee2) ran 1.5x slower on the 2M-key table, where the
// filter answers nearly every window and the pack is most of the work,
// and 1% faster on the 3.7M-key one, whose 16% hits walk the table.
// ptxas: 31 registers a thread, 1,072 bytes of shared memory a block, no
// stack frame.

#include <cstdint>
#include <cuda_runtime.h>

#include "bucket_probe.cuh"
#include "key_filter.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRun = 4;                    // consecutive windows a thread
constexpr int kTile = kThreads * kRun;     // windows a block: 512
constexpr int kMaxK = 15;
// normalised code words a run packs: its kRun + k - 1 codes
constexpr int kRunWords = (kRun + kMaxK - 1 + 3) / 4;
// staged words: up to 15 bytes before the tile, then the words the last
// run reads (one more than it packs, for the funnel shift)
constexpr int kCodeWords = (15 + kTile - kRun) / 4 + kRunWords + 1;
constexpr int kFlagWords = (15 + kTile - kRun) / 4 + kRun / 4 + 1;
constexpr int kCodeVecs = (kCodeWords + 3) / 4;
constexpr int kFlagVecs = (kFlagWords + 3) / 4;
static_assert(kRun % 4 == 0 && kRun + kMaxK - 1 <= 32,
              "a run's codes fill at most one 64-bit word");

struct Walk {
  const uint32_t* table;
  uint32_t mask;
  int max_probes;
};

// Stage n_vecs 16-byte vectors of src, starting at stream byte g0 (16-byte
// aligned in memory), into dst; bytes outside [0, n) read 0.
__device__ __forceinline__ void stage(uint4* __restrict__ dst,
                                      const uint8_t* __restrict__ src,
                                      int64_t g0, int64_t n, int n_vecs) {
  for (int v = threadIdx.x; v < n_vecs; v += kThreads) {
    const int64_t g = g0 + 16 * v;
    uint4 q;
    if (g >= 0 && g + 16 <= n) {
      q = __ldg(reinterpret_cast<const uint4*>(src + g));
    } else {                       // crosses an end of the stream
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int64_t x = g + 4 * i + b;
          const uint32_t c = (x >= 0 && x < n) ? src[x] : 0u;
          word |= c << (8 * b);
        }
        w[i] = word;
      }
      q = make_uint4(w[0], w[1], w[2], w[3]);
    }
    dst[v] = q;
  }
}

// 16 blocks an SM: every thread of the SM resident, 32 registers each
template <bool kFiltered>
__global__ void __launch_bounds__(kThreads, 16)
dna_probe_kernel(Walk w, kan::KeyFilter f, const uint8_t* __restrict__ codes,
                 const uint8_t* __restrict__ valid, int64_t n, int k,
                 int32_t* __restrict__ out) {
  __shared__ uint4 s_codes[kCodeVecs];
  __shared__ uint4 s_flags[kFlagVecs];

  const int tid = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  // staged byte i is stream byte base - shift + i
  const int cshift =
      static_cast<int>(reinterpret_cast<uintptr_t>(codes) & 15);
  const int vshift =
      static_cast<int>(reinterpret_cast<uintptr_t>(valid) & 15);
  stage(s_codes, codes, base - cshift, n, kCodeVecs);
  stage(s_flags, valid, base - vshift, n, kFlagVecs);
  __syncthreads();

  // the run's codes, 2 bits each: code j of the run at bits 2j
  const int c0 = cshift + kRun * tid;
  const uint32_t* sc = reinterpret_cast<const uint32_t*>(s_codes) + (c0 >> 2);
  const uint32_t cfs = 8 * (c0 & 3);
  uint64_t packed = 0;
#pragma unroll
  for (int m = 0; m < kRunWords; ++m) {
    const uint32_t x = __funnelshift_r(sc[m], sc[m + 1], cfs) & 0x03030303u;
    uint32_t y = (x | (x >> 6)) & 0x000F000Fu;
    y = (y | (y >> 12)) & 0xFFu;
    packed |= static_cast<uint64_t>(y) << (8 * m);
  }
  // bit i: window i of the run is valid (a non-zero flag byte)
  const int v0 = vshift + kRun * tid;
  const uint32_t* sv = reinterpret_cast<const uint32_t*>(s_flags) + (v0 >> 2);
  const uint32_t vfs = 8 * (v0 & 3);
  uint32_t live = 0;
#pragma unroll
  for (int m = 0; m < kRun / 4; ++m) {
    const uint32_t x = __funnelshift_r(sv[m], sv[m + 1], vfs);
    const uint32_t nz = ((((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) >> 7) &
                        0x01010101u;
    live |= ((nz * 0x10204080u) >> 28) << (4 * m);
  }

  const uint32_t marker = 1u << (2 * k);
  const uint32_t key_mask = marker - 1;
  const uint32_t lo_word = static_cast<uint32_t>(packed);
  const uint32_t hi_word = static_cast<uint32_t>(packed >> 32);
  int32_t res[kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    const uint32_t lo =
        (__funnelshift_r(lo_word, hi_word, 2 * i) & key_mask) | marker;
    res[i] = ((live >> i) & 1u) && (!kFiltered || kan::may_hold(f, lo, 0u))
                 ? kan::probe_bucket_key(w.table, w.mask, lo, 0u,
                                         w.max_probes)
                 : -1;
  }
  // the run's payloads: one 16-byte store a run when the output is aligned
  // and the run lies inside the stream
  const int64_t p0 = base + kRun * tid;
  if (p0 + kRun <= n && !(reinterpret_cast<uintptr_t>(out) & 15)) {
#pragma unroll
    for (int q = 0; q < kRun / 4; ++q)
      reinterpret_cast<int4*>(out + p0)[q] = make_int4(
          res[4 * q], res[4 * q + 1], res[4 * q + 2], res[4 * q + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i)
      if (p0 + i < n) out[p0 + i] = res[i];
  }
}

template <bool kFiltered>
int launch(const int32_t* table, int64_t n_buckets, int max_probes,
           kan::KeyFilter f, const uint8_t* codes, const uint8_t* valid,
           int64_t n_windows, int k, int32_t* out, void* stream) {
  if (n_windows > 0) {
    const unsigned blocks =
        static_cast<unsigned>((n_windows + kTile - 1) / kTile);
    dna_probe_kernel<kFiltered><<<blocks, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        Walk{reinterpret_cast<const uint32_t*>(table),
             static_cast<uint32_t>(n_buckets - 1), max_probes},
        f, codes, valid, n_windows, k, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table: (n_buckets, 24) 32-bit words, n_buckets a power of two, 16-byte
// aligned; codes / valid: (n_windows,) bytes, any alignment; out:
// (n_windows,) int32, written.  k in 4..15.
extern "C" int kan_dna_probe(const int32_t* table, int64_t n_buckets,
                             int max_probes, const uint8_t* codes,
                             const uint8_t* valid, int64_t n_windows, int k,
                             int32_t* out, void* stream) {
  return launch<false>(table, n_buckets, max_probes,
                       kan::make_key_filter(nullptr, 0), codes, valid,
                       n_windows, k, out, stream);
}

// As kan_dna_probe, with the table's key filter in front of the lookup:
// filter: (n_sectors, 8) 32-bit words (ops/key_filter.py), n_sectors >= 1,
// 16-byte aligned.
extern "C" int kan_dna_probe_filtered(const int32_t* table, int64_t n_buckets,
                                      int max_probes, const int32_t* filter,
                                      int64_t n_sectors, const uint8_t* codes,
                                      const uint8_t* valid, int64_t n_windows,
                                      int k, int32_t* out, void* stream) {
  return launch<true>(table, n_buckets, max_probes,
                      kan::make_key_filter(filter, n_sectors), codes, valid,
                      n_windows, k, out, stream);
}
