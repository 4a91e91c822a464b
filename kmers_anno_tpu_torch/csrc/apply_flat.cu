// Flat-stream apply step over the 8-slot bucket table: for every token of a
// stream of proteins (codes, segment id, window validity), pack its kmer
// window, walk the table and vote per protein.
//
// Replaces kmers_anno_tpu/engine/apply_engine.py · apply_flat (:61-101) and
// apply_weighted_flat (:104-128) with the segmented votes of ops/vote.py
// (weighted_vote_dense :123-144, weighted_vote_chunked :195-234), XLA
// kernels on the TPU that pack, probe the table (ops/hashtable.probe_table,
// or past 48 MB the sort-and-stream ops/sliced_probe.probe_table_sliced on
// a probe-window copy of it) and reduce by segment.  Here every table is
// walked in its plain layout: the walk leaves its home bucket for under 1%
// of lookups, so the probe window saves next to nothing.  Plain versions:
// ops/apply_flat.py.
//
// kan_apply_flat (the unanimity vote): one thread a token, the warps of a
// grid-stride loop over the stream, each on 32 consecutive tokens.  A thread
// packs codes[t .. t+k-1] (5 bits a residue, residues 0..5 in lo and 6..11
// in hi; positions at or past T read the pad code), walks the table
// (bucket_probe.cuh) and, on a hit of a protein below n_seqs, counts it
// with its role into three int32 arrays: hits (add), min role and max
// role.  A protein's tokens are contiguous, so a warp's hits
// belong to one or two proteins: the lanes of the first and of the last
// hit's protein each reduce to one atomicAdd, atomicMin and atomicMax; any
// other hit adds alone.  Integer atomics are order-free, so the result is
// exact.  A finalize pass calls role = max role and keeps the count when the
// protein has hits, min == max and at least min_hits of them; otherwise role
// -1 and count 0 (unlike the row vote, which keeps the count of a unanimous
// row below min_hits).
//
// kan_apply_flat_weighted: the same pack and walk; a hit's payload is
// fp16_bits(weight) << 16 | role.  The weight, a non-negative fp16, is a
// whole number of 2^-24 units below 2^40, decoded from its bits; a hit whose
// role lies in [role_base, role_base + r_blk) adds its units to the int64
// cell (protein, role - role_base) of a dense tally block, with the same
// two-group warp merge (each lane's units split in 20-bit halves, so that a
// warp sum fits 32 bits).  Integer sums are exact in any order.  A row pass
// then takes each protein's block row: every cell converted once to float32
// (times 2^-24), the first maximum, merged into the running best only when
// strictly greater (from tally 0 and role -1), and the row's non-zero cells
// cleared, so the next block starts from zeros.  After the last block it
// calls the best role when its tally is >= min_weight and > 0.  Equal
// tallies call the smaller role, in any number of blocks.
//
// What bounds them on this card: the table lookups.  A 10M-key table is
// about 403 MB, eight times the 50 MB L2, so a miss reads its home bucket's
// lo keys (one 32-byte sector) from device memory; hits of a role's kmers
// recur across proteins and stay in L2.  The stream is read once (code and
// flag bytes, coalesced), and the votes are a few merged atomics a warp.
// The weighted step walks the table once for each role block, and its row
// pass reads the whole block (at most 2^25 int64 cells, 256 MiB).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bucket_probe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 64;   // 64 blocks an SM fill the grid-stride
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr float kUnit = 1.0f / 16777216.0f;   // 2^-24

struct Walk {
  const uint32_t* table;
  uint32_t mask;
  int max_probes;
};

struct Stream {
  const uint8_t* codes;
  const int32_t* seg_ids;
  const uint8_t* valid;
  int64_t n_tokens;
  int k;
  uint32_t pad;
};

// The payload of token t's kmer window, or -1 (an invalid window, a miss).
__device__ __forceinline__ int32_t lookup(const Walk& w, const Stream& s,
                                          int64_t t) {
  if (t >= s.n_tokens || !__ldg(s.valid + t)) return -1;
  uint32_t lo = 0, hi = 0;
  for (int j = 0; j < s.k; ++j) {
    const uint32_t code =
        t + j < s.n_tokens ? __ldg(s.codes + t + j) : s.pad;
    if (j < 6)
      lo |= code << (5 * j);
    else
      hi |= code << (5 * (j - 6));
  }
  return kan::probe_bucket_key(w.table, w.mask, lo, hi, w.max_probes);
}

// token t's protein, or -1 when it lies at or past n_seqs (padding)
__device__ __forceinline__ int32_t segment_of(const Stream& s, int64_t t,
                                              int32_t n_seqs) {
  const int32_t seg = __ldg(s.seg_ids + t);
  return static_cast<uint32_t>(seg) < static_cast<uint32_t>(n_seqs) ? seg
                                                                    : -1;
}

__global__ void __launch_bounds__(kThreads)
flat_init_kernel(int32_t n_seqs, int32_t* hits, int32_t* rmin,
                 int32_t* rmax) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n_seqs) {
    hits[i] = 0;
    rmin[i] = INT_MAX;
    rmax[i] = -1;
  }
}

// the hits of the lanes in `in` (all of protein seg), counted once by
// `leader`
__device__ __forceinline__ void merge_unanimous(bool in, int32_t seg,
                                                int32_t role, int leader,
                                                int32_t* hits, int32_t* rmin,
                                                int32_t* rmax) {
  const int n = __popc(__ballot_sync(kFullMask, in));
  const int mn = __reduce_min_sync(kFullMask, in ? role : INT_MAX);
  const int mx = __reduce_max_sync(kFullMask, in ? role : -1);
  if ((threadIdx.x & 31) == leader) {
    atomicAdd(hits + seg, n);
    atomicMin(rmin + seg, mn);
    atomicMax(rmax + seg, mx);
  }
}

__global__ void __launch_bounds__(kThreads)
flat_unanimous_kernel(Walk w, Stream s, int32_t n_seqs, int32_t* hits,
                      int32_t* rmin, int32_t* rmax) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  // the loop bound is warp-uniform, so every lane reaches every merge
  for (int64_t base = warp * 32; base < s.n_tokens; base += n_warps * 32) {
    const int64_t t = base + lane;
    const int32_t role = lookup(w, s, t);
    const int32_t seg = role >= 0 ? segment_of(s, t, n_seqs) : -1;
    const unsigned hit = __ballot_sync(kFullMask, seg >= 0);
    if (!hit) continue;
    const int first = __ffs(hit) - 1;
    const int last = 31 - __clz(hit);
    const int32_t seg_a = __shfl_sync(kFullMask, seg, first);
    const int32_t seg_b = __shfl_sync(kFullMask, seg, last);
    const bool in_a = seg >= 0 && seg == seg_a;
    const bool in_b = seg >= 0 && seg == seg_b && !in_a;
    merge_unanimous(in_a, seg_a, role, first, hits, rmin, rmax);
    if (seg_b != seg_a)
      merge_unanimous(in_b, seg_b, role, last, hits, rmin, rmax);
    if (seg >= 0 && !in_a && !in_b) {
      atomicAdd(hits + seg, 1);
      atomicMin(rmin + seg, role);
      atomicMax(rmax + seg, role);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flat_finalize_kernel(int32_t n_seqs, int32_t min_hits, int32_t* hits,
                     const int32_t* rmin, int32_t* rmax) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n_seqs) {
    const int32_t n = hits[i];
    const bool called = n > 0 && rmin[i] == rmax[i] && n >= min_hits;
    if (!called) {
      hits[i] = 0;
      rmax[i] = -1;
    }
  }
}

// A non-negative fp16 weight's value in units of 2^-24: m for a subnormal
// (exponent field 0), (1024 + m) << (e - 1) otherwise; below 2^40.
__device__ __forceinline__ uint64_t fp16_units(uint32_t bits) {
  const uint32_t e = (bits >> 10) & 0x1Fu;
  const uint64_t m = bits & 0x3FFu;
  return e ? (1024u + m) << (e - 1) : m;
}

// the units of the lanes in `in` (all of one cell), added once by `leader`
__device__ __forceinline__ void merge_weighted(bool in, int64_t cell,
                                               uint64_t units, int leader,
                                               unsigned long long* tally) {
  const unsigned lo = __reduce_add_sync(
      kFullMask, in ? static_cast<unsigned>(units & 0xFFFFFu) : 0u);
  const unsigned hi = __reduce_add_sync(
      kFullMask, in ? static_cast<unsigned>(units >> 20) : 0u);
  if ((threadIdx.x & 31) == leader)
    atomicAdd(tally + cell,
              (static_cast<unsigned long long>(hi) << 20) + lo);
}

__global__ void __launch_bounds__(kThreads)
flat_weighted_kernel(Walk w, Stream s, int32_t n_seqs, int32_t role_base,
                     int32_t r_blk, unsigned long long* tally) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  for (int64_t base = warp * 32; base < s.n_tokens; base += n_warps * 32) {
    const int64_t t = base + lane;
    const int32_t val = lookup(w, s, t);
    int64_t cell = -1;
    uint64_t units = 0;
    if (val >= 0) {
      const int32_t role = (val & 0xFFFF) - role_base;
      const int32_t seg = segment_of(s, t, n_seqs);
      if (seg >= 0 && role >= 0 && role < r_blk) {
        cell = static_cast<int64_t>(seg) * r_blk + role;
        units = fp16_units(static_cast<uint32_t>(val) >> 16);
      }
    }
    const unsigned hit = __ballot_sync(kFullMask, cell >= 0);
    if (!hit) continue;
    const int first = __ffs(hit) - 1;
    const int last = 31 - __clz(hit);
    const int64_t cell_a = __shfl_sync(kFullMask, cell, first);
    const int64_t cell_b = __shfl_sync(kFullMask, cell, last);
    const bool in_a = cell >= 0 && cell == cell_a;
    const bool in_b = cell >= 0 && cell == cell_b && !in_a;
    merge_weighted(in_a, cell_a, units, first, tally);
    if (cell_b != cell_a) merge_weighted(in_b, cell_b, units, last, tally);
    if (cell >= 0 && !in_a && !in_b)
      atomicAdd(tally + cell, static_cast<unsigned long long>(units));
  }
}

// One warp a protein: the first maximum of its block row as float32, merged
// into (best, role) by a strictly greater tally; the row's non-zero cells
// cleared.  `first`: no earlier block (best 0, role -1); `last`: write the
// call (role or -1, tally or 0) in place.
__global__ void __launch_bounds__(kThreads)
flat_best_kernel(unsigned long long* tally, int32_t n_seqs, int32_t role_base,
                 int32_t r_blk, int first, int last, float min_weight,
                 int32_t* role, float* best) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (row >= n_seqs) return;   // row is warp-uniform: whole warps leave
  unsigned long long* cells = tally + row * r_blk;
  float top = -1.0f;
  int32_t arg = 0;
  for (int32_t c = lane; c < r_blk; c += 32) {
    const unsigned long long x = cells[c];
    if (x) cells[c] = 0;
    const float f = __ll2float_rn(static_cast<long long>(x)) * kUnit;
    if (f > top) {   // a lane's cells rise: the first maximum stays
      top = f;
      arg = c;
    }
  }
  for (int offset = 16; offset; offset >>= 1) {
    const float o_top = __shfl_down_sync(kFullMask, top, offset);
    const int32_t o_arg = __shfl_down_sync(kFullMask, arg, offset);
    if (o_top > top || (o_top == top && o_arg < arg)) {
      top = o_top;
      arg = o_arg;
    }
  }
  if (lane) return;
  float b = first ? 0.0f : best[row];
  int32_t r = first ? -1 : role[row];
  if (top > b) {
    b = top;
    r = role_base + arg;
  }
  if (last) {
    const bool called = b >= min_weight && b > 0.0f;
    b = called ? b : 0.0f;
    r = called ? r : -1;
  }
  best[row] = b;
  role[row] = r;
}

unsigned grid_for(int64_t n_tokens) {
  const int64_t want = (n_tokens + kThreads - 1) / kThreads;
  return static_cast<unsigned>(want < kMaxBlocks ? (want ? want : 1)
                                                 : kMaxBlocks);
}

Walk make_walk(const int32_t* table, int64_t n_buckets, int max_probes) {
  return Walk{reinterpret_cast<const uint32_t*>(table),
              static_cast<uint32_t>(n_buckets - 1), max_probes};
}

}  // namespace

// table: (n_buckets, 24) 32-bit words, n_buckets a power of two, 16-byte
// aligned; codes / valid: (n_tokens,) bytes; seg_ids: (n_tokens,)
// int32, a protein index or >= n_seqs for padding; role / hits / rmin:
// (n_seqs,) int32, written (rmin is scratch).  k in 1..12; pad is the code
// read past the stream's end.
extern "C" int kan_apply_flat(const int32_t* table, int64_t n_buckets,
                              int max_probes, const uint8_t* codes,
                              const int32_t* seg_ids, const uint8_t* valid,
                              int64_t n_tokens, int k, int pad,
                              int64_t n_seqs, int min_hits, int32_t* role,
                              int32_t* hits, int32_t* rmin, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned seq_blocks =
      static_cast<unsigned>((n_seqs + kThreads - 1) / kThreads);
  if (seq_blocks) {
    flat_init_kernel<<<seq_blocks, kThreads, 0, st>>>(
        static_cast<int32_t>(n_seqs), hits, rmin, role);
  }
  if (n_tokens) {
    flat_unanimous_kernel<<<grid_for(n_tokens), kThreads, 0, st>>>(
        make_walk(table, n_buckets, max_probes),
        Stream{codes, seg_ids, valid, n_tokens, k,
               static_cast<uint32_t>(pad)},
        static_cast<int32_t>(n_seqs), hits, rmin, role);
  }
  if (seq_blocks) {
    flat_finalize_kernel<<<seq_blocks, kThreads, 0, st>>>(
        static_cast<int32_t>(n_seqs), min_hits, hits, rmin, role);
  }
  return static_cast<int>(cudaGetLastError());
}

// One role block of the weighted vote: table, codes, seg_ids, valid as for
// kan_apply_flat; tally: (n_seqs, r_blk) int64 cells, zero on entry and on
// return; role / best: (n_seqs,) int32 / float32, the running best (read
// unless `first`), and the call after the `last` block.
extern "C" int kan_apply_flat_weighted(
    const int32_t* table, int64_t n_buckets, int max_probes,
    const uint8_t* codes, const int32_t* seg_ids, const uint8_t* valid,
    int64_t n_tokens, int k, int pad, int64_t n_seqs, int64_t role_base,
    int64_t r_blk, int64_t* tally, int first, int last, float min_weight,
    int32_t* role, float* best, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* cells = reinterpret_cast<unsigned long long*>(tally);
  if (n_tokens) {
    flat_weighted_kernel<<<grid_for(n_tokens), kThreads, 0, st>>>(
        make_walk(table, n_buckets, max_probes),
        Stream{codes, seg_ids, valid, n_tokens, k,
               static_cast<uint32_t>(pad)},
        static_cast<int32_t>(n_seqs), static_cast<int32_t>(role_base),
        static_cast<int32_t>(r_blk), cells);
  }
  const int64_t row_blocks = (n_seqs * 32 + kThreads - 1) / kThreads;
  if (row_blocks) {
    flat_best_kernel<<<static_cast<unsigned>(row_blocks), kThreads, 0, st>>>(
        cells, static_cast<int32_t>(n_seqs), static_cast<int32_t>(role_base),
        static_cast<int32_t>(r_blk), first, last, min_weight, role, best);
  }
  return static_cast<int>(cudaGetLastError());
}
