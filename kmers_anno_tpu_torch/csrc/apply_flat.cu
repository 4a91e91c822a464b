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
// The key filter (ops/key_filter.py, read through key_filter.cuh).  A
// table past one wide table is 100 MB or more, past the 50 MB L2, and most
// windows of a protein miss it: a miss reads its home bucket's 32-byte
// lo-key sector from device memory.  In front of the walk sits a
// split-block Bloom filter of the table's own keys, 16 bits a key (20 MB
// for 10M keys, small enough for L2 beside the buckets that hold hits).  A
// window whose sector lacks one of its bits is a miss and never reads the
// table; a Bloom filter has no false negatives, so every output is as
// without it.  Without a filter (a null pointer) every window walks.
//
// kan_flat_unanimous (the unanimity vote): one thread a token, the warps of
// a grid-stride loop over the stream, each on 32 consecutive tokens.  A
// thread packs codes[t .. t+k-1] (5 bits a residue, residues 0..5 in lo and
// 6..11 in hi; positions at or past T read the pad code), asks the filter,
// walks the table (bucket_probe.cuh) and, on a hit of a protein below
// n_seqs, counts it with its role into three int32 arrays: hits (add), min
// role and max role.  Tokens of one protein sit side by side, so a warp's
// hits mostly belong to one or two proteins: the lanes of the first and of
// the last hit's protein each reduce to one atomicAdd, atomicMin and
// atomicMax; any other hit adds alone.  Integer atomics are order-free, so
// the result is exact for any order of the stream.  A finalize pass calls
// role = max role and keeps the count when the protein has hits, min == max
// and at least min_hits of them; otherwise role -1 and count 0 (unlike the
// row vote, which keeps the count of a unanimous row below min_hits).
//
// kan_flat_weighted (the weighted vote): one walk of the stream a call,
// whatever the numbers of roles and proteins.  Contract: seg_ids never
// decreases, so each protein's tokens are one contiguous run and proteins
// come in order (FlatBatch lays them out so, padding last).  A boundary pass
// reads seg_ids once, writes each protein's first token (starts, n_seqs + 1
// entries) and raises an error flag where an id is smaller than the one
// before it; the wrapper reads the flag and raises, so a stream that breaks
// the contract never miscounts silently.  Then one block of 128 threads owns
// one protein (the hardware hands blocks out as SMs free up, so a long
// protein holds only its own block): it walks the protein's windows 128 at
// a time with the same pack, filter and walk.  A hit's payload is
// fp16_bits(weight) << 16 | role; the weight, a non-negative fp16, is a
// whole number of 2^-24 units below 2^40, decoded from its bits.  Each hit
// adds its units into the protein's int64 tally in shared memory, indexed
// by role: the lanes of a warp with one role merge first (units split in
// 20-bit halves, so that a warp sum fits 32 bits), then one shared atomic a
// role.  Integer sums are exact in any order.  Hits of zero weight add
// nothing and are skipped: a tally of 0 is never called.  The tally holds
// r_tally = min(n_roles, r_direct) roles (r_direct 4,096: 32 KB); a hit of a
// role past it is kept, once, in a global scratch buffer at its protein's
// own token positions, and the block then sweeps role ranges of r_tally
// over those kept hits alone, each range starting at the smallest kept role
// not yet swept, never reading the table again.  After each range the
// block takes the first maximum of the range's cells as float32 (each cell
// converted once, times 2^-24), merged into the running best only when
// strictly greater (from tally 0 and role -1), so equal float32 tallies
// call the smaller role even where their int64 sums differ.  It calls the
// best role when its tally is >= min_weight and > 0, else role -1 and 0.
//
// What bounds them on this card: the latency of each window's chain of
// dependent reads (its flag and codes, the filter sector, the home bucket's
// lo keys, then a hit's hi key and payload), not bytes or operations.  A
// 10M-key table is about 403 MB, eight times the L2, so without the filter
// a miss reads its home bucket's lo keys from device memory; hits of a
// role's kmers recur across proteins and stay in L2.  A warp waits for its
// slowest lane, and a hit's chain through L2 is about as long as a miss's
// read from device memory, so the filter shortens a warp's step much less
// than it cuts device-memory reads: 1.2x on the unanimity kernel, next to
// nothing on the weighted one (PERF.md, Findings).  Four windows a thread
// in flight, with persistent owners that clear only the cells they
// touched, measured 5-7% slower than this design.  The stream is read once
// (code and flag bytes, coalesced; the weighted step also reads seg_ids
// once in its boundary pass), and the votes are a few merged atomics a
// warp.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bucket_probe.cuh"
#include "key_filter.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 64;   // 64 blocks an SM fill the grid-stride
constexpr int kOwnerThreads = 128;     // a weighted owner block: 4 warps
constexpr int kOwnerWarps = kOwnerThreads / 32;
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr float kUnit = 1.0f / 16777216.0f;   // 2^-24
struct Walk {
  const uint32_t* table;
  uint32_t mask;
  int max_probes;
};

using Filter = kan::KeyFilter;

struct Stream {
  const uint8_t* codes;
  const int32_t* seg_ids;
  const uint8_t* valid;
  int64_t n_tokens;
  int k;
  uint32_t pad;
};

// The payload of token t's kmer window, or -1 (an invalid window, a miss).
__device__ __forceinline__ int32_t lookup(const Walk& w, const Filter& f,
                                          const Stream& s, int64_t t) {
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
  if (!kan::may_hold(f, lo, hi)) return -1;
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
flat_unanimous_kernel(Walk w, Filter f, Stream s, int32_t n_seqs,
                      int32_t* hits, int32_t* rmin, int32_t* rmax) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  // the loop bound is warp-uniform, so every lane reaches every merge
  for (int64_t base = warp * 32; base < s.n_tokens; base += n_warps * 32) {
    const int64_t t = base + lane;
    const int32_t role = lookup(w, f, s, t);
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

// A protein id clamped to [-1, n_seqs]: below 0 and at or past n_seqs
// count nothing.
__device__ __forceinline__ int64_t clamp_seg(int32_t seg, int32_t n_seqs) {
  return seg < 0 ? -1 : (seg < n_seqs ? seg : n_seqs);
}

// starts[p] = the first token whose clamped id is >= p, for p in
// [0, n_seqs] (n_tokens where there is none), so protein p owns tokens
// [starts[p], starts[p + 1]).  Thread t writes the proteins between the ids
// of tokens t - 1 and t; *bad is set where an id falls below the one
// before it.
__global__ void __launch_bounds__(kThreads)
flat_starts_kernel(const int32_t* __restrict__ seg_ids, int64_t n_tokens,
                   int32_t n_seqs, int64_t* starts, int32_t* bad) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       t <= n_tokens; t += stride) {
    const int32_t prev = t ? __ldg(seg_ids + t - 1) : INT_MIN;
    const int32_t cur = t < n_tokens ? __ldg(seg_ids + t) : INT_MAX;
    if (cur < prev) *bad = 1;
    const int64_t from = t ? clamp_seg(prev, n_seqs) : -1;
    const int64_t to = t < n_tokens ? clamp_seg(cur, n_seqs) : n_seqs;
    for (int64_t p = from + 1; p <= to; ++p) starts[p] = t;
  }
}

// A non-negative fp16 weight's value in units of 2^-24: m for a subnormal
// (exponent field 0), (1024 + m) << (e - 1) otherwise; below 2^40.
__device__ __forceinline__ uint64_t fp16_units(uint32_t bits) {
  const uint32_t e = (bits >> 10) & 0x1Fu;
  const uint64_t m = bits & 0x3FFu;
  return e ? (1024u + m) << (e - 1) : m;
}

// Each role of the lanes in `add` gets the sum of their units in
// tally[role], one shared atomic a distinct role of the warp.
__device__ __forceinline__ void warp_tally(bool add, int32_t role,
                                           uint64_t units,
                                           unsigned long long* tally) {
  unsigned pending = __ballot_sync(kFullMask, add);
  while (pending) {
    const int leader = __ffs(pending) - 1;
    const int32_t r = __shfl_sync(kFullMask, role, leader);
    const bool in = add && role == r;
    const unsigned lo = __reduce_add_sync(
        kFullMask, in ? static_cast<unsigned>(units & 0xFFFFFu) : 0u);
    const unsigned hi = __reduce_add_sync(
        kFullMask, in ? static_cast<unsigned>(units >> 20) : 0u);
    if ((threadIdx.x & 31) == leader)
      atomicAdd(tally + r, (static_cast<unsigned long long>(hi) << 20) + lo);
    pending &= ~__ballot_sync(kFullMask, in);
  }
}

// (top, arg) := the better of the two: the larger tally, the smaller role
// on equal tallies.
__device__ __forceinline__ void keep_first_max(float& top, int32_t& arg,
                                               float o_top, int32_t o_arg) {
  if (o_top > top || (o_top == top && o_arg < arg)) {
    top = o_top;
    arg = o_arg;
  }
}

// The block's first maximum over tally[0 .. n): every cell converted once
// to float32; (top, cell) returned to every thread.  Starts and ends with a
// __syncthreads.
__device__ __forceinline__ void block_first_max(
    const unsigned long long* tally, int32_t n, float* s_top, int32_t* s_arg,
    float& top, int32_t& arg) {
  __syncthreads();
  top = -1.0f;
  arg = INT_MAX;
  for (int32_t c = threadIdx.x; c < n; c += kOwnerThreads) {
    const float v =
        __ll2float_rn(static_cast<long long>(tally[c])) * kUnit;
    if (v > top) {   // a thread's cells rise: its first maximum stays
      top = v;
      arg = c;
    }
  }
  for (int offset = 16; offset; offset >>= 1)
    keep_first_max(top, arg, __shfl_down_sync(kFullMask, top, offset),
                   __shfl_down_sync(kFullMask, arg, offset));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_top[warp] = top;
    s_arg[warp] = arg;
  }
  __syncthreads();
  top = s_top[0];
  arg = s_arg[0];
  for (int i = 1; i < kOwnerWarps; ++i) keep_first_max(top, arg, s_top[i],
                                                       s_arg[i]);
  __syncthreads();
}

__device__ __forceinline__ void zero_tally(unsigned long long* tally,
                                           int32_t n) {
  for (int32_t c = threadIdx.x; c < n; c += kOwnerThreads) tally[c] = 0;
}

// One block a protein (blockIdx.x): its windows walked once into the shared
// tally of roles [0, r_tally), hits of later roles kept in `kept` at the
// protein's own token positions and swept in ranges; the call written to
// role / best.
__global__ void __launch_bounds__(kOwnerThreads)
flat_weighted_kernel(Walk w, Filter f, Stream s, const int64_t* starts,
                     const int32_t* bad, int32_t n_roles, int32_t r_tally,
                     float min_weight, int32_t* kept, int32_t* role,
                     float* best) {
  extern __shared__ unsigned long long tally[];
  __shared__ float s_top[kOwnerWarps];
  __shared__ int32_t s_arg[kOwnerWarps];
  __shared__ int32_t s_kept, s_next;
  const int32_t p = blockIdx.x;
  const int lane = threadIdx.x & 31;
  if (*bad) {   // a broken contract: the wrapper raises
    if (!threadIdx.x) {
      role[p] = -1;
      best[p] = 0.0f;
    }
    return;
  }
  const int64_t t0 = starts[p];
  const int64_t t1 = starts[p + 1];
  zero_tally(tally, r_tally);
  if (!threadIdx.x) s_kept = 0;
  __syncthreads();
  // the loop bound is block-uniform, so every lane reaches every merge
  for (int64_t base = t0; base < t1; base += kOwnerThreads) {
    const int64_t t = base + threadIdx.x;
    const int32_t val = t < t1 ? lookup(w, f, s, t) : -1;
    const uint64_t units =
        val >= 0 ? fp16_units(static_cast<uint32_t>(val) >> 16) : 0;
    const int32_t r = val & 0xFFFF;
    // roles at or past n_roles count nothing, as in the plain votes
    warp_tally(units && r < r_tally, r, units, tally);
    const bool keep = units && r >= r_tally && r < n_roles;
    const unsigned keeps = __ballot_sync(kFullMask, keep);
    if (keeps) {
      int32_t at = 0;
      if (!lane) at = atomicAdd(&s_kept, __popc(keeps));
      at = __shfl_sync(kFullMask, at, 0);
      if (keep)
        kept[t0 + at + __popc(keeps & ((1u << lane) - 1u))] = val;
    }
  }
  float top;
  int32_t arg;
  block_first_max(tally, r_tally, s_top, s_arg, top, arg);
  float b = 0.0f;
  int32_t call = -1;
  if (top > b) {
    b = top;
    call = arg;
  }
  // roles past the tally: ranges over the kept hits, in role order
  const int32_t n_kept = s_kept;
  int32_t swept = r_tally;
  while (n_kept) {
    if (!threadIdx.x) s_next = INT_MAX;
    zero_tally(tally, r_tally);
    __syncthreads();
    int32_t next = INT_MAX;
    for (int32_t i = threadIdx.x; i < n_kept; i += kOwnerThreads) {
      const int32_t r = kept[t0 + i] & 0xFFFF;
      if (r >= swept && r < next) next = r;
    }
    next = __reduce_min_sync(kFullMask, next);
    if (!lane) atomicMin(&s_next, next);
    __syncthreads();
    const int32_t lo = s_next;
    if (lo == INT_MAX) break;
    for (int32_t i = threadIdx.x; i < n_kept; i += kOwnerThreads) {
      const int32_t v = kept[t0 + i];
      const int32_t r = v & 0xFFFF;
      if (r >= lo && r - lo < r_tally)
        atomicAdd(tally + (r - lo),
                  static_cast<unsigned long long>(
                      fp16_units(static_cast<uint32_t>(v) >> 16)));
    }
    block_first_max(tally, r_tally, s_top, s_arg, top, arg);
    if (top > b) {   // later ranges hold larger roles: ties stay
      b = top;
      call = lo + arg;
    }
    swept = lo + r_tally;
  }
  if (!threadIdx.x) {
    const bool called = b >= min_weight && b > 0.0f;
    role[p] = called ? call : -1;
    best[p] = called ? b : 0.0f;
  }
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
// aligned; filter: (n_sectors, 8) 32-bit words of the table's key filter,
// 16-byte aligned, or null (every window walks); codes / valid: (n_tokens,)
// bytes; seg_ids: (n_tokens,) int32, a protein index or >= n_seqs for
// padding; role / hits / rmin: (n_seqs,) int32, written (rmin is scratch).
// k in 1..12; pad is the code read past the stream's end.
extern "C" int kan_flat_unanimous(const int32_t* table, int64_t n_buckets,
                                  int max_probes, const int32_t* filter,
                                  int64_t n_sectors, const uint8_t* codes,
                                  const int32_t* seg_ids,
                                  const uint8_t* valid, int64_t n_tokens,
                                  int k, int pad, int64_t n_seqs,
                                  int min_hits, int32_t* role, int32_t* hits,
                                  int32_t* rmin, void* stream) {
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
        kan::make_key_filter(filter, n_sectors),
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

// The weighted vote, one walk: table, filter, codes, seg_ids, valid as for
// kan_flat_unanimous, seg_ids never decreasing; n_seqs >= 1; n_roles in
// 1..65536; r_direct >= 1, the most roles the shared tally holds (8 bytes
// each, at most 48 KB); starts: (n_seqs + 1,) int64 scratch; bad: one int32,
// set to 1 when seg_ids decreases somewhere (then every call is -1);
// kept: (n_tokens,) int32 scratch, needed only when n_roles > r_direct
// (else null); role / best: (n_seqs,) int32 / float32, the call.
extern "C" int kan_flat_weighted(
    const int32_t* table, int64_t n_buckets, int max_probes,
    const int32_t* filter, int64_t n_sectors, const uint8_t* codes,
    const int32_t* seg_ids, const uint8_t* valid, int64_t n_tokens, int k,
    int pad, int64_t n_seqs, int64_t n_roles, int64_t r_direct,
    float min_weight, int64_t* starts, int32_t* bad, int32_t* kept,
    int32_t* role, float* best, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t r_tally =
      static_cast<int32_t>(n_roles < r_direct ? n_roles : r_direct);
  // 14 owners of 2,000 roles an SM only with the whole carveout shared
  cudaError_t err = cudaFuncSetAttribute(
      flat_weighted_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(bad, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  flat_starts_kernel<<<grid_for(n_tokens + 1), kThreads, 0, st>>>(
      seg_ids, n_tokens, static_cast<int32_t>(n_seqs), starts, bad);
  flat_weighted_kernel<<<static_cast<unsigned>(n_seqs), kOwnerThreads,
                         r_tally * sizeof(unsigned long long), st>>>(
      make_walk(table, n_buckets, max_probes),
      kan::make_key_filter(filter, n_sectors),
      Stream{codes, seg_ids, valid, n_tokens, k, static_cast<uint32_t>(pad)},
      starts, bad, static_cast<int32_t>(n_roles), r_tally, min_weight, kept,
      role, best);
  return static_cast<int>(cudaGetLastError());
}
