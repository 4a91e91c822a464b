// Device build of a bucketed hash table from EMPTY-padded unique keys, in
// either layout: the wide-bucket table (24 slots a row) and the 8-slot
// table.
//
// Replaces kmers_anno_tpu/ops/widetable.py · build_wide_table_device (:153)
// and kmers_anno_tpu/ops/hashtable.py · build_table_device (:129), XLA
// programs on the TPU (argsort + associative max-scan + scatter), as the
// projection engine calls them for each close genome's singleton table
// (engine/projection.py:213 and :219, used at :1170, :1182 and :1259).
// Plain version: ops/table_build.build_table_plain.  The file's second
// function, the close set's union table from raw keys with duplicates
// (kan_union_dedupe, kan_union_build), is set out before its entry points
// at the end; it shares the scan and nothing else.
//
// The function.  A key i is real unless lo[i] == EMPTY (0xFFFFFFFF).  Its
// home row is fmix32(lo ^ fmix32(hi ^ salt)) & (rows - 1) (salt GOLDEN for
// the 8-slot layout: the unsalted mix_kmer).  The reference sorts the keys
// stably by home (pads last) and gives the key at rank i the slot
// pos = i + max over j <= i of (home_j * S - j), S slots a row: the greedy
// placement that fills each row in rank order and sends a full row's
// overflow on to the next row.  `bad` is set when a real key has
// pos >= rows * S (it would wrap) or a walk pos / S - home of max_walk or
// more (1 for the wide layout, whose probe reads one row; 2,
// MAX_DEVICE_PROBES, for the projection's 8-slot tables).  A key is
// written where pos < rows * S and, unless keep_walkers, its walk is 0:
// the wide layout drops the keys that walk, the 8-slot layout keeps them.
// hashAnno's index (`wrap`, the 8-slot layout with a max_walk no key
// reaches, since its probe walks as far as the longest walk) places the
// keys past the last row as build_table's wraparound tail does: the t-th
// of them in stable order takes the t-th free slot of the table counted
// from row 0 (a row's keys fill it from slot 0, so its free slots are its
// last), a walk of rows - home + its row; `bad` is then set only where no
// free slot is left.  The table's rows are [S lo keys | S hi keys |
// S payloads], EMPTY keys and 0 payloads where no key lies.
//
// The same placement by rows, with no sort.  Let cnt[h] be the real keys
// homed in row h, start[h] its exclusive prefix sum, and
// C[h] = max over h' <= h of (h' * S - start[h']).  The key of home h whose
// stable rank among that home's keys (by input index) is r takes
// pos = start[h] + C[h] + r.  So home h fills the run of slots from
// first[h] = start[h] + C[h], and the keys of the homes before it end at
// F[h] = start[h] + C[h - 1]; the slots [h * S, F[h]) are every one taken,
// the one at p by the key of sorted index p - C[h - 1].  A row's bad test
// is on its last key: first[h] + cnt[h] - 1 >= min(rows * S,
// (h + max_walk) * S), or (h + max_walk) * S with `wrap`.  The keys past
// the last row are the last n_real + C[rows - 1] - rows * S of the stable
// order.  tests/test_torch_table_build.py holds this to the plain version
// key by key.
//
// One entry point, kan_table_build, five passes (six for the 8-slot
// layout, seven with `wrap`), no library call:
//   zero   the row counts, the scan's status words and ticket, `bad` (and
//          for the 8-slot layout the longest walk);
//   count  a thread a key: its home, atomicAdd(&cnt[home], 1), the old
//          value kept as the key's arrival slot;
//   scan   a block a tile of 4,096 rows, one pass with a decoupled
//          look-back over the pair (sum, max) under
//          (s1, m1) . (s2, m2) = (s1 + s2, max(m1, m2 - s1)), each row's
//          element (cnt[h], h * S): each row's inclusive (start[h + 1],
//          C[h]) as an int2.  A tile publishes its flag and pair in one
//          64-bit word, so the look-back (32 tiles a step, a lane a tile)
//          needs no fence; counts come in and pairs go out through shared
//          memory, coalesced;
//   scatter a thread a key: the record (index, lo, hi, payload) at
//          start[home] + arrival, one 16-byte store;
//   wide   a warp a run of 8 rows: the run's records are one stretch,
//          read 32 at a time, each ranked by index among its row's (the
//          indices in shared memory), the rows staged in shared memory
//          with EMPTY and 0 where no key lands and written whole, once;
//   8-slot rank (a thread a record: its rank by index among its home's
//          records, the record stored at start + rank, the stable order)
//          then rows (a warp a run of 32 rows, a lane a slot in each of 8
//          rounds: the key of the walkers' run or of the home's own run
//          read from the stable order, EMPTY and 0 past them; each block
//          adds its rows' longest walk into `walk` with one atomicMax);
//   wrap   one block: where keys pass the last row, the rows' free slots
//          counted from the written table 256 rows at a time, a block
//          scan of them, each such key written into its free slot and its
//          walk into `walk`; where none do, it reads one pair and ends.
// Atomics arrive in any order; the rank by index makes every launch write
// the same table.  A block with a bad row stores 1 into `bad`, read once a
// build, beside the 8-slot layout's longest walk: the largest
// pos / S - home of a key written (pos < rows * S, and with `wrap` the
// keys past the last row too), build_table's max_probes - 1.  A row of L keys costs O(L^2)
// compares: the realistic sets hold 7 keys a wide row and under 4 an
// 8-slot row on average, and only forced bad cases reach a few hundred.
//
// What bounds it on this card: bytes.  A build of n keys into a table of
// B bytes must read each key's 12 bytes once and write B: on the
// projection's close tables (914,109 keys padded to 1,048,576; 131,072
// rows of 288 bytes) 50.3 MB, 0.0150 ms at 3.35 TB/s; the 8-slot table
// (1,048,576 rows of 96 bytes) 113.2 MB, 0.0338 ms; hashAnno's index
// (3.85M keys into the same 1,048,576 rows) 146.9 MB, 0.0438 ms.  The
// passes move more, and three of their accesses a key land at random: the
// count's atomic, the scatter's read of its row's start and its record's
// store (the counts, pairs and records stay in the 50 MB L2 at the
// projection's sizes; hashAnno's 61.6 MB of records do not).
// Those two passes take 0.06 of the wide build's 0.10 ms (PERF.md,
// Findings, with the designs that lost: a torch.sort of the homes, a
// fill and a place pass; groups of rows built in shared memory; a bucket
// a row filled by the count pass).

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr int kThreads = 256;            // threads a block, every pass
constexpr int kWarps = kThreads / 32;    // rows a block of the wide pass
constexpr int kScanItems = 16;           // rows a thread of the scan
// rows a tile of the scan: ops/table_build.SCAN_TILE
constexpr int kScanTile = kThreads * kScanItems;
constexpr int kWideSlots = 24;           // the wide layout's slots a row
constexpr int kRunRows = 8;              // rows a warp of the wide pass
constexpr int kRunIdx = 128;             // ... their indices in shared memory
constexpr int kBucketSlots = 8;          // the 8-slot layout's slots a row
constexpr int kSlotRunRows = 32;         // rows a warp of the 8-slot pass
constexpr unsigned kFullMask = 0xFFFFFFFFu;
// a tile's status word: flag << 62 | sum << 31 | max (both in [0, 2^31))
constexpr unsigned long long kAggregate = 1;   // its own pair
constexpr unsigned long long kPrefix = 2;      // its inclusive prefix
constexpr unsigned long long kField = 0x7FFFFFFFull;
constexpr long long kNegInf = LLONG_MIN / 4;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t home_of(uint32_t lo, uint32_t hi,
                                            uint32_t salt, uint32_t mask) {
  return fmix32(lo ^ fmix32(hi ^ salt)) & mask;
}

// (sum, max) of a run of rows; combine(a, b) is a followed by b.
struct RowPair {
  long long sum, max;
};

__device__ __forceinline__ RowPair combine(RowPair a, RowPair b) {
  return {a.sum + b.sum, max(a.max, b.max - a.sum)};
}

__device__ __forceinline__ RowPair shfl_up(RowPair v, int d) {
  return {__shfl_up_sync(kFullMask, v.sum, d),
          __shfl_up_sync(kFullMask, v.max, d)};
}

// The scratch the wrapper allocates (ops/table_build.scratch_bytes), in
// order, each part from a 16-byte boundary.
struct Scratch {
  int32_t* cnt;                // rows: real keys a home   } zeroed
  unsigned long long* status;  // tiles: the scan's words  } by the
  int32_t* ticket;             // 1: the scan's next tile  } zero pass
  int2* pair;                  // rows: (start[h + 1], C[h])
  int32_t* arrival;            // n: each real key's arrival slot
  int4* rec;                   // n: (index, lo, hi, payload) by home
  int4* sorted;                // n, 8-slot layout only: the stable order
  int64_t zero_bytes;          // the zeroed span from cnt
  int64_t bytes;               // the whole
};

__host__ __device__ inline int64_t align16(int64_t b) {
  return (b + 15) & ~int64_t{15};
}

Scratch carve(char* base, int64_t n, int64_t n_rows, bool keep_walkers) {
  const int64_t tiles = (n_rows + kScanTile - 1) / kScanTile;
  Scratch s;
  s.cnt = reinterpret_cast<int32_t*>(base);
  int64_t at = align16(4 * n_rows);
  s.status = reinterpret_cast<unsigned long long*>(base + at);
  at += 8 * tiles;
  s.ticket = reinterpret_cast<int32_t*>(base + at);
  at = s.zero_bytes = align16(at + 4);
  s.pair = reinterpret_cast<int2*>(base + at);
  at += align16(8 * n_rows);
  s.arrival = reinterpret_cast<int32_t*>(base + at);
  at += align16(4 * n);
  s.rec = reinterpret_cast<int4*>(base + at);
  at += 16 * n;
  s.sorted = reinterpret_cast<int4*>(base + at);
  if (keep_walkers) at += 16 * n;
  s.bytes = at;
  return s;
}

__global__ void __launch_bounds__(kThreads)
zero_kernel(int4* __restrict__ words, int64_t n_vec,
            uint8_t* __restrict__ bad, int32_t* __restrict__ walk) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (i < n_vec) words[i] = make_int4(0, 0, 0, 0);
  if (i == 0) {
    *bad = 0;
    if (walk) *walk = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
             int64_t n, uint32_t salt, uint32_t mask,
             int32_t* __restrict__ cnt, int32_t* __restrict__ arrival) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (i >= n) return;
  const uint32_t l = __ldg(lo + i);
  if (l == kEmpty) return;
  arrival[i] = atomicAdd(cnt + home_of(l, __ldg(hi + i), salt, mask), 1);
}

__device__ __forceinline__ void publish(unsigned long long* status,
                                        unsigned long long flag,
                                        RowPair v) {
  *reinterpret_cast<volatile unsigned long long*>(status) =
      flag << 62 | static_cast<unsigned long long>(v.sum) << 31 |
      static_cast<unsigned long long>(v.max);
}

// The pairs of the 32 tiles top - lane before a tile, combined in tile
// order up to the nearest one whose inclusive prefix is out (kPrefix);
// lane 0 gets the result, and `done` says whether a prefix was reached.
// A lane spins until its tile has published; flag and pair come in one
// 64-bit word, so no fence is needed.
__device__ __forceinline__ RowPair look_back(int top, int lane,
                                             const unsigned long long* status,
                                             bool* done) {
  const int j = top - lane;
  unsigned long long w = kPrefix << 62;   // before tile 0: never reached
  if (j >= 0) {
    do {
      w = *reinterpret_cast<const volatile unsigned long long*>(status + j);
    } while ((w >> 62) == 0);
  }
  RowPair v = {static_cast<long long>(w >> 31 & kField),
               static_cast<long long>(w & kField)};
  const unsigned prefixed = __ballot_sync(kFullMask, (w >> 62) == kPrefix);
  *done = prefixed != 0;
  // lanes past the nearest prefixed tile add nothing
  if (prefixed && lane > __ffs(prefixed) - 1) v = {0, kNegInf};
  // a higher lane holds an earlier tile
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const RowPair o = {__shfl_down_sync(kFullMask, v.sum, d),
                       __shfl_down_sync(kFullMask, v.max, d)};
    if (lane + d < 32) v = combine(o, v);
  }
  return v;
}

// Each row's inclusive pair (start[h + 1], C[h]).  Tiles are taken in the
// order blocks start (a ticket), so a block waits only on tiles that
// running or finished blocks hold; its first warp looks back 32 tiles at
// a time.  A tile's counts come in, and its pairs go out, through shared
// memory, so that both are coalesced.
__global__ void __launch_bounds__(kThreads)
scan_kernel(const int32_t* __restrict__ cnt, int64_t n_rows, int slots,
            unsigned long long* status, int32_t* ticket,
            int2* __restrict__ pair) {
  __shared__ __align__(16) int2 stage[kScanTile];
  __shared__ int tile_sh;
  __shared__ RowPair warp_tot[kWarps];
  __shared__ RowPair tile_total;
  __shared__ RowPair tile_before;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_sh = atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = tile_sh;
  const int64_t tile_row = static_cast<int64_t>(tile) * kScanTile;
  int32_t* stage_c = reinterpret_cast<int32_t*>(stage);
  for (int k = threadIdx.x; k < kScanTile; k += kThreads)
    stage_c[k] = tile_row + k < n_rows ? cnt[tile_row + k] : 0;
  __syncthreads();
  const int r0 = threadIdx.x * kScanItems;
  const int64_t row0 = tile_row + r0;
  int32_t c[kScanItems];
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) c[k] = stage_c[r0 + k];
  RowPair mine = {0, kNegInf};
#pragma unroll
  for (int k = 0; k < kScanItems; ++k)
    if (row0 + k < n_rows)
      mine = combine(mine, {c[k], (row0 + k) * slots});

  // the block's scan of the threads' pairs, in thread order
  RowPair in_warp = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const RowPair o = shfl_up(in_warp, d);
    if (lane >= d) in_warp = combine(o, in_warp);
  }
  if (lane == 31) warp_tot[warp] = in_warp;
  RowPair before = shfl_up(in_warp, 1);
  if (lane == 0) before = {0, kNegInf};
  __syncthreads();
  if (threadIdx.x == 0) {
    RowPair total = {0, kNegInf};
    for (int w = 0; w < kWarps; ++w) {
      const RowPair t = warp_tot[w];
      warp_tot[w] = total;               // the warps before w
      total = combine(total, t);
    }
    tile_total = total;
    publish(status + tile, tile == 0 ? kPrefix : kAggregate, total);
  }
  __syncthreads();
  if (warp == 0) {
    // the tiles before this one, by decoupled look-back
    RowPair prior = {0, kNegInf};
    bool done = tile == 0;
    for (int top = tile - 1; !done; top -= 32) {
      const RowPair window = look_back(top, lane, status, &done);
      const RowPair w0 = {__shfl_sync(kFullMask, window.sum, 0),
                          __shfl_sync(kFullMask, window.max, 0)};
      prior = combine(w0, prior);
    }
    if (lane == 0) {
      if (tile > 0) publish(status + tile, kPrefix,
                            combine(prior, tile_total));
      tile_before = prior;
    }
  }
  __syncthreads();
  RowPair run = combine(combine(tile_before, warp_tot[warp]), before);
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    run = combine(run, {c[k], (row0 + k) * slots});
    stage[r0 + k] = make_int2(static_cast<int32_t>(run.sum),
                              static_cast<int32_t>(run.max));
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kScanTile; k += kThreads)
    if (tile_row + k < n_rows) pair[tile_row + k] = stage[k];
}

__device__ __forceinline__ int32_t start_of(const int2* __restrict__ pair,
                                            int64_t h) {
  return h > 0 ? pair[h - 1].x : 0;
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint32_t* __restrict__ lo,
               const uint32_t* __restrict__ hi,
               const int32_t* __restrict__ values, int64_t n, uint32_t salt,
               uint32_t mask, const int2* __restrict__ pair,
               const int32_t* __restrict__ arrival, int4* __restrict__ rec) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (i >= n) return;
  const uint32_t l = __ldg(lo + i);
  if (l == kEmpty) return;
  const uint32_t hv = __ldg(hi + i);
  const int32_t at = start_of(pair, home_of(l, hv, salt, mask)) +
                     __ldg(arrival + i);
  rec[at] = make_int4(static_cast<int32_t>(i), static_cast<int32_t>(l),
                      static_cast<int32_t>(hv), __ldg(values + i));
}

// Whether row h (cnt keys from `first`) holds a bad key; with `wrap` a
// key past the last row (cap) is not bad, the wrap pass places it.
__device__ __forceinline__ bool row_bad(int64_t h, int32_t cnt,
                                        int32_t first, int64_t cap,
                                        int slots, int max_walk,
                                        bool wrap = false) {
  const int64_t walk_end = (h + max_walk) * slots;
  const int64_t limit = wrap ? walk_end : min(cap, walk_end);
  return cnt > 0 && static_cast<int64_t>(first) + cnt - 1 >= limit;
}

// The wide layout: a warp a run of kRunRows rows.  Only a row's own keys
// land in it (a key that walks is dropped), at first - h * S + rank while
// below S.  The run's records are one stretch of `rec`, read 32 at a
// time, their indices kept in shared memory; each is ranked by index
// among its row's.  The rows are staged in shared memory and written
// whole, 16 bytes a lane.
__global__ void __launch_bounds__(kThreads)
wide_rows_kernel(const int2* __restrict__ pair, const int4* __restrict__ rec,
                 int64_t n_rows, int max_walk, int32_t* __restrict__ table,
                 uint8_t* __restrict__ bad) {
  constexpr int S = kWideSlots;
  constexpr int W = 3 * kWideSlots;
  __shared__ __align__(16) int32_t buf[kWarps][kRunRows * W];
  __shared__ int32_t idx_buf[kWarps][kRunIdx];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t h0 =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kRunRows;
  bool is_bad = false;
  if (h0 < n_rows) {
    const int rows = static_cast<int>(min(int64_t{kRunRows}, n_rows - h0));
    // lane j <= rows: the pair of row h0 - 1 + j; lane j < rows then
    // holds row h0 + j's start, end and C
    const int64_t hp = h0 - 1 + lane;
    const int2 pv = lane <= rows && hp >= 0 ? pair[hp] : make_int2(0, 0);
    const int32_t start = pv.x;
    const int32_t end = __shfl_down_sync(kFullMask, pv.x, 1);
    const int32_t cmax = __shfl_down_sync(kFullMask, pv.y, 1);
    const int32_t base = start + cmax - static_cast<int32_t>((h0 + lane) * S);
    if (lane < rows)
      is_bad = row_bad(h0 + lane, end - start, start + cmax, n_rows * S, S,
                       max_walk);
    const int32_t seg0 = __shfl_sync(kFullMask, start, 0);
    const int32_t total = __shfl_sync(kFullMask, start, rows) - seg0;
    int4* stage4 = reinterpret_cast<int4*>(buf[warp]);
    for (int v = lane; v < rows * (W / 4); v += 32) {
      const int32_t word = v % (W / 4) < 2 * S / 4 ? -1 : 0;
      stage4[v] = make_int4(word, word, word, word);
    }
    int32_t* idx = idx_buf[warp];
    const bool in_smem = total <= kRunIdx;
    if (in_smem)
      for (int q = lane; q < total; q += 32) idx[q] = rec[seg0 + q].x;
    __syncwarp();
    int32_t* stage = buf[warp];
    for (int32_t c0 = 0; c0 < total; c0 += 32) {
      const int32_t q = c0 + lane;           // in the run
      // its row: the last of the run's rows that starts at or before it
      int my_row = 0;
      for (int j = 1; j < rows; ++j)
        my_row += __shfl_sync(kFullMask, start, j) - seg0 <= q;
      const int32_t rs = __shfl_sync(kFullMask, start, my_row) - seg0;
      const int32_t re = __shfl_sync(kFullMask, end, my_row) - seg0;
      const int32_t slot0 = __shfl_sync(kFullMask, base, my_row);
      if (q < total) {
        const int4 r = rec[seg0 + q];
        int32_t rank = 0;
        for (int32_t t = rs; t < re; ++t)
          rank += (in_smem ? idx[t] : rec[seg0 + t].x) < r.x;
        const int32_t slot = slot0 + rank;
        if (slot < S) {
          int32_t* row = stage + my_row * W;
          row[slot] = r.y;
          row[S + slot] = r.z;
          row[2 * S + slot] = r.w;
        }
      }
    }
    __syncwarp();
    int4* dst = reinterpret_cast<int4*>(table + h0 * W);
    for (int v = lane; v < rows * (W / 4); v += 32) dst[v] = stage4[v];
  }
  if (__syncthreads_or(is_bad) && threadIdx.x == 0) *bad = 1;
}

// The 8-slot layout, first: each real key's record at its stable rank.
__global__ void __launch_bounds__(kThreads)
rank_kernel(const int4* __restrict__ rec, const int2* __restrict__ pair,
            int64_t n_rows, uint32_t salt, int4* __restrict__ sorted) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (j >= pair[n_rows - 1].x) return;       // the real keys
  const int4 r = rec[j];
  const uint32_t h = home_of(static_cast<uint32_t>(r.y),
                             static_cast<uint32_t>(r.z), salt,
                             static_cast<uint32_t>(n_rows - 1));
  const int32_t start = start_of(pair, h);
  const int32_t end = pair[h].x;
  int32_t rank = 0;
  for (int32_t k = start; k < end; ++k) rank += rec[k].x < r.x;
  sorted[start + rank] = r;
}

// The 8-slot layout, then: a warp a run of kSlotRunRows rows, a lane a
// slot p of row h in each of its rounds.  The walkers' run [h * S, F)
// holds stable index p - C[h - 1]; the home's own run [first, first +
// cnt) holds start + (p - first).  Each lane finds its rounds' indices,
// then loads their records, then writes them.  A row's longest walk is its
// last key written's; the block's goes into `walk` where it is not null.
__global__ void __launch_bounds__(kThreads)
slot_rows_kernel(const int2* __restrict__ pair,
                 const int4* __restrict__ sorted, int64_t n_rows,
                 int max_walk, bool wrap, int32_t* __restrict__ table,
                 uint8_t* __restrict__ bad, int32_t* __restrict__ walk) {
  constexpr int S = kBucketSlots;
  constexpr int kRounds = kSlotRunRows * S / 32;
  __shared__ int32_t warp_walk[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t h0 =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kSlotRunRows;
  bool is_bad = false;
  int32_t row_walk = 0;
  if (h0 < n_rows) {
    const int rows =
        static_cast<int>(min(int64_t{kSlotRunRows}, n_rows - h0));
    // lane j < rows: row h0 + j's start, count, first slot, walkers' end
    const int64_t h = h0 + lane;
    int2 cur = make_int2(0, 0);
    int2 prev = make_int2(0, 0);
    if (lane < rows) {
      cur = pair[h];
      if (h > 0) prev = pair[h - 1];
    }
    const int32_t start = prev.x;
    const int32_t cnt = cur.x - start;
    const int32_t first = start + cur.y;
    const int32_t walkers_end = h > 0 ? start + prev.y : 0;
    const int32_t c_prev = prev.y;
    if (lane < rows) {
      is_bad = row_bad(h, cnt, first, n_rows * S, S, max_walk, wrap);
      if (cnt > 0 && first < n_rows * S)
        row_walk = static_cast<int32_t>(
            min(static_cast<int64_t>(first) + cnt - 1, n_rows * S - 1) / S -
            h);
    }
    int32_t at[kRounds];
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const int u = k * 32 + lane;
      const int r = u / S;
      const int64_t p = (h0 + r) * S + (u - r * S);
      const int32_t st = __shfl_sync(kFullMask, start, r);
      const int32_t cn = __shfl_sync(kFullMask, cnt, r);
      const int32_t fi = __shfl_sync(kFullMask, first, r);
      const int32_t we = __shfl_sync(kFullMask, walkers_end, r);
      const int32_t cp = __shfl_sync(kFullMask, c_prev, r);
      at[k] = -1;
      if (r < rows) {
        if (p < we)
          at[k] = static_cast<int32_t>(p - cp);
        else if (p >= fi && p < fi + cn)
          at[k] = st + static_cast<int32_t>(p - fi);
      }
    }
    int4 src[kRounds];
#pragma unroll
    for (int k = 0; k < kRounds; ++k)
      src[k] = at[k] >= 0 ? sorted[at[k]] : make_int4(0, -1, -1, 0);
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const int u = k * 32 + lane;
      const int r = u / S;
      if (r < rows) {
        int32_t* row = table + (h0 + r) * 3 * S + (u - r * S);
        row[0] = src[k].y;
        row[S] = src[k].z;
        row[2 * S] = src[k].w;
      }
    }
  }
  const int32_t w = static_cast<int32_t>(
      __reduce_max_sync(kFullMask, static_cast<unsigned>(row_walk)));
  if (lane == 0) warp_walk[warp] = w;
  if (__syncthreads_or(is_bad) && threadIdx.x == 0) *bad = 1;
  if (walk && threadIdx.x == 0) {
    int32_t most = 0;
    for (int k = 0; k < kWarps; ++k) most = max(most, warp_walk[k]);
    if (most > 0) atomicMax(walk, most);
  }
}

// The 8-slot layout with `wrap`, last: one block places the keys past the
// last row.  They are the stable order's last n_spill = n_real +
// C[rows - 1] - rows * S keys (pos of the last real key is n_real - 1 +
// C[rows - 1] where any passes; empty rows after it only lower that
// bound's max below rows * S - S).  Row r's free slots are its EMPTY lo
// words, its last ones; key t of the tail takes the t-th free slot in row
// order.  The block counts 256 rows' free slots a step, scans them, and
// goes on until every key is placed; rows run out only where the table
// holds fewer slots than real keys, which sets `bad`.
__global__ void __launch_bounds__(kThreads)
wrap_kernel(const int2* __restrict__ pair, const int4* __restrict__ sorted,
            int64_t n_rows, uint32_t salt, int32_t* __restrict__ table,
            uint8_t* __restrict__ bad, int32_t* __restrict__ walk) {
  constexpr int S = kBucketSlots;
  __shared__ int32_t warp_sum[kWarps];
  __shared__ int32_t warp_most[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int2 last = pair[n_rows - 1];
  const int64_t n_real = last.x;
  const int64_t n_spill = n_real + last.y - n_rows * S;
  if (n_spill <= 0) return;
  const int64_t tail = n_real - n_spill;
  const uint32_t mask = static_cast<uint32_t>(n_rows - 1);
  int64_t base = 0;                    // free slots in the rows before
  int32_t most = 0;
  for (int64_t r0 = 0; r0 < n_rows && base < n_spill; r0 += kThreads) {
    const int64_t r = r0 + threadIdx.x;
    int32_t* row = table + r * 3 * S;
    int free = 0;
    if (r < n_rows)
      for (int k = 0; k < S; ++k) free += row[k] == -1;
    int incl = free;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFullMask, incl, d);
      if (lane >= d) incl += o;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = 0;
    int total = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_sum[w] : 0;
      total += warp_sum[w];
    }
    __syncthreads();
    const int64_t t0 = base + before + incl - free;
    for (int q = 0; q < free && t0 + q < n_spill; ++q) {
      const int4 rec = sorted[tail + t0 + q];
      const int slot = S - free + q;
      row[slot] = rec.y;
      row[S + slot] = rec.z;
      row[2 * S + slot] = rec.w;
      const int64_t home = home_of(static_cast<uint32_t>(rec.y),
                                   static_cast<uint32_t>(rec.z), salt, mask);
      most = max(most, static_cast<int32_t>(n_rows - home + r));
    }
    base += total;
  }
  const int32_t w = static_cast<int32_t>(
      __reduce_max_sync(kFullMask, static_cast<unsigned>(most)));
  if (lane == 0) warp_most[warp] = w;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t m = 0;
    for (int k = 0; k < kWarps; ++k) m = max(m, warp_most[k]);
    if (m > 0) atomicMax(walk, m);
    if (base < n_spill) *bad = 1;
  }
}

unsigned blocks_for(int64_t n, int64_t per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

// ---------------------------------------------------------------------------
// The close set's union table, from its raw keys (see the note at the end).

constexpr int64_t kUnionRows = int64_t{1} << 18;  // ops/widetable.MAX_WIDE_ROWS
constexpr uint32_t kGolden = 0x9E3779B9u;         // ops/hashing.GOLDEN
constexpr int kUnionRun = 8;                      // table rows a warp writes

// The scratch kan_union_dedupe fills and kan_union_build reads
// (ops/table_build.union_scratch_bytes), each part from a 16-byte boundary.
struct UnionScratch {
  int32_t* cnt;                // rows: raw keys a row, then distinct } zeroed
  unsigned long long* status;  // tiles: the scan's words            } by the
  int32_t* ticket;             // 1: the scan's next tile            } dedupe
  int2* pair;                  // rows: (end of the row's run, 0)
  int2* rec;                   // n: (lo, hi) grouped by row
  int64_t zero_bytes;
  int64_t bytes;
};

UnionScratch carve_union(char* base, int64_t n) {
  UnionScratch s;
  s.cnt = reinterpret_cast<int32_t*>(base);
  int64_t at = align16(4 * kUnionRows);
  s.status = reinterpret_cast<unsigned long long*>(base + at);
  at += 8 * (kUnionRows / kScanTile);
  s.ticket = reinterpret_cast<int32_t*>(base + at);
  at = s.zero_bytes = align16(at + 4);
  s.pair = reinterpret_cast<int2*>(base + at);
  at += align16(8 * kUnionRows);
  s.rec = reinterpret_cast<int2*>(base + at);
  s.bytes = at + align16(8 * n);
  return s;
}

__device__ __forceinline__ unsigned long long key64(int2 r) {
  return static_cast<unsigned long long>(static_cast<uint32_t>(r.y)) << 32 |
         static_cast<uint32_t>(r.x);
}

__global__ void __launch_bounds__(kThreads)
union_zero_kernel(int4* __restrict__ words, int64_t n_vec,
                  int32_t* __restrict__ totals) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (i < n_vec) words[i] = make_int4(0, 0, 0, 0);
  if (i < 2) totals[i] = 0;
}

__global__ void __launch_bounds__(kThreads)
union_count_kernel(const uint32_t* __restrict__ lo,
                   const uint32_t* __restrict__ hi, int64_t n,
                   int32_t* __restrict__ cnt) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (i >= n) return;
  const uint32_t l = __ldg(lo + i);
  if (l == kEmpty) return;
  atomicAdd(cnt + home_of(l, __ldg(hi + i), kGolden, kUnionRows - 1), 1);
}

// A key goes to the end of its row's run less the row's count left: the
// order within a run is the atomics' and nothing later depends on it.
__global__ void __launch_bounds__(kThreads)
union_scatter_kernel(const uint32_t* __restrict__ lo,
                     const uint32_t* __restrict__ hi, int64_t n,
                     const int2* __restrict__ pair, int32_t* __restrict__ cnt,
                     int2* __restrict__ rec) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (i >= n) return;
  const uint32_t l = __ldg(lo + i);
  if (l == kEmpty) return;
  const uint32_t hv = __ldg(hi + i);
  const uint32_t h = home_of(l, hv, kGolden, kUnionRows - 1);
  rec[pair[h].x - atomicSub(cnt + h, 1)] =
      make_int2(static_cast<int32_t>(l), static_cast<int32_t>(hv));
}

// A warp a row: its keys read 32 at a time and inserted one by one into a
// sorted set, lane j holding the j-th smallest (a ballot finds a key
// present, another its place).  The set goes back over the start of the
// row's run, its size into cnt; a row past kWideSlots distinct keys stops,
// sets bad and counts kWideSlots + 1.  The block adds its rows' sizes to
// the distinct count.
__global__ void __launch_bounds__(kThreads)
union_dedupe_kernel(const int2* __restrict__ pair, int2* __restrict__ rec,
                    int32_t* __restrict__ cnt, int32_t* __restrict__ totals) {
  __shared__ int32_t warp_keys[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t h = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const int32_t start = h > 0 ? pair[h - 1].x : 0;
  const int32_t end = pair[h].x;
  unsigned long long mine = 0;
  int size = 0;
  bool over = false;
  for (int32_t c0 = start; c0 < end && !over; c0 += 32) {
    const unsigned long long got =
        c0 + lane < end ? key64(rec[c0 + lane]) : 0;
    const int m = min(32, end - c0);
    for (int t = 0; t < m; ++t) {
      const unsigned long long k = __shfl_sync(kFullMask, got, t);
      const bool live = lane < size;
      if (__ballot_sync(kFullMask, live && mine == k)) continue;
      if (size == kWideSlots) {
        over = true;
        break;
      }
      const int at = __popc(__ballot_sync(kFullMask, live && mine < k));
      const unsigned long long up = __shfl_up_sync(kFullMask, mine, 1);
      if (lane == at)
        mine = k;
      else if (lane > at && lane <= size)
        mine = up;
      ++size;
    }
  }
  if (!over && lane < size)
    rec[start + lane] = make_int2(static_cast<int32_t>(mine),
                                  static_cast<int32_t>(mine >> 32));
  if (lane == 0) {
    cnt[h] = over ? kWideSlots + 1 : size;
    warp_keys[warp] = over ? 0 : size;
  }
  const bool any_over = __syncthreads_or(over);
  if (threadIdx.x == 0) {
    int32_t sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += warp_keys[w];
    if (sum) atomicAdd(totals, sum);
    if (any_over) totals[1] = 1;
  }
}

// A warp a run of kUnionRun table rows.  Row r's keys are those of the
// dedupe's rows r + f * n_rows, f < kUnionRows / n_rows (their homes agree
// in the low bits); each such row's keys are copied into a list in shared
// memory, then ranked by key among the list's.  Rows are staged in shared
// memory with EMPTY and 0 where no key lands and written whole, 16 bytes a
// lane; a row past kWideSlots keys sets bad.
__global__ void __launch_bounds__(kThreads)
union_rows_kernel(const int2* __restrict__ pair, const int2* __restrict__ rec,
                  const int32_t* __restrict__ cnt, int64_t n_rows,
                  int32_t* __restrict__ table, uint8_t* __restrict__ bad) {
  constexpr int S = kWideSlots;
  constexpr int W = 3 * kWideSlots;
  __shared__ __align__(16) int32_t buf[kWarps][kUnionRun * W];
  __shared__ unsigned long long lists[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t r0 =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kUnionRun;
  bool is_bad = false;
  if (r0 < n_rows) {
    const int rows = static_cast<int>(min(int64_t{kUnionRun}, n_rows - r0));
    const int64_t fold = kUnionRows / n_rows;
    int4* stage4 = reinterpret_cast<int4*>(buf[warp]);
    for (int v = lane; v < rows * (W / 4); v += 32) {
      const int32_t word = v % (W / 4) < 2 * S / 4 ? -1 : 0;
      stage4[v] = make_int4(word, word, word, word);
    }
    int32_t* stage = buf[warp];
    unsigned long long* list = lists[warp];
    for (int j = 0; j < rows; ++j) {
      int32_t total = 0;
      for (int64_t f0 = 0; f0 < fold; f0 += 32) {
        const int64_t h = r0 + j + (f0 + lane) * n_rows;
        int32_t d = 0;
        int32_t st = 0;
        if (f0 + lane < fold) {
          d = cnt[h];
          if (d) st = h > 0 ? pair[h - 1].x : 0;
        }
        int32_t incl = d;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int32_t v = __shfl_up_sync(kFullMask, incl, o);
          if (lane >= o) incl += v;
        }
        const int32_t off = total + incl - d;
        for (unsigned todo = __ballot_sync(kFullMask, d > 0); todo;
             todo &= todo - 1) {
          const int src = __ffs(todo) - 1;
          const int32_t s_st = __shfl_sync(kFullMask, st, src);
          const int32_t s_d = __shfl_sync(kFullMask, d, src);
          const int32_t s_off = __shfl_sync(kFullMask, off, src);
          if (lane < s_d && s_off + lane < 32)
            list[s_off + lane] = key64(rec[s_st + lane]);
        }
        total += __shfl_sync(kFullMask, incl, 31);
      }
      __syncwarp();
      if (total > S) {
        is_bad = true;
      } else if (lane < total) {
        const unsigned long long k = list[lane];
        int rank = 0;
        for (int t = 0; t < total; ++t) rank += list[t] < k;
        stage[j * W + rank] = static_cast<int32_t>(k);
        stage[j * W + S + rank] = static_cast<int32_t>(k >> 32);
      }
      __syncwarp();
    }
    int4* dst = reinterpret_cast<int4*>(table + r0 * W);
    for (int v = lane; v < rows * (W / 4); v += 32) dst[v] = stage4[v];
  }
  if (__syncthreads_or(is_bad) && threadIdx.x == 0) *bad = 1;
}

}  // namespace

// lo / hi / values: (n,) 32-bit keys (EMPTY in pads) and payloads; n_rows a
// power of two, n_rows * slots + n < 2^31; scratch: scratch_bytes bytes of
// device memory (ops/table_build.scratch_bytes), 16-byte aligned; table:
// (n_rows, 3 * slots) int32, written whole; bad: one byte, written: 1 when
// a real key walks max_walk rows or more or wraps (with `wrap`: finds no
// free slot), else 0; walk: one int32 for the 8-slot layout (null for the
// wide one), written: the longest walk of a key written, in rows.  Slots
// and keep_walkers are 24 and 0 (the wide layout) or 8 and 1 (the 8-slot
// layout); wrap is 0, or 1 with the 8-slot layout.
extern "C" int kan_table_build(const int32_t* lo, const int32_t* hi,
                               const int32_t* values, int64_t n,
                               int64_t n_rows, uint32_t salt, int32_t slots,
                               int32_t max_walk, int32_t keep_walkers,
                               int32_t wrap, void* scratch,
                               int64_t scratch_bytes, int32_t* table,
                               uint8_t* bad, int32_t* walk, void* stream) {
  if (n < 0 || n_rows < 1 || (n_rows & (n_rows - 1)) || slots < 1 ||
      slots != (keep_walkers ? kBucketSlots : kWideSlots) ||
      (keep_walkers && !walk) || (wrap && !keep_walkers) ||
      n_rows * slots + n >= (int64_t{1} << 31) ||
      reinterpret_cast<uintptr_t>(scratch) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scratch s = carve(static_cast<char*>(scratch), n, n_rows,
                          keep_walkers != 0);
  if (scratch_bytes < s.bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const auto u_lo = reinterpret_cast<const uint32_t*>(lo);
  const auto u_hi = reinterpret_cast<const uint32_t*>(hi);
  const uint32_t mask = static_cast<uint32_t>(n_rows - 1);
  cudaError_t err;

  const int64_t n_vec = s.zero_bytes / 16;
  if (!keep_walkers) walk = nullptr;
  zero_kernel<<<blocks_for(n_vec, kThreads), kThreads, 0, st>>>(
      reinterpret_cast<int4*>(s.cnt), n_vec, bad, walk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    count_kernel<<<blocks_for(n, kThreads), kThreads, 0, st>>>(
        u_lo, u_hi, n, salt, mask, s.cnt, s.arrival);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  scan_kernel<<<blocks_for(n_rows, kScanTile), kThreads, 0, st>>>(
      s.cnt, n_rows, slots, s.status, s.ticket, s.pair);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    scatter_kernel<<<blocks_for(n, kThreads), kThreads, 0, st>>>(
        u_lo, u_hi, values, n, salt, mask, s.pair, s.arrival, s.rec);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  if (!keep_walkers) {
    wide_rows_kernel<<<blocks_for(n_rows, kWarps * kRunRows), kThreads, 0,
                       st>>>(s.pair, s.rec, n_rows, max_walk, table, bad);
  } else {
    if (n > 0) {
      rank_kernel<<<blocks_for(n, kThreads), kThreads, 0, st>>>(
          s.rec, s.pair, n_rows, salt, s.sorted);
      if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);
    }
    slot_rows_kernel<<<blocks_for(n_rows, kWarps * kSlotRunRows), kThreads,
                       0, st>>>(s.pair, s.sorted, n_rows, max_walk,
                                wrap != 0, table, bad, walk);
    if (wrap && n > 0) {
      if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);
      wrap_kernel<<<1, kThreads, 0, st>>>(s.pair, s.sorted, n_rows, salt,
                                          table, bad, walk);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The close set's union table, from the raw keys of its close genomes.
//
// Replaces no TPU kernel: the reference takes np.unique of the close set's
// concatenated singleton keys and builds the union's wide table on the host
// (kmers_anno_tpu/engine/projection.py:1239-1250).  Plain version:
// ops/table_build.union_dedupe and union_build on CPU tensors.
//
// The function.  The distinct real keys of the input (EMPTY pads skipped),
// n_d of them, into a wide table of n_rows rows at salt GOLDEN with payload
// 0: each key in its home row fmix32(lo ^ fmix32(hi ^ GOLDEN)) & (n_rows -
// 1), at its rank in ascending (hi << 32 | lo) order among that row's keys,
// EMPTY and 0 past them.  Where no row holds more than 24 keys that is the
// table build_wide_table gives np.unique's keys at its first salt: its
// walk limit is 1, so every key sits in its home row, in the order of the
// stable sort by home of keys in ascending order.  A row of more than 24
// keys sets bad (the host's overflow at GOLDEN); the caller then takes the
// host's salt-retry build.
//
// Two entry points, because n_rows = wide_rows_for(n_d) waits on n_d:
//   kan_union_dedupe  the keys grouped by home at the wide table's row cap
//       (2^18 rows; ops/widetable.MAX_WIDE_ROWS): zero; count (a thread a
//       key, an atomicAdd on its row); the scan above, with 0 slots (each
//       row's run's end); scatter (a thread a key, (lo, hi) at its run's
//       end less an atomic decrement of the row's count); dedupe (a warp a
//       row: union_dedupe_kernel).  It writes n_d and bad into totals.  A
//       row at the cap past 24 distinct keys is bad at any n_rows, since a
//       table row holds every key of the cap rows congruent to it.
//   kan_union_build  the table at n_rows (a power of two up to the cap):
//       a warp a run of 8 rows (union_rows_kernel); at the cap each row
//       takes one dedupe row's keys, below it kUnionRows / n_rows of them.
// Rows are ranked by key and written whole, so the atomics' order never
// shows and every launch writes the same table.  A dedupe row costs a few
// warp instructions a raw key whatever its length (a row past 24 distinct
// keys stops); a table row at most 24 compares a key.
//
// What bounds it on this card: bytes.  Each raw key's 8 bytes read once and
// the table written once: the projection cell's ~9.06M raw keys and its
// 262,144-row table (75.5 MB), 148 MB, 0.044 ms at 3.35 TB/s.  The passes
// read the keys twice (count, scatter), move them through the record array
// twice more (the scatter's store, the dedupe's read) and land the count's
// and scatter's atomics at random rows; 72 MB of raw keys do not fit the
// 50 MB L2.

// lo / hi: (n,) 32-bit keys, EMPTY in pads, n < 2^31; scratch:
// union_scratch_bytes(n) bytes of device memory, 16-byte aligned, kept for
// kan_union_build; totals: two int32, written: the distinct keys (n_d,
// meaningful only without bad) and bad (1 when a row at the cap holds more
// than 24 distinct keys).
extern "C" int kan_union_dedupe(const int32_t* lo, const int32_t* hi,
                                int64_t n, void* scratch,
                                int64_t scratch_bytes, int32_t* totals,
                                void* stream) {
  if (n < 0 || n >= (int64_t{1} << 31) ||
      reinterpret_cast<uintptr_t>(scratch) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const UnionScratch s = carve_union(static_cast<char*>(scratch), n);
  if (scratch_bytes < s.bytes) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const auto u_lo = reinterpret_cast<const uint32_t*>(lo);
  const auto u_hi = reinterpret_cast<const uint32_t*>(hi);
  cudaError_t err;

  const int64_t n_vec = s.zero_bytes / 16;
  union_zero_kernel<<<blocks_for(n_vec, kThreads), kThreads, 0, st>>>(
      reinterpret_cast<int4*>(s.cnt), n_vec, totals);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    union_count_kernel<<<blocks_for(n, kThreads), kThreads, 0, st>>>(
        u_lo, u_hi, n, s.cnt);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  scan_kernel<<<blocks_for(kUnionRows, kScanTile), kThreads, 0, st>>>(
      s.cnt, kUnionRows, 0, s.status, s.ticket, s.pair);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    union_scatter_kernel<<<blocks_for(n, kThreads), kThreads, 0, st>>>(
        u_lo, u_hi, n, s.pair, s.cnt, s.rec);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  union_dedupe_kernel<<<blocks_for(kUnionRows, kWarps), kThreads, 0, st>>>(
      s.pair, s.rec, s.cnt, totals);
  return static_cast<int>(cudaGetLastError());
}

// scratch / n: as kan_union_dedupe left them, with no bad; n_rows a power
// of two up to 2^18; table: (n_rows, 72) int32, written whole; bad: one
// byte, written: 1 when a row holds more than 24 keys, else 0.
extern "C" int kan_union_build(const void* scratch, int64_t n,
                               int64_t n_rows, int32_t* table, uint8_t* bad,
                               void* stream) {
  if (n < 0 || n >= (int64_t{1} << 31) || n_rows < 1 ||
      n_rows > kUnionRows || (n_rows & (n_rows - 1)) ||
      reinterpret_cast<uintptr_t>(scratch) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const UnionScratch s =
      carve_union(static_cast<char*>(const_cast<void*>(scratch)), n);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  zero_kernel<<<1, kThreads, 0, st>>>(nullptr, 0, bad, nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  union_rows_kernel<<<blocks_for(n_rows, kWarps * kUnionRun), kThreads, 0,
                      st>>>(s.pair, s.rec, s.cnt, n_rows, table, bad);
  return static_cast<int>(cudaGetLastError());
}
