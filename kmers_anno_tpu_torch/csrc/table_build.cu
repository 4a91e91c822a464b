// Device build of a bucketed hash table from EMPTY-padded unique keys, in
// either layout: the wide-bucket table (24 slots a row) and the 8-slot
// table.
//
// Replaces kmers_anno_tpu/ops/widetable.py · build_wide_table_device (:153)
// and kmers_anno_tpu/ops/hashtable.py · build_table_device (:129), XLA
// programs on the TPU (argsort + associative max-scan + scatter), as the
// projection engine calls them for each close genome's singleton table
// (engine/projection.py:213 and :219, used at :1170, :1182 and :1259).
// Plain version: ops/table_build.build_table_plain.
//
// The function.  A key i is real unless lo[i] == EMPTY (0xFFFFFFFF).  Its
// home row is fmix32(lo ^ fmix32(hi ^ salt)) & (rows - 1) (salt GOLDEN for
// the 8-slot layout: the unsalted mix_kmer); a pad's home is `rows`, so
// that pads sort last.  With the keys sorted by home, stably, the key at
// rank i takes slot pos = i + max over j <= i of (home_j * S - j), S slots
// a row: the greedy placement that fills each row in rank order and sends
// a full row's overflow on to the next row.  Its walk is pos / S - home.
// `bad` is set when a real key has pos >= rows * S (it would wrap past the
// last row) or a walk of max_walk or more (1 for the wide layout, whose
// probe reads one row; 2, MAX_DEVICE_PROBES, for the 8-slot layout).  A
// key is written where pos < rows * S and, unless keep_walkers, its walk
// is 0: the wide layout drops the keys that walk, the 8-slot layout keeps
// them, as the two reference builds do.  The table's rows are
// [S lo keys | S hi keys | S payloads]; the wrapper fills it with EMPTY
// keys and 0 payloads first.
//
// Two entry points, with the sort between them: kan_table_homes (one
// thread a key: the home), then torch.sort(stable=True) of the homes (the
// reference sorts with XLA's argsort, outside any kernel), then
// kan_table_place: a pass of tile maxima of home * S - i (1,024 ranks a
// tile), one block's exclusive max-scan of the tile maxima (each tile's
// carry), and the place pass, a block a tile: each thread's 4 ranks, an
// inclusive max-scan across the block's threads by warp shuffles, the
// carry, then the scatter of lo, hi and payload through the sort's order.
// A block that holds a bad key sets the flag once, with atomicOr; the
// wrapper's caller reads it on the host once a build.
//
// What bounds it on this card: bytes.  A build of n keys into a table of
// B bytes reads each key's 12 bytes once and writes B, and its sort reads
// the 4-byte homes and writes the sorted homes and their 8-byte order: on
// the projection's close tables (914,109 keys padded to 1,048,576; 131,072
// rows of 288 bytes) 67 MB, 0.020 ms at 3.35 TB/s.  Measured there
// (PERF.md, Findings; NVIDIA H100 80GB HBM3, 700 W): 0.358 ms a build
// through the wrapper, of which the stable sort takes 0.108 ms and the two
// entry points 0.126 ms; the table's fill, the allocations and the
// launches the rest.  The design is the simple one, one pass a step at one
// thread a key; the place pass reads each key's lo, hi and payload through
// the sort's order, three scattered 4-byte reads a key.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr int kThreads = 256;            // threads a block
constexpr int kItems = 4;                // ranks a thread
// ranks a tile: ops/table_build.KERNEL_TILE
constexpr int kTile = kThreads * kItems;
constexpr int kScanThreads = 1024;       // the carry scan's one block
constexpr unsigned kFullMask = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ int64_t lead(const int32_t* __restrict__ hb,
                                        int64_t i, int slots) {
  return static_cast<int64_t>(__ldg(hb + i)) * slots - i;
}

// Inclusive max-scan of one value a thread across the block; `warp_tot`
// holds blockDim.x / 32 entries.  Returns the thread's inclusive maximum.
__device__ __forceinline__ int64_t block_scan_max(int64_t v,
                                                  int64_t* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t o = __shfl_up_sync(kFullMask, v, d);
    if (lane >= d) v = max(v, o);
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int64_t t = lane < n_warps ? warp_tot[lane] : INT64_MIN;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t o = __shfl_up_sync(kFullMask, t, d);
      if (lane >= d) t = max(t, o);
    }
    if (lane < n_warps) warp_tot[lane] = t;
  }
  __syncthreads();
  if (warp > 0) v = max(v, warp_tot[warp - 1]);
  return v;
}

__global__ void __launch_bounds__(kThreads)
homes_kernel(const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
             int64_t n, uint32_t mask, uint32_t salt,
             int32_t* __restrict__ home) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t l = __ldg(lo + i);
  home[i] = l == kEmpty
                ? static_cast<int32_t>(mask + 1u)
                : static_cast<int32_t>(fmix32(l ^ fmix32(__ldg(hi + i) ^
                                                          salt)) & mask);
}

// The maximum of home * S - i over each tile of sorted ranks.
__global__ void __launch_bounds__(kThreads)
tile_max_kernel(const int32_t* __restrict__ hb, int64_t n, int slots,
                int64_t* __restrict__ tile_max) {
  __shared__ int64_t warp_max[kThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  int64_t m = INT64_MIN;
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int64_t i = base + j;
    if (i < n) m = max(m, lead(hb, i, slots));
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    m = max(m, __shfl_xor_sync(kFullMask, m, d));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
    tile_max[blockIdx.x] = m;
  }
}

// In place: tile_max[t] becomes the maximum over tiles 0 .. t-1 (INT64_MIN
// for tile 0), the carry of tile t.  One block, in chunks of its width.
__global__ void __launch_bounds__(kScanThreads)
carry_kernel(int64_t* __restrict__ tile_max, int64_t n_tiles) {
  __shared__ int64_t warp_tot[kScanThreads / 32];
  __shared__ int64_t last;
  int64_t running = INT64_MIN;
  for (int64_t c = 0; c < n_tiles; c += kScanThreads) {
    const int64_t t = c + threadIdx.x;
    const int64_t v = t < n_tiles ? tile_max[t] : INT64_MIN;
    const int64_t incl = block_scan_max(v, warp_tot);
    // the exclusive maximum: the inclusive one of the thread before
    const int64_t before = __shfl_up_sync(kFullMask, incl, 1);
    int64_t excl = (threadIdx.x & 31) ? before : INT64_MIN;
    if ((threadIdx.x & 31) == 0 && threadIdx.x > 0)
      excl = warp_tot[(threadIdx.x >> 5) - 1];
    if (t < n_tiles) tile_max[t] = max(running, excl);
    if (threadIdx.x == kScanThreads - 1) last = incl;
    __syncthreads();
    running = max(running, last);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
place_kernel(const int32_t* __restrict__ hb, const int64_t* __restrict__ order,
             const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
             const int32_t* __restrict__ values, int64_t n, int64_t n_rows,
             int slots, int max_walk, int keep_walkers,
             const int64_t* __restrict__ carry, int32_t* __restrict__ table,
             int32_t* __restrict__ bad) {
  __shared__ int64_t warp_tot[kThreads / 32];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kTile +
                        static_cast<int64_t>(threadIdx.x) * kItems;
  int64_t run[kItems];
  int64_t m = INT64_MIN;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = first + j;
    if (i < n) m = max(m, lead(hb, i, slots));
    run[j] = m;
  }
  // the maximum over every rank before this thread's first
  const int64_t incl = block_scan_max(m, warp_tot);
  int64_t before = __shfl_up_sync(kFullMask, incl, 1);
  if ((threadIdx.x & 31) == 0)
    before = threadIdx.x > 0 ? warp_tot[(threadIdx.x >> 5) - 1] : INT64_MIN;
  const int64_t prefix = max(before, carry[blockIdx.x]);

  const int64_t cap = n_rows * slots;
  bool is_bad = false;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = first + j;
    if (i >= n) break;
    const int64_t home = __ldg(hb + i);
    const int64_t pos = i + max(prefix, run[j]);
    const bool ok = pos < cap;
    const int64_t walk = ok ? pos / slots - home : 0;
    if (home < n_rows && (!ok || walk >= max_walk)) is_bad = true;
    if (!ok || (!keep_walkers && walk > 0)) continue;
    const int64_t src = order[i];
    int32_t* row = table + (pos / slots) * 3 * slots + pos % slots;
    row[0] = __ldg(lo + src);
    row[slots] = __ldg(hi + src);
    row[2 * slots] = __ldg(values + src);
  }
  if (__syncthreads_or(is_bad) && threadIdx.x == 0) atomicOr(bad, 1);
}

}  // namespace

// lo / hi: (n,) 32-bit keys, EMPTY in pads; home: (n,) int32, written:
// the home row of each key at `salt` in a table of n_rows (a power of two)
// rows, n_rows for a pad.
extern "C" int kan_table_homes(const int32_t* lo, const int32_t* hi,
                               int64_t n, int64_t n_rows, uint32_t salt,
                               int32_t* home, void* stream) {
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) /
                                                  kThreads);
    homes_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const uint32_t*>(lo),
        reinterpret_cast<const uint32_t*>(hi), n,
        static_cast<uint32_t>(n_rows - 1), salt, home);
  }
  return static_cast<int>(cudaGetLastError());
}

// hb: (n,) int32 homes in stable sorted order; order: (n,) int64, the
// sort's indices into lo / hi / values (n,) 32-bit; tile_max: scratch of
// ceil(n / 1024) int64; table: (n_rows, 3 * slots) int32, filled by the
// caller with EMPTY keys and 0 payloads; bad: one int32 the caller zeroed,
// set to 1 when a real key walks max_walk rows or more or wraps.
extern "C" int kan_table_place(const int32_t* hb, const int64_t* order,
                               const int32_t* lo, const int32_t* hi,
                               const int32_t* values, int64_t n,
                               int64_t n_rows, int32_t slots,
                               int32_t max_walk, int32_t keep_walkers,
                               int64_t* tile_max, int32_t* table,
                               int32_t* bad, void* stream) {
  if (n > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    const int64_t n_tiles = (n + kTile - 1) / kTile;
    const unsigned tiles = static_cast<unsigned>(n_tiles);
    tile_max_kernel<<<tiles, kThreads, 0, s>>>(hb, n, slots, tile_max);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    carry_kernel<<<1, kScanThreads, 0, s>>>(tile_max, n_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    place_kernel<<<tiles, kThreads, 0, s>>>(hb, order, lo, hi, values, n,
                                            n_rows, slots, max_walk,
                                            keep_walkers, tile_max, table,
                                            bad);
  }
  return static_cast<int>(cudaGetLastError());
}
