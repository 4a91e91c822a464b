// hashAnno's chunk step: the common-kmer count matrix of one prototype chunk
// and the exact first-max best-proposal update.
//
// Replaces kmers_anno_tpu/engine/hashanno.py · _chunk_commons_body (:122,
// with the ops/hashtable.probe_table call before it, :423) and the floor,
// tournament and state update of _chunk_best (:71-119), XLA kernels on the
// TPU.  Plain versions: ops/hash_chunk.py.
//
// kan_hash_commons: a block of 1,024 threads counts a tile of kTileKmers
// chunk kmers (lo, hi, prototype row, valid), one a thread.  A thread
// walks the 8-slot table (bucket_probe.cuh), and on a hit reads the kmer's
// owner row owner_mat[rank, :cap], in 16-byte pieces when cap is a multiple
// of 4.
// Each owner below n_pad (the padding value, never written) is one count
// for the cell row * n_pad + owner, added into the block's table of
// (cell, count) in shared memory (open addressing, atomicCAS to claim a
// slot); at the end of the tile each cell of the table is one global
// atomicAdd.  The table keeps at most kTableCells cells; a count for a new
// cell past that goes straight to the global matrix, so the counts are
// exact in any order of the chunk's kmers.
//
// It replaces one thread a kmer with one global atomic a count.  On the
// bench shape's first chunk that made 3.27M atomics on 16,450 cells, and
// on the kmers in key order (as the engine then packed them) it took
// 0.058 ms on an H100.  The engine now packs a chunk prototype by
// prototype (engine/hashanno.py, PrototypeSet.chunks), so a tile covers a
// few prototypes and a few dozen cells, and a chunk needs some 20,000
// global adds.  What bounds it then is the lookups: a bucket's lo keys, a
// hit's hi and payload, its owner row, dependent reads from a 12.6 MB table
// and a 15.8 MB owner matrix on the bench shape, several times that on
// larger genome batches.  In key order, equal kmers of several prototypes
// sit in one warp and share those reads; prototype by prototype they do
// not, so the engine puts prototypes that share their smallest kmer side by
// side, and a block reads their buckets and owner rows into its cache once.
// Merging equal cells across a warp first (__match_any_sync, or a ballot
// on the first lane's cell) measured slower than the shared-memory adds.
//// kan_hash_best: one thread a (protein column, row slice).  A block is 32
// columns (one warp's lanes: each row read is one coalesced 128-byte line)
// by 16 row slices (one warp each, a contiguous range of rows).  A thread
// walks its rows in order and keeps the first strict maximum of c / u
// (compared as c1 * u2 > c2 * u1 in int32: c, u < 2^15 under the engine's
// length guard), after the min-score floor c >= minc[clamp(u, 1, M - 1)];
// a zero count never wins.  Slice 0 then folds the 16 slices in order with
// the same strict compare, which keeps the first maximum of the whole
// column (the winner of the reference's log2 tournament, where ties go to
// the lower row), and applies the state update.  Each non-zero cell is
// cleared as it is read, so the next chunk needs no memset; the matrix is
// sparse (a prototype shares kmers with a few proteins), so the clearing
// writes little.  What bounds it: reading the (rows, n_pad) count matrix
// once from device memory; eight rows' loads are issued before any is
// used, to keep enough bytes in flight.

#include <cstdint>
#include <cuda_runtime.h>

#include "bucket_probe.cuh"

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr int kTileKmers = 1024;
constexpr int kCommonsThreads = kTileKmers;   // one chunk kmer a thread
constexpr int kTableCells = 1024;
// at most kTableCells - 1 + kCommonsThreads slots are ever claimed (a claim
// reads the cell count before its atomicCAS), so a walk always ends
constexpr int kSlotBits = 11;
constexpr int kTableSlots = 1 << kSlotBits;
constexpr uint32_t kNoCell = 0xFFFFFFFFu;
constexpr int kCols = 32;
constexpr int kSlices = 16;
constexpr int kUnroll = 8;

struct CellTable {
  uint32_t cell[kTableSlots];
  uint32_t count[kTableSlots];
  uint32_t used;
};

static_assert(kTableCells - 1 + kCommonsThreads < kTableSlots,
              "the cell table must always keep a free slot");

// Count one for `cell` in the block's table, or straight in the global
// matrix once the table holds kTableCells cells and `cell` is not one.
__device__ __forceinline__ void add_cell(CellTable& t, int32_t* common,
                                         uint32_t cell) {
  volatile uint32_t* cells = t.cell;
  uint32_t s = (cell * kGolden) >> (32 - kSlotBits);
  while (true) {
    uint32_t c = cells[s];
    if (c == kNoCell) {
      if (*static_cast<volatile uint32_t*>(&t.used) >= kTableCells) {
        atomicAdd(common + cell, 1);
        return;
      }
      c = atomicCAS(&t.cell[s], kNoCell, cell);
      if (c == kNoCell) {
        atomicAdd(&t.used, 1u);
        atomicAdd(&t.count[s], 1u);
        return;
      }
    }
    if (c == cell) {
      atomicAdd(&t.count[s], 1u);
      return;
    }
    s = (s + 1) & (kTableSlots - 1);
  }
}

__global__ void __launch_bounds__(kCommonsThreads)
hash_commons_kernel(const uint32_t* __restrict__ table, uint32_t mask,
                    int max_probes, const int32_t* __restrict__ owner_mat,
                    int cap, const uint32_t* __restrict__ q_lo,
                    const uint32_t* __restrict__ q_hi,
                    const int32_t* __restrict__ proto,
                    const uint8_t* __restrict__ valid, int64_t h,
                    int32_t n_rows, int32_t n_pad, int32_t* common,
                    int32_t* ranks) {
  __shared__ CellTable t;
  for (int s = threadIdx.x; s < kTableSlots; s += kCommonsThreads) {
    t.cell[s] = kNoCell;
    t.count[s] = 0;
  }
  if (threadIdx.x == 0) t.used = 0;
  __syncthreads();
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kTileKmers + threadIdx.x;
  if (i < h) {
    const int32_t rank =
        valid[i]
            ? kan::probe_bucket_key(table, mask, q_lo[i], q_hi[i],
                                    max_probes)
            : -1;
    if (ranks) ranks[i] = rank;
    const int32_t p = proto[i];
    if (rank >= 0 &&
        static_cast<uint32_t>(p) < static_cast<uint32_t>(n_rows)) {
      const int32_t* own = owner_mat + static_cast<int64_t>(rank) * cap;
      const uint32_t row = static_cast<uint32_t>(p) * n_pad;
      if ((cap & 3) == 0 &&
          (reinterpret_cast<uintptr_t>(owner_mat) & 15) == 0) {
        // the row in 16-byte pieces, two loads in flight at a time
        const uint4* own4 = reinterpret_cast<const uint4*>(own);
        for (int q = 0; q < cap / 4; q += 2) {
          const uint4 a = __ldg(own4 + q);
          const uint4 b =
              q + 1 < cap / 4
                  ? __ldg(own4 + q + 1)
                  : make_uint4(kNoCell, kNoCell, kNoCell, kNoCell);
          const uint32_t o[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (o[j] < static_cast<uint32_t>(n_pad))
              add_cell(t, common, row + o[j]);
        }
      } else {
        for (int j = 0; j < cap; ++j) {
          const uint32_t o = static_cast<uint32_t>(__ldg(own + j));
          if (o < static_cast<uint32_t>(n_pad)) add_cell(t, common, row + o);
        }
      }
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < kTableSlots; s += kCommonsThreads) {
    const uint32_t cell = t.cell[s];
    if (cell != kNoCell)
      atomicAdd(common + cell, static_cast<int32_t>(t.count[s]));
  }
}

struct Best {
  int32_t c, u, r;
};

// Row r of a column with count c: keep it if it clears the floor and beats
// the running best strictly.
__device__ __forceinline__ void consider(Best& best, int32_t c, int32_t r,
                                         int32_t n1p,
                                         const int32_t* __restrict__ n2,
                                         const int32_t* __restrict__ minc,
                                         int32_t n_minc) {
  const int32_t u = n1p + __ldg(n2 + r) - c;
  const int32_t uc = min(max(u, 1), n_minc - 1);
  if (c < __ldg(minc + uc)) return;
  if (c * best.u > best.c * u) best = Best{c, u, r};
}

__global__ void __launch_bounds__(kCols * kSlices)
hash_best_kernel(int32_t* common, int32_t n_rows, int32_t n_pad,
                 const int32_t* __restrict__ n1,
                 const int32_t* __restrict__ n2,
                 const int32_t* __restrict__ minc, int32_t n_minc,
                 int32_t* state_c, int32_t* state_u, int32_t* state_i,
                 int32_t* state_m, int32_t chunk_base) {
  __shared__ Best part[kSlices][kCols];
  const int lane = threadIdx.x;
  const int slice = threadIdx.y;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kCols + lane;
  const bool live = p < n_pad;
  const int32_t per = (n_rows + kSlices - 1) / kSlices;
  const int32_t r0 = min(slice * per, n_rows);
  const int32_t r1 = min(r0 + per, n_rows);
  Best best{0, 1, 0};
  if (live) {
    const int32_t n1p = n1[p];
    int32_t* col = common + p;
    int32_t r = r0;
    for (; r + kUnroll <= r1; r += kUnroll) {
      int32_t c[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        c[j] = col[static_cast<int64_t>(r + j) * n_pad];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (c[j]) {
          col[static_cast<int64_t>(r + j) * n_pad] = 0;
          consider(best, c[j], r + j, n1p, n2, minc, n_minc);
        }
      }
    }
    for (; r < r1; ++r) {
      const int32_t c = col[static_cast<int64_t>(r) * n_pad];
      if (c) {
        col[static_cast<int64_t>(r) * n_pad] = 0;
        consider(best, c, r, n1p, n2, minc, n_minc);
      }
    }
  }
  part[slice][lane] = best;
  __syncthreads();
  if (slice != 0) return;
  for (int s = 1; s < kSlices; ++s) {
    const Best b = part[s][lane];
    if (b.c * best.u > best.c * b.u) best = b;
  }
  bool improved = false;
  if (live) {
    const int32_t oc = state_c[p];
    const int32_t ou = state_u[p];
    improved = best.c > 0 && best.c * ou > oc * best.u;
    if (improved) {
      state_c[p] = best.c;
      state_u[p] = best.u;
      state_i[p] = chunk_base + best.r;
    }
  }
  const int32_t n_improved = __reduce_add_sync(0xFFFFFFFFu, improved ? 1 : 0);
  if (lane == 0 && n_improved) atomicAdd(state_m, n_improved);
}

}  // namespace

// table: (n_buckets, 24) 32-bit words, n_buckets a power of two, 16-byte
// aligned; owner_mat: (U, cap) int32; q_lo / q_hi / proto: (h,) int32,
// valid: (h,) bytes; common: (>= n_rows, n_pad) int32, added into, with
// n_rows * n_pad < 2^31 cells; ranks: (h,) int32 or null.
extern "C" int kan_hash_commons(const int32_t* table, int64_t n_buckets,
                                int max_probes, const int32_t* owner_mat,
                                int64_t cap, const int32_t* q_lo,
                                const int32_t* q_hi, const int32_t* proto,
                                const uint8_t* valid, int64_t h,
                                int64_t n_rows, int64_t n_pad,
                                int32_t* common, int32_t* ranks,
                                void* stream) {
  const int64_t blocks = (h + kTileKmers - 1) / kTileKmers;
  hash_commons_kernel<<<static_cast<unsigned>(blocks), kCommonsThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(table),
      static_cast<uint32_t>(n_buckets - 1), max_probes, owner_mat,
      static_cast<int>(cap), reinterpret_cast<const uint32_t*>(q_lo),
      reinterpret_cast<const uint32_t*>(q_hi), proto, valid, h,
      static_cast<int32_t>(n_rows), static_cast<int32_t>(n_pad), common,
      ranks);
  return static_cast<int>(cudaGetLastError());
}

// common: (>= n_rows, n_pad) int32, rows [0, n_rows) read and cleared;
// n1 / state_c / state_u / state_i: (n_pad,) int32; n2: (>= n_rows,) int32;
// minc: (n_minc,) int32; state_m: (1,) int32.
extern "C" int kan_hash_best(int32_t* common, int64_t n_rows, int64_t n_pad,
                             const int32_t* n1, const int32_t* n2,
                             const int32_t* minc, int64_t n_minc,
                             int32_t* state_c, int32_t* state_u,
                             int32_t* state_i, int32_t* state_m,
                             int64_t chunk_base, void* stream) {
  const int64_t blocks = (n_pad + kCols - 1) / kCols;
  hash_best_kernel<<<static_cast<unsigned>(blocks), dim3(kCols, kSlices), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      common, static_cast<int32_t>(n_rows), static_cast<int32_t>(n_pad), n1,
      n2, minc, static_cast<int32_t>(n_minc), state_c, state_u, state_i,
      state_m, static_cast<int32_t>(chunk_base));
  return static_cast<int>(cudaGetLastError());
}
