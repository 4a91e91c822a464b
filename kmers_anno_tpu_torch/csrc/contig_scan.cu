// Contig scanner: codon translation + protein k-mer packing over a DNA
// code stream, one output per base.
//
// Replaces the TPU kernel kmers_anno_tpu/ops/pallas_contig.py · _kernel
// (driven by _scan_device).  Position p of the stream gets the k-mer whose
// amino acids are the codons at p, p+3, ..., p+3(k-1):
//
//   lo[p]  = aa_0 | aa_1 << 5 | ... | aa_5 << 25      (5 bits per residue)
//   hi[p]  = aa_6 | ... | aa_11 << 25
//   bad[p] = 1 if any aa is 'X' (23), '*' (26) or >= PROT_PAD (31)
//
// A codon with any base code > 3 translates through LUT entry 64.  Reads
// past the end of the stream see code 4 (ambiguous), so every output is
// defined; outputs at p >= n - 3k + 1 have bad = 1 and the caller masks
// them anyway.
//
// What bounds it on an H100: device memory.  Per base it reads 1 byte and
// writes 9 (two int32 words and one flag byte) with a few dozen integer
// operations, so the bound is bytes over 3.35 TB/s, and the kernel has to
// keep many bytes in flight on every SM and write in wide, coalesced
// stores.  The TPU version's 64x128 tiles, two-row DMA halo and lane
// rolls do not carry over.  The design:
//
//  * gives each block a tile of 4096 outputs.  It stages the tile's codes
//    plus the 3k-1 halo into shared memory with 16-byte loads from the
//    16-byte boundary at or below the tile's first base, so a stream that
//    starts anywhere (a slice) still loads whole vectors; vectors that
//    cross the stream's ends are filled byte by byte, with code 4 past
//    them.
//  * translates each codon once, four at a time: the three codes of four
//    neighbouring codons are word shifts of the staged words, their LUT
//    indices are built with byte-wise masks and shifts, and an ambiguous
//    codon's index gets bit 6, so that it reads one of 64 copies of entry
//    64.  The 128-entry LUT carries a spare bit (0x20) on every residue
//    that breaks a window, so a window's bad flag is one OR of its k bytes.
//  * packs four consecutive outputs a thread from the shared residues
//    (k is a template parameter, so every shift is a constant), and writes
//    them as one 16-byte store of lo, one of hi and a 4-byte store of bad;
//    neighbouring threads own neighbouring groups, so a warp writes 512
//    contiguous bytes of lo and hi and 128 of bad per store.
//  * takes the LUT by value, as a 128-byte kernel parameter filled on the
//    host from the 65 bytes the caller passes: no symbol copy on the
//    stream, and launches on several streams with different genetic codes
//    cannot disturb each other.  Each block copies it once into shared
//    memory, where its 32 words sit in 32 banks and the lane-divergent
//    lookups are free of conflicts (divergent reads of the parameter bank
//    itself would serialise).
//
// ptxas: 27-30 registers a thread, 8,488 bytes of shared memory a block,
// no spills.  Measured on an NVIDIA H100 80GB HBM3 at 700.00 W
// (chip_smoke.py, `launch_ms`: launches back to back): 0.0245 ms on a
// 6,291,456-base stream, 77% of its 0.0188 ms bound (2.57 TB/s); 0.0131
// ms on a 2,942,483-base strand, 67%: a strand is 719 blocks, under one
// wave of resident blocks, so the ramp and tail weigh more.  PERF.md has
// the rest.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;                 // outputs a block
constexpr int kGroups = kTile / 4;          // four-output groups a block
constexpr int kMaxK = 12;
constexpr int kLutBytes = 128;              // 64 codons, 64 copies of entry 64
// 16-byte vectors staged a block: the tile, the 3k-1 halo, up to 15 bytes
// before the tile's first base, and the last translated word's reach
constexpr int kStageVecs = kTile / 16 + 8;
constexpr uint32_t kBadBit = 0x20;
constexpr uint32_t kProtX = 23;
constexpr uint32_t kProtStop = 26;
constexpr uint32_t kProtPad = 31;
constexpr uint32_t kDnaAmbig = 4;

struct CodonLut {
  uint32_t w[kLutBytes / 4];
};

// Residue words one group reads: its bytes 0 .. 3k, plus one for the
// funnel shifts of the bad flags.
__host__ __device__ constexpr int group_words(int k) { return 3 * k / 4 + 2; }

template <int K>
__global__ void __launch_bounds__(kThreads)
contig_scan_kernel(const uint8_t* __restrict__ codes, int64_t n,
                   const __grid_constant__ CodonLut lut,
                   int32_t* __restrict__ lo, int32_t* __restrict__ hi,
                   uint8_t* __restrict__ bad) {
  constexpr int kWords = group_words(K);
  constexpr int kAaWords = kGroups + kWords - 1;   // residue words a block
  __shared__ uint32_t s_lut[kLutBytes / 4];
  __shared__ uint4 s_codes[kStageVecs];
  __shared__ uint32_t s_aa[kGroups + group_words(kMaxK) - 1];

  const int tid = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  // staged byte i is stream byte base - shift + i
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(codes) & 15);

  if (tid < kLutBytes / 4) s_lut[tid] = lut.w[tid];
  for (int v = tid; v < kStageVecs; v += kThreads) {
    const int64_t g0 = base - shift + 16 * v;
    uint4 q;
    if (g0 >= 0 && g0 + 16 <= n) {
      q = __ldg(reinterpret_cast<const uint4*>(codes + g0));
    } else {                       // crosses an end of the stream
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int64_t g = g0 + 4 * i + b;
          const uint32_t c = (g >= 0 && g < n) ? codes[g] : kDnaAmbig;
          word |= c << (8 * b);
        }
        w[i] = word;
      }
      q = make_uint4(w[0], w[1], w[2], w[3]);
    }
    s_codes[v] = q;
  }
  __syncthreads();

  // residue word w: the codons at tile positions 4w .. 4w+3
  const uint32_t* sc = reinterpret_cast<const uint32_t*>(s_codes) +
                       (shift >> 2);
  const uint32_t fs = 8 * (shift & 3);
  const uint8_t* sl = reinterpret_cast<const uint8_t*>(s_lut);
  for (int w = tid; w < kAaWords; w += kThreads) {
    const uint32_t a = sc[w], b = sc[w + 1], c = sc[w + 2];
    const uint32_t c0 = __funnelshift_r(a, b, fs);     // first bases
    const uint32_t x1 = __funnelshift_r(b, c, fs);
    const uint32_t c1 = __funnelshift_r(c0, x1, 8);    // second bases
    const uint32_t c2 = __funnelshift_r(c0, x1, 16);   // third bases
    const uint32_t high = (c0 | c1 | c2) & 0xFCFCFCFCu;
    const uint32_t amb =            // 0x80 in each byte with a code > 3
        (((high & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | high) & 0x80808080u;
    const uint32_t idx = ((c0 & 0x03030303u) << 4) |
                         ((c1 & 0x03030303u) << 2) | (c2 & 0x03030303u) |
                         (amb >> 1);
    s_aa[w] = static_cast<uint32_t>(sl[idx & 0xFF]) |
              static_cast<uint32_t>(sl[(idx >> 8) & 0xFF]) << 8 |
              static_cast<uint32_t>(sl[(idx >> 16) & 0xFF]) << 16 |
              static_cast<uint32_t>(sl[idx >> 24]) << 24;
  }
  __syncthreads();

  // group g: outputs base + 4g .. base + 4g + 3
  for (int g = tid; g < kGroups; g += kThreads) {
    const int64_t p = base + 4 * g;
    if (p >= n) break;
    uint32_t A[kWords];
#pragma unroll
    for (int m = 0; m < kWords; ++m) A[m] = s_aa[g + m];
    uint32_t l[4], h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t lv = 0, hv = 0;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int o = i + 3 * j;
        const uint32_t r = (A[o >> 2] >> (8 * (o & 3))) & 31u;
        if (j < 6)
          lv |= r << (5 * j);
        else
          hv |= r << (5 * (j - 6));
      }
      l[i] = lv;
      h[i] = hv;
    }
    // byte i of the word at byte offset 3j is residue j of output i
    uint32_t f = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int o = 3 * j;
      f |= (o & 3) ? __funnelshift_r(A[o >> 2], A[(o >> 2) + 1], 8 * (o & 3))
                   : A[o >> 2];
    }
    const uint32_t flags = (f >> 5) & 0x01010101u;
    if (p + 4 <= n) {
      *reinterpret_cast<int4*>(lo + p) = make_int4(
          static_cast<int>(l[0]), static_cast<int>(l[1]),
          static_cast<int>(l[2]), static_cast<int>(l[3]));
      *reinterpret_cast<int4*>(hi + p) = make_int4(
          static_cast<int>(h[0]), static_cast<int>(h[1]),
          static_cast<int>(h[2]), static_cast<int>(h[3]));
      *reinterpret_cast<uint32_t*>(bad + p) = flags;
    } else {                       // the stream's last, partial group
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (p + i < n) {
          lo[p + i] = static_cast<int32_t>(l[i]);
          hi[p + i] = static_cast<int32_t>(h[i]);
          bad[p + i] = static_cast<uint8_t>((flags >> (8 * i)) & 1u);
        }
      }
    }
  }
}

template <int K>
cudaError_t launch(const uint8_t* codes, int64_t n, const CodonLut& lut,
                   int32_t* lo, int32_t* hi, uint8_t* bad, cudaStream_t s) {
  const int64_t blocks = (n + kTile - 1) / kTile;
  contig_scan_kernel<K><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      codes, n, lut, lo, hi, bad);
  return cudaGetLastError();
}

}  // namespace

// codes: (n,) uint8 device, any alignment; lut65: 65 host bytes, each a
// 5-bit residue code; outputs (n,) device, 16-byte aligned.
extern "C" int kan_contig_scan(const uint8_t* codes, int64_t n,
                               const uint8_t* lut65, int k, int32_t* lo,
                               int32_t* hi, uint8_t* bad, void* stream) {
  if (n <= 0 || k < 1 || k > kMaxK) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(lo) | reinterpret_cast<uintptr_t>(hi) |
       reinterpret_cast<uintptr_t>(bad)) & 15)
    return cudaErrorMisalignedAddress;
  CodonLut lut;
  uint8_t* bytes = reinterpret_cast<uint8_t*>(lut.w);
  for (int i = 0; i < kLutBytes; ++i) {
    const uint32_t v = lut65[i < 64 ? i : 64];
    if (v > kProtPad) return cudaErrorInvalidValue;   // not a 5-bit code
    const bool breaks = v == kProtX || v == kProtStop || v >= kProtPad;
    bytes[i] = static_cast<uint8_t>(v | (breaks ? kBadBit : 0));
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(codes, n, lut, lo, hi, bad, s);
    case 2: return launch<2>(codes, n, lut, lo, hi, bad, s);
    case 3: return launch<3>(codes, n, lut, lo, hi, bad, s);
    case 4: return launch<4>(codes, n, lut, lo, hi, bad, s);
    case 5: return launch<5>(codes, n, lut, lo, hi, bad, s);
    case 6: return launch<6>(codes, n, lut, lo, hi, bad, s);
    case 7: return launch<7>(codes, n, lut, lo, hi, bad, s);
    case 8: return launch<8>(codes, n, lut, lo, hi, bad, s);
    case 9: return launch<9>(codes, n, lut, lo, hi, bad, s);
    case 10: return launch<10>(codes, n, lut, lo, hi, bad, s);
    case 11: return launch<11>(codes, n, lut, lo, hi, bad, s);
    default: return launch<12>(codes, n, lut, lo, hi, bad, s);
  }
}
