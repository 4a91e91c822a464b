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
// What bounds it: memory.  Per base it reads 1 byte and writes 9 (two
// int32 words and one flag byte), with a handful of integer operations,
// so it is a streaming kernel far below the card's compute roofline.  The
// TPU version's 64x128 tiles, two-row DMA halo and lane rolls do not carry
// over.  Here one thread owns one output base; each block stages its
// blockDim codes plus the 3k-1 halo its last window reaches into shared
// memory with coalesced byte loads, translates every staged codon ONCE
// into a shared amino-acid array (instead of k times, once per window
// that uses it), and each thread then packs its k shifted residues from
// shared memory.  The halo costs 3k-1 extra reads per block of 256 (<15%,
// served from L2).  The genetic-code LUT lives in __constant__ memory
// (copied in by the wrapper per launch, stream-ordered) and is staged into
// shared memory, because the codon lookups diverge across a warp and
// divergent constant-cache reads serialise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 12;
constexpr int kLutSize = 65;
constexpr uint32_t kProtX = 23;
constexpr uint32_t kProtStop = 26;
constexpr uint32_t kProtPad = 31;
constexpr uint8_t kDnaAmbig = 4;

__constant__ uint8_t c_lut[kLutSize];

__global__ void __launch_bounds__(kThreads)
contig_scan_kernel(const uint8_t* __restrict__ codes, int64_t n, int k,
                   int32_t* __restrict__ lo, int32_t* __restrict__ hi,
                   uint8_t* __restrict__ bad) {
  __shared__ uint8_t s_lut[kLutSize];
  __shared__ uint8_t s_codes[kThreads + 3 * kMaxK - 1];
  __shared__ uint8_t s_aa[kThreads + 3 * kMaxK - 3];

  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int n_stage = kThreads + 3 * k - 1;   // outputs + halo
  const int n_aa = n_stage - 2;               // codon starts needed

  for (int i = threadIdx.x; i < kLutSize; i += kThreads) s_lut[i] = c_lut[i];
  for (int i = threadIdx.x; i < n_stage; i += kThreads) {
    const int64_t g = base + i;
    s_codes[i] = g < n ? codes[g] : kDnaAmbig;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_aa; i += kThreads) {
    const uint32_t c0 = s_codes[i], c1 = s_codes[i + 1], c2 = s_codes[i + 2];
    const uint32_t idx =
        (c0 > 3 || c1 > 3 || c2 > 3) ? 64u : c0 * 16 + c1 * 4 + c2;
    s_aa[i] = s_lut[idx];
  }
  __syncthreads();

  const int64_t p = base + threadIdx.x;
  if (p >= n) return;
  uint32_t l = 0, h = 0;
  bool b = false;
  for (int j = 0; j < k; ++j) {
    const uint32_t a = s_aa[threadIdx.x + 3 * j];
    if (j < 6)
      l |= a << (5 * j);
    else
      h |= a << (5 * (j - 6));
    b |= (a == kProtX) | (a == kProtStop) | (a >= kProtPad);
  }
  lo[p] = static_cast<int32_t>(l);
  hi[p] = static_cast<int32_t>(h);
  bad[p] = b ? 1 : 0;
}

}  // namespace

// codes: (n,) uint8 device; lut65: 65 host bytes; outputs (n,) device.
extern "C" int kan_contig_scan(const uint8_t* codes, int64_t n,
                               const uint8_t* lut65, int k, int32_t* lo,
                               int32_t* hi, uint8_t* bad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyToSymbolAsync(c_lut, lut65, kLutSize, 0,
                                            cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  contig_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      codes, n, k, lo, hi, bad);
  return static_cast<int>(cudaGetLastError());
}
