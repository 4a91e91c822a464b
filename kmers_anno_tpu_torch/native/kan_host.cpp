// kan_host — native host-side runtime of kmers_anno_tpu_torch.
//
// The data loader that feeds the device kernels: protein and DNA encoding,
// the fused flat-batch, peg-batch and row-batch builders and the FASTA
// reader; plus the streaming signature builder, the key group-by, and the
// single-core baselines the port is checked against (the packed-key apply
// and projection loops, the string-keyed Java-dataflow apply walk and
// projection loops, the hashAnno loop and the DNA window probe).  A copy
// of the reference package's kan_host.cpp holding the entry points the
// port calls.  Exposed as a plain C ABI consumed via ctypes
// (kmers_anno_tpu_torch/native/__init__.py); every entry point is
// GIL-free.
//
// Encodings mirror kmers_anno_tpu_torch/ops/encode.py exactly:
//   protein: 'A'..'Z' -> 0..25 (case-insensitive), '*' -> 26, other -> 27,
//            PAD -> 31
//   dna:     t,c,a,g -> 0,1,2,3 (u -> 0), other -> 4, PAD -> 5

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <iterator>
#include <new>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

constexpr uint8_t PROT_STOP = 26;
constexpr uint8_t PROT_OTHER = 27;
constexpr uint8_t PROT_PAD = 31;
constexpr uint8_t DNA_AMBIG = 4;

struct Luts {
  uint8_t prot[256];
  uint8_t dna[256];
  constexpr Luts() : prot(), dna() {
    for (int i = 0; i < 256; ++i) prot[i] = PROT_OTHER;
    for (int i = 0; i < 26; ++i) {
      prot['A' + i] = static_cast<uint8_t>(i);
      prot['a' + i] = static_cast<uint8_t>(i);
    }
    prot[static_cast<int>('*')] = PROT_STOP;
    for (int i = 0; i < 256; ++i) dna[i] = DNA_AMBIG;
    const char bases[] = {'t', 'c', 'a', 'g', 'u'};
    const uint8_t codes[] = {0, 1, 2, 3, 0};
    for (int i = 0; i < 5; ++i) {
      dna[static_cast<int>(bases[i])] = codes[i];
      dna[static_cast<int>(bases[i] - 32)] = codes[i];  // upper case
    }
  }
};

constexpr Luts kLuts;

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// encoders
// ---------------------------------------------------------------------------

void kan_encode_protein(const char* s, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = kLuts.prot[static_cast<uint8_t>(s[i])];
}

void kan_encode_dna(const char* s, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = kLuts.dna[static_cast<uint8_t>(s[i])];
}

// ---------------------------------------------------------------------------
// fused flat-batch builder (the apply/build data loader)
// ---------------------------------------------------------------------------
//
// concat:  all sequences back to back (ASCII), total length offsets[n_seqs]
// offsets: (n_seqs + 1) int64 prefix offsets into concat
// width:   output length; everything past offsets[n_seqs] is padding
// pad_seg: segment id written for padding positions
// k:       kmer size for the validity mask (a window starting at position i
//          is valid iff it stays inside one sequence)
// codes/seg_ids/valid: caller-allocated (width,) outputs
//
// Matches FlatBatch (engine/apply_engine.py): codes padded with PROT_PAD,
// valid[i] = 1 for i in [start, start+len-k] of each sequence of len >= k.

void kan_flat_batch(const char* concat, const int64_t* offsets,
                    int64_t n_seqs, int64_t width, int32_t pad_seg,
                    int32_t k, uint8_t* codes, int32_t* seg_ids,
                    uint8_t* valid) {
  const int64_t total = offsets[n_seqs];
  for (int64_t i = 0; i < total; ++i)
    codes[i] = kLuts.prot[static_cast<uint8_t>(concat[i])];
  if (width > total) {
    memset(codes + total, PROT_PAD, static_cast<size_t>(width - total));
    memset(valid + total, 0, static_cast<size_t>(width - total));
    for (int64_t i = total; i < width; ++i) seg_ids[i] = pad_seg;
  }
  for (int64_t s = 0; s < n_seqs; ++s) {
    const int64_t lo = offsets[s], hi = offsets[s + 1], len = hi - lo;
    for (int64_t i = lo; i < hi; ++i) seg_ids[i] = static_cast<int32_t>(s);
    const int64_t n_valid = len >= k ? len - k + 1 : 0;
    if (n_valid) memset(valid + lo, 1, static_cast<size_t>(n_valid));
    if (len > n_valid)
      memset(valid + lo + n_valid, 0, static_cast<size_t>(len - n_valid));
  }
}

// Row-batch builder for the r4 2-D apply layout (engine/apply_engine.py):
// sequence s is encoded into row s of a (n_rows, width) code matrix padded
// with PROT_PAD, with the per-row kmer-window validity mask alongside.
// Rows past n_seqs are all padding.  Caller guarantees len <= width.
void kan_row_batch(const char* concat, const int64_t* offsets,
                   int64_t n_seqs, int64_t n_rows, int64_t width,
                   int32_t k, uint8_t* codes, uint8_t* valid) {
  memset(codes, PROT_PAD, static_cast<size_t>(n_rows * width));
  memset(valid, 0, static_cast<size_t>(n_rows * width));
  for (int64_t s = 0; s < n_seqs; ++s) {
    const int64_t lo = offsets[s];
    int64_t len = offsets[s + 1] - lo;
    if (len > width) len = width;
    uint8_t* row = codes + s * width;
    const char* src = concat + lo;
    for (int64_t i = 0; i < len; ++i)
      row[i] = kLuts.prot[static_cast<uint8_t>(src[i])];
    if (len >= k)
      memset(valid + s * width, 1, static_cast<size_t>(len - k + 1));
  }
}

// Variant for the peg-singleton path (engine/projection.py): also emits the
// position within each sequence and the broadcast sequence length.
void kan_flat_peg_batch(const char* concat, const int64_t* offsets,
                        int64_t n_seqs, int64_t width, int32_t pad_seg,
                        uint8_t* codes, int32_t* seg_ids,
                        int32_t* pos_in_seq, int32_t* len_bcast) {
  const int64_t total = offsets[n_seqs];
  for (int64_t i = 0; i < total; ++i)
    codes[i] = kLuts.prot[static_cast<uint8_t>(concat[i])];
  if (width > total) {
    memset(codes + total, PROT_PAD, static_cast<size_t>(width - total));
    for (int64_t i = total; i < width; ++i) {
      seg_ids[i] = pad_seg;
      pos_in_seq[i] = 0;
      len_bcast[i] = 0;
    }
  }
  for (int64_t s = 0; s < n_seqs; ++s) {
    const int64_t lo = offsets[s], hi = offsets[s + 1];
    const int32_t len = static_cast<int32_t>(hi - lo);
    for (int64_t i = lo; i < hi; ++i) {
      seg_ids[i] = static_cast<int32_t>(s);
      pos_in_seq[i] = static_cast<int32_t>(i - lo);
      len_bcast[i] = len;
    }
  }
}

// ---------------------------------------------------------------------------
// single-core compiled apply baseline
// ---------------------------------------------------------------------------
//
// The honest stand-in for the reference's single-core Java HashMap loop
// (ApplyKmerProcessor.java:122-147): one thread, one protein at a time,
// per-kmer hash probe + unanimity vote with early abort on conflict.  It
// probes the SAME bucketed table layout as the device (ops/hashtable.py)
// with the same murmur3 mixer, so it is if anything *faster* than a Java
// HashMap<String,String> walk (no string hashing/allocation), making the
// reported device multiple conservative.

static inline uint32_t kan_fmix32(uint32_t x) {
  x ^= x >> 16; x *= 0x85EBCA6Bu;
  x ^= x >> 13; x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

void kan_apply_baseline(const uint8_t* codes, int64_t n_prot, int64_t plen,
                        const uint32_t* table, int64_t n_buckets,
                        int32_t max_probes, int32_t k, int32_t min_hits,
                        int32_t* out_roles) {
  const uint32_t mask = static_cast<uint32_t>(n_buckets - 1);
  for (int64_t p = 0; p < n_prot; ++p) {
    const uint8_t* s = codes + p * plen;
    int32_t role = -1, count = 0;
    bool bad = false;
    for (int64_t i = 0; i + k <= plen && !bad; ++i) {
      uint32_t lo = 0, hi = 0;
      for (int32_t j = 0; j < k; ++j) {
        const uint32_t c = s[i + j];
        if (j < 6) lo |= c << (5 * j); else hi |= c << (5 * (j - 6));
      }
      uint32_t b = kan_fmix32(lo ^ kan_fmix32(hi ^ 0x9E3779B9u)) & mask;
      int32_t val = -1;
      for (int32_t r = 0; r < max_probes; ++r) {
        const uint32_t* row = table + static_cast<size_t>(b) * 24;
        bool full = true;
        for (int t = 0; t < 8; ++t) {
          if (row[t] == lo && row[8 + t] == hi) {
            val = static_cast<int32_t>(row[16 + t]);
            break;
          }
          if (row[t] == 0xFFFFFFFFu) full = false;
        }
        if (val >= 0 || !full) break;
        b = (b + 1) & mask;
      }
      if (val >= 0) {
        if (role < 0) { role = val; count = 1; }
        else if (val == role) ++count;
        else bad = true;
      }
    }
    out_roles[p] = (!bad && role >= 0 && count >= min_hits) ? role : -1;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// streaming signature-table builder (handle-based)
// ---------------------------------------------------------------------------
//
// The single-host fast path for the two-pass build semantics
// (BuildKmerProcessor.java:137-223; engine/signature.py documents the
// algorithm).  State is ONE sorted vector of (key, role) with role == -2
// (CONFLICT) tombstones for keys seen under >= 2 distinct roles; pending
// occurrence chunks are sorted and merged in a single linear pass, so cost
// is O(occ log chunk + passes * unique) and memory is O(unique + chunk).
// The kill list (pass 2) is a second sorted-unique vector subtracted from
// the state at finish.  Mirrors StreamingTableBuilder exactly (same
// CONFLICT sentinel, same stats), ~50-100x faster than the device
// group-by path for single-host builds.

namespace {

constexpr int32_t kConflict = -2;

struct KanBuilder {
  using Entry = std::pair<uint64_t, int32_t>;
  std::vector<Entry> state;       // sorted, unique keys
  std::vector<Entry> pend;
  std::vector<uint64_t> kill_state;  // sorted, unique
  std::vector<uint64_t> pend_kill;
  int64_t pruned = 0, killed = 0, uniq = 0;
  static constexpr size_t kChunk = size_t{16} << 20;

  void flush() {
    if (pend.empty()) return;
    std::sort(pend.begin(), pend.end());
    std::vector<Entry> merged;
    merged.reserve(state.size() + pend.size());
    auto sp = state.begin();
    size_t i = 0;
    while (i < pend.size()) {
      const uint64_t key = pend[i].first;
      int32_t role = pend[i].second;
      size_t j = i + 1;
      while (j < pend.size() && pend[j].first == key) {
        if (pend[j].second != role) role = kConflict;
        ++j;
      }
      while (sp != state.end() && sp->first < key) merged.push_back(*sp++);
      if (sp != state.end() && sp->first == key) {
        if (sp->second != role) role = kConflict;
        ++sp;
      }
      merged.emplace_back(key, role);
      i = j;
    }
    merged.insert(merged.end(), sp, state.end());
    state.swap(merged);
    pend.clear();
  }

  void flush_kills() {
    if (pend_kill.empty()) return;
    std::sort(pend_kill.begin(), pend_kill.end());
    pend_kill.erase(std::unique(pend_kill.begin(), pend_kill.end()),
                    pend_kill.end());
    std::vector<uint64_t> merged;
    merged.reserve(kill_state.size() + pend_kill.size());
    std::merge(kill_state.begin(), kill_state.end(), pend_kill.begin(),
               pend_kill.end(), std::back_inserter(merged));
    merged.erase(std::unique(merged.begin(), merged.end()), merged.end());
    kill_state.swap(merged);
    pend_kill.clear();
  }

  void finish() {
    flush();
    flush_kills();
    uniq = static_cast<int64_t>(state.size());
    size_t out = 0;
    auto kp = kill_state.begin();
    for (const Entry& e : state) {
      if (e.second == kConflict) {
        ++pruned;
        continue;
      }
      while (kp != kill_state.end() && *kp < e.first) ++kp;
      if (kp != kill_state.end() && *kp == e.first) {
        ++killed;
        continue;
      }
      state[out++] = e;
    }
    state.resize(out);
  }
};

}  // namespace

extern "C" {

void* kan_build_new() { return new (std::nothrow) KanBuilder(); }

void kan_build_add(void* h, const uint32_t* lo, const uint32_t* hi,
                   const int32_t* role, int64_t n) {
  auto* b = static_cast<KanBuilder*>(h);
  b->pend.reserve(b->pend.size() + static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i)
    b->pend.emplace_back(
        (static_cast<uint64_t>(hi[i]) << 32) | lo[i], role[i]);
  if (b->pend.size() >= KanBuilder::kChunk) b->flush();
}

void kan_build_kills(void* h, const uint32_t* lo, const uint32_t* hi,
                     int64_t n) {
  auto* b = static_cast<KanBuilder*>(h);
  b->pend_kill.reserve(b->pend_kill.size() + static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i)
    b->pend_kill.push_back(
        (static_cast<uint64_t>(hi[i]) << 32) | lo[i]);
  if (b->pend_kill.size() >= KanBuilder::kChunk) b->flush_kills();
}

// Resolve everything; returns survivor count and fills stats[3] =
// {unique, pruned, killed}.
int64_t kan_build_finish(void* h, int64_t* stats) {
  auto* b = static_cast<KanBuilder*>(h);
  b->finish();
  stats[0] = b->uniq;
  stats[1] = b->pruned;
  stats[2] = b->killed;
  return static_cast<int64_t>(b->state.size());
}

void kan_build_fill(void* h, uint32_t* lo, uint32_t* hi, int32_t* role) {
  auto* b = static_cast<KanBuilder*>(h);
  for (size_t i = 0; i < b->state.size(); ++i) {
    lo[i] = static_cast<uint32_t>(b->state[i].first & 0xFFFFFFFFu);
    hi[i] = static_cast<uint32_t>(b->state[i].first >> 32);
    role[i] = b->state[i].second;
  }
}

void kan_build_free(void* h) { delete static_cast<KanBuilder*>(h); }

// ---------------------------------------------------------------------------
// key group-by (the projection engine's host-side sort kernel)
// ---------------------------------------------------------------------------
//
// Stable-sorts (hi, lo) packed kmer keys and reports the grouping:
// order[i] = original index of the i-th key in sorted order, ustarts[u] =
// first sorted position of the u-th unique key; returns the unique count.
// Equivalent to the device sort group-by in engine/projection.py
// (_sort_with_payload) — used when device round-trips are slower than one
// host sort (e.g. over a remote-tunnel device).  Ties sort by original
// index, matching jax.lax.sort's stability.

int64_t kan_groupby(const uint32_t* lo, const uint32_t* hi, int64_t n,
                    int32_t* order, int64_t* ustarts) {
  std::vector<std::pair<uint64_t, int32_t>> v(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i)
    v[static_cast<size_t>(i)] = {
        (static_cast<uint64_t>(hi[i]) << 32) | lo[i],
        static_cast<int32_t>(i)};
  std::sort(v.begin(), v.end());
  int64_t u = 0;
  for (int64_t i = 0; i < n; ++i) {
    order[i] = v[static_cast<size_t>(i)].second;
    if (i == 0 ||
        v[static_cast<size_t>(i)].first != v[static_cast<size_t>(i - 1)].first)
      ustarts[u++] = i;
  }
  return u;
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// FASTA reader (handle-based: parse once, copy out, free)
// ---------------------------------------------------------------------------
//
// Grammar per the reference's FastaInputStream contract (SURVEY.md §2b):
// '>'<label>[ <comment>]\n sequence lines (concatenated, whitespace
// stripped) until the next '>' or EOF.

struct KanFasta {
  std::string seq;            // all residues, concatenated
  std::vector<int64_t> offs;  // n+1 prefix offsets into seq
  std::string hdr;            // all "label\tcomment" strings, concatenated
  std::vector<int64_t> hoffs; // n+1 prefix offsets into hdr
};

void* kan_fasta_read(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  const long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize(static_cast<size_t>(sz));
  if (sz && fread(&buf[0], 1, static_cast<size_t>(sz), f) !=
                static_cast<size_t>(sz)) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  auto* out = new (std::nothrow) KanFasta();
  if (!out) return nullptr;
  out->offs.push_back(0);
  out->hoffs.push_back(0);
  const char* p = buf.data();
  const char* end = p + buf.size();
  bool in_record = false;
  while (p < end) {
    if (*p == '>') {
      if (in_record) out->offs.push_back(static_cast<int64_t>(
          out->seq.size()));
      ++p;
      const char* eol = static_cast<const char*>(
          memchr(p, '\n', static_cast<size_t>(end - p)));
      if (!eol) eol = end;
      const char* sp = p;
      while (sp < eol && *sp != ' ' && *sp != '\t' && *sp != '\r') ++sp;
      out->hdr.append(p, static_cast<size_t>(sp - p));  // label
      out->hdr.push_back('\t');
      const char* c = sp < eol ? sp + 1 : eol;
      const char* ce = eol;
      while (ce > c && (ce[-1] == '\r' || ce[-1] == ' ')) --ce;
      if (c < ce) out->hdr.append(c, static_cast<size_t>(ce - c));
      out->hoffs.push_back(static_cast<int64_t>(out->hdr.size()));
      in_record = true;
      p = eol < end ? eol + 1 : end;
    } else {
      const char* eol = static_cast<const char*>(
          memchr(p, '\n', static_cast<size_t>(end - p)));
      if (!eol) eol = end;
      if (in_record)
        for (const char* q = p; q < eol; ++q)
          if (*q != '\r' && *q != ' ' && *q != '\t') out->seq.push_back(*q);
      p = eol < end ? eol + 1 : end;
    }
  }
  if (in_record) out->offs.push_back(static_cast<int64_t>(out->seq.size()));
  return out;
}

int64_t kan_fasta_nseq(void* h) {
  return static_cast<int64_t>(static_cast<KanFasta*>(h)->offs.size()) - 1;
}
int64_t kan_fasta_seqbytes(void* h) {
  return static_cast<int64_t>(static_cast<KanFasta*>(h)->seq.size());
}
int64_t kan_fasta_hdrbytes(void* h) {
  return static_cast<int64_t>(static_cast<KanFasta*>(h)->hdr.size());
}
void kan_fasta_fill(void* h, char* seq, int64_t* offs, char* hdr,
                    int64_t* hoffs) {
  auto* fa = static_cast<KanFasta*>(h);
  memcpy(seq, fa->seq.data(), fa->seq.size());
  memcpy(offs, fa->offs.data(), fa->offs.size() * sizeof(int64_t));
  memcpy(hdr, fa->hdr.data(), fa->hdr.size());
  memcpy(hoffs, fa->hoffs.data(), fa->hoffs.size() * sizeof(int64_t));
}
void kan_fasta_free(void* h) { delete static_cast<KanFasta*>(h); }

}  // extern "C"

// ---------------------------------------------------------------------------
// single-core compiled projection baseline (handle-based)
// ---------------------------------------------------------------------------
//
// The compiled stand-in for the reference's single-core ORF-projection hot
// loops (KmerProcessor.annotateGenome, KmerProcessor.java:166-287): contig
// 6-frame kmer HashMap build (hot loop #1, KmerReference.java:180-203),
// per-close-genome peg-kmer singleton counting (#2, KmerProcessor.java:
// 319-327), singleton hash probe into the contig map (#3, 197-207), and
// the (peg, frame) window scan (#4, 240-254).  Same HashMap-per-kmer
// dataflow the Java runs, in C++ with packed integer keys — so the
// reported device multiple is conservative.  The downstream proposal
// extend/filter/dedup is host-shared between both engines and excluded.

namespace {

struct ProjLoc {
  int32_t contig;
  int32_t left;
  uint8_t strand;
};

struct KanProj {
  int k;
  std::unordered_map<uint64_t, std::vector<ProjLoc>> map;
};

inline uint64_t kan_proj_key(uint32_t lo, uint32_t hi) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

constexpr uint8_t PROT_X = 23;

}  // namespace

extern "C" {

// dna: concatenated contig codes (0..3, 4 = ambiguous); offs (n_contigs+1)
// lut65: codon -> aa-code LUT, entry [64] = ambiguous-codon result
void* kan_proj_new(const uint8_t* dna, const int64_t* offs,
                   int64_t n_contigs, const uint8_t* lut65, int32_t k) {
  auto* h = new (std::nothrow) KanProj();
  if (!h) return nullptr;
  h->k = k;
  const int64_t k3 = 3 * k;
  std::vector<uint8_t> rc;
  std::vector<uint8_t> aa;
  for (int64_t c = 0; c < n_contigs; ++c) {
    const uint8_t* seq = dna + offs[c];
    const int64_t L = offs[c + 1] - offs[c];
    rc.assign(seq, seq + L);
    std::reverse(rc.begin(), rc.end());
    for (auto& b : rc)
      if (b < 4) b ^= 2;
    for (int strand = 0; strand < 2; ++strand) {
      const uint8_t* s = strand == 0 ? seq : rc.data();
      for (int f = 0; f < 3; ++f) {
        const int64_t flen = (L - f) / 3;
        if (flen <= k) continue;
        aa.resize(static_cast<size_t>(flen));
        for (int64_t p = 0; p < flen; ++p) {
          const uint8_t c0 = s[f + 3 * p], c1 = s[f + 3 * p + 1],
                        c2 = s[f + 3 * p + 2];
          aa[p] = (c0 > 3 || c1 > 3 || c2 > 3)
                      ? lut65[64]
                      : lut65[c0 * 16 + c1 * 4 + c2];
        }
        for (int64_t p = 0; p < flen - k; ++p) {  // Q1 strict drop-last
          uint32_t lo = 0, hi = 0;
          bool bad = false;
          for (int j = 0; j < k; ++j) {
            const uint8_t a = aa[p + j];          // Q2: reject '*'/'X'
            if (a == PROT_X || a == PROT_STOP || a >= PROT_PAD) {
              bad = true;
              break;
            }
            if (j < 6) lo |= static_cast<uint32_t>(a) << (5 * j);
            else hi |= static_cast<uint32_t>(a) << (5 * (j - 6));
          }
          if (bad) continue;
          const int64_t base = 3 * p + f;
          const int32_t left =
              strand == 0 ? static_cast<int32_t>(base + 1)
                          : static_cast<int32_t>(L - k3 + 1 - base);
          h->map[kan_proj_key(lo, hi)].push_back(
              {static_cast<int32_t>(c), left,
               static_cast<uint8_t>(strand)});
        }
      }
    }
  }
  return h;
}

int64_t kan_proj_map_size(void* hv) {
  return static_cast<int64_t>(static_cast<KanProj*>(hv)->map.size());
}

// prots: concatenated protein codes of one close genome; offs (n_pegs+1)
// out[0] = matched (peg, location) pairs, out[1] = (peg, frame) groups,
// out[2] = live window candidates (pre-dedup proposals)
void kan_proj_match(void* hv, const uint8_t* prots, const int64_t* offs,
                    int64_t n_pegs, double min_strength, double max_fuzz,
                    double min_fuzz, int64_t* out) {
  auto* h = static_cast<KanProj*>(hv);
  const int k = h->k;
  const int64_t k3 = 3 * k;

  // hot loop #2: count peg kmers, keep singletons (Q5)
  struct Cnt { int32_t count; int32_t peg; };
  std::unordered_map<uint64_t, Cnt> counts;
  counts.reserve(static_cast<size_t>(offs[n_pegs]));
  for (int64_t s = 0; s < n_pegs; ++s) {
    const uint8_t* p = prots + offs[s];
    const int64_t plen = offs[s + 1] - offs[s];
    for (int64_t i = 0; i < plen - k; ++i) {      // Q1 strict drop-last
      uint32_t lo = 0, hi = 0;
      bool bad = false;
      for (int j = 0; j < k; ++j) {
        const uint8_t a = p[i + j];               // Q2 peg path: 'X' only
        if (a == PROT_X || a >= PROT_PAD) {
          bad = true;
          break;
        }
        if (j < 6) lo |= static_cast<uint32_t>(a) << (5 * j);
        else hi |= static_cast<uint32_t>(a) << (5 * (j - 6));
      }
      if (bad) continue;
      auto& e = counts[kan_proj_key(lo, hi)];
      ++e.count;
      e.peg = static_cast<int32_t>(s);
    }
  }

  // hot loop #3: probe singletons, expand location lists to pairs
  struct Pair {
    int32_t frame, peg, contig, left;
  };
  std::vector<Pair> pairs;
  for (const auto& kv : counts) {
    if (kv.second.count != 1) continue;
    auto it = h->map.find(kv.first);
    if (it == h->map.end()) continue;
    for (const ProjLoc& loc : it->second) {
      const int32_t right = loc.left + static_cast<int32_t>(k3) - 1;
      const int32_t frame =
          loc.strand == 0 ? 3 + loc.left % 3 : right % 3;
      pairs.push_back({frame, kv.second.peg, loc.contig, loc.left});
    }
  }
  out[0] = static_cast<int64_t>(pairs.size());

  // hot loop #4: (frame, peg) window scan (Q6)
  std::sort(pairs.begin(), pairs.end(), [](const Pair& a, const Pair& b) {
    if (a.frame != b.frame) return a.frame < b.frame;
    if (a.peg != b.peg) return a.peg < b.peg;
    if (a.contig != b.contig) return a.contig < b.contig;
    return a.left < b.left;
  });
  int64_t groups = 0, live = 0;
  const int64_t m = static_cast<int64_t>(pairs.size());
  int64_t gs = 0;
  while (gs < m) {
    int64_t ge = gs + 1;
    while (ge < m && pairs[ge].frame == pairs[gs].frame &&
           pairs[ge].peg == pairs[gs].peg)
      ++ge;
    ++groups;
    const int64_t size = ge - gs;
    const int64_t plen3 =
        3 * (offs[pairs[gs].peg + 1] - offs[pairs[gs].peg]);
    const int64_t max_len = static_cast<int64_t>(plen3 * max_fuzz + 1);
    const int64_t min_len = static_cast<int64_t>(plen3 * min_fuzz);
    const int64_t min_k = static_cast<int64_t>(plen3 * (min_strength / 3));
    if (min_k <= size) {
      int64_t rs = gs;
      while (rs < ge) {                    // contig runs; rights ascend
        int64_t re = rs + 1;
        while (re < ge && pairs[re].contig == pairs[rs].contig) ++re;
        for (int64_t i = rs; i < re; ++i) {
          if (i - gs > size - min_k) break;
          const int64_t left = pairs[i].left;
          const int64_t edge = left + max_len;
          // first j in the run with right >= edge (rights sorted)
          int64_t lo_j = rs, hi_j = re;
          while (lo_j < hi_j) {
            const int64_t mid = (lo_j + hi_j) / 2;
            if (pairs[mid].left + k3 - 1 < edge) lo_j = mid + 1;
            else hi_j = mid;
          }
          const int64_t ub = lo_j;
          const int64_t bi = ub - 1 > i ? ub - 1 : i;
          const int64_t best_edge = pairs[bi].left + k3 - 1;
          if (best_edge >= left + min_len) ++live;
        }
        rs = re;
      }
    }
    gs = ge;
  }
  out[1] = groups;
  out[2] = live;
}

void kan_proj_free(void* hv) { delete static_cast<KanProj*>(hv); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Java-dataflow apply baseline (string-keyed HashMap walk)
// ---------------------------------------------------------------------------
//
// kan_apply_baseline above probes packed integer keys — faster than any
// JVM HashMap<String,String> walk, so the device multiple it yields is a
// floor.  This variant reproduces the reference's actual dataflow
// (ApplyKmerProcessor.java:101-110, 122-145): the kmer database is a
// string-keyed hash map and every lookup materializes the kmer substring
// and hashes its characters, exactly what `map.get(protein.substring(i,
// i+K))` does on the JVM.  C++ std::string SSO still makes this an
// optimistic stand-in for Java (no per-substring heap allocation), so
// the resulting multiple remains conservative.

namespace {

struct KanJavaMap {
  std::unordered_map<std::string, int32_t> map;
};

}  // namespace

extern "C" {

void* kan_java_new(int64_t n_hint) {
  auto* h = new (std::nothrow) KanJavaMap();
  if (h) h->map.reserve(static_cast<size_t>(n_hint));
  return h;
}

// concat: kmer texts back to back, each k chars; roles per kmer
void kan_java_add(void* hv, const char* concat, int64_t n, int32_t k,
                  const int32_t* roles) {
  auto* h = static_cast<KanJavaMap*>(hv);
  for (int64_t i = 0; i < n; ++i)
    h->map.emplace(std::string(concat + i * k, static_cast<size_t>(k)),
                   roles[i]);
}

// prots: protein texts back to back; offs (n_prot+1)
void kan_java_apply(void* hv, const char* prots, const int64_t* offs,
                    int64_t n_prot, int32_t k, int32_t min_hits,
                    int32_t* out_roles) {
  auto* h = static_cast<KanJavaMap*>(hv);
  std::string kmer;
  for (int64_t p = 0; p < n_prot; ++p) {
    const char* s = prots + offs[p];
    const int64_t plen = offs[p + 1] - offs[p];
    int32_t role = -1, count = 0;
    bool bad = false;
    for (int64_t i = 0; i + k <= plen && !bad; ++i) {
      kmer.assign(s + i, static_cast<size_t>(k));   // the substring
      auto it = h->map.find(kmer);                  // hash chars + probe
      if (it != h->map.end()) {
        if (role < 0) { role = it->second; count = 1; }
        else if (it->second == role) ++count;
        else bad = true;
      }
    }
    out_roles[p] = (!bad && role >= 0 && count >= min_hits) ? role : -1;
  }
}

void kan_java_free(void* hv) { delete static_cast<KanJavaMap*>(hv); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Java-dataflow projection baseline (string-keyed maps, handle-based)
// ---------------------------------------------------------------------------
//
// kan_proj_* above uses packed integer keys — a strict floor on what the
// reference's JVM actually costs.  This variant reproduces the Java
// dataflow of annotateGenome's hot loops: the contig index is a
// HashMap<String kmer, List<Location>> built by materializing every
// frame-translation substring (KmerReference.getContigKmers,
// KmerReference.java:157-203), peg singleton counting is a
// CountMap<String> of substrings (KmerProcessor.java:319-327), and every
// probe hashes the kmer characters (197-207).  C++ std::string SSO (k=8
// fits inline) still avoids Java's per-substring heap allocation, so the
// resulting multiple remains conservative.

namespace {

struct KanJProj {
  int k;
  std::unordered_map<std::string, std::vector<ProjLoc>> map;
};

}  // namespace

extern "C" {

void* kan_jproj_new(const uint8_t* dna, const int64_t* offs,
                    int64_t n_contigs, const uint8_t* lut65, int32_t k) {
  auto* h = new (std::nothrow) KanJProj();
  if (!h) return nullptr;
  h->k = k;
  const int64_t k3 = 3 * k;
  std::vector<uint8_t> rc;
  std::string aa;
  std::string kmer;
  for (int64_t c = 0; c < n_contigs; ++c) {
    const uint8_t* seq = dna + offs[c];
    const int64_t L = offs[c + 1] - offs[c];
    rc.assign(seq, seq + L);
    std::reverse(rc.begin(), rc.end());
    for (auto& b : rc)
      if (b < 4) b ^= 2;
    for (int strand = 0; strand < 2; ++strand) {
      const uint8_t* s = strand == 0 ? seq : rc.data();
      for (int f = 0; f < 3; ++f) {
        const int64_t flen = (L - f) / 3;
        if (flen <= k) continue;
        aa.resize(static_cast<size_t>(flen));   // the frame translation
        for (int64_t p = 0; p < flen; ++p) {
          const uint8_t c0 = s[f + 3 * p], c1 = s[f + 3 * p + 1],
                        c2 = s[f + 3 * p + 2];
          aa[static_cast<size_t>(p)] =
              static_cast<char>((c0 > 3 || c1 > 3 || c2 > 3)
                                    ? lut65[64]
                                    : lut65[c0 * 16 + c1 * 4 + c2]);
        }
        for (int64_t p = 0; p < flen - k; ++p) {  // Q1 strict drop-last
          bool bad = false;
          for (int j = 0; j < k; ++j) {           // Q2: reject '*'/'X'
            const uint8_t a = static_cast<uint8_t>(aa[p + j]);
            if (a == PROT_X || a == PROT_STOP || a >= PROT_PAD) {
              bad = true;
              break;
            }
          }
          if (bad) continue;
          kmer.assign(aa, static_cast<size_t>(p),
                      static_cast<size_t>(k));    // the substring
          const int64_t base = 3 * p + f;
          const int32_t left =
              strand == 0 ? static_cast<int32_t>(base + 1)
                          : static_cast<int32_t>(L - k3 + 1 - base);
          h->map[kmer].push_back(                 // hash chars + insert
              {static_cast<int32_t>(c), left,
               static_cast<uint8_t>(strand)});
        }
      }
    }
  }
  return h;
}

int64_t kan_jproj_map_size(void* hv) {
  return static_cast<int64_t>(static_cast<KanJProj*>(hv)->map.size());
}

// identical contract to kan_proj_match; prots are PROTEIN CODES and get
// re-materialized as strings per window like the Java ProteinKmers walk
void kan_jproj_match(void* hv, const uint8_t* prots, const int64_t* offs,
                     int64_t n_pegs, double min_strength, double max_fuzz,
                     double min_fuzz, int64_t* out) {
  auto* h = static_cast<KanJProj*>(hv);
  const int k = h->k;
  const int64_t k3 = 3 * k;

  // hot loop #2: CountMap<String> of peg kmers, keep singletons (Q5)
  struct Cnt { int32_t count; int32_t peg; };
  std::unordered_map<std::string, Cnt> counts;
  counts.reserve(static_cast<size_t>(offs[n_pegs]));
  std::string kmer;
  for (int64_t s = 0; s < n_pegs; ++s) {
    const uint8_t* p = prots + offs[s];
    const int64_t plen = offs[s + 1] - offs[s];
    for (int64_t i = 0; i < plen - k; ++i) {      // Q1 strict drop-last
      bool bad = false;
      for (int j = 0; j < k; ++j) {               // Q2 peg path: 'X' only
        const uint8_t a = p[i + j];
        if (a == PROT_X || a >= PROT_PAD) {
          bad = true;
          break;
        }
      }
      if (bad) continue;
      kmer.assign(reinterpret_cast<const char*>(p) + i,
                  static_cast<size_t>(k));        // the substring
      auto& e = counts[kmer];                     // hash chars + insert
      ++e.count;
      e.peg = static_cast<int32_t>(s);
    }
  }

  // hot loop #3: probe singleton strings into the contig map
  struct Pair {
    int32_t frame, peg, contig, left;
  };
  std::vector<Pair> pairs;
  for (const auto& kv : counts) {
    if (kv.second.count != 1) continue;
    auto it = h->map.find(kv.first);              // hash chars + probe
    if (it == h->map.end()) continue;
    for (const ProjLoc& loc : it->second) {
      const int32_t right = loc.left + static_cast<int32_t>(k3) - 1;
      const int32_t frame =
          loc.strand == 0 ? 3 + loc.left % 3 : right % 3;
      pairs.push_back({frame, kv.second.peg, loc.contig, loc.left});
    }
  }
  out[0] = static_cast<int64_t>(pairs.size());

  // hot loop #4: (frame, peg) window scan (Q6) — same as kan_proj_match
  std::sort(pairs.begin(), pairs.end(), [](const Pair& a, const Pair& b) {
    if (a.frame != b.frame) return a.frame < b.frame;
    if (a.peg != b.peg) return a.peg < b.peg;
    if (a.contig != b.contig) return a.contig < b.contig;
    return a.left < b.left;
  });
  int64_t groups = 0, live = 0;
  const int64_t m = static_cast<int64_t>(pairs.size());
  int64_t gs = 0;
  while (gs < m) {
    int64_t ge = gs + 1;
    while (ge < m && pairs[ge].frame == pairs[gs].frame &&
           pairs[ge].peg == pairs[gs].peg)
      ++ge;
    ++groups;
    const int64_t size = ge - gs;
    const int64_t plen3 =
        3 * (offs[pairs[gs].peg + 1] - offs[pairs[gs].peg]);
    const int64_t max_len = static_cast<int64_t>(plen3 * max_fuzz + 1);
    const int64_t min_len = static_cast<int64_t>(plen3 * min_fuzz);
    const int64_t min_k = static_cast<int64_t>(plen3 * (min_strength / 3));
    if (min_k <= size) {
      int64_t rs = gs;
      while (rs < ge) {
        int64_t re = rs + 1;
        while (re < ge && pairs[re].contig == pairs[rs].contig) ++re;
        for (int64_t i = rs; i < re; ++i) {
          if (i - gs > size - min_k) break;
          const int64_t left = pairs[i].left;
          const int64_t edge = left + max_len;
          int64_t lo_j = rs, hi_j = re;
          while (lo_j < hi_j) {
            const int64_t mid = (lo_j + hi_j) / 2;
            if (pairs[mid].left + k3 - 1 < edge) lo_j = mid + 1;
            else hi_j = mid;
          }
          const int64_t ub = lo_j;
          const int64_t bi = ub - 1 > i ? ub - 1 : i;
          const int64_t best_edge = pairs[bi].left + k3 - 1;
          if (best_edge >= left + min_len) ++live;
        }
        rs = re;
      }
    }
    gs = ge;
  }
  out[1] = groups;
  out[2] = live;
}

void kan_jproj_free(void* hv) { delete static_cast<KanJProj*>(hv); }

}  // extern "C"

// ---------------------------------------------------------------------------
// single-core hashAnno baseline (GenomeProteinKmers dataflow, handle-based)
// ---------------------------------------------------------------------------
//
// The compiled stand-in for the reference tool's per-genome hashAnno hot
// loop (HashAnnotationProcessor.java:233-263 via the external
// GenomeProteinKmers): build a kmer -> protein-list hash from the genome's
// distinct protein kmer sets, then score every prototype sequentially: per
// prototype kmer, hash-probe and tally common counts per protein;
// similarity is the distinct-kmer Jaccard |∩|/|∪| and a proposal improves
// only on strictly greater similarity at or above the min-score floor
// (earliest prototype wins ties), the device engine's update rule
// (engine/hashanno.py).

#include <unordered_set>

namespace {

struct KanHash {
  int k;
  double min_score;
  int64_t n_prot;
  std::unordered_map<uint64_t, std::vector<int32_t>> map;
  std::vector<int32_t> nk;          // distinct kmers per protein
  std::vector<double> best;         // best similarity (0 = default)
  std::vector<int32_t> best_proto;  // winning prototype index, -1 default
  std::vector<int32_t> common;      // scratch tally
  std::vector<int32_t> touched;
};

inline bool kan_hash_pack(const uint8_t* p, int k, uint64_t* key) {
  uint64_t v = 0;
  for (int j = 0; j < k; ++j) {
    if (p[j] >= PROT_PAD) return false;   // padding guard only
    v |= static_cast<uint64_t>(p[j]) << (5 * j);
  }
  *key = v;
  return true;
}

}  // namespace

extern "C" {

// prots: concatenated protein codes; offs (n_prot+1)
void* kan_hash_new(const uint8_t* prots, const int64_t* offs,
                   int64_t n_prot, int32_t k, double min_score) {
  auto* h = new (std::nothrow) KanHash();
  if (!h) return nullptr;
  h->k = k;
  h->min_score = min_score;
  h->n_prot = n_prot;
  h->nk.assign(static_cast<size_t>(n_prot), 0);
  h->best.assign(static_cast<size_t>(n_prot), 0.0);
  h->best_proto.assign(static_cast<size_t>(n_prot), -1);
  h->common.assign(static_cast<size_t>(n_prot), 0);
  h->map.reserve(static_cast<size_t>(offs[n_prot]));
  std::unordered_set<uint64_t> distinct;
  for (int64_t s = 0; s < n_prot; ++s) {
    const uint8_t* p = prots + offs[s];
    const int64_t plen = offs[s + 1] - offs[s];
    distinct.clear();
    for (int64_t i = 0; i + k <= plen; ++i) {   // ALL L-K+1 windows
      uint64_t key;
      if (kan_hash_pack(p + i, k, &key)) distinct.insert(key);
    }
    h->nk[static_cast<size_t>(s)] = static_cast<int32_t>(distinct.size());
    for (uint64_t key : distinct)
      h->map[key].push_back(static_cast<int32_t>(s));
  }
  return h;
}

int64_t kan_hash_kmers(void* hv) {
  return static_cast<int64_t>(static_cast<KanHash*>(hv)->map.size());
}

// protos: concatenated prototype codes; offs (n_proto+1); proto_base is
// added to the stored winner index.  Returns improvement events.
int64_t kan_hash_score(void* hv, const uint8_t* protos,
                       const int64_t* offs, int64_t n_proto,
                       int32_t proto_base) {
  auto* h = static_cast<KanHash*>(hv);
  const int k = h->k;
  int64_t events = 0;
  std::unordered_set<uint64_t> distinct;
  for (int64_t q = 0; q < n_proto; ++q) {
    const uint8_t* p = protos + offs[q];
    const int64_t plen = offs[q + 1] - offs[q];
    distinct.clear();
    for (int64_t i = 0; i + k <= plen; ++i) {
      uint64_t key;
      if (kan_hash_pack(p + i, k, &key)) distinct.insert(key);
    }
    const double n2 = static_cast<double>(distinct.size());
    h->touched.clear();
    for (uint64_t key : distinct) {             // the hash-probe loop
      auto it = h->map.find(key);
      if (it == h->map.end()) continue;
      for (int32_t o : it->second) {
        if (h->common[static_cast<size_t>(o)]++ == 0)
          h->touched.push_back(o);
      }
    }
    for (int32_t o : h->touched) {
      const double c = h->common[static_cast<size_t>(o)];
      h->common[static_cast<size_t>(o)] = 0;
      const double uni = h->nk[static_cast<size_t>(o)] + n2 - c;
      const double sim = c / (uni > 0 ? uni : 1.0);
      if (sim >= h->min_score && sim > h->best[static_cast<size_t>(o)]) {
        h->best[static_cast<size_t>(o)] = sim;
        h->best_proto[static_cast<size_t>(o)] =
            proto_base + static_cast<int32_t>(q);
        ++events;
      }
    }
  }
  return events;
}

void kan_hash_best(void* hv, double* out_sim, int32_t* out_proto) {
  auto* h = static_cast<KanHash*>(hv);
  std::memcpy(out_sim, h->best.data(), h->best.size() * sizeof(double));
  std::memcpy(out_proto, h->best_proto.data(),
              h->best_proto.size() * sizeof(int32_t));
}

void kan_hash_free(void* hv) { delete static_cast<KanHash*>(hv); }

}  // extern "C"

// ---------------------------------------------------------------------------
// single-core DNA-mode baseline (config 3)
// ---------------------------------------------------------------------------
//
// A single-core DNA window probe over the bucketed table, the check of the
// device DNA mode (engine/dna_apply.probe_dna_flat).  Packing matches
// ops/dna_kmers.py: lo = (1 << 2k) | sum(base_i << 2i), hi = 0; windows
// touching an ambiguous base are skipped.

extern "C" {

// codes: (n,) DNA codes 0..3, >=4 ambiguous; returns total hits
int64_t kan_dna_baseline(const uint8_t* codes, int64_t n,
                         const uint32_t* table, int64_t n_buckets,
                         int32_t max_probes, int32_t k) {
  const uint32_t mask = static_cast<uint32_t>(n_buckets - 1);
  const uint32_t marker = 1u << (2 * k);
  int64_t hits = 0;
  for (int64_t i = 0; i + k <= n; ++i) {
    uint32_t lo = marker;
    bool bad = false;
    for (int32_t j = 0; j < k; ++j) {
      const uint8_t c = codes[i + j];
      if (c > 3) { bad = true; break; }
      lo |= static_cast<uint32_t>(c) << (2 * j);
    }
    if (bad) continue;
    uint32_t b = kan_fmix32(lo ^ kan_fmix32(0u ^ 0x9E3779B9u)) & mask;
    int32_t val = -1;
    for (int32_t r = 0; r < max_probes; ++r) {
      const uint32_t* row = table + static_cast<size_t>(b) * 24;
      bool full = true;
      for (int t = 0; t < 8; ++t) {
        if (row[t] == lo && row[8 + t] == 0u) {
          val = static_cast<int32_t>(row[16 + t]);
          break;
        }
        if (row[t] == 0xFFFFFFFFu) full = false;
      }
      if (val >= 0 || !full) break;
      b = (b + 1) & mask;
    }
    if (val >= 0) ++hits;
  }
  return hits;
}

}  // extern "C"
