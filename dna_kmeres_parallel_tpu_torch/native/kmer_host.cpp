// The port's C++ host library: FASTA parse, 2-bit pack, the MSD+LSD
// radix compactor of unsorted window words, the host-only sparse counter
// (a rolling encoder fused into the same radix core), the compactors of
// the device-sort route (sorted words, row-sorted words merged by a loser
// tree or an AVX-512 merge ladder, run-start flags, RLE records), the
// k-way merge of sorted (code, count) tables, and the "%f" CSV formatter.
//
// A copy of the entries of the JAX package's native/fastaparse.cpp that
// the port calls, so that the port builds and loads its own library and
// never the JAX package's. The parse emits a flat uint8 base-code stream
// (A=0, C=1, G=2, T=3; 0xFF for any other character and as the single
// sentinel between records), per-record offsets and lengths, and the
// concatenated header lines; it parses a large uncompressed file as
// record-aligned ranges on the host's threads and joins them into the
// one-range machine's records (kp_parse_fasta_range).
//
// Plain C ABI, loaded with ctypes (native/__init__.py builds it with g++
// at first use).

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <zlib.h>

#include <algorithm>
#include <array>
#include <atomic>
#include <memory>
#include <thread>
#include <type_traits>
#include <vector>

#if defined(__AVX512F__) || defined(__AVX2__)
#include <immintrin.h>
#elif defined(__x86_64__) || defined(_M_X64)
#include <emmintrin.h>  // SSE2 non-temporal stores + sfence
#endif

namespace {

int num_threads(int64_t work, int64_t grain) {
  // KMER_NATIVE_THREADS overrides the hardware count (benchmark thread-
  // scaling curves; read per call so in-process changes take effect).
  if (const char* e = getenv("KMER_NATIVE_THREADS")) {
    const int forced = atoi(e);
    if (forced > 0)
      return static_cast<int>(std::max<int64_t>(
          1, std::min<int64_t>(forced, std::max<int64_t>(work / grain, 1))));
  }
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 1;
  int64_t by_work = work / grain;
  return static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(std::min<int64_t>(hw, 16), by_work)));
}

constexpr uint8_t kInvalid = 0xFF;

// ASCII -> base code LUT (case-sensitive: only 'A','C','G','T' match).
struct Lut {
  uint8_t v[256];
  Lut() {
    memset(v, kInvalid, sizeof(v));
    v['A'] = 0;
    v['C'] = 1;
    v['G'] = 2;
    v['T'] = 3;
  }
};
const Lut kLut;

// The base codes of the n bytes at s, written to dst; returns how many
// are invalid. The low nibble tells 'A' (1), 'C' (3), 'T' (4) and 'G' (7)
// apart, so a byte is a base exactly when it equals the letter its low
// nibble names: one shuffle gives that letter, another its code.
int64_t encode_bases(const uint8_t* s, int64_t n, uint8_t* dst) {
  int64_t bad = 0;
  int64_t i = 0;
#if defined(__AVX512BW__) || defined(__AVX2__)
  // Entries no base names hold a byte whose low nibble is not theirs.
  const __m128i chr4 = _mm_setr_epi8(1, 'A', 0, 'C', 'T', 0, 0, 'G', 0, 0, 0,
                                     0, 0, 0, 0, 0);
  const __m128i code4 = _mm_setr_epi8(-1, 0, -1, 1, 3, -1, -1, 2, -1, -1, -1,
                                      -1, -1, -1, -1, -1);
#endif
#if defined(__AVX512BW__)
  const __m512i chr = _mm512_broadcast_i32x4(chr4);
  const __m512i code = _mm512_broadcast_i32x4(code4);
  const __m512i nib = _mm512_set1_epi8(0x0F);
  const __m512i inv = _mm512_set1_epi8(-1);
  for (; i < n; i += 64) {
    const int64_t m = n - i < 64 ? n - i : 64;
    const __mmask64 live = m == 64 ? ~0ULL : (1ULL << m) - 1;
    const __m512i x = _mm512_maskz_loadu_epi8(live, s + i);
    const __m512i lo = _mm512_and_si512(x, nib);
    const __mmask64 ok =
        _mm512_cmpeq_epi8_mask(x, _mm512_shuffle_epi8(chr, lo)) & live;
    _mm512_mask_storeu_epi8(
        dst + i, live,
        _mm512_mask_blend_epi8(ok, inv, _mm512_shuffle_epi8(code, lo)));
    bad += m - __builtin_popcountll(ok);
  }
#elif defined(__AVX2__)
  const __m256i chr = _mm256_broadcastsi128_si256(chr4);
  const __m256i code = _mm256_broadcastsi128_si256(code4);
  const __m256i nib = _mm256_set1_epi8(0x0F);
  for (; i + 32 <= n; i += 32) {
    const __m256i x =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(s + i));
    const __m256i lo = _mm256_and_si256(x, nib);
    const __m256i ok = _mm256_cmpeq_epi8(x, _mm256_shuffle_epi8(chr, lo));
    _mm256_storeu_si256(
        reinterpret_cast<__m256i*>(dst + i),
        _mm256_or_si256(_mm256_and_si256(ok, _mm256_shuffle_epi8(code, lo)),
                        _mm256_andnot_si256(ok, _mm256_set1_epi8(-1))));
    bad += 32 - __builtin_popcount(
                     static_cast<uint32_t>(_mm256_movemask_epi8(ok)));
  }
#endif
  for (; i < n; i++) {
    const uint8_t c = kLut.v[s[i]];
    dst[i] = c;
    bad += (c == kInvalid);
  }
  return bad;
}

// An output array of a parse: a heap block that doubles as it fills, or,
// for a split range's stream, a slice of one block sized to the range's
// bound, which never grows (`grow` past it is a broken bound).
template <class T>
struct Out {
  T* data = nullptr;
  int64_t len = 0;
  int64_t cap = 0;
  bool owned = true;
  T* grow(int64_t need) {
    if (len + need > cap) {
      if (!owned) abort();
      int64_t ncap = cap ? cap : (1 << 20) / static_cast<int64_t>(sizeof(T));
      while (ncap < len + need) ncap *= 2;
      data = static_cast<T*>(realloc(data, ncap * sizeof(T)));
      cap = ncap;
    }
    return data + len;
  }
  void release() {
    if (owned) free(data);
    data = nullptr;
    len = cap = 0;
  }
};

enum { FQ_HDR, FQ_SEQ, FQ_QUAL };

// Where the record machine stands between two lines.
struct ParseState {
  int format = 0;  // 0 = undecided, 1 = FASTA, 2 = FASTQ
  int fq_state = FQ_HDR;
  bool in_seq = false;  // a record is open
  int64_t cur_len = 0;  // the open record's bases so far
  int64_t qual_seen = 0;
};

// The record machine of one range of lines, with what it wrote. Record
// semantics are those of utils/fasta.parse_fasta: '>' starts a header, a
// record's sequence is the concatenation of the following non-header
// lines, blank lines are ignored and a trailing CR is stripped. A CR
// inside a line is read as an invalid base, where Python's text mode ends
// the line there; lone_cr counts such lines. FASTQ (first significant
// byte '@') is a 4-state machine, HDR -> SEQ -> '+' -> QUAL (until the
// quality covers the sequence) -> HDR, so a quality line beginning with
// '@' or '+' never starts a record.
struct RangeParse {
  ParseState st;
  Out<uint8_t> stream;
  Out<char> ids;                 // header lines, each ended by a NUL
  std::vector<int64_t> offsets;  // stream offset of each header's record
  std::vector<int64_t> lengths;  // the length of each record closed here
  int64_t total_bases = 0;
  int64_t invalid_bases = 0;
  int64_t lone_cr = 0;
  int64_t max_seqs = 0;  // <= 0: no cap
  bool done = false;
  bool sep = false;  // a record came before: the next header writes a 0xFF

  void end_record() {
    if (!st.in_seq) return;
    lengths.push_back(st.cur_len);
    st.in_seq = false;
    if (max_seqs > 0 && static_cast<int64_t>(lengths.size()) >= max_seqs)
      done = true;
  }

  void header(const uint8_t* s, int64_t n) {
    end_record();
    if (done) return;
    char* id = ids.grow(n + 1);
    memcpy(id, s, n);
    id[n] = '\0';
    ids.len += n + 1;
    if (sep) *stream.grow(1) = kInvalid, stream.len++;
    sep = true;
    offsets.push_back(stream.len);
    st.cur_len = 0;
    st.in_seq = true;
  }

  void bases(const uint8_t* s, int64_t n) {
    invalid_bases += encode_bases(s, n, stream.grow(n));
    stream.len += n;
    st.cur_len += n;
    total_bases += n;
  }

  void line(const uint8_t* s, int64_t n) {
    while (n > 0 && s[n - 1] == '\r') n--;
    if (n == 0) return;
    if (memchr(s, '\r', n)) lone_cr++;
    if (st.format == 0) st.format = (s[0] == '@') ? 2 : 1;
    if (st.format == 2) {
      if (st.fq_state == FQ_HDR) {
        if (s[0] != '@') return;  // tolerate junk between records
        header(s, n);
        if (!done) st.fq_state = FQ_SEQ;
      } else if (st.fq_state == FQ_SEQ) {
        if (s[0] != '+') {
          bases(s, n);
        } else if (st.cur_len == 0) {
          // Zero-length read (adapter-trimmed): no quality bytes follow,
          // so waiting in QUAL would eat the NEXT record's '@' header.
          end_record();
          st.fq_state = FQ_HDR;
        } else {
          st.fq_state = FQ_QUAL;
          st.qual_seen = 0;
        }
      } else {  // FQ_QUAL: consume until the quality covers the sequence
        st.qual_seen += n;
        if (st.qual_seen >= st.cur_len) {
          end_record();
          st.fq_state = FQ_HDR;
        }
      }
      return;
    }
    if (s[0] == '>')
      header(s, n);
    else if (st.in_seq)
      bases(s, n);
  }

  // The lines of [p, e): '\n' ends a line, and the last may have none.
  void lines(const uint8_t* p, const uint8_t* e) {
    while (p < e && !done) {
      const uint8_t* nl =
          static_cast<const uint8_t*>(memchr(p, '\n', e - p));
      const uint8_t* q = nl ? nl : e;
      line(p, q - p);
      p = q + 1;
    }
  }
};

// A parse in progress: its ranges in file order, their joined sizes, and
// where each range lands in the joined arrays.
struct Parse {
  std::vector<RangeParse> ranges;
  uint8_t* stream_slab = nullptr;  // the ranges' stream slices
  // per range: whether it was parsed on from the state the range before
  // ended in (else afresh, from a header line); the bytes its stream
  // skips (the first record's 0xFF when no record came before it);
  // whether the join closes its open record (the next range starts
  // afresh, or none follows); where its arrays start in the joined ones
  std::vector<char> continued;
  std::vector<int64_t> skip, closes, stream_at, offset_at, length_at, ids_at;
  ~Parse() {
    for (auto& r : ranges) {
      r.stream.release();
      r.ids.release();
    }
    free(stream_slab);
  }
};

// The one-range path: the file read in 1 MB chunks through zlib (gzip or
// plain), each line handed to the machine as it completes. Returns 0, or
// 2 on a read failure.
int parse_streaming(const char* path, int64_t start, int64_t end,
                    RangeParse& rp) {
  gzFile f = gzopen(path, "rb");
  if (!f) return 1;
  if (start > 0 && gzseek(f, static_cast<z_off_t>(start), SEEK_SET) < 0) {
    gzclose(f);
    return 2;
  }
  int64_t remaining = (end < 0) ? INT64_MAX : end - start;
  constexpr int64_t CHUNK = 1 << 20;
  std::unique_ptr<uint8_t[]> buf(new uint8_t[CHUNK]);
  Out<uint8_t> line;  // a line that spans chunks
  int rc = 0;
  while (!rp.done && remaining > 0) {
    const int64_t want = CHUNK < remaining ? CHUNK : remaining;
    const int64_t got = static_cast<int64_t>(
        gzread(f, buf.get(), static_cast<unsigned>(want)));
    if (got < 0) {
      rc = 2;
      break;
    }
    if (got == 0) break;
    remaining -= got;
    const uint8_t* p = buf.get();
    const uint8_t* e = p + got;
    while (p < e && !rp.done) {
      const uint8_t* nl =
          static_cast<const uint8_t*>(memchr(p, '\n', e - p));
      const int64_t n = (nl ? nl : e) - p;
      if (nl && !line.len) {
        rp.line(p, n);
      } else {
        memcpy(line.grow(n), p, n);
        line.len += n;
        if (!nl) break;
        rp.line(line.data, line.len);
        line.len = 0;
      }
      p = nl + 1;
    }
  }
  if (rc == 0 && !rp.done && line.len) rp.line(line.data, line.len);
  line.release();
  gzclose(f);
  return rc;
}

// The cut after byte `from` of text[0, n) where a range may start: FASTA,
// the first '>' that starts a line (lines end at '\n' alone, so every
// such line is a header in every state); FASTQ, a guess: the first line
// that starts with '@' and whose second line after starts with '+'.
// Returns n where there is none.
int64_t next_cut(const uint8_t* text, int64_t n, int64_t from, int format) {
  int64_t j = from;
  while (j < n) {
    if (j > 0 && text[j - 1] != '\n') {
      const void* nl = memchr(text + j, '\n', n - j);
      if (!nl) return n;
      j = static_cast<const uint8_t*>(nl) - text + 1;
      continue;
    }
    if (format == 1 && text[j] == '>') return j;
    if (format == 2 && text[j] == '@') {
      const void* a = memchr(text + j, '\n', n - j);
      const int64_t l1 = a ? static_cast<const uint8_t*>(a) - text + 1 : n;
      const void* b = l1 < n ? memchr(text + l1, '\n', n - l1) : nullptr;
      const int64_t l2 = b ? static_cast<const uint8_t*>(b) - text + 1 : n;
      if (l2 < n && text[l2] == '+') return j;
    }
    j++;
  }
  return n;
}

// The format of text's first significant line (1 FASTA, 2 FASTQ; 0 for
// none), as the record machine decides it.
int first_format(const uint8_t* text, int64_t n) {
  const uint8_t* p = text;
  const uint8_t* e = text + n;
  while (p < e) {
    const uint8_t* nl = static_cast<const uint8_t*>(memchr(p, '\n', e - p));
    const uint8_t* q = nl ? nl : e;
    int64_t len = q - p;
    while (len > 0 && p[len - 1] == '\r') len--;
    if (len > 0) return p[0] == '@' ? 2 : 1;
    p = q + 1;
  }
  return 0;
}

// The range split: bytes [start, start + n) of an uncompressed file,
// mapped read-only, cut into at most nt record-aligned ranges, each parsed
// on its own thread into its slice of one stream block (its header lines
// into a block of its own). A range's codes and sentinels never outnumber
// its bytes (each base is a byte of a sequence line, each sentinel the
// first byte of a header line), so its slice starts at the range's own
// byte offset and never grows.
//
// Exactness: a range is parsed from the machine's state after a header
// line's start with no record open. In FASTA that state holds at every
// cut (a '>' line closes whatever record is open; the join closes it).
// In FASTQ it holds where the range before ends in HDR; where it does
// not, the range is parsed again from the state the range before really
// ended in, and so on along the file, so the joined records are the
// one-range machine's on every input. (The file must not shrink while it
// is parsed: a mapped read past its end faults.)
int parse_split(int fd, int64_t start, int64_t n, int nt, Parse& P) {
  // The bytes, mapped read-only: each range's thread faults in its own
  // pages, and no heap block holds a copy.
  const int64_t lead = start % sysconf(_SC_PAGESIZE);
  void* map = mmap(nullptr, n + lead, PROT_READ, MAP_PRIVATE, fd, start - lead);
  if (map == MAP_FAILED) return 2;
  struct Unmap {
    size_t len;
    void operator()(void* m) const { munmap(m, len); }
  };
  const std::unique_ptr<void, Unmap> unmap(map, Unmap{size_t(n + lead)});
  const uint8_t* text = static_cast<const uint8_t*>(map) + lead;

  const int format = first_format(text, n);
  std::vector<int64_t> cuts{0};
  for (int t = 1; t < nt && format; t++) {
    const int64_t c = next_cut(text, n, std::max(n * t / nt, cuts.back() + 1),
                               format);
    if (c >= n) break;
    cuts.push_back(c);
  }
  cuts.push_back(n);
  const int nr = static_cast<int>(cuts.size()) - 1;

  P.stream_slab = static_cast<uint8_t*>(malloc(n));
  if (!P.stream_slab) return 2;
  P.ranges.resize(nr);
  auto run = [&](int r, const ParseState& from, bool sep) {
    RangeParse& rp = P.ranges[r];
    rp.stream.release();
    rp.ids.release();
    rp = RangeParse();
    rp.stream = {P.stream_slab + cuts[r], 0, cuts[r + 1] - cuts[r], false};
    rp.st = from;
    rp.sep = sep;
    rp.lines(text + cuts[r], text + cuts[r + 1]);
  };
  ParseState fresh;
  fresh.format = format;
  {
    std::vector<std::thread> ths;
    for (int r = 0; r < nr; r++)
      ths.emplace_back([&, r] { run(r, fresh, r > 0); });
    for (auto& th : ths) th.join();
  }
  P.continued.assign(nr, 0);
  for (int r = 1; r < nr; r++) {
    const ParseState& before = P.ranges[r - 1].st;
    if (format == 2 && before.fq_state != FQ_HDR) {
      run(r, before, true);
      P.continued[r] = 1;
    }
  }
  return 0;
}

// Lays the ranges out in the joined arrays: each range's stream after the
// one before (the first record's sentinel dropped), its offsets shifted
// by where its stream lands, and the open record closed where the next
// range starts afresh or none follows.
void plan_join(Parse& P, int64_t* sizes) {
  const size_t nr = P.ranges.size();
  P.continued.resize(nr, 0);
  for (auto* v : {&P.skip, &P.closes, &P.stream_at, &P.offset_at,
                  &P.length_at, &P.ids_at})
    v->assign(nr, 0);
  int64_t stream_len = 0, n_seqs = 0, n_headers = 0, ids_len = 0;
  int64_t total = 0, invalid = 0, lone_cr = 0;
  for (size_t r = 0; r < nr; r++) {
    const RangeParse& rp = P.ranges[r];
    // A range after the first writes a 0xFF before its first header; the
    // first record of the file has none.
    P.skip[r] = r > 0 && n_headers == 0 && !rp.offsets.empty();
    P.closes[r] = rp.st.in_seq && (r + 1 == nr || !P.continued[r + 1]);
    P.stream_at[r] = stream_len;
    P.offset_at[r] = n_headers;
    P.length_at[r] = n_seqs;
    P.ids_at[r] = ids_len;
    stream_len += rp.stream.len - P.skip[r];
    n_headers += static_cast<int64_t>(rp.offsets.size());
    n_seqs += static_cast<int64_t>(rp.lengths.size()) + P.closes[r];
    ids_len += rp.ids.len;
    total += rp.total_bases;
    invalid += rp.invalid_bases;
    lone_cr += rp.lone_cr;
  }
  // n_headers == n_seqs: every record has one header and closes once.
  sizes[0] = n_seqs;
  sizes[1] = stream_len;
  sizes[2] = ids_len;
  sizes[3] = total;
  sizes[4] = invalid;
  sizes[5] = lone_cr;
  sizes[6] = static_cast<int64_t>(nr);
}

}  // namespace

extern "C" {

// A parse's joined sizes (the join fills arrays of these sizes), and the
// parse itself until kp_free_fasta.
struct KpFasta {
  int64_t n_seqs;
  int64_t stream_len;
  int64_t ids_len;
  int64_t total_bases;
  int64_t invalid_bases;
  int64_t lone_cr;   // lines holding a CR that does not end them
  int64_t ranges;    // the ranges the file was parsed in (1: one range)
  Parse* parse;
};

// Parse a FASTA or FASTQ file, plain or gzip, into a flat encoded stream:
// base codes (A=0, C=1, G=2, T=3, 0xFF for any other byte) with one 0xFF
// between records, each record's offset and length, and its header line.
// The records of bytes [start, end) of the file (end < 0: to its end):
// one rank's share of a multi-host run, whose bounds are record starts
// (parallel/multihost.split_fasta_byte_ranges). max_seqs <= 0: no cap.
//
// An uncompressed input with no cap, of more than the thread grain, is
// mapped and parsed as record-aligned ranges on the host's
// threads (num_threads: at most 16, KMER_NATIVE_THREADS overrides), and
// the ranges' output joined: parse_split states the cut and why the join
// equals the one-range machine's records, byte for byte. gzip (whose
// offsets are compressed ones), a cap, or a small input take one range,
// streamed through zlib. A byte range on gzip input is refused with rc 3:
// gzseek takes uncompressed offsets.
//
// Returns 0 on success, 1 on open failure, 2 on read failure. kp_fasta_join
// then writes the arrays, and kp_free_fasta frees the parse.
int kp_parse_fasta_range(const char* path, int64_t start, int64_t end,
                         int64_t max_seqs, KpFasta** out) {
  bool is_gz = false;
  int fd = open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return 1;
  unsigned char magic[2] = {0, 0};
  is_gz = pread(fd, magic, 2, 0) == 2 && magic[0] == 0x1F && magic[1] == 0x8B;
  if (is_gz && (start > 0 || end >= 0)) {
    close(fd);
    return 3;
  }
  struct stat sb;
  if (fstat(fd, &sb) != 0) {
    close(fd);
    return 2;
  }
  const int64_t size = static_cast<int64_t>(sb.st_size);
  const int64_t a = std::min(std::max<int64_t>(start, 0), size);
  const int64_t b = (end < 0 || end > size) ? size : std::max(end, a);
  const int nt = num_threads(b - a, 1 << 18);
  std::unique_ptr<Parse> P(new Parse());
  int rc;
  if (!is_gz && max_seqs <= 0 && nt > 1 && S_ISREG(sb.st_mode)) {
    rc = parse_split(fd, a, b - a, nt, *P);
    close(fd);
  } else {
    close(fd);
    P->ranges.resize(1);
    P->ranges[0].max_seqs = max_seqs;
    rc = parse_streaming(path, start, end, P->ranges[0]);
  }
  if (rc != 0) return rc;
  int64_t sizes[7];
  plan_join(*P, sizes);
  KpFasta* r = static_cast<KpFasta*>(malloc(sizeof(KpFasta)));
  r->n_seqs = sizes[0];
  r->stream_len = sizes[1];
  r->ids_len = sizes[2];
  r->total_bases = sizes[3];
  r->invalid_bases = sizes[4];
  r->lone_cr = sizes[5];
  r->ranges = sizes[6];
  r->parse = P.release();
  *out = r;
  return 0;
}

// The joined arrays, into the caller's: stream [stream_len], offsets
// [n_seqs + 1] (the last the stream's length), lengths [n_seqs], ids
// [ids_len] (the header lines, each ended by a NUL). One thread a range.
void kp_fasta_join(const KpFasta* r, uint8_t* stream, int64_t* offsets,
                   int64_t* lengths, char* ids) {
  Parse& P = *r->parse;
  const size_t nr = P.ranges.size();
  auto one = [&](size_t i) {
    const RangeParse& rp = P.ranges[i];
    const int64_t skip = P.skip[i];
    // (an empty range may hold no buffer at all: memcpy takes none)
    if (rp.stream.len > skip)
      memcpy(stream + P.stream_at[i], rp.stream.data + skip,
             rp.stream.len - skip);
    const int64_t shift = P.stream_at[i] - skip;
    int64_t* off = offsets + P.offset_at[i];
    for (size_t j = 0; j < rp.offsets.size(); j++)
      off[j] = rp.offsets[j] + shift;
    int64_t* len = lengths + P.length_at[i];
    std::copy(rp.lengths.begin(), rp.lengths.end(), len);
    if (P.closes[i]) len[rp.lengths.size()] = rp.st.cur_len;
    if (rp.ids.len) memcpy(ids + P.ids_at[i], rp.ids.data, rp.ids.len);
  };
  if (nr == 1) {
    one(0);
  } else {
    std::vector<std::thread> ths;
    for (size_t i = 0; i < nr; i++) ths.emplace_back(one, i);
    for (auto& th : ths) th.join();
  }
  offsets[r->n_seqs] = r->stream_len;
}

void kp_free_fasta(KpFasta* r) {
  if (!r) return;
  delete r->parse;
  free(r);
}

// 2-bit pack: base codes -> 4 bases/byte (little-endian within byte) plus a
// validity bitmask (8 bases/byte). Invalid bases pack as 0 with mask bit 0.
// out_data must hold (n+3)/4 bytes, out_mask (n+7)/8 bytes.
//
// SWAR inner loop (8 bases per u64; zero-byte detect for validity, two
// multiply-gathers for the bit packing) — the pack sits on the streaming
// pipeline's prep path, so the scalar version's ~0.6 Gbase/s would
// co-bottleneck a >1 Gbase/s device feed.
static void pack_range(const uint8_t* bases, int64_t i0, int64_t i1,
                       uint8_t* out_data, uint8_t* out_mask) {
  // [i0, i1): i0 % 8 == 0 guaranteed by callers.
  int64_t i = i0;
  const uint64_t lo2 = 0x0303030303030303ULL;
  const uint64_t ones = 0x0101010101010101ULL;
  const uint64_t high = 0x8080808080808080ULL;
  for (; i + 8 <= i1; i += 8) {
    uint64_t x;
    memcpy(&x, bases + i, 8);
    const uint64_t t = x & ~lo2;  // zero byte <=> base code < 4 (valid)
    const uint64_t vhigh = (t - ones) & ~t & high;  // 0x80 at valid bytes
    const uint64_t vmask = (vhigh >> 7) * 0xFF;     // 0xFF at valid bytes
    const uint64_t vals = x & lo2 & vmask;          // invalid packs as 0
    // Gather the 2-bit values of each 4-byte half into one byte:
    // sum(v_i << (2i)) from sum(v_i << (8i)) via multiply 0x01041040.
    const uint32_t ylo = static_cast<uint32_t>(vals);
    const uint32_t yhi = static_cast<uint32_t>(vals >> 32);
    out_data[i >> 2] =
        static_cast<uint8_t>((ylo * 0x01041040u) >> 24);
    out_data[(i >> 2) + 1] =
        static_cast<uint8_t>((yhi * 0x01041040u) >> 24);
    // Gather the 8 validity bits (bit 7 of each byte) into one byte.
    out_mask[i >> 3] = static_cast<uint8_t>(
        ((vhigh >> 7) * 0x0102040810204080ULL) >> 56);
  }
  for (; i < i1; i++) {  // tail
    uint8_t b = bases[i];
    if (b < 4) {
      out_data[i >> 2] |= static_cast<uint8_t>(b << ((i & 3) * 2));
      out_mask[i >> 3] |= static_cast<uint8_t>(1u << (i & 7));
    }
  }
}

void kp_pack_2bit(const uint8_t* bases, int64_t n, uint8_t* out_data,
                  uint8_t* out_mask) {
  int64_t nd = (n + 3) / 4;
  int64_t nm = (n + 7) / 8;
  // Zero only the tail bytes the SWAR loop won't fully overwrite.
  int64_t full = (n / 8) * 8;
  if (full < n) {
    memset(out_data + full / 4, 0, nd - full / 4);
    memset(out_mask + full / 8, 0, nm - full / 8);
  }
  const int nt = num_threads(n, 4 << 20);
  if (nt <= 1) {
    pack_range(bases, 0, n, out_data, out_mask);
    return;
  }
  std::vector<std::thread> ths;
  for (int t = 0; t < nt; t++) {
    int64_t a = ((n * t / nt) / 8) * 8;
    int64_t b = (t == nt - 1) ? n : ((n * (t + 1) / nt) / 8) * 8;
    if (a >= b) continue;
    ths.emplace_back(
        [=] { pack_range(bases, a, b, out_data, out_mask); });
  }
  for (auto& th : ths) th.join();
}

// Unpack (inverse of kp_pack_2bit): out must hold n bytes.
void kp_unpack_2bit(const uint8_t* data, const uint8_t* mask, int64_t n,
                    uint8_t* out) {
  for (int64_t i = 0; i < n; i++) {
    bool ok = (mask[i >> 3] >> (i & 7)) & 1;
    out[i] = ok ? ((data[i >> 2] >> ((i & 3) * 2)) & 3) : kInvalid;
  }
}

// Dense k-mer count over an encoded stream (0xFF = invalid or separator),
// rolling 2-bit codes, k <= 15: the windows that start in [0, n_own),
// canonical or not, added into out (4^k int64, zeroed by the caller).
void kp_count_dense(const uint8_t* stream, int64_t n, int64_t n_own, int k,
                    int canonical, int64_t* out) {
  const uint32_t mask = (1u << (2 * k)) - 1;
  uint32_t code = 0;
  int run = 0;  // consecutive valid bases ending at i
  if (n_own > n - k + 1) n_own = n - k + 1;
  for (int64_t i = 0; i < n; i++) {
    uint8_t b = stream[i];
    if (b < 4) {
      code = ((code << 2) | b) & mask;
      run++;
    } else {
      run = 0;
    }
    int64_t start = i - k + 1;
    if (run >= k && start < n_own) {
      uint32_t c = code;
      if (canonical) {
        uint32_t rc = 0, t = code;
        for (int j = 0; j < k; j++) {
          rc = (rc << 2) | ((t & 3) ^ 3);
          t >>= 2;
        }
        if (rc < c) c = rc;
      }
      out[c]++;
    }
  }
}

}  // extern "C"

namespace {

// Combined code at index i for the (hi?, lo) sorted word layout.
inline uint64_t word_code(const void* hi, int hi_width, const uint32_t* lo,
                          int64_t i) {
  if (hi_width == 0) return lo[i];
  if (hi_width == 2)
    return (static_cast<uint64_t>(static_cast<const uint16_t*>(hi)[i]) << 32) |
           lo[i];
  return (static_cast<uint64_t>(static_cast<const uint32_t*>(hi)[i]) << 32) |
         lo[i];
}


// First index whose MAJOR sort word equals the all-ones sentinel (the
// invalid-window tail); the words are sorted ascending so binary search.
int64_t sentinel_begin(const void* hi, int hi_width, const uint32_t* lo,
                       int64_t n) {
  int64_t a = 0, b = n;
  auto is_sent = [&](int64_t i) {
    if (hi_width == 0) return lo[i] == 0xFFFFFFFFu;
    if (hi_width == 2) return static_cast<const uint16_t*>(hi)[i] == 0xFFFFu;
    return static_cast<const uint32_t*>(hi)[i] == 0xFFFFFFFFu;
  };
  while (a < b) {
    int64_t m = a + (b - a) / 2;
    if (is_sent(m))
      b = m;
    else
      a = m + 1;
  }
  return a;
}

template <int HW>
inline uint64_t code_hw(const void* hi, const uint32_t* lo, int64_t i) {
  if (HW == 0) return lo[i];
  if (HW == 2)
    return (static_cast<uint64_t>(static_cast<const uint16_t*>(hi)[i]) << 32) |
           lo[i];
  return (static_cast<uint64_t>(static_cast<const uint32_t*>(hi)[i]) << 32) |
         lo[i];
}

// Shared RLE: collapse a sorted run into (code u64, count i64) entries.
template <class T>
int64_t rle_run(const T* v, int64_t n, uint64_t* oc, int64_t* on) {
  int64_t w = -1;
  for (int64_t i = 0; i < n; i++) {
    const uint64_t c = v[i];
    if (w >= 0 && oc[w] == c) {
      on[w]++;
    } else {
      w++;
      oc[w] = c;
      on[w] = 1;
    }
  }
  return w + 1;
}

// ---------------------------------------------------------------------------
// Loser-tree multiway merge over sorted streams of window codes.
//
// The R-way merge behind kp_compact_rows. A binary std::heap costs
// 2*log2(R) branchy swaps through a 100+ KB array per element (measured
// ~3.5 Melem/s/thread at R=8192); the loser tree costs log2(R) compares on
// an L2-resident array, every stream read is sequential, and runs of equal
// codes inside one stream drain in bulk without touching the tree.
// Templated on the hi-word width so code assembly is branch-free.

struct MergeStream {
  int64_t pos;   // current absolute index into the word arrays
  int64_t stop;  // absolute end of this stream's slice
};

// One loser-tree core over any stream type. A Stream provides:
//   uint64_t head() const    — current key, UINT64_MAX when exhausted
//   int64_t pop(uint64_t c)  — consume the current run of key c, return
//                              its count contribution, advance
// Valid codes are at most 2*31 bits (< 2^62), so UINT64_MAX marks
// exhaustion unambiguously.
template <class Stream>
int64_t loser_tree_core(std::vector<Stream>& ss, uint64_t* oc, int64_t* on) {
  const int S = static_cast<int>(ss.size());
  if (S == 0) return 0;
  int S2 = 1;
  while (S2 < S) S2 <<= 1;
  std::vector<uint64_t> key(S2, UINT64_MAX);
  for (int s = 0; s < S; s++) key[s] = ss[s].head();
  std::vector<int> ls(S2, 0);  // ls[1..S2-1] = losers; ls[0] = winner
  {
    std::vector<int> win(2 * S2);
    for (int i = 0; i < S2; i++) win[S2 + i] = i;
    for (int node = S2 - 1; node >= 1; node--) {
      int a = win[2 * node], b = win[2 * node + 1];
      int w = (key[a] <= key[b]) ? a : b;
      ls[node] = (w == a) ? b : a;
      win[node] = w;
    }
    ls[0] = win[1];
  }
  int64_t w = -1;
  int wtr = ls[0];
  while (key[wtr] != UINT64_MAX) {
    const uint64_t c = key[wtr];
    const int64_t cnt = ss[wtr].pop(c);
    key[wtr] = ss[wtr].head();
    if (w >= 0 && oc[w] == c) {
      on[w] += cnt;
    } else {
      w++;
      oc[w] = c;
      on[w] = cnt;
    }
    // Replay from this leaf to the root. Branchless mask blends: the
    // compare at each level is a ~50/50 coin flip, and the mispredict
    // penalty (~17 cycles/level measured) dominates a branchy replay.
    int winner = wtr;
    uint64_t kwin = key[wtr];
    for (int node = (S2 + wtr) >> 1; node >= 1; node >>= 1) {
      const int l = ls[node];
      const uint64_t kl = key[l];
      const uint64_t msk = (uint64_t)0 - (uint64_t)(kl < kwin);
      ls[node] = (int)(((uint64_t)winner & msk) | ((uint64_t)l & ~msk));
      winner = (int)(((uint64_t)l & msk) | ((uint64_t)winner & ~msk));
      kwin = (kl & msk) | (kwin & ~msk);
    }
    ls[0] = winner;
    wtr = winner;
  }
  return w + 1;
}

// Stream of raw sorted window codes (duplicates adjacent; each counts 1).
template <int HW>
struct WindowStream {
  const void* hi;
  const uint32_t* lo;
  int64_t pos, stop;
  inline uint64_t head() const {
    return pos < stop ? code_hw<HW>(hi, lo, pos) : UINT64_MAX;
  }
  inline int64_t pop(uint64_t c) {
    int64_t cnt = 0;
    do {  // drain this stream's run of equal codes without tree replays
      cnt++;
      pos++;
    } while (pos < stop && code_hw<HW>(hi, lo, pos) == c);
    if (pos + 16 < stop) __builtin_prefetch(lo + pos + 16);
    return cnt;
  }
};

// Stream of pre-aggregated (code, count) runs (codes unique within one).
struct RunStream {
  const uint64_t* c;
  const int64_t* n;
  int64_t pos, stop;
  inline uint64_t head() const { return pos < stop ? c[pos] : UINT64_MAX; }
  inline int64_t pop(uint64_t) {
    const int64_t cnt = n[pos];
    pos++;
    if (pos + 8 < stop) __builtin_prefetch(c + pos + 8);
    return cnt;
  }
};

// Merge ss (sorted window-code slices) writing sorted-unique (code, count).
template <int HW>
int64_t loser_tree_merge(std::vector<MergeStream>& ss, const void* hi,
                         const uint32_t* lo, uint64_t* oc, int64_t* on) {
  if (ss.size() == 1) {
    // Single stream: plain RLE walk.
    int64_t w = -1;
    for (int64_t i = ss[0].pos; i < ss[0].stop; i++) {
      uint64_t c = code_hw<HW>(hi, lo, i);
      if (w >= 0 && oc[w] == c)
        on[w]++;
      else {
        w++;
        oc[w] = c;
        on[w] = 1;
      }
    }
    return w + 1;
  }
  std::vector<WindowStream<HW>> ws;
  ws.reserve(ss.size());
  for (auto& st : ss) ws.push_back({hi, lo, st.pos, st.stop});
  return loser_tree_core(ws, oc, on);
}

// Hierarchical (two-stage) merge for high fan-in: bundles of <= kGroup
// streams merge through L1-resident trees into scratch (code, count) runs,
// then one tree over the runs. One extra memory pass buys shallow trees
// at both stages — ~2x the flat tree past a few hundred streams.
constexpr int kGroup = 128;
constexpr int kTwoStageMin = 384;

template <int HW>
int64_t merge_two_stage(std::vector<MergeStream>& ss, const void* hi,
                        const uint32_t* lo, uint64_t* oc, int64_t* on) {
  const int64_t S = static_cast<int64_t>(ss.size());
  int64_t in_total = 0;
  for (auto& st : ss) in_total += st.stop - st.pos;
  std::vector<uint64_t> sc_c(in_total);
  std::vector<int64_t> sc_n(in_total);
  std::vector<RunStream> runs;
  runs.reserve((S + kGroup - 1) / kGroup);
  int64_t off = 0;
  for (int64_t g = 0; g < S; g += kGroup) {
    int64_t ge = std::min<int64_t>(g + kGroup, S);
    std::vector<MergeStream> bundle(ss.begin() + g, ss.begin() + ge);
    int64_t cap = 0;
    for (auto& st : bundle) cap += st.stop - st.pos;
    int64_t len =
        loser_tree_merge<HW>(bundle, hi, lo, sc_c.data() + off, sc_n.data() + off);
    runs.push_back({sc_c.data() + off, sc_n.data() + off, 0, len});
    off += cap;
  }
  return loser_tree_core(runs, oc, on);
}

// ---------------------------------------------------------------------------
// SIMD pairwise merge ladder (AVX-512) — the fast host half of the
// row-sorted sparse path on real (server-core) hosts.
//
// The loser tree above costs log2(R) dependent compares per element; even
// branchless, that is ~10 Melem/s/thread at R=8192. A pairwise merge
// ladder instead does log2(R)+1 sequential passes, each a streaming 2-way
// merge that the 8x/16x-lane bitonic-merge network below sustains at
// hundreds of Melem/s. The ladder recurses depth-first with a
// length-balanced split, so subtrees up to cache size merge entirely in
// cache and only the top levels pay DRAM bandwidth. Codes travel in their
// native width (u32 for hi_width 0, u64 otherwise); the final pass RLEs
// the single sorted run into the (code u64, count i64) table.
//
// Selection: merge_ladder when compiled with AVX-512, else the loser tree
// (two-stage past kTwoStageMin streams).

#if defined(__AVX512F__)

// Bitonic-merge two ascending 8-lane u64 vectors: a = low 8, b = high 8.
inline __m512i bclean_u64(__m512i v) {
  // Cleaner for an 8-lane bitonic sequence: compare-exchange at
  // distances 4, 2, 1. mask_blend bit=1 selects the max operand.
  __m512i u, mn, mx;
  u = _mm512_permutexvar_epi64(_mm512_setr_epi64(4, 5, 6, 7, 0, 1, 2, 3), v);
  mn = _mm512_min_epu64(v, u);
  mx = _mm512_max_epu64(v, u);
  v = _mm512_mask_blend_epi64(0xF0, mn, mx);
  u = _mm512_permutexvar_epi64(_mm512_setr_epi64(2, 3, 0, 1, 6, 7, 4, 5), v);
  mn = _mm512_min_epu64(v, u);
  mx = _mm512_max_epu64(v, u);
  v = _mm512_mask_blend_epi64(0xCC, mn, mx);
  u = _mm512_permutexvar_epi64(_mm512_setr_epi64(1, 0, 3, 2, 5, 4, 7, 6), v);
  mn = _mm512_min_epu64(v, u);
  mx = _mm512_max_epu64(v, u);
  return _mm512_mask_blend_epi64(0xAA, mn, mx);
}

inline __m512i bclean_u32(__m512i v) {
  __m512i u, mn, mx;
  u = _mm512_permutexvar_epi32(
      _mm512_setr_epi32(8, 9, 10, 11, 12, 13, 14, 15, 0, 1, 2, 3, 4, 5, 6, 7),
      v);
  mn = _mm512_min_epu32(v, u);
  mx = _mm512_max_epu32(v, u);
  v = _mm512_mask_blend_epi32(0xFF00, mn, mx);
  u = _mm512_permutexvar_epi32(
      _mm512_setr_epi32(4, 5, 6, 7, 0, 1, 2, 3, 12, 13, 14, 15, 8, 9, 10, 11),
      v);
  mn = _mm512_min_epu32(v, u);
  mx = _mm512_max_epu32(v, u);
  v = _mm512_mask_blend_epi32(0xF0F0, mn, mx);
  u = _mm512_permutexvar_epi32(
      _mm512_setr_epi32(2, 3, 0, 1, 6, 7, 4, 5, 10, 11, 8, 9, 14, 15, 12, 13),
      v);
  mn = _mm512_min_epu32(v, u);
  mx = _mm512_max_epu32(v, u);
  v = _mm512_mask_blend_epi32(0xCCCC, mn, mx);
  u = _mm512_permutexvar_epi32(
      _mm512_setr_epi32(1, 0, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10, 13, 12, 15, 14),
      v);
  mn = _mm512_min_epu32(v, u);
  mx = _mm512_max_epu32(v, u);
  return _mm512_mask_blend_epi32(0xAAAA, mn, mx);
}

template <class T>
struct VecMerge;

template <>
struct VecMerge<uint64_t> {
  static constexpr int64_t kLanes = 8;
  static inline void merge(__m512i& a, __m512i& b) {
    // [a, reverse(b)] is one bitonic 16-sequence; first exchange at
    // distance 8, then clean each half.
    __m512i br =
        _mm512_permutexvar_epi64(_mm512_setr_epi64(7, 6, 5, 4, 3, 2, 1, 0), b);
    __m512i lo = _mm512_min_epu64(a, br);
    __m512i hi = _mm512_max_epu64(a, br);
    a = bclean_u64(lo);
    b = bclean_u64(hi);
  }
};

template <>
struct VecMerge<uint32_t> {
  static constexpr int64_t kLanes = 16;
  static inline void merge(__m512i& a, __m512i& b) {
    __m512i br = _mm512_permutexvar_epi32(
        _mm512_setr_epi32(15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1,
                          0),
        b);
    __m512i lo = _mm512_min_epu32(a, br);
    __m512i hi = _mm512_max_epu32(a, br);
    a = bclean_u32(lo);
    b = bclean_u32(hi);
  }
};

// Branchless scalar 2-way merge (cmov advance; ~50/50 compares mispredict).
template <class T>
inline T* scalar_merge2(const T* a, const T* ae, const T* b, const T* be,
                        T* o) {
  while (a < ae && b < be) {
    const T ca = *a, cb = *b;
    const bool t = ca <= cb;
    *o++ = t ? ca : cb;
    a += t;
    b += !t;
  }
  while (a < ae) *o++ = *a++;
  while (b < be) *o++ = *b++;
  return o;
}

// Streaming SIMD 2-way merge of two sorted arrays into out (size na+nb).
template <class T>
void simd_merge2(const T* A, int64_t na, const T* B, int64_t nb, T* out) {
  constexpr int64_t L = VecMerge<T>::kLanes;
  if (na < 2 * L || nb < 2 * L) {
    scalar_merge2(A, A + na, B, B + nb, out);
    return;
  }
  __m512i v = _mm512_loadu_si512(A);
  __m512i w = _mm512_loadu_si512(B);
  int64_t ia = L, ib = L;
  for (;;) {
    VecMerge<T>::merge(v, w);  // v = low L (final), w = high L (carry)
    _mm512_storeu_si512(out, v);
    out += L;
    if (ia + L > na || ib + L > nb) break;
    // Refill from the stream whose head is smaller — the carry covers
    // everything below the other stream's head.
    const bool takeA = A[ia] <= B[ib];
    v = _mm512_loadu_si512(takeA ? A + ia : B + ib);
    ia += takeA ? L : 0;
    ib += takeA ? 0 : L;
  }
  // Spill the carry; merge it with the drained stream's tail (< L elems),
  // then that small run with the surviving stream's tail.
  T spill[L], tmp[3 * L];
  _mm512_storeu_si512(spill, w);
  const T* ta = A + ia;
  const int64_t ra = na - ia;
  const T* tb = B + ib;
  const int64_t rb = nb - ib;
  if (ra <= rb) {
    T* te = scalar_merge2(spill, spill + L, ta, ta + ra, tmp);
    scalar_merge2(tmp, te, tb, tb + rb, out);
  } else {
    T* te = scalar_merge2(spill, spill + L, tb, tb + rb, tmp);
    scalar_merge2(tmp, te, ta, ta + ra, out);
  }
}

// Depth-first merge ladder over the streams' (hi, lo) slices. Buffers dst
// and scr are full-partition sized; subtree [a, b) occupies
// [pre[a], pre[b]) in either buffer, children write to scr with dst as
// their scratch, so the subtree's final run lands in dst.
template <int HW>
struct MergeLadder {
  using T = typename std::conditional<HW == 0, uint32_t, uint64_t>::type;
  const void* hi;
  const uint32_t* lo;
  const MergeStream* ss;
  const int64_t* pre;  // pre[i] = total elements of streams [0, i)

  void widen(int s, T* dst) const {
    const int64_t p = ss[s].pos, e = ss[s].stop;
    if (HW == 0) {
      memcpy(dst, lo + p, static_cast<size_t>(e - p) * sizeof(uint32_t));
    } else {
      for (int64_t i = p; i < e; i++) *dst++ = code_hw<HW>(hi, lo, i);
    }
  }

  void run(int a, int b, T* dst, T* scr) const {
    if (b - a == 1) {
      widen(a, dst + pre[a]);
      return;
    }
    // Split at the length midpoint so both halves stream comparable
    // volumes through simd_merge2.
    const int64_t want = (pre[a] + pre[b]) / 2;
    int mid = static_cast<int>(
        std::upper_bound(pre + a + 1, pre + b, want) - pre);
    if (mid >= b) mid = b - 1;
    run(a, mid, scr, dst);
    run(mid, b, scr, dst);
    simd_merge2(scr + pre[a], pre[mid] - pre[a], scr + pre[mid],
                pre[b] - pre[mid], dst + pre[a]);
  }
};

template <int HW>
int64_t merge_ladder(std::vector<MergeStream>& ss, const void* hi,
                     const uint32_t* lo, uint64_t* oc, int64_t* on) {
  using T = typename std::conditional<HW == 0, uint32_t, uint64_t>::type;
  const int S = static_cast<int>(ss.size());
  std::vector<int64_t> pre(S + 1, 0);
  for (int i = 0; i < S; i++) pre[i + 1] = pre[i] + (ss[i].stop - ss[i].pos);
  const int64_t total = pre[S];
  if (total == 0) return 0;
  std::vector<T> b0(total), b1(total);
  MergeLadder<HW> ml{hi, lo, ss.data(), pre.data()};
  ml.run(0, S, b0.data(), b1.data());
  return rle_run(b0.data(), total, oc, on);
}

#endif  // __AVX512F__

template <int HW>
int64_t merge_streams(std::vector<MergeStream>& ss, const void* hi,
                      const uint32_t* lo, uint64_t* oc, int64_t* on) {
#if defined(__AVX512F__)
  if (ss.size() > 1) return merge_ladder<HW>(ss, hi, lo, oc, on);
#endif
  if (ss.size() >= kTwoStageMin) return merge_two_stage<HW>(ss, hi, lo, oc, on);
  return loser_tree_merge<HW>(ss, hi, lo, oc, on);
}

// ---------------------------------------------------------------------------
// Sortedness-free radix compactor — the host half of the NO-DEVICE-SORT
// sparse path. The device only encodes window codes (split words +
// all-ones sentinels for invalid windows) and ships them UNSORTED; this
// builds the sorted-unique (code u64, count i64) table with an MSD+LSD
// radix sort:
//
//   pass 1 (parallel): 8-bit MSD on code bits [kbits-8, kbits) scatters
//     elements into 256 value-range buckets (write-combining staging lines
//     so the scatter writes are 64-byte bursts), widening (hi, lo) words
//     to native-width codes on the way and dropping sentinel words
//     (code >= 2^kbits). Buckets are range-ordered, so the final table is
//     globally sorted without any merge.
//   pass 2 (parallel over buckets): each ~N/256-element bucket is LSD
//     radix sorted over the remaining kbits-8 bits with <= 12-bit digits
//     (counters L1-resident, bucket ping-pong L2-resident), then RLE'd
//     straight into its reserved output range.
//
// This costs a constant ~6 memory touches per element, and the device
// does not have to sort at all: it runs the encode kernel alone.

template <class T>
struct RadixTraits;
template <>
struct RadixTraits<uint32_t> {
  static constexpr int kMaxDigit = 11;  // 2048 x u64 counters = 16 KB (L1)
};
template <>
struct RadixTraits<uint64_t> {
  static constexpr int kMaxDigit = 12;  // 4096 x u64 counters = 32 KB (L1)
};

// LSD radix sort of buf[0..n) over bit range [0, bits); scr is ping-pong
// scratch of size n. Returns the buffer holding the sorted data.
template <class T>
T* lsd_radix(T* buf, T* scr, int64_t n, int bits) {
  if (n <= 1 || bits <= 0) return buf;
  int passes = (bits + RadixTraits<T>::kMaxDigit - 1) / RadixTraits<T>::kMaxDigit;
  int digit = (bits + passes - 1) / passes;  // even-ish split
  // EVERY pass's digit histogram in ONE read of the data: the per-pass
  // count loop re-read src from DRAM each time (at 3 passes that is 2
  // extra full passes over the bucket, and the LSD phase is
  // bandwidth-bound). passes * 4K u64 counters
  // stay cache-resident. u64 counters: a single MSD bucket can exceed
  // 2^32 elements on repeat-skewed multi-Gbase inputs, and wrapped u32
  // counts would emit a silently wrong table.
  constexpr int kMaxB = 1 << RadixTraits<T>::kMaxDigit;
  std::vector<uint64_t> cnt_all(static_cast<size_t>(passes) * kMaxB, 0);
  {
    // Per-pass EXACT masks: the last pass's digit is narrower, and the
    // bits above `bits` (the constant MSD bucket id of every element in
    // this bucket) must not leak into its slots.
    T mask_p[8];
    for (int p = 0; p < passes; p++) {
      const int d = std::min(digit, bits - p * digit);
      mask_p[p] = (T(1) << d) - 1;
    }
    uint64_t* c0 = cnt_all.data();
    for (int64_t i = 0; i < n; i++) {
      const T v = buf[i];
      for (int p = 0; p < passes; p++)
        c0[(static_cast<size_t>(p) << RadixTraits<T>::kMaxDigit) +
           (static_cast<size_t>((v >> (p * digit)) & mask_p[p]))]++;
    }
  }
  T* src = buf;
  T* dst = scr;
  int pass = 0;
  for (int shift = 0; shift < bits; shift += digit, pass++) {
    const int d = std::min(digit, bits - shift);
    const T mask = (T(1) << d) - 1;
    const int64_t B = int64_t(1) << d;
    uint64_t* cnt = cnt_all.data() + (static_cast<size_t>(pass) << RadixTraits<T>::kMaxDigit);
    uint64_t acc = 0;
    for (int64_t b = 0; b < B; b++) {
      uint64_t c = cnt[b];
      cnt[b] = acc;
      acc += c;
    }
    for (int64_t i = 0; i < n; i++) dst[cnt[(src[i] >> shift) & mask]++] = src[i];
    std::swap(src, dst);
  }
  return src;
}

// The MSD scatter's per-bucket write-combining staging: one cache line
// (8 u64 / 16 u32) per bucket, flushed when full. The first flush of each
// bucket is a partial memcpy that brings the output pointer to 64-byte
// alignment; every flush after that is a full aligned line written with
// NON-TEMPORAL stores, which skip the read-for-ownership of the
// destination line (the scratch is written exactly once here and re-read
// from DRAM by the LSD pass regardless) — one third of the scatter's DRAM
// traffic gone. On the memcpy path the next flush line is write-prefetched
// instead: the 256-bucket working set is far larger than L1/L2 and the
// flush would otherwise stall on the RFO + TLB walk of a cold line
// (measured: the scatter was 15x the hist pass before this + the
// huge-page buffer below).
constexpr int kMsdBuckets = 256;

template <class T>
struct WcBuf {
  static constexpr int kLine = 64 / sizeof(T);
  alignas(64) T stage[kMsdBuckets][kLine];
  int fill[kMsdBuckets];
  int target[kMsdBuckets];  // fill level that triggers the next flush
  T* out[kMsdBuckets];
  void init(T* base, const int64_t* offs) {
    for (int b = 0; b < kMsdBuckets; b++) {
      fill[b] = 0;
      out[b] = base + offs[b];
      const int mis = static_cast<int>(
          (reinterpret_cast<uintptr_t>(out[b]) & 63) / sizeof(T));
      target[b] = mis ? kLine - mis : kLine;
      // Prefetch only when the first flush is a regular (RFO-ing) store;
      // pulling the line into cache would defeat a non-temporal store.
      if (target[b] != kLine) __builtin_prefetch(out[b], 1, 1);
    }
  }
  inline void flush_line(int b) {
    const int m = target[b];
#if defined(__AVX512F__)
    if (m == kLine) {
      _mm512_stream_si512(
          reinterpret_cast<__m512i*>(out[b]),
          _mm512_load_si512(reinterpret_cast<const __m512i*>(stage[b])));
    } else {
      memcpy(out[b], stage[b], static_cast<size_t>(m) * sizeof(T));
      target[b] = kLine;
    }
#elif defined(__x86_64__) || defined(_M_X64)
    if (m == kLine) {
      const __m128i* s = reinterpret_cast<const __m128i*>(stage[b]);
      __m128i* d = reinterpret_cast<__m128i*>(out[b]);
      _mm_stream_si128(d + 0, _mm_load_si128(s + 0));
      _mm_stream_si128(d + 1, _mm_load_si128(s + 1));
      _mm_stream_si128(d + 2, _mm_load_si128(s + 2));
      _mm_stream_si128(d + 3, _mm_load_si128(s + 3));
    } else {
      memcpy(out[b], stage[b], static_cast<size_t>(m) * sizeof(T));
      target[b] = kLine;
    }
#else
    memcpy(out[b], stage[b], static_cast<size_t>(m) * sizeof(T));
    target[b] = kLine;
    __builtin_prefetch(out[b] + m, 1, 1);
#endif
    out[b] += m;
    fill[b] = 0;
  }
  inline void push(int b, T v) {
    stage[b][fill[b]++] = v;
    if (fill[b] == target[b]) flush_line(b);
  }
  void flush() {
    for (int b = 0; b < kMsdBuckets; b++) {
      memcpy(out[b], stage[b], fill[b] * sizeof(T));
      out[b] += fill[b];
      fill[b] = 0;
    }
#if defined(__x86_64__) || defined(_M_X64)
    // Non-temporal stores are weakly ordered; make them visible before the
    // spawning thread joins and the LSD pass reads the scratch.
    _mm_sfence();
#endif
  }
};

// Scratch buffer on transparent huge pages when available: the MSD
// scatter touches its whole extent in 64-byte strides, so 4K pages mean a
// TLB walk per flush (16K live pages at 64 MB); 2 MB pages cut that to a
// few dozen.
template <class T>
struct HugeBuf {
  T* p = nullptr;
  int64_t n = 0;
  explicit HugeBuf(int64_t count) : n(count) {
    void* mem = nullptr;
    if (posix_memalign(&mem, 2 << 20, static_cast<size_t>(n) * sizeof(T)))
      mem = nullptr;
    p = static_cast<T*>(mem);
#if defined(MADV_HUGEPAGE)
    if (p != nullptr)
      madvise(p, static_cast<size_t>(n) * sizeof(T), MADV_HUGEPAGE);
#endif
  }
  ~HugeBuf() { free(p); }
  HugeBuf(const HugeBuf&) = delete;
  HugeBuf& operator=(const HugeBuf&) = delete;
  T* data() { return p; }
};

// Radix-compact n UNSORTED (hi, lo) window words (sentinels = all-ones
// words interspersed) into the sorted-unique table. kbits = significant
// code bits (valid codes < 2^kbits). Returns entries written.
// Generic MSD+LSD radix core over any code source. ForRange is a callable
// `for_range(a, b, f)` that invokes f(code u64) for every CANDIDATE code
// of items [a, b) IN ORDER (codes >= 2^kbits are dropped as sentinels);
// it must enumerate identically on repeated calls (the histogram and
// scatter passes both walk it).
template <class T, class ForRange>
int64_t radix_compact_core(ForRange&& for_range, int64_t n, int kbits,
                           uint64_t* out_code, int64_t* out_cnt) {
  if (n == 0) return 0;
  const int msd_shift = std::max(kbits - 8, 0);
  const int nt = num_threads(n, 1 << 20);
  std::vector<int64_t> range(nt + 1);
  for (int t = 0; t <= nt; t++) range[t] = n * t / nt;

  // Pass 1a: per-(thread, bucket) histogram. Sentinel words land in
  // bucket >= 256 (code >= 2^kbits) and are dropped.
  std::vector<std::array<int64_t, kMsdBuckets>> th_cnt(nt);
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; t++)
      ths.emplace_back([&, t] {
        auto& c = th_cnt[t];
        c.fill(0);
        for_range(range[t], range[t + 1], [&](uint64_t code) {
          const uint64_t b = code >> msd_shift;
          if (b < kMsdBuckets) c[b]++;
        });
      });
    for (auto& th : ths) th.join();
  }
  // Bucket layout: bucket-major, thread-minor (so each bucket is
  // contiguous and range-ordered across the whole input).
  std::vector<int64_t> bucket_off(kMsdBuckets + 1, 0);
  {
    int64_t acc = 0;
    for (int b = 0; b < kMsdBuckets; b++) {
      bucket_off[b] = acc;
      for (int t = 0; t < nt; t++) acc += th_cnt[t][b];
    }
    bucket_off[kMsdBuckets] = acc;
  }
  const int64_t valid = bucket_off[kMsdBuckets];
  if (valid == 0) return 0;
  HugeBuf<T> binned(valid);
  if (binned.data() == nullptr) return -1;  // allocation failure

  // Pass 1b: widen + scatter through write-combining lines.
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; t++)
      ths.emplace_back([&, t] {
        std::vector<int64_t> offs(kMsdBuckets);
        for (int b = 0; b < kMsdBuckets; b++) {
          int64_t o = bucket_off[b];
          for (int u = 0; u < t; u++) o += th_cnt[u][b];
          offs[b] = o;
        }
        auto wc = std::make_unique<WcBuf<T>>();
        wc->init(binned.data(), offs.data());
        for_range(range[t], range[t + 1], [&](uint64_t code) {
          const uint64_t b = code >> msd_shift;
          if (b < kMsdBuckets) wc->push(static_cast<int>(b), static_cast<T>(code));
        });
        wc->flush();
      });
    for (auto& th : ths) th.join();
  }

  // Pass 2: per-bucket LSD sort + RLE into the bucket's reserved output
  // slice (distinct <= elements, so output offset = input offset is safe).
  // Buckets are claimed dynamically to ride out skew.
  std::vector<int64_t> bucket_len(kMsdBuckets, 0);
  {
    std::atomic<int> next{0};
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; t++)
      ths.emplace_back([&] {
        // Scratch grows to the largest bucket THIS thread claims —
        // skewed data (repeat-rich genomes) can put ~all windows in one
        // bucket, and eagerly sizing every thread's scratch to that
        // maximum would transiently demand nt * n * sizeof(T).
        std::vector<T> scr;
        for (;;) {
          const int b = next.fetch_add(1);
          if (b >= kMsdBuckets) break;
          const int64_t off = bucket_off[b];
          const int64_t len = bucket_off[b + 1] - off;
          if (len == 0) continue;
          if (static_cast<int64_t>(scr.size()) < len) scr.resize(len);
          T* data = lsd_radix(binned.data() + off, scr.data(), len, msd_shift);
          bucket_len[b] = rle_run(data, len, out_code + off, out_cnt + off);
        }
      });
    for (auto& th : ths) th.join();
  }

  // Compact the per-bucket tables contiguously.
  int64_t w = 0;
  for (int b = 0; b < kMsdBuckets; b++) {
    const int64_t off = bucket_off[b];
    if (off != w && bucket_len[b]) {
      memmove(out_code + w, out_code + off, bucket_len[b] * sizeof(uint64_t));
      memmove(out_cnt + w, out_cnt + off, bucket_len[b] * sizeof(int64_t));
    }
    w += bucket_len[b];
  }
  return w;
}

// Word-array source: the no-device-sort D2H layout (split hi/lo words,
// all-ones sentinels interspersed).
template <int HW>
int64_t radix_compact(const void* hi, const uint32_t* lo, int64_t n,
                      int kbits, uint64_t* out_code, int64_t* out_cnt) {
  using T = typename std::conditional<HW == 0, uint32_t, uint64_t>::type;
  auto for_range = [hi, lo](int64_t a, int64_t b, auto&& f) {
    for (int64_t i = a; i < b; i++) f(code_hw<HW>(hi, lo, i));
  };
  return radix_compact_core<T>(for_range, n, kbits, out_code, out_cnt);
}

// Rolling 2k-bit window codes over a u8 base stream (0..3 valid; anything
// else, the 0xFF record separator included, breaks the window run): the
// code source of the host-only sparse counter.
struct RollingWindows {
  const uint8_t* s;
  int k;
  bool canonical;
  uint64_t mask;
  int rc_shift;

  RollingWindows(const uint8_t* stream, int kk, bool canon)
      : s(stream), k(kk), canonical(canon) {
    mask = (k >= 32) ? ~uint64_t(0) : ((uint64_t(1) << (2 * k)) - 1);
    rc_shift = 2 * (k - 1);
  }

  // Enumerate the valid windows STARTING in [a, b), calling f(code) in
  // order; reads bases [a, b + k - 1).
  template <class F>
  void for_range(int64_t a, int64_t b, F&& f) const {
    uint64_t fwd = 0, rc = 0;
    int run = 0;
    for (int64_t j = a; j < b + k - 1; j++) {
      const uint8_t base = s[j];
      if (base > 3) {
        run = 0;
        continue;
      }
      fwd = ((fwd << 2) | base) & mask;
      rc = (rc >> 2) | (uint64_t(3 - base) << rc_shift);
      run = run < k ? run + 1 : k;
      if (run >= k) {
        const int64_t start = j - k + 1;
        if (start >= a && start < b) f(canonical ? std::min(fwd, rc) : fwd);
      }
    }
  }
};

}  // namespace

extern "C" {

// Valid windows (k consecutive valid bases) in a u8 base stream: sizes
// the output of kp_count_sparse_host.
int64_t kp_count_windows_valid(const uint8_t* stream, int64_t n, int k) {
  const int64_t nw = n - k + 1;
  if (nw <= 0) return 0;
  const int nt = num_threads(nw, 1 << 20);
  std::vector<int64_t> counts(nt, 0);
  std::vector<std::thread> ths;
  for (int t = 0; t < nt; t++)
    ths.emplace_back([&, t] {
      int64_t a = nw * t / nt, b = nw * (t + 1) / nt, c = 0;
      int run = 0;
      for (int64_t j = a; j < b + k - 1; j++) {
        run = stream[j] > 3 ? 0 : (run < k ? run + 1 : k);
        if (run >= k && j - k + 1 >= a) c++;
      }
      counts[t] = c;
    });
  for (auto& th : ths) th.join();
  int64_t total = 0;
  for (int64_t c : counts) total += c;
  return total;
}

// Host-only sparse k-mer counter: u8 base stream (0..3; 0xFF separators)
// -> sorted-unique (code u64, count i64) table, the rolling encoder fused
// into the MSD+LSD radix core. The same index space and canonical form as
// the device encoders, so its tables equal the device route's. out arrays
// must hold kp_count_windows_valid(...) entries; returns entries written
// (-1 if scratch allocation failed).
int64_t kp_count_sparse_host(const uint8_t* stream, int64_t n, int k,
                             int canonical, uint64_t* out_code,
                             int64_t* out_cnt) {
  const int64_t nw = n - k + 1;
  if (nw <= 0 || k < 1 || k > 31) return 0;
  RollingWindows rw(stream, k, canonical != 0);
  auto for_range = [&rw](int64_t a, int64_t b, auto&& f) {
    rw.for_range(a, b, f);
  };
  if (2 * k <= 32)
    return radix_compact_core<uint32_t>(for_range, nw, 2 * k, out_code,
                                        out_cnt);
  return radix_compact_core<uint64_t>(for_range, nw, 2 * k, out_code,
                                      out_cnt);
}

// Valid (non-sentinel) words in an UNSORTED window-word stream: counts
// codes < 2^kbits. Sizes the output of kp_compact_unsorted.
int64_t kp_count_valid(const void* hi, int hi_width, const uint32_t* lo,
                       int64_t n, int kbits) {
  if (n == 0) return 0;
  const uint64_t lim = kbits >= 64 ? UINT64_MAX : (uint64_t(1) << kbits);
  const int nt = num_threads(n, 1 << 20);
  std::vector<int64_t> counts(nt, 0);
  std::vector<std::thread> ths;
  for (int t = 0; t < nt; t++)
    ths.emplace_back([&, t] {
      int64_t a = n * t / nt, b = n * (t + 1) / nt, c = 0;
      for (int64_t i = a; i < b; i++)
        c += (word_code(hi, hi_width, lo, i) < lim);
      counts[t] = c;
    });
  for (auto& th : ths) th.join();
  int64_t total = 0;
  for (int64_t c : counts) total += c;
  return total;
}

// Compact n UNSORTED window words (all-ones sentinel words interspersed
// where the device emitted invalid windows) into the sorted-unique
// (code u64, count i64) table via the MSD+LSD radix compactor above.
// kbits = significant code bits (2k for a k-mer table; valid codes are
// < 2^kbits). out arrays must hold kp_count_valid(...) entries. Returns
// entries written. This is the host half of the no-device-sort path: the
// device runs the encode kernel alone and ships the word stream as-is.
int64_t kp_compact_unsorted(const void* hi, int hi_width, const uint32_t* lo,
                            int64_t n, int kbits, uint64_t* out_code,
                            int64_t* out_cnt) {
  if (hi_width == 0) return radix_compact<0>(hi, lo, n, kbits, out_code, out_cnt);
  if (hi_width == 2) return radix_compact<2>(hi, lo, n, kbits, out_code, out_cnt);
  return radix_compact<4>(hi, lo, n, kbits, out_code, out_cnt);
}

// Merge m sorted (codes u64 ascending-unique, counts i64) tables into one,
// summing counts of equal codes. out arrays must hold sum(lens) entries.
// Multithreaded by code-range partition (pivots sampled from the inputs so
// skewed distributions still balance); each partition is an independent
// linear-time heap merge, then partitions are compacted contiguously.
// Returns the merged length.
int64_t kp_merge_tables(int64_t m, const uint64_t* const* codes,
                        const int64_t* const* cnts, const int64_t* lens,
                        uint64_t* out_code, int64_t* out_cnt) {
  int64_t total = 0;
  for (int64_t i = 0; i < m; i++) total += lens[i];
  if (total == 0) return 0;
  const int nt = num_threads(total, 1 << 20);

  // Sample pivots across all tables (tables are sorted, so striding each
  // one samples its distribution).
  std::vector<uint64_t> samples;
  samples.reserve(1024);
  for (int64_t i = 0; i < m; i++) {
    int64_t step = std::max<int64_t>(1, lens[i] / 64);
    for (int64_t j = 0; j < lens[i]; j += step) samples.push_back(codes[i][j]);
  }
  std::sort(samples.begin(), samples.end());
  std::vector<uint64_t> pivot(nt + 1);
  pivot[0] = 0;
  pivot[nt] = UINT64_MAX;
  for (int t = 1; t < nt; t++)
    pivot[t] = samples[samples.size() * t / nt];

  // Per (partition, table) input ranges; partition p takes codes in
  // [pivot[p], pivot[p+1]) — last partition inclusive of UINT64_MAX.
  std::vector<std::vector<int64_t>> lo_idx(nt + 1, std::vector<int64_t>(m));
  for (int64_t i = 0; i < m; i++) {
    lo_idx[0][i] = 0;
    lo_idx[nt][i] = lens[i];
    for (int t = 1; t < nt; t++)
      lo_idx[t][i] = std::lower_bound(codes[i], codes[i] + lens[i], pivot[t]) -
                     codes[i];
  }
  std::vector<int64_t> part_cap(nt + 1, 0);  // input sizes = output caps
  for (int t = 0; t < nt; t++) {
    int64_t c = 0;
    for (int64_t i = 0; i < m; i++) c += lo_idx[t + 1][i] - lo_idx[t][i];
    part_cap[t + 1] = part_cap[t] + c;
  }

  std::vector<int64_t> part_len(nt, 0);
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; t++)
      ths.emplace_back([&, t] {
        uint64_t* oc = out_code + part_cap[t];
        int64_t* on = out_cnt + part_cap[t];
        // Tables with a non-empty slice of this partition.
        std::vector<int64_t> act;
        for (int64_t i = 0; i < m; i++)
          if (lo_idx[t][i] < lo_idx[t + 1][i]) act.push_back(i);

        if (act.empty()) {
          part_len[t] = 0;
          return;
        }
        if (act.size() == 1) {
          // Inputs are sorted-unique already: straight copy.
          int64_t i = act[0], a = lo_idx[t][i], n = lo_idx[t + 1][i] - a;
          memcpy(oc, codes[i] + a, n * sizeof(uint64_t));
          memcpy(on, cnts[i] + a, n * sizeof(int64_t));
          part_len[t] = n;
          return;
        }
        if (act.size() == 2) {
          // The dominant shape (the MergeLadder merges pairs): a tight
          // two-pointer merge, ~10x the heap loop's throughput.
          int64_t i0 = act[0], i1 = act[1];
          const uint64_t* c0 = codes[i0];
          const uint64_t* c1 = codes[i1];
          const int64_t* n0 = cnts[i0];
          const int64_t* n1 = cnts[i1];
          int64_t a = lo_idx[t][i0], ae = lo_idx[t + 1][i0];
          int64_t b = lo_idx[t][i1], be = lo_idx[t + 1][i1];
          int64_t w = 0;
          while (a < ae && b < be) {
            const uint64_t ca = c0[a], cb = c1[b];
            if (__builtin_expect(ca == cb, 0)) {
              // Equal codes are rare (distinct tables; dups only across
              // batches) — keep the branch, it predicts well.
              oc[w] = ca;
              on[w++] = n0[a++] + n1[b++];
              continue;
            }
            // The < compare is a ~50/50 coin flip: branchless cmov
            // advance (same trick as the loser-tree replay).
            const bool t2 = ca < cb;
            oc[w] = t2 ? ca : cb;
            on[w++] = t2 ? n0[a] : n1[b];
            a += t2;
            b += !t2;
          }
          if (a < ae) {
            memcpy(oc + w, c0 + a, (ae - a) * sizeof(uint64_t));
            memcpy(on + w, n0 + a, (ae - a) * sizeof(int64_t));
            w += ae - a;
          }
          if (b < be) {
            memcpy(oc + w, c1 + b, (be - b) * sizeof(uint64_t));
            memcpy(on + w, n1 + b, (be - b) * sizeof(int64_t));
            w += be - b;
          }
          part_len[t] = w;
          return;
        }

        // General shape: binary heap of table heads.
        struct Head {
          uint64_t code;
          int64_t tab;
        };
        std::vector<int64_t> pos(m), stop(m);
        std::vector<Head> heap;
        heap.reserve(act.size());
        for (int64_t i : act) {
          pos[i] = lo_idx[t][i];
          stop[i] = lo_idx[t + 1][i];
          heap.push_back({codes[i][pos[i]], i});
        }
        auto cmp = [](const Head& a, const Head& b) { return a.code > b.code; };
        std::make_heap(heap.begin(), heap.end(), cmp);
        int64_t w = -1;
        while (!heap.empty()) {
          std::pop_heap(heap.begin(), heap.end(), cmp);
          Head h = heap.back();
          heap.pop_back();
          if (w >= 0 && oc[w] == h.code) {
            on[w] += cnts[h.tab][pos[h.tab]];
          } else {
            w++;
            oc[w] = h.code;
            on[w] = cnts[h.tab][pos[h.tab]];
          }
          if (++pos[h.tab] < stop[h.tab]) {
            heap.push_back({codes[h.tab][pos[h.tab]], h.tab});
            std::push_heap(heap.begin(), heap.end(), cmp);
          }
        }
        part_len[t] = w + 1;
      });
    for (auto& th : ths) th.join();
  }

  // Compact partitions to be contiguous (they were written at conservative
  // input-size offsets; merged lengths can only be smaller).
  int64_t w = part_len.empty() ? 0 : part_len[0];
  for (int t = 1; t < nt; t++) {
    if (part_cap[t] != w) {
      memmove(out_code + w, out_code + part_cap[t],
              part_len[t] * sizeof(uint64_t));
      memmove(out_cnt + w, out_cnt + part_cap[t],
              part_len[t] * sizeof(int64_t));
    }
    w += part_len[t];
  }
  return w;
}

// Sorted-unique (code, count) tables of many records in one call: the
// sparse distance path's per-sequence tables. Record i is the n[i] bases
// at stream + start[i]. Threads claim records; a record's valid windows
// (RollingWindows: the same codes and canonical form as
// kp_count_sparse_host) are sorted and run-length counted into its slice
// of out_code/out_cnt, which starts at slot[i] and holds n[i] - k + 1
// entries; out_len[i] is its number of distinct codes. One call in place of
// one kp_count_sparse_host a record, whose fixed cost (threads, scratch)
// dwarfs a read of a few kbase. Returns 0, or -1 for a k outside 1..31.
int64_t kp_count_tables(const uint8_t* stream, const int64_t* start,
                        const int64_t* n, const int64_t* slot, int64_t S, int k,
                        int canonical, uint64_t* out_code, int64_t* out_cnt,
                        int64_t* out_len) {
  if (k < 1 || k > 31) return -1;
  int64_t total = 0;
  for (int64_t i = 0; i < S; i++) total += std::max<int64_t>(n[i] - k + 1, 0);
  const int nt = num_threads(total, 1 << 16);
  std::atomic<int64_t> next{0};
  std::vector<std::thread> ths;
  for (int t = 0; t < nt; t++)
    ths.emplace_back([&] {
      std::vector<uint64_t> codes;
      for (;;) {
        const int64_t i = next.fetch_add(1);
        if (i >= S) break;
        const int64_t nw = n[i] - k + 1;
        out_len[i] = 0;
        if (nw <= 0) continue;
        codes.clear();
        RollingWindows rw(stream + start[i], k, canonical != 0);
        rw.for_range(0, nw, [&](uint64_t c) { codes.push_back(c); });
        std::sort(codes.begin(), codes.end());
        uint64_t* oc = out_code + slot[i];
        int64_t* on = out_cnt + slot[i];
        int64_t m = 0;
        for (size_t a = 0; a < codes.size();) {
          size_t b = a + 1;
          while (b < codes.size() && codes[b] == codes[a]) b++;
          oc[m] = codes[a];
          on[m] = static_cast<int64_t>(b - a);
          m++;
          a = b;
        }
        out_len[i] = m;
      }
    });
  for (auto& th : ths) th.join();
  return 0;
}

// Pairwise (min,+) over per-sequence sparse k-mer tables: the distance
// core wherever the dense [S, 4^k] counts matrix cannot exist. Tables are
// sorted-unique (code, count) runs concatenated in codes/counts, with
// fences offs[S+1] (sequence i's table is offs[i]..offs[i+1]). For every
// pair i < j with r0 <= i < r1, the min-sum sum_p min(cnt_i[p], cnt_j[p])
// is a two-pointer sorted intersection, written in the packed strict
// upper triangle of rows r0..r1-1, row-major (row r0's partners first).
// Threads claim rows dynamically (early rows have more partners).
// Returns the number of pairs written.
static int64_t min_sum_rows(const uint64_t* codes, const int64_t* counts,
                            const int64_t* offs, int64_t S, int64_t r0,
                            int64_t r1, int64_t* out_sums) {
  // packed start of row i, counted from row r0
  auto row_start = [S, r0](int64_t i) {
    return (i - r0) * (S - 1) - (i * (i - 1) - r0 * (r0 - 1)) / 2;
  };
  const int64_t n_pairs = row_start(r1);
  const int nt = num_threads(n_pairs, 1 << 12);
  std::atomic<int64_t> next{r0};
  std::vector<std::thread> ths;
  for (int t = 0; t < nt; t++)
    ths.emplace_back([&] {
      for (;;) {
        const int64_t i = next.fetch_add(1);
        if (i >= r1) break;
        int64_t w = row_start(i);
        const int64_t ia = offs[i], ib = offs[i + 1];
        for (int64_t j = i + 1; j < S; j++, w++) {
          int64_t a = ia, b = offs[j];
          const int64_t bb = offs[j + 1];
          int64_t sum = 0;
          while (a < ib && b < bb) {
            const uint64_t ca = codes[a], cb = codes[b];
            if (ca == cb) {
              sum += std::min(counts[a], counts[b]);
              a++;
              b++;
            } else if (ca < cb) {
              a++;
            } else {
              b++;
            }
          }
          out_sums[w] = sum;
        }
      }
    });
  for (auto& th : ths) th.join();
  return n_pairs;
}

// Every pair: out_sums holds S*(S-1)/2 min-sums, the packed strict upper
// triangle. Returns the number of pairs written.
int64_t kp_min_sum_pairs(const uint64_t* codes, const int64_t* counts,
                         const int64_t* offs, int64_t S, int64_t* out_sums) {
  if (S < 2) return 0;
  return min_sum_rows(codes, counts, offs, S, 0, S - 1, out_sums);
}

// The pairs of rows [r0, r1) only (clamped to [0, S - 1)), packed from
// row r0 on: the streamed distance path's unit of work. Returns the
// number of pairs written.
int64_t kp_min_sum_panel(const uint64_t* codes, const int64_t* counts,
                         const int64_t* offs, int64_t S, int64_t r0,
                         int64_t r1, int64_t* out_sums) {
  if (S < 2) return 0;
  if (r0 < 0) r0 = 0;
  if (r1 > S - 1) r1 = S - 1;
  if (r0 >= r1) return 0;
  return min_sum_rows(codes, counts, offs, S, r0, r1, out_sums);
}

// Format n float32 values as the reference's one-float-per-line CSV body
// ("%f\n" per value, the reference's main.cu:199-202 and 355-358) into
// out. snprintf does the digits, so the bytes match the C library's %f
// exactly (byte-parity with the oracle CSVs is a framework invariant);
// threads format disjoint ranges into their own slab of out (16 bytes per
// value is enough for any distance value, which lives in [0, 1]) and the
// slabs are compacted in parallel afterwards. Returns bytes written, or
// -1 if out_cap < 16 * n. The Python "%f\n" loop this replaces measured
// ~500 ns/value — the 54K-sequence design-scale run (1.46G pairs,
// main.cu:29) would spend 12 minutes formatting.
int64_t kp_format_f6(const float* v, int64_t n, char* out, int64_t out_cap) {
  if (n <= 0) return 0;
  if (out_cap < 16 * n) return -1;
  const int nt = num_threads(n, 1 << 18);
  std::vector<int64_t> begin(nt + 1), len(nt, 0);
  for (int t = 0; t <= nt; t++) begin[t] = n * t / nt;
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; t++)
      ths.emplace_back([&, t] {
        char* p = out + 16 * begin[t];
        char* q = p;
        for (int64_t i = begin[t]; i < begin[t + 1]; i++) {
          int m = snprintf(q, 16, "%f\n", static_cast<double>(v[i]));
          // %f of a finite float is at most 15 chars here (distances are
          // in [0, 1]; even garbage inputs clamp at the buffer).
          q += (m > 0 && m < 16) ? m : 0;
        }
        len[t] = q - p;
      });
    for (auto& th : ths) th.join();
  }
  // Compact slabs left-to-right, serially: slab t's target end
  // (off[t] + len[t] <= 15 * begin[t+1]) always precedes slab t+1's
  // source start (16 * begin[t+1]), so each move only touches bytes the
  // later moves no longer need. (A parallel compaction would race: slab
  // t's target can overlap slab t-1's source tail.)
  int64_t w = len.empty() ? 0 : len[0];
  for (int t = 1; t < nt; t++) {
    memmove(out + w, out + 16 * begin[t], len[t]);
    w += len[t];
  }
  return w;
}

// Count-table CSV lines: "kmer,count\n" for each (code, count) of a
// table, the k-mer spelled from its big-endian 2-bit code (A, C, G, T),
// the count in decimal as printf's %lld writes it. Each line is at most
// 31 + 1 + 20 + 1 < 64 bytes: threads format slabs at a 64-byte stride,
// compacted as kp_format_f6's. Returns bytes written, or -1 if out_cap <
// 64 * n or k is outside 1..31.
int64_t kp_format_count_lines(const uint64_t* codes, const int64_t* counts,
                              int64_t n, int k, char* out, int64_t out_cap) {
  if (n <= 0) return 0;
  if (out_cap < 64 * n || k < 1 || k > 31) return -1;
  const int nt = num_threads(n, 1 << 18);
  std::vector<int64_t> begin(nt + 1), len(nt, 0);
  for (int t = 0; t <= nt; t++) begin[t] = n * t / nt;
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; t++)
      ths.emplace_back([&, t] {
        static const char kBases[4] = {'A', 'C', 'G', 'T'};
        char* p = out + 64 * begin[t];
        char* q = p;
        for (int64_t i = begin[t]; i < begin[t + 1]; i++) {
          const uint64_t c = codes[i];
          for (int j = 0; j < k; j++) q[j] = kBases[(c >> (2 * (k - 1 - j))) & 3];
          q[k] = ',';
          q += k + 1;
          const int64_t v = counts[i];
          uint64_t u = v < 0 ? 0 - static_cast<uint64_t>(v) : static_cast<uint64_t>(v);
          char digits[20];
          int m = 0;
          do {
            digits[m++] = static_cast<char>('0' + u % 10);
            u /= 10;
          } while (u);
          if (v < 0) *q++ = '-';
          while (m) *q++ = digits[--m];
          *q++ = '\n';
        }
        len[t] = q - p;
      });
    for (auto& th : ths) th.join();
  }
  int64_t w = len.empty() ? 0 : len[0];
  for (int t = 1; t < nt; t++) {
    memmove(out + w, out + 64 * begin[t], len[t]);
    w += len[t];
  }
  return w;
}

// Compact masked RLE output (device sparse tables) into dense arrays.
// starts: bool mask [n]; returns number of set entries written to
// out_hi/out_lo/out_cnt (caller allocates capacity >= popcount(starts);
// call kp_count_starts first to size them).
int64_t kp_count_starts(const uint8_t* starts, int64_t n) {
  int64_t c = 0;
  for (int64_t i = 0; i < n; i++) c += (starts[i] != 0);
  return c;
}

int64_t kp_compact_rle(const uint32_t* hi, const uint32_t* lo,
                       const int32_t* cnt, const uint8_t* starts, int64_t n,
                       uint64_t* out_code, int64_t* out_cnt) {
  int64_t w = 0;
  for (int64_t i = 0; i < n; i++) {
    if (starts[i]) {
      out_code[w] = (static_cast<uint64_t>(hi[i]) << 32) | lo[i];
      out_cnt[w] = cnt[i];
      w++;
    }
  }
  return w;
}

// Compact sorted window codes + run-start flags into a (code, count) table.
// Run lengths are implied by consecutive start indices (the device never
// computes them): count(j) = idx(j+1) - idx(j), last run closed by the
// sentinel tail. hi may be NULL (hi_width 0: code = lo; k <= 15), uint16
// (hi_width 2) or uint32 (hi_width 4). Multithreaded two-pass
// (count-prefix-fill). Returns entries written.
int64_t kp_compact_starts(const void* hi, int hi_width, const uint32_t* lo,
                          const uint8_t* starts, int64_t n,
                          uint64_t* out_code, int64_t* out_cnt) {
  const int64_t end = sentinel_begin(hi, hi_width, lo, n);
  if (end == 0) return 0;
  const int nt = num_threads(end, 1 << 20);
  std::vector<int64_t> range_begin(nt + 1);
  for (int t = 0; t <= nt; t++) range_begin[t] = end * t / nt;
  std::vector<int64_t> nstarts(nt, 0);

  {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; t++)
      ths.emplace_back([&, t] {
        int64_t c = 0;
        for (int64_t i = range_begin[t]; i < range_begin[t + 1]; i++)
          c += (starts[i] != 0);
        nstarts[t] = c;
      });
    for (auto& th : ths) th.join();
  }
  std::vector<int64_t> out_off(nt + 1, 0);
  for (int t = 0; t < nt; t++) out_off[t + 1] = out_off[t] + nstarts[t];

  {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; t++)
      ths.emplace_back([&, t] {
        int64_t w = out_off[t];
        int64_t prev = -1;  // index of the last start seen in this range
        for (int64_t i = range_begin[t]; i < range_begin[t + 1]; i++) {
          if (!starts[i]) continue;
          if (prev >= 0) out_cnt[w - 1] = i - prev;
          out_code[w] = word_code(hi, hi_width, lo, i);
          prev = i;
          w++;
        }
        if (prev >= 0) {
          // Close the range's last run: next start at/after the range end
          // (runs can span range boundaries), else the sentinel tail.
          int64_t nxt = range_begin[t + 1];
          while (nxt < end && !starts[nxt]) nxt++;
          out_cnt[w - 1] = nxt - prev;
        }
      });
    for (auto& th : ths) th.join();
  }
  return out_off[nt];
}

// Number of distinct codes before the sentinel tail (sizes the output of
// kp_compact_sorted).
int64_t kp_count_distinct(const void* hi, int hi_width, const uint32_t* lo,
                          int64_t n) {
  const int64_t end = sentinel_begin(hi, hi_width, lo, n);
  if (end == 0) return 0;
  const int nt = num_threads(end, 1 << 20);
  std::vector<int64_t> counts(nt, 0);
  std::vector<std::thread> ths;
  for (int t = 0; t < nt; t++)
    ths.emplace_back([&, t] {
      int64_t a = end * t / nt, b = end * (t + 1) / nt;
      int64_t c = 0;
      for (int64_t i = a; i < b; i++)
        c += (i == 0 || word_code(hi, hi_width, lo, i) !=
                            word_code(hi, hi_width, lo, i - 1));
      counts[t] = c;
    });
  for (auto& th : ths) th.join();
  int64_t total = 0;
  for (int64_t c : counts) total += c;
  return total;
}

// Compact sorted window codes into a (code, count) table with NO
// device-side run-start flags: run boundaries are neighbor compares of the
// codes this pass walks anyway (saves a device pass and 1 B/window of
// D2H). Same word layout as kp_compact_starts. Multithreaded two-pass.
int64_t kp_compact_sorted(const void* hi, int hi_width, const uint32_t* lo,
                          int64_t n, uint64_t* out_code, int64_t* out_cnt) {
  const int64_t end = sentinel_begin(hi, hi_width, lo, n);
  if (end == 0) return 0;
  const int nt = num_threads(end, 1 << 20);
  std::vector<int64_t> range_begin(nt + 1);
  for (int t = 0; t <= nt; t++) range_begin[t] = end * t / nt;
  std::vector<int64_t> nstarts(nt, 0);

  auto is_start = [&](int64_t i) {
    return i == 0 || word_code(hi, hi_width, lo, i) !=
                         word_code(hi, hi_width, lo, i - 1);
  };

  {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; t++)
      ths.emplace_back([&, t] {
        int64_t c = 0;
        for (int64_t i = range_begin[t]; i < range_begin[t + 1]; i++)
          c += is_start(i);
        nstarts[t] = c;
      });
    for (auto& th : ths) th.join();
  }
  std::vector<int64_t> out_off(nt + 1, 0);
  for (int t = 0; t < nt; t++) out_off[t + 1] = out_off[t] + nstarts[t];

  {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; t++)
      ths.emplace_back([&, t] {
        int64_t w = out_off[t];
        int64_t prev = -1;
        for (int64_t i = range_begin[t]; i < range_begin[t + 1]; i++) {
          if (!is_start(i)) continue;
          if (prev >= 0) out_cnt[w - 1] = i - prev;
          out_code[w] = word_code(hi, hi_width, lo, i);
          prev = i;
          w++;
        }
        if (prev >= 0) {
          int64_t nxt = range_begin[t + 1];
          while (nxt < end && !is_start(nxt)) nxt++;
          out_cnt[w - 1] = nxt - prev;
        }
      });
    for (auto& th : ths) th.join();
  }
  return out_off[nt];
}

// Sum of per-row valid prefixes for the [rows, m] row-sorted word layout
// (each row ascending with an all-ones-sentinel tail). Sizes the output of
// kp_compact_rows: distinct codes <= valid windows.
int64_t kp_rows_valid(const void* hi, int hi_width, const uint32_t* lo,
                      int64_t rows, int64_t m) {
  int64_t total = 0;
  for (int64_t r = 0; r < rows; r++) {
    const void* h =
        hi == nullptr
            ? nullptr
            : static_cast<const void*>(static_cast<const uint8_t*>(hi) +
                                       r * m * hi_width);
    total += sentinel_begin(h, hi_width, lo + r * m, m);
  }
  return total;
}

// Merge-compact R independently sorted rows of window codes into ONE
// sorted-unique (code, count) table in a single pass.
//
// This is the host half of the row-sorted sparse path: the device sorts
// [R, m] rows independently and this function does the R-way merge the
// device skipped. Multithreaded by sampled code-range partition; each
// partition runs a multiway merge (merge_streams) over its row slices,
// accumulating duplicate codes at the output cursor (rows carry raw
// windows, so each element contributes count 1).
//
// Layout matches the device output: row r = lo[r*m .. r*m+m), optional hi
// words parallel (hi_width 0 / 2 / 4), each row ascending with the
// all-ones sentinel marking its invalid tail. out arrays must hold
// kp_rows_valid(...) entries. Returns entries written.
int64_t kp_compact_rows(const void* hi, int hi_width, const uint32_t* lo,
                        int64_t rows, int64_t m, uint64_t* out_code,
                        int64_t* out_cnt) {
  // Per-row valid ends (absolute indices into the flat arrays).
  std::vector<int64_t> row_beg(rows), row_end(rows);
  int64_t total = 0;
  for (int64_t r = 0; r < rows; r++) {
    const void* h =
        hi == nullptr
            ? nullptr
            : static_cast<const void*>(static_cast<const uint8_t*>(hi) +
                                       r * m * hi_width);
    row_beg[r] = r * m;
    row_end[r] = r * m + sentinel_begin(h, hi_width, lo + r * m, m);
    total += row_end[r] - row_beg[r];
  }
  if (total == 0) return 0;
  const int nt = num_threads(total, 1 << 20);

  auto code_at = [&](int64_t i) { return word_code(hi, hi_width, lo, i); };

  // Sampled pivots across rows (rows are sorted, striding samples the
  // distribution; robust to skew).
  std::vector<uint64_t> samples;
  samples.reserve(static_cast<size_t>(rows) * 8 + 8);
  for (int64_t r = 0; r < rows; r++) {
    int64_t n = row_end[r] - row_beg[r];
    int64_t step = std::max<int64_t>(1, n / 8);
    for (int64_t j = 0; j < n; j += step) samples.push_back(code_at(row_beg[r] + j));
  }
  std::sort(samples.begin(), samples.end());
  std::vector<uint64_t> pivot(nt + 1);
  pivot[0] = 0;
  pivot[nt] = UINT64_MAX;
  for (int t = 1; t < nt; t++) pivot[t] = samples[samples.size() * t / nt];

  // Per (partition, row) slice starts via binary search on the code.
  std::vector<std::vector<int64_t>> cut(nt + 1, std::vector<int64_t>(rows));
  for (int64_t r = 0; r < rows; r++) {
    cut[0][r] = row_beg[r];
    cut[nt][r] = row_end[r];
    for (int t = 1; t < nt; t++) {
      int64_t a = row_beg[r], b = row_end[r];
      while (a < b) {
        int64_t mid = a + (b - a) / 2;
        if (code_at(mid) < pivot[t])
          a = mid + 1;
        else
          b = mid;
      }
      cut[t][r] = a;
    }
  }
  std::vector<int64_t> part_cap(nt + 1, 0);
  for (int t = 0; t < nt; t++) {
    int64_t c = 0;
    for (int64_t r = 0; r < rows; r++) c += cut[t + 1][r] - cut[t][r];
    part_cap[t + 1] = part_cap[t] + c;
  }

  std::vector<int64_t> part_len(nt, 0);
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; t++)
      ths.emplace_back([&, t] {
        uint64_t* oc = out_code + part_cap[t];
        int64_t* on = out_cnt + part_cap[t];
        std::vector<MergeStream> ss;
        ss.reserve(rows);
        for (int64_t r = 0; r < rows; r++)
          if (cut[t][r] < cut[t + 1][r])
            ss.push_back({cut[t][r], cut[t + 1][r]});
        if (hi_width == 0)
          part_len[t] = merge_streams<0>(ss, hi, lo, oc, on);
        else if (hi_width == 2)
          part_len[t] = merge_streams<2>(ss, hi, lo, oc, on);
        else
          part_len[t] = merge_streams<4>(ss, hi, lo, oc, on);
      });
    for (auto& th : ths) th.join();
  }

  int64_t w = part_len.empty() ? 0 : part_len[0];
  for (int t = 1; t < nt; t++) {
    if (part_cap[t] != w) {
      memmove(out_code + w, out_code + part_cap[t],
              part_len[t] * sizeof(uint64_t));
      memmove(out_cnt + w, out_cnt + part_cap[t],
              part_len[t] * sizeof(int64_t));
    }
    w += part_len[t];
  }
  return w;
}
}  // extern "C"
