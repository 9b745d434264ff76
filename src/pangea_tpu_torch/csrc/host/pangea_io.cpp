// Native FASTA/FASTQ ingest into padded codes or packed wire rows, and the
// bulk assignment-TSV writer, of the CLI's two read paths.
//
// The port's own copy of the reference's native/pangea_io.cpp (the port
// loads no library of the JAX package): the same record scanner over zlib
// (transparent gzip), pangea_fastx_next_batch (padded int8 codes, for the
// general path's native reader), pangea_fastx_next_batch_packed and
// pangea_write_assignments, byte for byte. Exposed as a plain C ABI for
// ctypes; pangea_tpu_torch/io/native.py builds it with g++ at first use.
//
// Semantics contracts: the codes, wire rows, lengths and qualities equal
// the reference reader's, and the assignment lines equal
// pangea_tpu_torch.report.writers.format_assignment (tested in
// tests/test_torch_packed.py and tests/test_torch_cohort.py).

#include <unistd.h>
#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr size_t kChunk = 1 << 20;  // 1 MiB read chunks
constexpr int8_t kPad = 4;

struct Lut {
  unsigned char enc[256];
  Lut() {
    std::memset(enc, 4, sizeof(enc));
    const char* bases = "ACGTU";
    const unsigned char codes[] = {0, 1, 2, 3, 3};
    for (int i = 0; i < 5; ++i) {
      enc[(unsigned char)bases[i]] = codes[i];
      enc[(unsigned char)(bases[i] + 32)] = codes[i];  // lowercase
    }
  }
};
const Lut kLut;

struct Reader {
  gzFile f = nullptr;
  std::string buf;      // unconsumed bytes
  size_t pos = 0;       // parse cursor into buf
  bool stream_eof = false;
  int format = 0;       // 1 = fasta, 2 = fastq
  std::string err;
  std::string seq_scratch;

  bool fill() {
    // Append up to kChunk more bytes; false at stream EOF.
    if (stream_eof) return false;
    size_t old = buf.size();
    buf.resize(old + kChunk);
    int n = gzread(f, &buf[old], kChunk);
    if (n < 0) {
      int zerr = 0;
      err = std::string("gzread: ") + gzerror(f, &zerr);
      buf.resize(old);
      stream_eof = true;
      return false;
    }
    buf.resize(old + (size_t)n);
    if ((size_t)n < kChunk) stream_eof = true;
    return n > 0;
  }

  // Next line [start, end) excluding newline; false at EOF with no bytes.
  bool getline(size_t* start, size_t* end) {
    for (;;) {
      size_t nl = buf.find('\n', pos);
      if (nl != std::string::npos) {
        *start = pos;
        *end = (nl > pos && buf[nl - 1] == '\r') ? nl - 1 : nl;
        pos = nl + 1;
        return true;
      }
      if (!stream_eof) {
        // Compact consumed prefix, then read more.
        if (pos > 0) {
          buf.erase(0, pos);
          pos = 0;
        }
        fill();
        continue;
      }
      if (pos < buf.size()) {  // final line without newline
        *start = pos;
        *end = buf.size();
        pos = buf.size();
        return true;
      }
      return false;
    }
  }

  bool peek_format() {
    if (format) return true;
    while (buf.size() <= pos && !stream_eof) fill();
    if (buf.size() <= pos) {
      err = "empty input";
      return false;
    }
    char c = buf[pos];
    if (c == '>') format = 1;
    else if (c == '@') format = 2;
    else {
      err = "not FASTA/FASTQ";
      return false;
    }
    return true;
  }
};

inline void copy_id(const char* s, size_t n, char* dst, long stride) {
  // First whitespace-delimited token, truncated to stride-1.
  size_t m = 0;
  while (m < n && s[m] != ' ' && s[m] != '\t') ++m;
  if (m > (size_t)(stride - 1)) m = (size_t)(stride - 1);
  std::memcpy(dst, s, m);
  dst[m] = '\0';
}

inline void encode_row(const char* seq, size_t n, size_t max_len,
                       int8_t* row, int32_t* len_out) {
  size_t m = n < max_len ? n : max_len;
  for (size_t i = 0; i < m; ++i)
    row[i] = (int8_t)kLut.enc[(unsigned char)seq[i]];
  if (m < max_len) std::memset(row + m, kPad, max_len - m);
  // Report the TRUE (pre-truncation) length so callers can detect and
  // warn about overlong reads; the row itself holds min(n, max_len) bases.
  *len_out = (int32_t)n;
}

}  // namespace

extern "C" {

void* pangea_fastx_open(const char* path) {
  gzFile f = gzopen(path, "rb");
  if (!f) return nullptr;
  gzbuffer(f, 1 << 20);
  Reader* r = new Reader();
  r->f = f;
  return r;
}

void pangea_fastx_close(void* h) {
  Reader* r = (Reader*)h;
  if (!r) return;
  if (r->f) gzclose(r->f);
  delete r;
}

const char* pangea_fastx_error(void* h) {
  Reader* r = (Reader*)h;
  return r ? r->err.c_str() : "null handle";
}

// Parse up to max_reads records into a padded batch.
//   codes: int8 [max_reads, max_len]  (row-padded with 4)
//   lens:  int32 [max_reads]          (TRUE pre-truncation lengths)
//   quals: uint8 [max_reads, max_len] or NULL (phred+33 decoded, 0-padded)
//   ids:   char  [max_reads, id_stride] NUL-terminated first tokens
// Returns records parsed (0 = EOF), or -1 on malformed input / IO error.
long pangea_fastx_next_batch(void* h, long max_reads, long max_len,
                             int8_t* codes, int32_t* lens, uint8_t* quals,
                             char* ids, long id_stride) {
  Reader* r = (Reader*)h;
  if (!r || !r->peek_format()) return -1;
  long n = 0;
  size_t s, e;
  if (r->format == 2) {  // FASTQ
    while (n < max_reads) {
      if (!r->getline(&s, &e)) break;  // EOF
      if (e == s) continue;            // blank line tolerance
      if (r->buf[s] != '@') {
        r->err = "malformed FASTQ header";
        return -1;
      }
      copy_id(&r->buf[s + 1], e - s - 1, ids + n * id_stride, id_stride);
      size_t hs = s;
      if (!r->getline(&s, &e)) {
        r->err = "truncated FASTQ record";
        return -1;
      }
      (void)hs;
      // NOTE: getline may compact the buffer, so sequence bytes must be
      // consumed before the next getline call.
      encode_row(&r->buf[s], e - s, (size_t)max_len,
                 codes + n * max_len, lens + n);
      size_t seq_len = e - s;
      if (!r->getline(&s, &e) || r->buf[s] != '+') {
        r->err = "malformed FASTQ separator";
        return -1;
      }
      if (!r->getline(&s, &e)) {
        r->err = "truncated FASTQ quality";
        return -1;
      }
      if (e - s != seq_len) {
        r->err = "FASTQ qual/seq length mismatch";
        return -1;
      }
      if (quals) {
        uint8_t* q = quals + n * max_len;
        size_t m = seq_len < (size_t)max_len ? seq_len : (size_t)max_len;
        for (size_t i = 0; i < m; ++i)
          q[i] = (uint8_t)(r->buf[s + i] - 33);
        if (m < (size_t)max_len) std::memset(q + m, 0, max_len - m);
      }
      ++n;
    }
    return n;
  }
  // FASTA: sequences may span lines; accumulate until next '>' or EOF.
  std::string& seq = r->seq_scratch;
  while (n < max_reads) {
    if (!r->getline(&s, &e)) break;  // EOF
    if (e == s) continue;
    if (r->buf[s] != '>') {
      r->err = "malformed FASTA header";
      return -1;
    }
    // Copy header id now (buffer may compact during sequence reads).
    copy_id(&r->buf[s + 1], e - s - 1, ids + n * id_stride, id_stride);
    seq.clear();
    bool eof = false;
    for (;;) {
      if (!r->getline(&s, &e)) {
        eof = true;
        break;
      }
      if (e > s && r->buf[s] == '>') break;  // next record header
      seq.append(&r->buf[s], e - s);
    }
    encode_row(seq.data(), seq.size(), (size_t)max_len,
               codes + n * max_len, lens + n);
    if (quals)
      std::memset(quals + n * max_len, 0, max_len);
    ++n;
    if (eof) break;
    // The '>' line for the NEXT record is already consumed: rewind pos so
    // the next loop iteration re-reads it. Safe because getline never
    // compacts past a line it just returned.
    r->pos = s;
  }
  return n;
}

// ---------------------------------------------------------------------------
// Packed-batch parser: like pangea_fastx_next_batch but emits the 2-bit
// device wire format (SEMANTICS.md §1/§2) — ONE uint32 row per read:
//   words[0 .. W16)  : base j in bits [2*(j%16), +2) of word j/16 (code&3)
//   words[W16 .. W16+W32): "bad" bitmask — bit (j%32) of word j/32 set when
//                      base j is AMBIG (or beyond the read's length — pad)
// with W16 = ceil(max_len/16), W32 = ceil(max_len/32). 60 B per 150 bp read
// instead of 150 B, and a whole batch ships to the device as ONE array (the
// host↔device link charges a large fixed cost per transfer).
// quals (optional, may be NULL): uint8 [max_reads, max_len], phred+33
// decoded, 0-padded — host-side only (quality trim); never shipped to the
// device. FASTA rows get all-zero quals.
long pangea_fastx_next_batch_packed(void* h, long max_reads, long max_len,
                                    uint32_t* rows, int32_t* lens,
                                    char* ids, long id_stride,
                                    uint8_t* quals) {
  Reader* r = (Reader*)h;
  if (!r || !r->peek_format()) return -1;
  const long w16 = (max_len + 15) / 16, w32 = (max_len + 31) / 32;
  const long stride = w16 + w32;
  long n = 0;
  size_t s, e;

  auto pack_row = [&](const char* seq, size_t len, long i) {
    uint32_t* wp = rows + i * stride;
    uint32_t* bp = wp + w16;
    std::memset(wp, 0, (size_t)w16 * 4);
    std::memset(bp, 0xFF, (size_t)w32 * 4);  // default: bad (pad)
    size_t m = len < (size_t)max_len ? len : (size_t)max_len;
    for (size_t j = 0; j < m; ++j) {
      unsigned char c = kLut.enc[(unsigned char)seq[j]];
      wp[j >> 4] |= (uint32_t)(c & 3) << (2 * (j & 15));
      if (c <= 3) bp[j >> 5] &= ~(1u << (j & 31));
    }
    lens[i] = (int32_t)len;  // TRUE length (overlong detection upstream)
  };

  if (r->format == 2) {  // FASTQ
    while (n < max_reads) {
      if (!r->getline(&s, &e)) break;
      if (e == s) continue;
      if (r->buf[s] != '@') {
        r->err = "malformed FASTQ header";
        return -1;
      }
      copy_id(&r->buf[s + 1], e - s - 1, ids + n * id_stride, id_stride);
      if (!r->getline(&s, &e)) {
        r->err = "truncated FASTQ record";
        return -1;
      }
      pack_row(&r->buf[s], e - s, n);
      size_t seq_len = e - s;
      if (!r->getline(&s, &e) || r->buf[s] != '+') {
        r->err = "malformed FASTQ separator";
        return -1;
      }
      if (!r->getline(&s, &e)) {
        r->err = "truncated FASTQ quality";
        return -1;
      }
      if (e - s != seq_len) {
        r->err = "FASTQ qual/seq length mismatch";
        return -1;
      }
      if (quals) {
        uint8_t* q = quals + n * max_len;
        size_t m = seq_len < (size_t)max_len ? seq_len : (size_t)max_len;
        for (size_t i = 0; i < m; ++i)
          q[i] = (uint8_t)(r->buf[s + i] - 33);
        if (m < (size_t)max_len) std::memset(q + m, 0, max_len - m);
      }
      ++n;
    }
    return n;
  }
  std::string& seq = r->seq_scratch;  // FASTA
  while (n < max_reads) {
    if (!r->getline(&s, &e)) break;
    if (e == s) continue;
    if (r->buf[s] != '>') {
      r->err = "malformed FASTA header";
      return -1;
    }
    copy_id(&r->buf[s + 1], e - s - 1, ids + n * id_stride, id_stride);
    seq.clear();
    bool eof = false;
    for (;;) {
      if (!r->getline(&s, &e)) {
        eof = true;
        break;
      }
      if (e > s && r->buf[s] == '>') break;
      seq.append(&r->buf[s], e - s);
    }
    pack_row(seq.data(), seq.size(), n);
    if (quals)
      std::memset(quals + n * max_len, 0, max_len);
    ++n;
    if (eof) break;
    r->pos = s;
  }
  return n;
}

// ---------------------------------------------------------------------------
// Bulk per-read assignment writer (SEMANTICS.md §10.1, SURVEY.md C18).
//
// Formats one batch of assignment lines
//   <C|U>\t<read_id>\t<taxon>\t<rank>\t<name>\t<best>/<nvalid>\t<conf %.6f>\n
// and appends them to `path`. conf = (float)best / (float)nvalid computed in
// float32 then printed with C printf %.6f — byte-identical to the Python
// writer (format_assignment), which formats the same float32 value.
//
//   ids:        char [n, id_stride] NUL-terminated (reader layout); when
//               strip_mate_suffix, a trailing "/1" or "/2" is dropped.
//   rank_code:  int8 [T+1] rank codes into rank_blob/rank_off ([R+1] blob
//               offsets — rank r's name is rank_blob[rank_off[r]..[r+1]).
//   names:      names_blob/name_off, same offset-blob encoding, [T+2].
//   do_fsync:   fsync before returning (callers batch durability points —
//               the resume manifest records offsets only after an fsync).
// Returns the file size (offset) after the write, or -1 on IO error.
long pangea_write_assignments(
    const char* path, int append, long n,
    const char* ids, long id_stride, int strip_mate_suffix,
    const int32_t* taxon, const int32_t* best, const int32_t* nvalid,
    const int8_t* rank_code,
    const char* names_blob, const int64_t* name_off,
    const char* rank_blob, const int64_t* rank_off, int do_fsync) {
  FILE* f = std::fopen(path, append ? "ab" : "wb");
  if (!f) return -1;
  std::string out;
  out.reserve((size_t)n * 64);
  char tmp[64];
  for (long i = 0; i < n; ++i) {
    const char* id = ids + i * id_stride;
    size_t idlen = strnlen(id, (size_t)id_stride);
    if (strip_mate_suffix && idlen >= 2 && id[idlen - 2] == '/' &&
        (id[idlen - 1] == '1' || id[idlen - 1] == '2'))
      idlen -= 2;
    int32_t t = taxon[i];
    out.push_back(t != 0 ? 'C' : 'U');
    out.push_back('\t');
    out.append(id, idlen);
    out.push_back('\t');
    int m = std::snprintf(tmp, sizeof tmp, "%d\t", t);
    out.append(tmp, m);
    int8_t rc = t != 0 ? rank_code[t] : 0;
    out.append(rank_blob + rank_off[rc],
               (size_t)(rank_off[rc + 1] - rank_off[rc]));
    out.push_back('\t');
    int64_t noff = t != 0 ? name_off[t] : name_off[0];
    int64_t nend = t != 0 ? name_off[t + 1] : name_off[1];
    out.append(names_blob + noff, (size_t)(nend - noff));
    float conf = nvalid[i] ? (float)best[i] / (float)nvalid[i] : 0.0f;
    m = std::snprintf(tmp, sizeof tmp, "\t%d/%d\t%.6f\n", best[i], nvalid[i],
                      (double)conf);
    out.append(tmp, m);
  }
  size_t wrote = std::fwrite(out.data(), 1, out.size(), f);
  if (wrote != out.size()) {
    std::fclose(f);
    return -1;
  }
  std::fflush(f);
  if (do_fsync) fsync(fileno(f));
  long off = std::ftell(f);
  std::fclose(f);
  return off;
}

}  // extern "C"
