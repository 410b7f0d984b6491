// Fast GTrack valued-points parser (host runtime, C++).
//
// The reference's native layer is C (kernels + pthread pool); in the
// accelerator-native framework the compute lives on the device and the host-side
// runtime that still deserves native code is data loading: a chromosome-
// scale GTrack file is hundreds of MB of "seqid\tpos\tvalue\tgenomeid"
// rows (reference data model, tools/VCFConvert.py:75-86; the C test
// harness's hand-rolled reader is testcss.c:213-288).
//
// Design: the file is read in one shot, split into near-equal chunks at
// line boundaries, and parsed by a std::thread pool into per-thread
// buffers (hand-rolled integer/float scanning, no iostream/strtod in the
// hot loop for the common fixed-point values).  Seqids are interned into
// a string table; chunk results are concatenated in order, preserving
// file row order exactly like the Python reader.
//
// C ABI (ctypes-friendly): gtrack_parse() fills a flat result struct of
// malloc'd arrays; gtrack_free() releases them.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <thread>
#include <vector>

namespace {

struct ChunkOut {
  std::vector<int64_t> pos;
  std::vector<double> vals;
  std::vector<int32_t> seq;                  // local seqid ids
  std::vector<std::string> local_seqids;     // id -> name
  bool malformed = false;                    // strictness flag (see below)
};

// Strict decimal-integer token: requires >= 1 digit and a whitespace/EOL
// terminator (mirrors Python int(cols[1])).  Returns nullptr if malformed.
inline const char* scan_i64_strict(const char* p, const char* end,
                                   int64_t* out) {
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
  const char* d0 = p;
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; }
  if (p == d0) return nullptr;
  if (p < end && !isspace(static_cast<unsigned char>(*p))) return nullptr;
  *out = neg ? -v : v;
  return p;
}

// Strict floating token (falls back to strtod for exponents): requires
// >= 1 digit and a whitespace/EOL terminator (mirrors Python
// float(cols[2])).  Returns nullptr if malformed.
inline const char* scan_f64_strict(const char* p, const char* end,
                                   double* out) {
  const char* q = p;
  bool simple = true;
  if (q < end && (*q == '-' || *q == '+')) ++q;
  while (q < end && ((*q >= '0' && *q <= '9') || *q == '.')) ++q;
  if (q < end && (*q == 'e' || *q == 'E')) simple = false;
  if (!simple) {
    char* endp = nullptr;
    *out = strtod(p, &endp);
    if (endp == p) return nullptr;
    if (endp < end && !isspace(static_cast<unsigned char>(*endp)))
      return nullptr;
    return endp;
  }
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
  int ndigits = 0, ndots = 0;
  int64_t ip = 0;
  while (p < end && *p >= '0' && *p <= '9') {
    ip = ip * 10 + (*p - '0');
    ++ndigits;
    ++p;
  }
  double v = static_cast<double>(ip);
  if (p < end && *p == '.') {
    ++ndots;
    ++p;
    double scale = 0.1;
    while (p < end && *p >= '0' && *p <= '9') {
      v += (*p - '0') * scale;
      scale *= 0.1;
      ++ndigits;
      ++p;
    }
  }
  if (ndigits == 0) return nullptr;                 // ".", "-", "" ...
  if (p < end && !isspace(static_cast<unsigned char>(*p)))
    return nullptr;                                 // "1.2.3", "12x" ...
  *out = neg ? -v : v;
  return p;
}

// Parse [begin, end) line by line.  Semantics mirror the Python
// fallback reader (io/gtrack.py:_read_rows_chunked) exactly: lines that
// are blank or whose first non-whitespace char is '#' are skipped; any
// other line must yield (seqid, int pos, float value) or the whole
// parse is flagged malformed — the ctypes wrapper then returns None and
// the strict Python reader raises the proper error (never fabricate
// rows from garbage).
void parse_chunk(const char* begin, const char* end, ChunkOut* out) {
  std::map<std::string, int32_t> interned;
  // per-row std::string construction + map lookup dominates the parse
  // (tens of ns x 10^7 rows); rows are overwhelmingly grouped by
  // chromosome, so compare the raw token against the previous row's
  // and reuse its id on match
  const char* last_tok = nullptr;
  size_t last_len = 0;
  int32_t last_id = -1;
  const char* p = begin;
  while (p < end) {
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!line_end) line_end = end;
    const char* s = p;
    while (s < line_end && isspace(static_cast<unsigned char>(*s))) ++s;
    if (s < line_end && *s != '#') {
      // column 1: seqid (to the first whitespace; tab in the common case)
      const char* tab1 = s;
      while (tab1 < line_end &&
             !isspace(static_cast<unsigned char>(*tab1)))
        ++tab1;
      const char* q = tab1;
      while (q < line_end && isspace(static_cast<unsigned char>(*q))) ++q;
      int64_t position = 0;
      double value = 0.0;
      q = scan_i64_strict(q, line_end, &position);
      if (q) {
        while (q < line_end && isspace(static_cast<unsigned char>(*q)))
          ++q;
        q = scan_f64_strict(q, line_end, &value);
      }
      if (!q) {
        out->malformed = true;
        return;
      }
      // column 4 (genomeid) is ignored: the population-size contract
      // infers individuals from position run lengths
      // (reference statistics/css/comparative.c:25-34)
      size_t tok_len = static_cast<size_t>(tab1 - s);
      int32_t id;
      if (last_tok && tok_len == last_len &&
          memcmp(s, last_tok, tok_len) == 0) {
        id = last_id;
      } else {
        std::string seqid(s, tok_len);
        auto it = interned.find(seqid);
        if (it == interned.end()) {
          id = static_cast<int32_t>(out->local_seqids.size());
          out->local_seqids.push_back(seqid);
          interned.emplace(std::move(seqid), id);
        } else {
          id = it->second;
        }
        last_id = id;
      }
      last_tok = s;
      last_len = tok_len;
      out->seq.push_back(id);
      out->pos.push_back(position);
      out->vals.push_back(value);
    }
    p = line_end + 1;
  }
}

}  // namespace

extern "C" {

struct GtrackResult {
  int64_t n_rows;
  int64_t* pos;
  double* vals;
  int32_t* seq_idx;
  int32_t n_seqids;
  char* seqid_blob;   // '\0'-separated names, n_seqids entries
  int64_t blob_len;
};

// Returns 0 on success, negative on error.
int gtrack_parse(const char* path, struct GtrackResult* out, int n_threads) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (fsize < 0) { fclose(f); return -2; }
  // +1: NUL sentinel so the strtod fallback in scan_f64 (which takes a
  // C string, not a bounded range) can never read past the buffer when
  // the last line has no trailing newline
  std::vector<char> buf(static_cast<size_t>(fsize) + 1, '\0');
  if (fsize > 0 && fread(buf.data(), 1, static_cast<size_t>(fsize), f) !=
                       static_cast<size_t>(fsize)) {
    fclose(f);
    return -3;
  }
  fclose(f);

  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  size_t nbytes = static_cast<size_t>(fsize);  // sentinel byte excluded
  if (nbytes < (1u << 20)) n_threads = 1;  // small files: no thread tax

  // chunk boundaries snapped to line starts
  std::vector<const char*> starts(static_cast<size_t>(n_threads) + 1);
  const char* base = buf.data();
  const char* endp = base + nbytes;
  starts[0] = base;
  for (int t = 1; t < n_threads; ++t) {
    const char* guess = base + nbytes * static_cast<size_t>(t) /
                                   static_cast<size_t>(n_threads);
    const char* nl = static_cast<const char*>(
        memchr(guess, '\n', static_cast<size_t>(endp - guess)));
    starts[static_cast<size_t>(t)] = nl ? nl + 1 : endp;
  }
  starts[static_cast<size_t>(n_threads)] = endp;

  std::vector<ChunkOut> chunks(static_cast<size_t>(n_threads));
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) {
    threads.emplace_back(parse_chunk, starts[static_cast<size_t>(t)],
                         starts[static_cast<size_t>(t) + 1],
                         &chunks[static_cast<size_t>(t)]);
  }
  for (auto& th : threads) th.join();

  // any malformed row: refuse the whole parse (-5) so the caller falls
  // back to the strict Python reader, which raises the documented error
  for (auto& c : chunks)
    if (c.malformed) return -5;

  // merge: global seqid interning + remap, order-preserving
  std::map<std::string, int32_t> global;
  std::vector<std::string> names;
  int64_t total = 0;
  for (auto& c : chunks) total += static_cast<int64_t>(c.pos.size());

  out->n_rows = total;
  out->pos = static_cast<int64_t*>(malloc(sizeof(int64_t) *
                                          static_cast<size_t>(total)));
  out->vals = static_cast<double*>(malloc(sizeof(double) *
                                          static_cast<size_t>(total)));
  out->seq_idx = static_cast<int32_t*>(malloc(sizeof(int32_t) *
                                              static_cast<size_t>(total)));
  if (total > 0 && (!out->pos || !out->vals || !out->seq_idx)) {
    free(out->pos); free(out->vals); free(out->seq_idx);
    return -4;
  }
  int64_t off = 0;
  for (auto& c : chunks) {
    std::vector<int32_t> remap(c.local_seqids.size());
    for (size_t i = 0; i < c.local_seqids.size(); ++i) {
      auto it = global.find(c.local_seqids[i]);
      if (it == global.end()) {
        int32_t id = static_cast<int32_t>(names.size());
        global.emplace(c.local_seqids[i], id);
        names.push_back(c.local_seqids[i]);
        remap[i] = id;
      } else {
        remap[i] = it->second;
      }
    }
    size_t n = c.pos.size();
    if (n) {
      memcpy(out->pos + off, c.pos.data(), sizeof(int64_t) * n);
      memcpy(out->vals + off, c.vals.data(), sizeof(double) * n);
      for (size_t i = 0; i < n; ++i)
        out->seq_idx[off + static_cast<int64_t>(i)] =
            remap[static_cast<size_t>(c.seq[i])];
      off += static_cast<int64_t>(n);
    }
  }

  int64_t blob_len = 0;
  for (auto& s : names) blob_len += static_cast<int64_t>(s.size()) + 1;
  out->seqid_blob = static_cast<char*>(malloc(static_cast<size_t>(
      blob_len ? blob_len : 1)));
  if (!out->seqid_blob) {
    free(out->pos); free(out->vals); free(out->seq_idx);
    return -4;
  }
  char* bp = out->seqid_blob;
  for (auto& s : names) {
    memcpy(bp, s.c_str(), s.size() + 1);
    bp += s.size() + 1;
  }
  out->n_seqids = static_cast<int32_t>(names.size());
  out->blob_len = blob_len;
  return 0;
}

void gtrack_free(struct GtrackResult* r) {
  free(r->pos);
  free(r->vals);
  free(r->seq_idx);
  free(r->seqid_blob);
  r->pos = nullptr;
  r->vals = nullptr;
  r->seq_idx = nullptr;
  r->seqid_blob = nullptr;
  r->n_rows = 0;
  r->n_seqids = 0;
}

}  // extern "C"
