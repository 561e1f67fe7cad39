// Columnar CSV ingest of the PyTorch port: one pass over a byte buffer
// into float32 numeric columns and dictionary-encoded int32 categorical
// columns, with no Python string per field.
//
// The port's own copy of avenir_tpu/native/csv_ingest.cpp, cut to what
// the ported jobs use: csv_count_rows(_mt), csv_parse(_mt),
// csv_column_bytes, csv_extract_column, and the ragged encoder of the
// miners, seq_token_count and seq_encode. Exposed through ctypes; see
// avenir_tpu_torch/native/ingest.py for the Python contract. A float token
// takes the same path as the reference's native parser (plain
// [+-]digits[.digits] tokens in double arithmetic, anything else through
// strtof), so the columns are the reference's bit for bit.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Trim ASCII whitespace in [b, e).
inline void trim(const char*& b, const char*& e) {
    while (b < e && (*b == ' ' || *b == '\t' || *b == '\r')) ++b;
    while (e > b && (e[-1] == ' ' || e[-1] == '\t' || e[-1] == '\r')) --e;
}

// Allocation-free categorical vocabulary: open-addressing over the value
// list, probed with (ptr, len) so the hot loop never constructs a
// std::string per token (the former unordered_map<string> lookup was the
// parse-rate bottleneck together with strtof).
struct Vocab {
    std::vector<std::string> values;
    std::vector<int32_t> slots;   // open addressing, -1 empty
    size_t mask = 0;

    static uint64_t hash(const char* b, size_t n) {
        uint64_t h = 1469598103934665603ull;          // FNV-1a
        for (size_t i = 0; i < n; ++i) {
            h ^= static_cast<unsigned char>(b[i]);
            h *= 1099511628211ull;
        }
        return h;
    }

    void build() {
        size_t cap = 8;
        while (cap < values.size() * 2) cap <<= 1;
        slots.assign(cap, -1);
        mask = cap - 1;
        for (size_t v = 0; v < values.size(); ++v) {
            size_t h = hash(values[v].data(), values[v].size()) & mask;
            while (slots[h] >= 0) h = (h + 1) & mask;
            slots[h] = static_cast<int32_t>(v);
        }
    }

    int32_t find(const char* b, size_t n) const {
        size_t h = hash(b, n) & mask;
        while (slots[h] >= 0) {
            const std::string& s = values[slots[h]];
            if (s.size() == n && memcmp(s.data(), b, n) == 0) return slots[h];
            h = (h + 1) & mask;
        }
        return -1;
    }
};

const double kPow10[10] = {1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9};

// Fast path for plain [+-]digits[.digits] tokens (the overwhelming CSV
// case); returns false for exponents/specials so the caller can fall back
// to strtof.
inline bool parse_float_fast(const char* b, const char* e, float* out) {
    bool neg = false;
    const char* p = b;
    if (p < e && (*p == '-' || *p == '+')) { neg = *p == '-'; ++p; }
    int64_t ip = 0;
    int nd = 0;
    while (p < e && *p >= '0' && *p <= '9') {
        if (nd == 18) return false;   // before the multiply: no signed overflow
        ip = ip * 10 + (*p - '0');
        ++p;
        ++nd;
    }
    if (nd == 0) return false;
    double v;
    if (p == e) {
        v = static_cast<double>(ip);
    } else {
        if (*p != '.') return false;
        ++p;
        int64_t fp = 0;
        int fd = 0;
        while (p < e && *p >= '0' && *p <= '9') {
            fp = fp * 10 + (*p - '0');
            ++p;
            if (++fd > 9) return false;
        }
        if (p != e) return false;
        v = static_cast<double>(ip) + static_cast<double>(fp) / kPow10[fd];
    }
    *out = static_cast<float>(neg ? -v : v);
    return true;
}

// Shared per-parse lookup tables (built once, read-only across threads).
struct ParseTables {
    std::vector<int8_t> kind;     // ordinal -> 0 none, 1 numeric, 2 cat
    std::vector<int32_t> slot;
    std::vector<Vocab> vocabs;
    int32_t max_ord;
};

// Parse rows in [p, end) writing global rows [row_base, row_base+max_rows).
// Returns rows parsed, or -1 (unknown categorical) / -2 (bad numeric) with
// err_row (global) / err_ord set.
int64_t parse_range(const char* p, const char* end, char delim,
                    const ParseTables& t, float* num_out, int32_t* cat_out,
                    int64_t n_rows, int64_t row_base, int64_t max_rows,
                    int64_t* err_row, int32_t* err_ord) {
    int64_t row = 0;
    while (p < end && row < max_rows) {
        const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
        const char* line_end = nl ? nl : end;
        {
            const char* b = p;
            const char* e = line_end;
            trim(b, e);
            if (e <= b) {  // blank line
                p = nl ? nl + 1 : end;
                continue;
            }
        }
        int32_t ord = 0;
        const char* fb = p;
        for (const char* q = p; q <= line_end; ++q) {
            if (q == line_end || *q == delim) {
                if (ord <= t.max_ord && t.kind[ord]) {
                    const char* b = fb;
                    const char* e = q;
                    trim(b, e);
                    if (t.kind[ord] == 1) {
                        float v;
                        if (e == b) {
                            v = __builtin_nanf("");
                        } else if (!parse_float_fast(b, e, &v)) {
                            // exponents/specials: fall back to strtof
                            char* endp = nullptr;
                            std::string tok(b, e - b);
                            v = strtof(tok.c_str(), &endp);
                            if (endp == tok.c_str() || *endp != '\0') {
                                *err_row = row_base + row;
                                *err_ord = ord;
                                return -2;
                            }
                        }
                        num_out[static_cast<int64_t>(t.slot[ord]) * n_rows
                                + row_base + row] = v;
                    } else {
                        int32_t code = t.vocabs[t.slot[ord]].find(b, e - b);
                        if (code < 0) {
                            *err_row = row_base + row;
                            *err_ord = ord;
                            return -1;
                        }
                        cat_out[static_cast<int64_t>(t.slot[ord]) * n_rows
                                + row_base + row] = code;
                    }
                }
                ++ord;
                fb = q + 1;
            }
        }
        ++row;
        p = nl ? nl + 1 : end;
    }
    return row;
}

ParseTables build_tables(int32_t max_ord, const int32_t* num_ords,
                         int32_t n_num, const int32_t* cat_ords,
                         int32_t n_cat, const char* vocab_blob,
                         const int32_t* vocab_counts) {
    ParseTables t;
    t.max_ord = max_ord;
    t.kind.assign(max_ord + 1, 0);
    t.slot.assign(max_ord + 1, -1);
    for (int32_t i = 0; i < n_num; ++i) {
        t.kind[num_ords[i]] = 1;
        t.slot[num_ords[i]] = i;
    }
    t.vocabs.resize(n_cat);
    const char* vp = vocab_blob;
    for (int32_t c = 0; c < n_cat; ++c) {
        t.kind[cat_ords[c]] = 2;
        t.slot[cat_ords[c]] = c;
        for (int32_t v = 0; v < vocab_counts[c]; ++v) {
            t.vocabs[c].values.emplace_back(vp);
            vp += strlen(vp) + 1;
        }
        t.vocabs[c].build();
    }
    return t;
}

// Count non-empty rows in [p, end).
int64_t count_range(const char* p, const char* end) {
    int64_t rows = 0;
    while (p < end) {
        const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
        const char* line_end = nl ? nl : end;
        const char* b = p;
        const char* e = line_end;
        trim(b, e);
        if (e > b) ++rows;
        p = nl ? nl + 1 : end;
    }
    return rows;
}

// Stripe [buf, buf+len) into n newline-aligned ranges; bounds[i..i+1]
// delimits stripe i.
std::vector<const char*> stripe_bounds(const char* buf, int64_t len,
                                       int32_t n) {
    std::vector<const char*> bounds(n + 1);
    bounds[0] = buf;
    bounds[n] = buf + len;
    for (int32_t i = 1; i < n; ++i) {
        const char* p = buf + len * i / n;
        const char* nl = static_cast<const char*>(
            memchr(p, '\n', buf + len - p));
        bounds[i] = nl ? nl + 1 : buf + len;
    }
    return bounds;
}

// Run fn(i) on n threads; false if spawning failed (work may be partially
// done — callers must treat false as "redo sequentially").
template <typename Fn>
bool run_threads(int32_t n, Fn fn) {
    std::vector<std::thread> ts;
    ts.reserve(n);
    try {
        for (int32_t i = 0; i < n; ++i) ts.emplace_back([fn, i] { fn(i); });
    } catch (...) {
        // std::system_error from thread creation (pid/memory limits):
        // join what started, report failure — throwing across the
        // extern "C" boundary would std::terminate the host process
        for (auto& th : ts) th.join();
        return false;
    }
    for (auto& th : ts) th.join();
    return true;
}

}  // namespace

extern "C" {

// Count non-empty lines.
int64_t csv_count_rows(const char* buf, int64_t len) {
    return count_range(buf, buf + len);
}

// Parse the buffer in one pass.
//
// num_ords / n_num: field ordinals to parse as float32 into num_out
//   (column-major: num_out[c * n_rows + r]); empty tokens -> NaN, invalid
//   non-empty tokens abort with -2 (see return doc).
// cat_ords / n_cat: field ordinals to dictionary-encode into cat_out
//   (column-major int32). The vocabulary for categorical column c is
//   vocab_blob[vocab_off[vc] .. ] holding vocab_counts[c] zero-terminated
//   strings back to back (vc = running string index). Unknown values
//   write -1 and the row/ordinal of the first failure into err_row/err_ord.
// String/id columns are extracted separately via csv_extract_column.
//
// Returns the number of parsed rows, -1 on unknown categorical value, or
// -2 on an invalid non-empty numeric token (err_row/err_ord locate it).
int64_t csv_parse(const char* buf, int64_t len, char delim, int32_t max_ord,
                  const int32_t* num_ords, int32_t n_num, float* num_out,
                  const int32_t* cat_ords, int32_t n_cat,
                  const char* vocab_blob, const int32_t* vocab_counts,
                  int32_t* cat_out, int64_t n_rows,
                  int64_t* err_row, int32_t* err_ord) {
    ParseTables t = build_tables(max_ord, num_ords, n_num, cat_ords, n_cat,
                                 vocab_blob, vocab_counts);
    return parse_range(buf, buf + len, delim, t, num_out, cat_out, n_rows,
                       0, n_rows, err_row, err_ord);
}

// Multi-threaded csv_parse: the buffer splits into `n_threads` stripes at
// newline boundaries; each stripe is row-counted, prefix-summed into a
// global row base, then parsed in parallel into the shared column-major
// outputs (disjoint row ranges, no synchronization needed). Semantics are
// identical to csv_parse; on error the failure with the LOWEST global row
// wins (matching the sequential first-failure contract). Buffers under two
// 4 MB stripes parse on the calling thread.
int64_t csv_parse_mt(const char* buf, int64_t len, char delim,
                     int32_t max_ord, const int32_t* num_ords, int32_t n_num,
                     float* num_out, const int32_t* cat_ords, int32_t n_cat,
                     const char* vocab_blob, const int32_t* vocab_counts,
                     int32_t* cat_out, int64_t n_rows,
                     int64_t* err_row, int32_t* err_ord, int32_t n_threads) {
    if (n_threads <= 0) {
        n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
        if (n_threads <= 0) n_threads = 1;
    }
    // below ~4MB the spawn+count overhead beats the parallel win
    int64_t max_stripes = len / (4 << 20);
    if (n_threads > max_stripes) n_threads = static_cast<int32_t>(max_stripes);
    if (n_threads <= 1)
        return csv_parse(buf, len, delim, max_ord, num_ords, n_num, num_out,
                         cat_ords, n_cat, vocab_blob, vocab_counts, cat_out,
                         n_rows, err_row, err_ord);

    ParseTables t = build_tables(max_ord, num_ords, n_num, cat_ords, n_cat,
                                 vocab_blob, vocab_counts);
    std::vector<const char*> bounds = stripe_bounds(buf, len, n_threads);
    // pass A: parallel row count per stripe
    std::vector<int64_t> stripe_rows(n_threads, 0);
    bool ok = run_threads(n_threads, [&](int32_t i) {
        stripe_rows[i] = count_range(bounds[i], bounds[i + 1]);
    });
    std::vector<int64_t> base(n_threads + 1, 0);
    for (int32_t i = 0; i < n_threads; ++i)
        base[i + 1] = base[i] + stripe_rows[i];
    // thread-spawn failure or under-allocated output (the sequential
    // contract is "parse at most n_rows"): fall back to the sequential
    // path, which implements both cases exactly
    if (!ok || base[n_threads] > n_rows)
        return parse_range(buf, buf + len, delim, t, num_out, cat_out,
                           n_rows, 0, n_rows, err_row, err_ord);

    // pass B: parallel parse into disjoint global row ranges
    std::vector<int64_t> st(n_threads, 0), erow(n_threads, -1);
    std::vector<int32_t> eord(n_threads, -1);
    ok = run_threads(n_threads, [&](int32_t i) {
        st[i] = parse_range(bounds[i], bounds[i + 1], delim, t,
                            num_out, cat_out, n_rows, base[i],
                            stripe_rows[i], &erow[i], &eord[i]);
    });
    if (!ok)
        return parse_range(buf, buf + len, delim, t, num_out, cat_out,
                           n_rows, 0, n_rows, err_row, err_ord);
    for (int32_t i = 0; i < n_threads; ++i) {
        if (st[i] < 0) {                      // lowest-row failure wins
            *err_row = erow[i];
            *err_ord = eord[i];
            return st[i];
        }
    }
    return base[n_threads];
}

// Striped row count: the sequential pre-count is otherwise the Amdahl
// bottleneck of the parallel ingest (two full-buffer scans, one serial).
int64_t csv_count_rows_mt(const char* buf, int64_t len, int32_t n_threads) {
    if (n_threads <= 0) {
        n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
        if (n_threads <= 0) n_threads = 1;
    }
    int64_t max_stripes = len / (4 << 20);
    if (n_threads > max_stripes) n_threads = static_cast<int32_t>(max_stripes);
    if (n_threads <= 1) return count_range(buf, buf + len);
    std::vector<const char*> bounds = stripe_bounds(buf, len, n_threads);
    std::vector<int64_t> rows(n_threads, 0);
    if (!run_threads(n_threads, [&](int32_t i) {
            rows[i] = count_range(bounds[i], bounds[i + 1]);
        }))
        return count_range(buf, buf + len);
    int64_t total = 0;
    for (int64_t r : rows) total += r;
    return total;
}

// Total bytes needed by csv_extract_column's output (tokens + '\n' each).
int64_t csv_column_bytes(const char* buf, int64_t len, char delim,
                         int32_t ordinal) {
    int64_t total = 0;
    const char* p = buf;
    const char* end = buf + len;
    while (p < end) {
        const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
        const char* line_end = nl ? nl : end;
        const char* b = p;
        const char* e = line_end;
        trim(b, e);
        if (e > b) {
            int32_t ord = 0;
            const char* fb = p;
            bool found = false;
            for (const char* q = p; q <= line_end; ++q) {
                if (q == line_end || *q == delim) {
                    if (ord == ordinal) {
                        const char* tb = fb;
                        const char* te = q;
                        trim(tb, te);
                        total += (te - tb) + 1;
                        found = true;
                        break;
                    }
                    ++ord;
                    fb = q + 1;
                }
            }
            if (!found) total += 1;  // short row: empty token keeps alignment
        }
        p = nl ? nl + 1 : end;
    }
    return total;
}

// Extract one column's tokens, '\n'-separated, into out (cap bytes).
// Returns bytes written, or -1 if cap is too small.
int64_t csv_extract_column(const char* buf, int64_t len, char delim,
                           int32_t ordinal, char* out, int64_t cap) {
    int64_t w = 0;
    const char* p = buf;
    const char* end = buf + len;
    while (p < end) {
        const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
        const char* line_end = nl ? nl : end;
        const char* b = p;
        const char* e = line_end;
        trim(b, e);
        if (e > b) {
            int32_t ord = 0;
            const char* fb = p;
            bool found = false;
            for (const char* q = p; q <= line_end; ++q) {
                if (q == line_end || *q == delim) {
                    if (ord == ordinal) {
                        const char* tb = fb;
                        const char* te = q;
                        trim(tb, te);
                        int64_t n = te - tb;
                        if (w + n + 1 > cap) return -1;
                        memcpy(out + w, tb, n);
                        w += n;
                        out[w++] = '\n';
                        found = true;
                        break;
                    }
                    ++ord;
                    fb = q + 1;
                }
            }
            if (!found) {  // short row: empty token keeps row alignment
                if (w + 1 > cap) return -1;
                out[w++] = '\n';
            }
        }
        p = nl ? nl + 1 : end;
    }
    return w;
}

// Ragged tokenize and dictionary-encode (the miners' ingest: rows are
// "id,item,item,..." with a token count of their own). One scan splits
// every line that is not all space, tab or CR by `delim`, trims each
// token of space, tab and CR, and encodes it against ONE vocabulary
// (n_vocab zero-terminated strings back to back in vocab_blob); an
// unknown token encodes as -1 and the caller decides which positions
// must be known. Outputs CSR: codes[total_tokens] + offsets[n_rows+1]
// (offsets[0] = 0). seq_token_count sizes the arrays; seq_encode returns
// the rows written, or -3 when the buffers are too small.
int64_t seq_token_count(const char* buf, int64_t len, char delim,
                        int64_t* out_tokens) {
    int64_t rows = 0, tokens = 0;
    const char* p = buf;
    const char* end = buf + len;
    while (p < end) {
        const char* nl = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        const char* e = nl ? nl : end;
        // what is a row must match seq_encode exactly: a whitespace-only
        // line is skipped even when the delimiter is a whitespace byte
        bool all_ws = true;
        int64_t t = 1;
        for (const char* q = p; q < e; ++q) {
            if (*q == delim) ++t;
            if (*q != ' ' && *q != '\t' && *q != '\r') all_ws = false;
        }
        if (!all_ws) { ++rows; tokens += t; }
        p = nl ? nl + 1 : end;
    }
    *out_tokens = tokens;
    return rows;
}

int64_t seq_encode(const char* buf, int64_t len, char delim,
                   const char* vocab_blob, int32_t n_vocab,
                   int32_t* codes, int64_t max_tokens,
                   int64_t* offsets, int64_t max_rows) {
    Vocab vocab;
    const char* v = vocab_blob;
    for (int32_t i = 0; i < n_vocab; ++i) {
        size_t n = strlen(v);
        vocab.values.emplace_back(v, n);
        v += n + 1;
    }
    vocab.build();

    int64_t rows = 0, tok = 0;
    offsets[0] = 0;
    const char* p = buf;
    const char* end = buf + len;
    while (p < end) {
        const char* nl = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        const char* e = nl ? nl : end;
        // a whitespace-only line is no row (the Python line reader's
        // `if ln.strip()`); a line of delimiters is one, of empty tokens
        bool all_ws = true;
        for (const char* s = p; s < e; ++s)
            if (*s != ' ' && *s != '\t' && *s != '\r') { all_ws = false; break; }
        if (all_ws) {
            p = nl ? nl + 1 : end;
            continue;
        }
        if (rows + 1 >= max_rows) return -3;   // offsets[++rows] must fit
        const char* ts = p;
        for (const char* s = p;; ++s) {
            if (s == e || *s == delim) {
                const char* a = ts;
                const char* b = s;
                while (a < b && (*a == ' ' || *a == '\t' || *a == '\r')) ++a;
                while (b > a && (b[-1] == ' ' || b[-1] == '\t'
                                 || b[-1] == '\r')) --b;
                if (tok >= max_tokens) return -3;
                codes[tok++] = vocab.find(a, static_cast<size_t>(b - a));
                ts = s + 1;
                if (s == e) break;
            }
        }
        offsets[++rows] = tok;
        p = nl ? nl + 1 : end;
    }
    return rows;
}

}  // extern "C"
