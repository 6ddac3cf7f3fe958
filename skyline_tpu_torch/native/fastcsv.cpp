// Fast data-plane CSV parser: "id,v1,...,vd" lines -> (ids, values) arrays.
//
// The host-side ingest hot path. The reference's wire format is CSV strings on
// Kafka (unified_producer.py:174, parsed tuple-at-a-time by
// ServiceTuple.fromString, ServiceTuple.java:89-104); at stream rates the
// reference attributes ~80% of total processing time to ingest (pdf §5.5).
// This parser processes a whole poll batch as one contiguous byte buffer with
// no allocation, writing straight into caller-provided numpy buffers.
//
// Semantics parity with skyline_tpu_torch.bridge.wire.parse_tuple_lines (which is
// also the fallback when this library isn't built): a line is dropped — not
// an error — when it has the wrong field count, a non-integer id, a
// non-numeric value, or any non-finite value (NaN/inf must never enter
// windows; +inf is reserved for padding).
//
// Build: see skyline_tpu_torch/native/__init__.py (g++ -O3 -march=native
// -shared -fPIC, into skyline_tpu_torch/_build/ keyed by this file's hash).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

// Parse an integer id; returns false on malformed or int64 overflow (an
// out-of-range id is a dropped line, matching the Python fallback).
bool parse_id(const char*& p, const char* end, int64_t& out) {
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) {
        neg = (*p == '-');
        ++p;
    }
    if (p >= end || *p < '0' || *p > '9') return false;
    uint64_t v = 0;
    while (p < end && *p >= '0' && *p <= '9') {
        if (v > (UINT64_MAX - 9) / 10) return false;
        v = v * 10 + static_cast<uint64_t>(*p - '0');
        ++p;
    }
    const uint64_t limit =
        neg ? (static_cast<uint64_t>(INT64_MAX) + 1) : static_cast<uint64_t>(INT64_MAX);
    if (v > limit) return false;
    out = neg ? -static_cast<int64_t>(v - 1) - 1 : static_cast<int64_t>(v);
    return true;
}

// Fast float parse for the common integer-valued case (the generators stream
// integers); falls back to strtof for general decimals/exponents.
bool parse_value(const char*& p, const char* end, float& out) {
    const char* start = p;
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) {
        neg = (*p == '-');
        ++p;
    }
    int64_t ip = 0;
    int digits = 0;
    while (p < end && *p >= '0' && *p <= '9' && digits < 18) {
        ip = ip * 10 + (*p - '0');
        ++p;
        ++digits;
    }
    if (digits > 0 && (p == end || *p == ',' || *p == '\n' || *p == '\r')) {
        out = static_cast<float>(neg ? -ip : ip);
        return true;
    }
    // general path (decimals, exponents, or >18 digits)
    char tmp[64];
    size_t n = 0;
    const char* q = start;
    while (q < end && *q != ',' && *q != '\n' && *q != '\r' && n < sizeof(tmp) - 1)
        tmp[n++] = *q++;
    if (n == 0) return false;
    tmp[n] = '\0';
    char* parsed_end = nullptr;
    float v = strtof(tmp, &parsed_end);
    if (parsed_end != tmp + n) return false;
    if (!std::isfinite(v)) return false;
    p = q;
    out = v;
    return true;
}

}  // namespace

extern "C" {

// Returns the number of parsed rows (<= max_rows); *dropped counts malformed
// lines. Stops early (remaining lines dropped-silently excluded from both
// counts) only if max_rows is hit — callers size max_rows to the line count.
int64_t sky_parse_tuples(const char* buf, int64_t len, int32_t dims,
                         int64_t max_rows, int64_t* ids, float* values,
                         int64_t* dropped) {
    const char* p = buf;
    const char* end = buf + len;
    int64_t rows = 0;
    int64_t bad = 0;
    while (p < end && rows < max_rows) {
        const char* line_end = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        if (line_end == nullptr) line_end = end;
        const char* q = p;
        const char* qe = line_end;
        if (qe > q && qe[-1] == '\r') --qe;  // tolerate CRLF

        bool ok = (qe > q);
        int64_t id = 0;
        if (ok) ok = parse_id(q, qe, id);
        float* row = values + rows * dims;
        for (int32_t k = 0; ok && k < dims; ++k) {
            ok = (q < qe && *q == ',');
            if (ok) ++q;
            if (ok) ok = parse_value(q, qe, row[k]);
        }
        if (ok && q != qe) ok = false;  // trailing junk / too many fields
        if (ok) {
            ids[rows] = id;
            ++rows;
        } else if (line_end > p) {
            ++bad;
        }
        p = line_end + 1;
    }
    *dropped = bad;
    return rows;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Kafka RecordBatch v2 produce-plane helpers (see bridge/kafkalite/protocol.py
// encode_record_batch): CRC32C over the post-crc batch region and the
// per-record frame loop for value-only records. Both byte-identical to the
// Python fallbacks — the golden-bytes tests pin the format.
// ---------------------------------------------------------------------------

namespace {

struct Crc32cTables {
    uint32_t t[8][256];
    Crc32cTables() {
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i;
            for (int k = 0; k < 8; ++k)
                c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
            t[0][i] = c;
        }
        for (int k = 1; k < 8; ++k)
            for (uint32_t i = 0; i < 256; ++i)
                t[k][i] = t[0][t[k - 1][i] & 0xFF] ^ (t[k - 1][i] >> 8);
    }
};

uint32_t crc32c_sw(uint32_t crc, const uint8_t* p, int64_t n) {
    // C++11 guarantees thread-safe one-time construction of local statics
    // (ctypes releases the GIL, so concurrent first calls are real)
    static const Crc32cTables tables;
    const auto& crc32c_table = tables.t;
    while (n >= 8) {
        crc ^= static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
               (static_cast<uint32_t>(p[2]) << 16) |
               (static_cast<uint32_t>(p[3]) << 24);
        crc = crc32c_table[7][crc & 0xFF] ^ crc32c_table[6][(crc >> 8) & 0xFF] ^
              crc32c_table[5][(crc >> 16) & 0xFF] ^
              crc32c_table[4][(crc >> 24) & 0xFF] ^ crc32c_table[3][p[4]] ^
              crc32c_table[2][p[5]] ^ crc32c_table[1][p[6]] ^
              crc32c_table[0][p[7]];
        p += 8;
        n -= 8;
    }
    while (n-- > 0) crc = crc32c_table[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
    return crc;
}

// LEB128 of an already-zigzagged value; returns bytes written.
inline int put_uvarint(uint8_t* out, uint64_t z) {
    int i = 0;
    while (z >= 0x80) {
        out[i++] = static_cast<uint8_t>(z) | 0x80;
        z >>= 7;
    }
    out[i++] = static_cast<uint8_t>(z);
    return i;
}

inline int uvarint_len(uint64_t z) {
    int i = 1;
    while (z >= 0x80) {
        z >>= 7;
        ++i;
    }
    return i;
}

}  // namespace

extern "C" uint32_t sky_crc32c(const uint8_t* data, int64_t n) {
#if defined(__SSE4_2__)
    uint32_t crc = 0xFFFFFFFFu;
    const uint8_t* p = data;
    while (n >= 8) {
        uint64_t v;
        std::memcpy(&v, p, 8);
        crc = static_cast<uint32_t>(__builtin_ia32_crc32di(crc, v));
        p += 8;
        n -= 8;
    }
    while (n-- > 0) crc = __builtin_ia32_crc32qi(crc, *p++);
    return crc ^ 0xFFFFFFFFu;
#else
    return crc32c_sw(0xFFFFFFFFu, data, n) ^ 0xFFFFFFFFu;
#endif
}

// Encode n value-only records (key=null, timestampDelta=0, offsetDelta=i,
// no headers) into `out`. `values` is the concatenation of the value byte
// strings; `offsets` has n+1 prefix offsets. Returns bytes written, or -1
// if out_cap would be exceeded (caller sizes out generously).
extern "C" int64_t sky_encode_records(const uint8_t* values,
                                      const int64_t* offsets, int64_t n,
                                      uint8_t* out, int64_t out_cap) {
    int64_t w = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t vlen = offsets[i + 1] - offsets[i];
        // body: attributes(1) + tsDelta(1) + offsetDelta + keyLen(1=null)
        //       + valueLen + value + headerCount(1)
        const uint64_t off_z = static_cast<uint64_t>(i) << 1;
        const uint64_t vlen_z = static_cast<uint64_t>(vlen) << 1;
        const int64_t body = 3 + uvarint_len(off_z) + uvarint_len(vlen_z) +
                             vlen + 1;
        const uint64_t body_z = static_cast<uint64_t>(body) << 1;
        if (w + uvarint_len(body_z) + body > out_cap) return -1;
        w += put_uvarint(out + w, body_z);
        out[w++] = 0x00;  // attributes
        out[w++] = 0x00;  // timestampDelta = 0
        w += put_uvarint(out + w, off_z);
        out[w++] = 0x01;  // key = null (zigzag(-1))
        w += put_uvarint(out + w, vlen_z);
        std::memcpy(out + w, values + offsets[i], static_cast<size_t>(vlen));
        w += vlen;
        out[w++] = 0x00;  // headers count
    }
    return w;
}

namespace {

// Reverse-digit int64 -> decimal ascii; returns the advanced write pointer.
inline char* write_i64(char* w, int64_t v) {
    if (v < 0) {
        *w++ = '-';
        // negate via unsigned to survive INT64_MIN
        uint64_t u = static_cast<uint64_t>(-(v + 1)) + 1;
        char tmp[20];
        int k = 0;
        do { tmp[k++] = static_cast<char>('0' + u % 10); u /= 10; } while (u);
        while (k) *w++ = tmp[--k];
        return w;
    }
    uint64_t u = static_cast<uint64_t>(v);
    char tmp[20];
    int k = 0;
    do { tmp[k++] = static_cast<char>('0' + u % 10); u /= 10; } while (u);
    while (k) *w++ = tmp[--k];
    return w;
}

}  // namespace

namespace {

// Bounds-checked zigzag varint read; false on truncation/overflow.
inline bool read_zigzag(const uint8_t*& p, const uint8_t* end, int64_t& out) {
    uint64_t z = 0;
    int shift = 0;
    while (p < end) {
        const uint8_t b = *p++;
        z |= static_cast<uint64_t>(b & 0x7F) << shift;
        if (!(b & 0x80)) {
            out = static_cast<int64_t>((z >> 1) ^ (~(z & 1) + 1));
            return true;
        }
        shift += 7;
        if (shift > 63) return false;
    }
    return false;
}

inline uint32_t be32(const uint8_t* p) {
    return (static_cast<uint32_t>(p[0]) << 24) |
           (static_cast<uint32_t>(p[1]) << 16) |
           (static_cast<uint32_t>(p[2]) << 8) | p[3];
}

inline int64_t be64(const uint8_t* p) {
    return static_cast<int64_t>((static_cast<uint64_t>(be32(p)) << 32) |
                                be32(p + 4));
}

}  // namespace

extern "C" uint32_t sky_crc32c(const uint8_t* data, int64_t n);

// Consume-plane twin of sky_encode_records + sky_parse_tuples: walk a
// concatenation of RecordBatch v2 blobs (one fetch response's record set,
// bridge/kafkalite/protocol.py decode_record_batches) and CSV-parse each
// record's value straight into the caller's (ids, values) numpy buffers —
// zero per-record Python objects on the whole broker->engine path. Mirrors
// the Python decode exactly: tolerates a truncated trailing batch, skips
// records below `min_offset` (a fetch can return a batch starting before
// the requested offset), keys and headers are skipped via the record
// length, `*next_offset` tracks last-seen-abs+1 (the fetch position
// advance), malformed CSV values count into `*dropped`.
//
// Returns rows parsed (stops at max_rows; remaining records stay
// re-fetchable at *next_offset... callers size max_rows to len/9, the
// framing minimum, so a single pass always completes), or a negative
// error: -2 unsupported magic, -3 CRC32C mismatch (verify_crc=1),
// -4 malformed record framing inside a complete batch. All three raise in
// the Python wrapper, matching decode_record_batches' behavior.
extern "C" int64_t sky_parse_recordbatches(
    const uint8_t* buf, int64_t len, int64_t min_offset, int32_t dims,
    int32_t verify_crc, int64_t max_rows, int64_t* ids, float* values,
    int64_t* dropped, int64_t* next_offset) {
    const uint8_t* p = buf;
    const uint8_t* end = buf + len;
    int64_t rows = 0;
    int64_t bad = 0;
    while (end - p >= 12) {
        const int64_t base = be64(p);
        const int64_t blen = be32(p + 8);
        if (end - p - 12 < blen) break;  // truncated tail
        const uint8_t* batch = p + 12;
        p += 12 + blen;
        if (blen < 49) return -4;  // shorter than a v2 batch header
        if (batch[4] != 2) return -2;
        if (verify_crc &&
            sky_crc32c(batch + 9, blen - 9) != be32(batch + 5))
            return -3;
        const int64_t n = static_cast<int64_t>(be32(batch + 45));
        const uint8_t* q = batch + 49;
        const uint8_t* qe = batch + blen;
        for (int64_t i = 0; i < n; ++i) {
            int64_t rec_len, off_delta, klen, vlen, tmp;
            if (!read_zigzag(q, qe, rec_len)) return -4;
            // validate BEFORE forming rec_end: q + rec_len with a negative
            // or oversized rec_len from a corrupt varint is out-of-range
            // pointer arithmetic (UB) even if never dereferenced
            if (rec_len <= 0 || rec_len > qe - q) return -4;
            const uint8_t* rec_end = q + rec_len;
            ++q;  // attributes
            if (!read_zigzag(q, rec_end, tmp)) return -4;  // timestampDelta
            if (!read_zigzag(q, rec_end, off_delta)) return -4;
            if (!read_zigzag(q, rec_end, klen)) return -4;
            if (klen > 0) {
                if (rec_end - q < klen) return -4;
                q += klen;  // key skipped (data-plane records are value-only)
            }
            if (!read_zigzag(q, rec_end, vlen)) return -4;
            if (vlen > 0 && rec_end - q < vlen) return -4;
            const int64_t abs = base + off_delta;
            *next_offset = abs + 1;
            if (abs >= min_offset) {
                if (rows >= max_rows) {
                    *next_offset = abs;  // this record not consumed
                    *dropped = bad;
                    return rows;
                }
                bool ok = vlen > 0;
                if (ok) {
                    const char* v = reinterpret_cast<const char*>(q);
                    const char* ve = v + vlen;
                    int64_t id = 0;
                    ok = parse_id(v, ve, id);
                    float* row = values + rows * dims;
                    for (int32_t k = 0; ok && k < dims; ++k) {
                        ok = (v < ve && *v == ',');
                        if (ok) ++v;
                        if (ok) ok = parse_value(v, ve, row[k]);
                    }
                    if (ok && v != ve) ok = false;
                    if (ok) ids[rows++] = id;
                }
                if (!ok) ++bad;
            }
            q = rec_end;  // headers (if any) skipped via the record length
        }
    }
    *dropped = bad;
    return rows;
}

// Format n data-plane lines "id,v1,...,vd" (no separators between records —
// `offsets` carries the n+1 prefix offsets, so record i is
// out[offsets[i]:offsets[i+1]]). The produce-plane twin of sky_parse_tuples:
// the reference emits integer-valued tuples (unified_producer.py:174) and
// the Python producer casts to int64 before formatting, so values arrive
// here already as int64. Returns bytes written, or -1 if out_cap would be
// exceeded (callers size out at 21 bytes per field).
extern "C" int64_t sky_format_tuples(const int64_t* ids,
                                     const int64_t* values, int64_t n,
                                     int32_t dims, char* out, int64_t out_cap,
                                     int64_t* offsets) {
    char* w = out;
    const char* end = out + out_cap;
    const int64_t worst = (static_cast<int64_t>(dims) + 1) * 21;
    for (int64_t i = 0; i < n; ++i) {
        offsets[i] = w - out;
        if (end - w < worst) return -1;
        w = write_i64(w, ids[i]);
        const int64_t* row = values + i * dims;
        for (int32_t k = 0; k < dims; ++k) {
            *w++ = ',';
            w = write_i64(w, row[k]);
        }
    }
    offsets[n] = w - out;
    return w - out;
}

// ---------------------------------------------------------------------------
// Wire-body row serializer (serve/bodystore.py): the JSON points array and
// the format=csv line block the serving plane preserializes at publish time.
// Byte parity contract: mode 0 must equal json.dumps(points.tolist()) and
// mode 1 must equal "\n".join(wire.format_tuple_line(i, row)) — both reduce
// to CPython's float.__repr__, the shortest decimal string that round-trips
// to the double (each float32 widened to double first, exactly like
// tolist()/float()). glibc's printf is correctly rounded at any precision,
// so the minimal round-tripping "%.*e" precision (found by binary search —
// round-tripping is monotone in digit count) yields the same digit string
// as CPython's dtoa; only the presentation (fixed vs scientific, ".0"
// suffix, two-digit exponents) differs, and that is reformatted below under
// CPython's rules. A bits-keyed memo table makes steady-state publishes
// cheap: skyline rows mostly survive each merge, so the same float32 values
// recur version after version.

#include <cstdio>
#include <mutex>

namespace {

std::mutex g_repr_mutex;  // ctypes drops the GIL; the memo table needs one

struct ReprEnt {
    uint32_t bits;
    uint8_t len;  // 0 = empty slot (a real repr is never empty)
    char s[27];   // max: '-' + 17 digits + punctuation/exponent <= 25
};
ReprEnt g_repr_cache[1 << 16];

bool roundtrips(double v, int prec, char* buf) {
    snprintf(buf, 40, "%.*e", prec - 1, v);
    return strtod(buf, nullptr) == v;
}

// Positive finite v -> CPython repr; returns bytes written (no NUL).
int repr_positive(double v, char* out) {
    char buf[48];
    int lo = 1, hi = 17;
    while (lo < hi) {  // minimal digit count whose conversion round-trips
        const int mid = (lo + hi) / 2;
        if (roundtrips(v, mid, buf)) hi = mid; else lo = mid + 1;
    }
    snprintf(buf, sizeof buf, "%.*e", lo - 1, v);
    char digits[20];
    int k = 0;
    const char* p = buf;
    digits[k++] = *p++;
    if (*p == '.') {
        ++p;
        while (*p != 'e') digits[k++] = *p++;
    }
    while (*p != 'e') ++p;
    const int e10 = atoi(p + 1);
    // CPython float_repr: fixed notation for -4 <= e10 < 16, else
    // scientific with a sign and a >=2-digit exponent
    int n = 0;
    if (-4 <= e10 && e10 < 16) {
        if (e10 >= k - 1) {
            for (int i = 0; i < k; ++i) out[n++] = digits[i];
            for (int i = 0; i < e10 - (k - 1); ++i) out[n++] = '0';
            out[n++] = '.';
            out[n++] = '0';
        } else if (e10 >= 0) {
            for (int i = 0; i <= e10; ++i) out[n++] = digits[i];
            out[n++] = '.';
            for (int i = e10 + 1; i < k; ++i) out[n++] = digits[i];
        } else {
            out[n++] = '0';
            out[n++] = '.';
            for (int i = 0; i < -e10 - 1; ++i) out[n++] = '0';
            for (int i = 0; i < k; ++i) out[n++] = digits[i];
        }
    } else {
        out[n++] = digits[0];
        if (k > 1) {
            out[n++] = '.';
            for (int i = 1; i < k; ++i) out[n++] = digits[i];
        }
        out[n++] = 'e';
        int ae = e10;
        if (e10 >= 0) {
            out[n++] = '+';
        } else {
            out[n++] = '-';
            ae = -e10;
        }
        if (ae >= 100) {
            out[n++] = static_cast<char>('0' + ae / 100);
            ae %= 100;
        }
        out[n++] = static_cast<char>('0' + ae / 10);
        out[n++] = static_cast<char>('0' + ae % 10);
    }
    return n;
}

// One float32 -> its wire text. JSON spells non-finites the json.dumps way
// (NaN/Infinity); CSV spells them the str(float()) way (nan/inf).
int fmt_value(float f, char* w, bool json) {
    const double v = static_cast<double>(f);
    if (std::isnan(v)) {
        const char* s = json ? "NaN" : "nan";
        const int n = json ? 3 : 3;
        memcpy(w, s, n);
        return n;
    }
    if (std::isinf(v)) {
        const char* s = json ? (std::signbit(v) ? "-Infinity" : "Infinity")
                             : (std::signbit(v) ? "-inf" : "inf");
        const int n = static_cast<int>(strlen(s));
        memcpy(w, s, n);
        return n;
    }
    uint32_t bits;
    memcpy(&bits, &f, 4);
    ReprEnt& e = g_repr_cache[(bits * 2654435761u) >> 16];
    if (e.len && e.bits == bits) {
        memcpy(w, e.s, e.len);
        return e.len;
    }
    char* p = w;
    if (std::signbit(v)) *p++ = '-';
    if (f == 0.0f) {
        p[0] = '0';
        p[1] = '.';
        p[2] = '0';
        p += 3;
    } else {
        p += repr_positive(std::signbit(v) ? -v : v, p);
    }
    const int n = static_cast<int>(p - w);
    e.bits = bits;
    e.len = static_cast<uint8_t>(n);
    memcpy(e.s, w, n);
    return n;
}

}  // namespace

// Serialize a (k, d) float32 row block into one wire body. mode 0: the JSON
// points array `[[a, b], [c, d]]` with json.dumps' default ", " separators;
// mode 1: format=csv lines `i,v1,...,vd` joined by '\n' (ids are the row
// enumeration, matching the serve handler). Returns bytes written, or -1 if
// out_cap would be exceeded (callers size at ~30 bytes/field and fall back
// to Python formatting on -1).
extern "C" int64_t sky_format_rows(const float* vals, int64_t k, int32_t d,
                                   int32_t mode, char* out, int64_t out_cap) {
    std::lock_guard<std::mutex> guard(g_repr_mutex);
    char* w = out;
    const char* end = out + out_cap;
    if (mode == 0) {
        if (end - w < 2) return -1;
        *w++ = '[';
        for (int64_t i = 0; i < k; ++i) {
            if (end - w < 4) return -1;
            if (i) {
                *w++ = ',';
                *w++ = ' ';
            }
            *w++ = '[';
            const float* row = vals + i * d;
            for (int32_t j = 0; j < d; ++j) {
                if (end - w < 32) return -1;
                if (j) {
                    *w++ = ',';
                    *w++ = ' ';
                }
                w += fmt_value(row[j], w, true);
            }
            if (end - w < 2) return -1;
            *w++ = ']';
        }
        *w++ = ']';
    } else {
        for (int64_t i = 0; i < k; ++i) {
            if (end - w < 24) return -1;
            if (i) *w++ = '\n';
            w = write_i64(w, i);
            const float* row = vals + i * d;
            for (int32_t j = 0; j < d; ++j) {
                if (end - w < 32) return -1;
                *w++ = ',';
                w += fmt_value(row[j], w, false);
            }
        }
    }
    return w - out;
}
