// A Zstandard decoder (RFC 8878 frames) for TIFF strips and tiles
// compressed with libtiff's ZSTD codec, which reads one frame through
// libzstd's streaming decoder into the strip buffer: raw, RLE and
// compressed blocks; literals raw, RLE or Huffman-coded (1 or 4 streams,
// the tree given or repeated); sequences with predefined, RLE,
// FSE-compressed and repeated tables, and the three repeat offsets; the
// content size and XXH64 checksum checked where libzstd checks them;
// dictionaries are not supported. Damaged or cut data gives what the
// streaming decoder had written when it stopped or failed (see frame()).
//
// C interface:
//   zstd_decode(src, n, dst, cap, partial) -> bytes written (at most cap),
//   or -1 where libzstd reports an error (the message in zstd_last_error;
//   *partial the bytes its streaming decoder had handed over by then, none
//   where it decoded in one pass).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

std::string g_err;

struct Bad : std::runtime_error {
    using std::runtime_error::runtime_error;
};

inline int highbit(uint32_t v) {
    int n = -1;
    while (v) { v >>= 1; n++; }
    return n;
}

// a forward little-endian bit reader (FSE table descriptions)
struct Forward {
    const uint8_t* p;
    size_t n;
    size_t bit = 0;
    uint32_t read(int k) {
        uint32_t v = 0;
        for (int i = 0; i < k; i++, bit++) {
            if ((bit >> 3) >= n) throw Bad("FSE header overruns its data");
            v |= ((p[bit >> 3] >> (bit & 7)) & 1u) << i;
        }
        return v;
    }
    size_t bytes() const { return (bit + 7) >> 3; }
};

// a backward bit stream: read from its end, past the padding's 1 bit;
// bits before its start read as 0
struct Backward {
    const uint8_t* p;
    int64_t off;               // bits left
    Backward(const uint8_t* s, size_t n) : p(s) {
        if (n == 0 || s[n - 1] == 0) throw Bad("bad bit stream padding");
        off = (int64_t)n * 8 - (8 - highbit(s[n - 1]));
    }
    uint32_t read(int k) {
        if (k == 0) return 0;
        off -= k;
        uint32_t v = 0;
        for (int i = 0; i < k; i++) {
            int64_t b = off + i;
            if (b >= 0) v |= ((p[b >> 3] >> (b & 7)) & 1u) << i;
        }
        return v;
    }
};

struct FSE {
    int log = 0;
    std::vector<uint8_t> sym, bits;
    std::vector<uint16_t> base;
    void build(const std::vector<int16_t>& norm, int al) {
        size_t size = (size_t)1 << al;
        log = al;
        sym.assign(size, 0);
        bits.assign(size, 0);
        base.assign(size, 0);
        std::vector<uint16_t> next(norm.size(), 0);
        size_t high = size;
        for (size_t s = 0; s < norm.size(); s++)
            if (norm[s] == -1) { sym[--high] = (uint8_t)s; next[s] = 1; }
        size_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
        for (size_t s = 0; s < norm.size(); s++) {
            if (norm[s] <= 0) continue;
            next[s] = norm[s];
            for (int i = 0; i < norm[s]; i++) {
                sym[pos] = (uint8_t)s;
                do { pos = (pos + step) & mask; } while (pos >= high);
            }
        }
        if (pos != 0) throw Bad("bad FSE distribution");
        for (size_t i = 0; i < size; i++) {
            uint16_t d = next[sym[i]]++;
            bits[i] = (uint8_t)(al - highbit(d));
            base[i] = (uint16_t)(((uint32_t)d << bits[i]) - size);
        }
    }
    void rle(uint8_t s) {
        log = 0;
        sym.assign(1, s);
        bits.assign(1, 0);
        base.assign(1, 0);
    }
    // a table description; returns the bytes it took
    size_t read(const uint8_t* p, size_t n, int max_log, int max_sym) {
        Forward in{p, n};
        int al = (int)in.read(4) + 5;
        if (al > max_log) throw Bad("FSE accuracy too large");
        int32_t remaining = 1 << al;
        std::vector<int16_t> norm;
        while (remaining > 0 && (int)norm.size() <= max_sym) {
            int nb = highbit((uint32_t)remaining + 1) + 1;
            uint32_t val = in.read(nb);
            uint32_t lower = (1u << (nb - 1)) - 1;
            uint32_t thresh = (1u << nb) - 1 - ((uint32_t)remaining + 1);
            if ((val & lower) < thresh) {
                in.bit--;
                val &= lower;
            } else if (val > lower) {
                val -= thresh;
            }
            int16_t prob = (int16_t)val - 1;
            remaining -= prob < 0 ? -prob : prob;
            norm.push_back(prob);
            if (prob == 0) {
                uint32_t rep = in.read(2);
                for (;;) {
                    for (uint32_t i = 0; i < rep; i++) norm.push_back(0);
                    if (rep != 3) break;
                    rep = in.read(2);
                }
            }
        }
        if (remaining != 0 || (int)norm.size() > max_sym + 1)
            throw Bad("bad FSE table description");
        build(norm, al);
        return in.bytes();
    }
};

// libzstd's BIT_DStream_t: a 64-bit container over the 8 bytes at ptr,
// read from its top; lookFast wraps its shift as the C code does, which
// decides the symbols read past a stream's start
struct ZBits {
    const uint8_t* start;
    const uint8_t* ptr;
    uint64_t c = 0;
    unsigned bc = 0;
    bool overflow = false;
    static uint64_t le64(const uint8_t* q) { uint64_t v; std::memcpy(&v, q, 8); return v; }
    ZBits(const uint8_t* s, size_t n) : start(s), ptr(s) {
        if (n == 0 || s[n - 1] == 0) throw Bad("bad bit stream padding");
        if (n >= 8) {
            ptr = s + n - 8;
            c = le64(ptr);
        } else {
            for (size_t i = 0; i < n; i++) c |= (uint64_t)s[i] << (8 * i);
            bc = (unsigned)(8 - n) * 8;
        }
        bc += 8 - (unsigned)highbit(s[n - 1]);
    }
    void reload() {
        if (bc > 64) { overflow = true; return; }
        if (ptr >= start + 8) {
            ptr -= bc >> 3;
            bc &= 7;
            c = le64(ptr);
            return;
        }
        if (ptr == start) return;
        size_t nb = bc >> 3;
        if ((size_t)(ptr - start) < nb) nb = (size_t)(ptr - start);
        ptr -= nb;
        bc -= (unsigned)nb * 8;
        c = le64(ptr);
    }
    // HUF_initRemainingDStream: the state the fast loop hands on, read back
    // as far as the first stream's jump table
    ZBits(const uint8_t* s, const uint8_t* p, unsigned consumed)
        : start(s), ptr(p), c(le64(p)), bc(consumed) {}
    uint32_t look(int nb) const { return (uint32_t)((c << (bc & 63)) >> ((64 - nb) & 63)); }
    bool done() const { return !overflow && ptr == start && bc == 64; }
};

struct Huffman {
    int max_bits = 0;
    int x2 = 0;                 // libzstd's table type: 0 single, 1 double symbol
    std::vector<uint8_t> sym, bits;
    bool ready = false;
    void build(const std::vector<uint8_t>& w) {
        // HUF_readStats
        uint32_t total = 0;
        for (uint8_t x : w) {
            if (x > 12) throw Bad("bad Huffman weight");
            if (x) total += 1u << (x - 1);
        }
        if (total == 0) throw Bad("bad Huffman weights");
        max_bits = highbit(total) + 1;
        if (max_bits > 12) throw Bad("Huffman codes too long");
        uint32_t rest = (1u << max_bits) - total;
        if (rest & (rest - 1)) throw Bad("bad Huffman weights");
        std::vector<uint8_t> all = w;
        all.push_back((uint8_t)(highbit(rest) + 1));
        int ones = 0;
        for (uint8_t x : all) ones += x == 1;
        if (ones < 2 || (ones & 1)) throw Bad("bad Huffman weights");
        std::vector<int> nbits(all.size()), count(max_bits + 2, 0);
        for (size_t i = 0; i < all.size(); i++) {
            nbits[i] = all[i] ? max_bits + 1 - all[i] : 0;
            count[nbits[i]]++;
        }
        size_t size = (size_t)1 << max_bits;
        sym.assign(size, 0);
        bits.assign(size, 0);
        std::vector<uint32_t> rank(max_bits + 2, 0);
        rank[max_bits] = 0;
        for (int b = max_bits; b >= 1; b--) {
            rank[b - 1] = rank[b] + count[b] * (1u << (max_bits - b));
            for (uint32_t i = rank[b]; i < rank[b - 1]; i++) bits[i] = (uint8_t)b;
        }
        for (size_t i = 0; i < all.size(); i++) {
            if (!nbits[i]) continue;
            uint32_t code = rank[nbits[i]], len = 1u << (max_bits - nbits[i]);
            for (uint32_t k = 0; k < len; k++) sym[code + k] = (uint8_t)i;
            rank[nbits[i]] += len;
        }
        ready = true;
    }
    // a tree description; returns the bytes it took
    size_t read(const uint8_t* p, size_t n) {
        if (n < 1) throw Bad("truncated Huffman tree");
        uint8_t head = p[0];
        std::vector<uint8_t> w;
        if (head >= 128) {
            size_t count = head - 127, nb = (count + 1) / 2;
            if (1 + nb > n) throw Bad("truncated Huffman weights");
            for (size_t i = 0; i < count; i++)
                w.push_back(i & 1 ? p[1 + i / 2] & 15 : p[1 + i / 2] >> 4);
            build(w);
            return 1 + nb;
        }
        if (1 + (size_t)head > n) throw Bad("truncated Huffman weights");
        FSE t;
        size_t used = t.read(p + 1, head, 6, 255);
        if (used > head) throw Bad("bad Huffman weights");
        Backward bs(p + 1 + used, head - used);
        uint32_t s1 = bs.read(t.log), s2 = bs.read(t.log);
        // FSE_decompress's tail: at most 255 weights
        for (;;) {
            if (w.size() > 253) throw Bad("too many Huffman weights");
            w.push_back(t.sym[s1]);
            s1 = t.base[s1] + bs.read(t.bits[s1]);
            if (bs.off < 0) { w.push_back(t.sym[s2]); break; }
            if (w.size() > 253) throw Bad("too many Huffman weights");
            w.push_back(t.sym[s2]);
            s2 = t.base[s2] + bs.read(t.bits[s2]);
            if (bs.off < 0) { w.push_back(t.sym[s1]); break; }
        }
        build(w);
        return 1 + head;
    }
    // HUF_selectDecoder: libzstd's choice of the double-symbol decoder for
    // 4-stream literals with a new tree
    static int select(size_t dst, size_t src) {
        static const uint32_t t[16][4] = {
            {0, 0, 1, 1}, {0, 0, 1, 1}, {150, 216, 381, 119},
            {170, 205, 514, 112}, {177, 199, 539, 110}, {197, 194, 644, 107},
            {221, 192, 735, 107}, {256, 189, 881, 106}, {359, 188, 1167, 109},
            {582, 187, 1570, 114}, {688, 187, 1712, 122}, {825, 186, 1965, 136},
            {976, 185, 2131, 150}, {1180, 186, 2070, 175}, {1377, 185, 1731, 202},
            {1412, 185, 1695, 202}};
        const uint32_t q = src >= dst ? 15 : (uint32_t)(src * 16 / dst);
        const uint32_t d256 = (uint32_t)(dst >> 8);
        const uint32_t t0 = t[q][0] + t[q][1] * d256;
        uint32_t t1 = t[q][2] + t[q][3] * d256;
        t1 += t1 >> 5;
        return t1 < t0;
    }
    int dlog() const { return max_bits > 11 ? max_bits : 11; }
    int min_bits() const {
        int m = max_bits;
        for (uint8_t b : bits) m = b && b < m ? b : m;
        return m;
    }
    // a double-symbol table entry at window v: the first symbol, and a
    // second where its whole code fits in the rest of the window
    void entry(uint32_t v, int minb, int& len, int& nb, uint8_t* o) const {
        const int dl = dlog(), shift = dl - max_bits;
        const uint32_t i1 = v >> shift;
        const int l1 = bits[i1];
        o[0] = sym[i1];
        len = 1;
        nb = l1;
        const int r = dl - l1;
        if (r < minb) return;
        const uint32_t low = v & ((1u << r) - 1);
        const uint32_t i2 = r >= max_bits ? low >> (r - max_bits)
                                          : low << (max_bits - r);
        if (bits[i2] <= r) {
            o[1] = sym[i2];
            len = 2;
            nb = l1 + bits[i2];
        }
    }
    // HUF_decodeStreamX1 / X2 from state b: `count` symbols; the double
    // symbol decoder's last symbol may take its bits from past the end
    // (its clamp of the bits consumed)
    void tail(ZBits& b, uint8_t* out, size_t count) const {
        const int dl = dlog(), shift = dl - max_bits, minb = min_bits();
        if (!x2) {
            for (size_t i = 0; i < count; i++) {
                b.reload();
                const uint32_t v = b.look(dl) >> shift;
                out[i] = sym[v];
                b.bc += bits[v];
            }
            return;
        }
        size_t i = 0;
        uint8_t two[2];
        int len, nb;
        while (i + 2 <= count) {
            b.reload();
            entry(b.look(dl), minb, len, nb, two);
            out[i] = two[0];
            if (len == 2) out[i + 1] = two[1];
            i += len;
            b.bc += nb;
        }
        if (i < count) {
            b.reload();
            entry(b.look(dl), minb, len, nb, two);
            out[i] = two[0];
            if (len == 1) {
                b.bc += nb;
            } else if (b.bc < 64) {
                b.bc += nb;
                if (b.bc > 64) b.bc = 64;
            }
        }
    }
    // One stream on its own (HUF_decompress1X* and the 4-stream decoder's
    // fallback): its bits must end exactly at its start
    void stream(const uint8_t* p, size_t n, uint8_t* out, size_t count) const {
        ZBits b(p, n);
        tail(b, out, count);
        if (!b.done()) throw Bad("Huffman stream does not end at its start");
    }
    // HUF_decompress4X*_usingDTable_internal_fast: where the table is 11
    // bits deep and each stream holds 8 bytes or more, libzstd decodes the
    // four streams in lock step (5 table lookups a stream a round) reading
    // each back through the bytes before it, then each stream's rest from
    // the state the loop left, and checks only the counts. Returns false
    // where libzstd takes the fallback.
    bool fast4(const uint8_t* q, size_t qn, uint8_t* out, size_t regen) const {
        if (dlog() != 11) return false;
        size_t len[4] = {(size_t)(q[0] | q[1] << 8), (size_t)(q[2] | q[3] << 8),
                         (size_t)(q[4] | q[5] << 8), 0};
        len[3] = qn - 6 - len[0] - len[1] - len[2];
        for (size_t l : len)
            if (l < 8) return false;
        const size_t seg = (regen + 3) / 4;
        if (3 * seg >= regen) return false;
        size_t beg[4], fin[4], op[4], oend[4];
        long long ip[4];
        unsigned cons[4];
        for (int k = 0; k < 4; k++) {
            beg[k] = k ? fin[k - 1] : 6;
            fin[k] = beg[k] + len[k];
            op[k] = k * seg;
            oend[k] = k < 3 ? (k + 1) * seg : regen;
            ip[k] = (long long)fin[k] - 8;
            const uint8_t last = q[fin[k] - 1];
            cons[k] = last ? 8 - highbit(last) : 0;
        }
        const int minb = min_bits();
        for (;;) {
            size_t iters = (size_t)ip[0] / 7;
            size_t olimit;
            if (!x2) {
                iters = std::min(iters, (regen - op[3]) / 5);
            } else {
                for (int k = 0; k < 4; k++) iters = std::min(iters, (oend[k] - op[k]) / 10);
            }
            olimit = op[3] + iters * 5;
            if (op[3] == olimit) break;
            bool crossed = false;
            for (int k = 1; k < 4; k++) crossed = crossed || ip[k] < ip[k - 1];
            if (crossed) break;
            do {
                for (int k = 0; k < 4; k++) {
                    uint64_t w = ZBits::le64(q + ip[k]);
                    for (int j = 0; j < 5; j++) {
                        const uint32_t v = (uint32_t)((w << cons[k]) >> (64 - 11));
                        if (!x2) {
                            out[op[k]++] = sym[v >> (11 - max_bits)];
                            cons[k] += bits[v >> (11 - max_bits)];
                        } else {
                            uint8_t two[2];
                            int l, nb;
                            entry(v, minb, l, nb, two);
                            out[op[k]] = two[0];
                            if (l == 2) out[op[k] + 1] = two[1];
                            op[k] += l;
                            cons[k] += nb;
                        }
                    }
                    ip[k] -= cons[k] >> 3;
                    cons[k] &= 7;
                }
            } while (op[3] < olimit);
        }
        for (int k = 0; k < 4; k++) {
            if (op[k] > oend[k] || ip[k] < (long long)beg[k] - 8)
                throw Bad("Huffman stream overruns its neighbour");
            ZBits b(q, q + ip[k], cons[k]);
            tail(b, out + op[k], oend[k] - op[k]);
        }
        return true;
    }
};

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
                                2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
                                -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18, 20, 22, 24,
    28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
    65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11,
                             12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41, 43, 47,
    51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771,
    65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10,
                             11, 12, 13, 14, 15, 16};

struct Frame {
    Huffman huf;
    FSE ll, of, ml;
    bool ll_set = false, of_set = false, ml_set = false;
    uint32_t rep[3] = {1, 4, 8};
};

struct Out {
    std::vector<uint8_t> buf;
    uint8_t* p = nullptr;
    size_t n = 0;
    size_t frame_start = 0;
    size_t flushed = 0;        // bytes of the blocks finished so far
    bool one_pass = false;     // libzstd decodes into the caller's buffer
    void grow(size_t k) {
        if (n + k > buf.size()) buf.resize((n + k) * 2);
        p = buf.data();
    }
    void put(const uint8_t* s, size_t k) {
        grow(k);
        std::memcpy(p + n, s, k);
        n += k;
    }
    void fill(uint8_t v, size_t k) {
        grow(k);
        std::memset(p + n, v, k);
        n += k;
    }
    void match(size_t off, size_t len) {
        if (off == 0 || off > n - frame_start) throw Bad("match offset too far");
        grow(len);
        for (size_t i = 0; i < len; i++, n++) p[n] = p[n - off];
    }
};

// the literals section: returns the bytes it took
size_t literals(Frame& f, const uint8_t* p, size_t n, std::vector<uint8_t>& lit) {
    if (n < 1) throw Bad("truncated literals");
    int type = p[0] & 3, sf = (p[0] >> 2) & 3;
    if (type <= 1) {
        size_t size, hs;
        if (sf == 0 || sf == 2) { size = p[0] >> 3; hs = 1; }
        else if (sf == 1) {
            if (n < 2) throw Bad("truncated literals");
            size = (p[0] >> 4) + ((size_t)p[1] << 4); hs = 2;
        } else {
            if (n < 3) throw Bad("truncated literals");
            size = (p[0] >> 4) + ((size_t)p[1] << 4) + ((size_t)p[2] << 12);
            hs = 3;
        }
        if (type == 0) {
            if (hs + size > n) throw Bad("truncated raw literals");
            lit.assign(p + hs, p + hs + size);
            return hs + size;
        }
        if (hs + 1 > n) throw Bad("truncated RLE literals");
        lit.assign(size, p[hs]);
        return hs + 1;
    }
    size_t regen, comp, hs;
    int streams = sf == 0 ? 1 : 4;
    uint64_t h = 0;
    hs = sf <= 1 ? 3 : sf == 2 ? 4 : 5;
    if (n < hs) throw Bad("truncated literals header");
    for (size_t i = 0; i < hs; i++) h |= (uint64_t)p[i] << (8 * i);
    int fb = sf <= 1 ? 10 : sf == 2 ? 14 : 18;
    regen = (h >> 4) & ((1u << fb) - 1);
    comp = (h >> (4 + fb)) & ((1u << fb) - 1);
    if (hs + comp > n) throw Bad("truncated compressed literals");
    const uint8_t* q = p + hs;
    size_t qn = comp;
    if (streams == 4 && regen < 6) throw Bad("too few literals for 4 streams");
    if (type == 2) {
        size_t used = f.huf.read(q, qn);
        f.huf.x2 = streams == 4 ? Huffman::select(regen, comp) : 0;
        q += used;
        qn -= used;
    } else if (!f.huf.ready) {
        throw Bad("treeless literals without a tree");
    }
    lit.assign(regen, 0);
    if (streams == 1) {
        f.huf.stream(q, qn, lit.data(), regen);
    } else {
        if (qn < 10) throw Bad("truncated jump table");
        size_t s1 = q[0] | (q[1] << 8), s2 = q[2] | (q[3] << 8),
               s3 = q[4] | (q[5] << 8);
        if (6 + s1 + s2 + s3 > qn) throw Bad("bad jump table");
        size_t s4 = qn - 6 - s1 - s2 - s3;
        size_t each = (regen + 3) / 4;
        if (each * 3 > regen) throw Bad("bad literal count");
        if (f.huf.fast4(q, qn, lit.data(), regen)) return hs + comp;
        const uint8_t* b = q + 6;
        f.huf.stream(b, s1, lit.data(), each);
        f.huf.stream(b + s1, s2, lit.data() + each, each);
        f.huf.stream(b + s1 + s2, s3, lit.data() + 2 * each, each);
        f.huf.stream(b + s1 + s2 + s3, s4, lit.data() + 3 * each,
                     regen - 3 * each);
    }
    return hs + comp;
}

size_t table(FSE& t, bool& set, int mode, const uint8_t* p, size_t n,
             const int16_t* def, int ndef, int def_log, int max_log,
             int max_sym) {
    switch (mode) {
    case 0:
        t.build(std::vector<int16_t>(def, def + ndef), def_log);
        set = true;
        return 0;
    case 1:
        if (n < 1) throw Bad("truncated RLE table");
        if (p[0] > max_sym) throw Bad("bad RLE symbol");
        t.rle(p[0]);
        set = true;
        return 1;
    case 2: {
        size_t used = t.read(p, n, max_log, max_sym);
        set = true;
        return used;
    }
    default:
        if (!set) throw Bad("repeated table without a table");
        return 0;
    }
}

void block(Frame& f, const uint8_t* p, size_t n, Out& out) {
    std::vector<uint8_t> lit;
    size_t pos = literals(f, p, n, lit);
    if (pos >= n) {
        if (pos > n) throw Bad("truncated block");
        out.put(lit.data(), lit.size());
        return;
    }
    uint32_t nseq = p[pos];
    if (nseq == 0) {
        pos += 1;
    } else if (nseq < 128) {
        pos += 1;
    } else if (nseq < 255) {
        if (pos + 2 > n) throw Bad("truncated sequences");
        nseq = ((nseq - 128) << 8) + p[pos + 1];
        pos += 2;
    } else {
        if (pos + 3 > n) throw Bad("truncated sequences");
        nseq = p[pos + 1] + (p[pos + 2] << 8) + 0x7F00;
        pos += 3;
    }
    if (nseq == 0) {
        out.put(lit.data(), lit.size());
        return;
    }
    if (pos >= n) throw Bad("truncated sequences");
    uint8_t modes = p[pos++];
    if (modes & 3) throw Bad("reserved sequence bits");
    pos += table(f.ll, f.ll_set, modes >> 6, p + pos, n - pos, kLLDefault, 36,
                 6, 9, 35);
    pos += table(f.of, f.of_set, (modes >> 4) & 3, p + pos, n - pos,
                 kOFDefault, 29, 5, 8, 31);
    pos += table(f.ml, f.ml_set, (modes >> 2) & 3, p + pos, n - pos,
                 kMLDefault, 53, 6, 9, 52);
    if (pos > n) throw Bad("truncated sequence tables");
    Backward bs(p + pos, n - pos);
    uint32_t sl = bs.read(f.ll.log), so = bs.read(f.of.log),
             sm = bs.read(f.ml.log);
    size_t lp = 0;
    for (uint32_t i = 0; i < nseq; i++) {
        uint32_t oc = f.of.sym[so], mc = f.ml.sym[sm], lc = f.ll.sym[sl];
        if (lc > 35 || mc > 52 || oc > 31) throw Bad("bad sequence code");
        uint32_t ofv = (1u << oc) + bs.read(oc);
        uint32_t ml = kMLBase[mc] + bs.read(kMLBits[mc]);
        uint32_t ll = kLLBase[lc] + bs.read(kLLBits[lc]);
        uint32_t off;
        if (ofv > 3) {
            off = ofv - 3;
            f.rep[2] = f.rep[1]; f.rep[1] = f.rep[0]; f.rep[0] = off;
        } else {
            uint32_t k = ofv + (ll == 0 ? 1 : 0);
            if (k == 1) {
                off = f.rep[0];
            } else if (k == 2) {
                off = f.rep[1];
                f.rep[1] = f.rep[0]; f.rep[0] = off;
            } else if (k == 3) {
                off = f.rep[2];
                f.rep[2] = f.rep[1]; f.rep[1] = f.rep[0]; f.rep[0] = off;
            } else {
                off = f.rep[0] - 1;
                if (off == 0) throw Bad("zero offset");
                f.rep[2] = f.rep[1]; f.rep[1] = f.rep[0]; f.rep[0] = off;
            }
        }
        if (lp + ll > lit.size()) throw Bad("literals overrun");
        out.put(lit.data() + lp, ll);
        lp += ll;
        out.match(off, ml);
        if (i + 1 < nseq) {
            sl = f.ll.base[sl] + bs.read(f.ll.bits[sl]);
            sm = f.ml.base[sm] + bs.read(f.ml.bits[sm]);
            so = f.of.base[so] + bs.read(f.of.bits[so]);
        }
    }
    if (bs.off != 0) throw Bad("sequence bit stream not at its end");
    out.put(lit.data() + lp, lit.size() - lp);
}

// XXH64 of a buffer, seed 0 (the frame's content checksum is its low 32
// bits)
uint64_t xxh64(const uint8_t* p, size_t n) {
    const uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
                   P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
                   P5 = 0x27D4EB2F165667C5ULL;
    auto rotl = [](uint64_t x, int r) { return (x << r) | (x >> (64 - r)); };
    auto rd64 = [](const uint8_t* q) { uint64_t v; std::memcpy(&v, q, 8); return v; };
    auto rd32 = [](const uint8_t* q) { uint32_t v; std::memcpy(&v, q, 4); return v; };
    auto round = [&](uint64_t acc, uint64_t lane) {
        return rotl(acc + lane * P2, 31) * P1;
    };
    const uint8_t* e = p + n;
    uint64_t h;
    if (n >= 32) {
        uint64_t v[4] = {P1 + P2, P2, 0, 0 - P1};
        for (; p + 32 <= e; p += 32)
            for (int i = 0; i < 4; ++i) v[i] = round(v[i], rd64(p + 8 * i));
        h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18);
        for (int i = 0; i < 4; ++i) h = (h ^ round(0, v[i])) * P1 + P4;
    } else {
        h = P5;
    }
    h += n;
    for (; p + 8 <= e; p += 8) h = rotl(h ^ round(0, rd64(p)), 27) * P1 + P4;
    if (p + 4 <= e) {
        h = rotl(h ^ (rd32(p) * P1), 23) * P2 + P3;
        p += 4;
    }
    for (; p < e; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    return h ^ (h >> 32);
}

// The first frame of p as libtiff's ZSTDDecode reads it: ZSTD_decompressStream
// called until the frame ends, the input is used up or the strip buffer
// (cap bytes) is full. A compressed block is decoded once all of it has
// arrived, a raw block as far as its bytes go; the decoder goes on to the
// next block (or the checksum) when a block's output ends exactly at the
// buffer's end, and stops when it runs past it. Where the frame header
// names its content size, the buffer can hold it and the whole frame is
// present, libzstd decodes in one pass instead (and fails where the
// content outgrows the buffer). Returns quietly where libzstd waits for
// input or output space; throws Bad where it reports an error.
void frame(const uint8_t* p, size_t n, Out& out, size_t cap) {
    if (n < 4) return;
    uint32_t magic = p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) return;   // a skippable frame
    if (magic != 0xFD2FB528u) throw Bad("not a Zstandard frame");
    if (n < 5) return;
    uint8_t d = p[4];
    int fcs_flag = d >> 6, single = (d >> 5) & 1, checksum = (d >> 2) & 1,
        dict = d & 3;
    static const int dsize[4] = {0, 1, 2, 4};
    static const int fsize[4] = {0, 2, 4, 8};
    const int fcs_bytes = fcs_flag == 0 ? (single ? 1 : 0) : fsize[fcs_flag];
    size_t pos = 5 + (single ? 0 : 1) + dsize[dict] + fcs_bytes;
    if (pos > n) return;
    if (d & 8) throw Bad("reserved frame header bit");
    uint64_t window = 0;
    if (!single) {
        const int wlog = 10 + (p[5] >> 3);
        window = ((uint64_t)1 << wlog) + (((uint64_t)1 << wlog) >> 3) * (p[5] & 7);
    }
    size_t q = 5 + (single ? 0 : 1);
    uint32_t dict_id = 0;
    for (int i = 0; i < dsize[dict]; i++) dict_id |= (uint32_t)p[q++] << (8 * i);
    uint64_t fcs = 0;
    for (int i = 0; i < fcs_bytes; i++) fcs |= (uint64_t)p[q++] << (8 * i);
    if (fcs_flag == 1) fcs += 256;
    const bool has_fcs = fcs_flag != 0 || single;
    if (single) window = fcs;
    if (dict_id) throw Bad("Zstandard dictionaries are not supported");
    if (window > ((uint64_t)1 << 27) + 1) throw Bad("frame window too large");
    const size_t block_max = window < 131072 ? (size_t)window : 131072;
    // ZSTD_findFrameCompressedSize: the one-pass shortcut wants the whole
    // frame
    bool whole = false;
    if (has_fcs && fcs <= cap) {
        size_t r = pos;
        for (;;) {
            if (r + 3 > n) break;
            uint32_t h = p[r] | (p[r + 1] << 8) | (p[r + 2] << 16);
            int type = (h >> 1) & 3;
            if (type == 3) break;
            r += 3 + (type == 1 ? 1 : (h >> 3));
            if (h & 1) {
                whole = r + (checksum ? 4 : 0) <= n;
                break;
            }
        }
    }
    Frame f;
    out.frame_start = out.n;
    out.one_pass = whole;
    for (;;) {
        if (pos + 3 > n) return;
        uint32_t h = p[pos] | (p[pos + 1] << 8) | (p[pos + 2] << 16);
        pos += 3;
        int last = h & 1, type = (h >> 1) & 3;
        size_t size = h >> 3;
        if (type == 3) throw Bad("reserved block type");
        if (size > block_max) throw Bad("block larger than the window");
        if (type == 1) {
            if (pos + 1 > n) return;
            out.fill(p[pos], size);
            pos += 1;
        } else if (type == 0) {
            const size_t k = pos + size > n ? n - pos : size;
            out.put(p + pos, k);
            out.flushed = out.n;
            if (k < size) return;
            pos += size;
        } else {
            if (pos + size > n) return;
            block(f, p + pos, size, out);
            pos += size;
        }
        // libzstd checks the content size as it ends the last block, before
        // its streaming decoder hands that block over
        if (last && has_fcs && out.n - out.frame_start != fcs)
            throw Bad("content size differs from the frame header's");
        out.flushed = out.n;
        if (whole && out.n > cap) throw Bad("content larger than the buffer");
        if (last) break;
        if (!whole && out.n > cap) return;
    }
    if (has_fcs && out.n - out.frame_start != fcs)
        throw Bad("content size differs from the frame header's");
    if (!whole && out.n > cap) return;
    if (checksum) {
        if (pos + 4 > n) return;
        const uint32_t want = p[pos] | (p[pos + 1] << 8) | (p[pos + 2] << 16) |
                              ((uint32_t)p[pos + 3] << 24);
        if ((uint32_t)xxh64(out.p + out.frame_start, out.n - out.frame_start) !=
            want)
            throw Bad("content checksum differs");
    }
}

}  // namespace

extern "C" {

const char* zstd_last_error() { return g_err.c_str(); }

long long zstd_decode(const uint8_t* src, long long n, uint8_t* dst,
                      long long cap, long long* partial) {
    Out out;
    try {
        frame(src, (size_t)n, out, (size_t)cap);
        const size_t k = out.n < (size_t)cap ? out.n : (size_t)cap;
        if (k) std::memcpy(dst, out.p, k);
        return (long long)k;
    } catch (const Bad& e) {
        g_err = e.what();
    } catch (const std::bad_alloc&) {
        g_err = "out of memory";
    }
    // what the streaming decoder had handed over when it failed: every
    // block before the failing one (a raw block as far as it went). In one
    // pass libzstd reports no output at all, so libtiff, which zeroes its
    // buffer past the output position on an error, keeps none of it
    const size_t k = out.one_pass ? 0
                     : out.flushed < (size_t)cap ? out.flushed : (size_t)cap;
    if (k) std::memcpy(dst, out.p, k);
    *partial = (long long)k;
    return -1;
}

}  // extern "C"
