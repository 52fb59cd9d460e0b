// A Zstandard decoder (RFC 8878 frames) for TIFF strips and tiles
// compressed with libtiff's ZSTD codec: skippable frames skipped; raw, RLE
// and compressed blocks; literals raw, RLE or Huffman-coded (1 or 4
// streams, the tree given or repeated); sequences with predefined, RLE,
// FSE-compressed and repeated tables, and the three repeat offsets. The
// content checksum is skipped; dictionaries are not supported.
//
// C interface:
//   zstd_decode(src, n, dst, cap) -> bytes written, or -1 on damaged data
//   (the message in zstd_last_error).
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

struct Huffman {
    int max_bits = 0;
    std::vector<uint8_t> sym, bits;
    bool ready = false;
    void build(const std::vector<uint8_t>& w) {
        uint32_t total = 0;
        for (uint8_t x : w) {
            if (x > 11) throw Bad("bad Huffman weight");
            if (x) total += 1u << (x - 1);
        }
        if (total == 0) throw Bad("bad Huffman weights");
        max_bits = highbit(total) + 1;
        uint32_t rest = (1u << max_bits) - total;
        if (rest & (rest - 1)) throw Bad("bad Huffman weights");
        std::vector<uint8_t> all = w;
        all.push_back((uint8_t)(highbit(rest) + 1));
        if (max_bits > 11) throw Bad("Huffman codes too long");
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
        for (;;) {
            if (w.size() >= 255) throw Bad("too many Huffman weights");
            w.push_back(t.sym[s1]);
            s1 = t.base[s1] + bs.read(t.bits[s1]);
            if (bs.off < 0) { w.push_back(t.sym[s2]); break; }
            w.push_back(t.sym[s2]);
            s2 = t.base[s2] + bs.read(t.bits[s2]);
            if (bs.off < 0) { w.push_back(t.sym[s1]); break; }
        }
        build(w);
        return 1 + head;
    }
    void stream(const uint8_t* p, size_t n, uint8_t* out, size_t count) {
        Backward bs(p, n);
        uint32_t mask = (1u << max_bits) - 1;
        uint32_t state = bs.read(max_bits);
        for (size_t i = 0; i < count; i++) {
            out[i] = sym[state];
            int b = bits[state];
            state = ((state << b) + bs.read(b)) & mask;
        }
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
    uint8_t* p;
    size_t cap, n = 0;
    size_t frame_start = 0;
    void put(const uint8_t* s, size_t k) {
        if (n + k > cap) throw Bad("output larger than expected");
        std::memcpy(p + n, s, k);
        n += k;
    }
    void fill(uint8_t v, size_t k) {
        if (n + k > cap) throw Bad("output larger than expected");
        std::memset(p + n, v, k);
        n += k;
    }
    void match(size_t off, size_t len) {
        if (off == 0 || off > n - frame_start) throw Bad("match offset too far");
        if (n + len > cap) throw Bad("output larger than expected");
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
    if (type == 2) {
        size_t used = f.huf.read(q, qn);
        q += used;
        qn -= used;
    } else if (!f.huf.ready) {
        throw Bad("treeless literals without a tree");
    }
    lit.assign(regen, 0);
    if (streams == 1) {
        f.huf.stream(q, qn, lit.data(), regen);
    } else {
        if (qn < 6) throw Bad("truncated jump table");
        size_t s1 = q[0] | (q[1] << 8), s2 = q[2] | (q[3] << 8),
               s3 = q[4] | (q[5] << 8);
        if (6 + s1 + s2 + s3 > qn) throw Bad("bad jump table");
        size_t s4 = qn - 6 - s1 - s2 - s3;
        size_t each = (regen + 3) / 4;
        if (each * 3 > regen) throw Bad("bad literal count");
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
    out.put(lit.data() + lp, lit.size() - lp);
}

size_t frame(const uint8_t* p, size_t n, Out& out) {
    uint32_t magic = p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        if (n < 8) throw Bad("truncated skippable frame");
        uint32_t size = p[4] | (p[5] << 8) | (p[6] << 16) | ((uint32_t)p[7] << 24);
        if (8 + (size_t)size > n) throw Bad("truncated skippable frame");
        return 8 + size;
    }
    if (magic != 0xFD2FB528u) throw Bad("not a Zstandard frame");
    size_t pos = 4;
    if (pos >= n) throw Bad("truncated frame header");
    uint8_t d = p[pos++];
    int fcs_flag = d >> 6, single = (d >> 5) & 1, checksum = (d >> 2) & 1,
        dict = d & 3;
    if (d & 8) throw Bad("reserved frame header bit");
    if (!single) pos++;                               // window descriptor
    static const int dsize[4] = {0, 1, 2, 4};
    uint32_t dict_id = 0;
    for (int i = 0; i < dsize[dict]; i++) {
        if (pos >= n) throw Bad("truncated frame header");
        dict_id |= (uint32_t)p[pos++] << (8 * i);
    }
    if (dict_id) throw Bad("Zstandard dictionaries are not supported");
    static const int fsize[4] = {0, 2, 4, 8};
    pos += fcs_flag == 0 ? (single ? 1 : 0) : fsize[fcs_flag];
    if (pos > n) throw Bad("truncated frame header");
    Frame f;
    out.frame_start = out.n;
    for (;;) {
        if (pos + 3 > n) throw Bad("truncated block header");
        uint32_t h = p[pos] | (p[pos + 1] << 8) | (p[pos + 2] << 16);
        pos += 3;
        int last = h & 1, type = (h >> 1) & 3;
        size_t size = h >> 3;
        if (type == 1) {
            if (pos + 1 > n) throw Bad("truncated RLE block");
            out.fill(p[pos], size);
            pos += 1;
        } else {
            if (pos + size > n) throw Bad("truncated block");
            if (type == 0) out.put(p + pos, size);
            else if (type == 2) block(f, p + pos, size, out);
            else throw Bad("reserved block type");
            pos += size;
        }
        if (last) break;
    }
    if (checksum) {
        if (pos + 4 > n) throw Bad("truncated checksum");
        pos += 4;
    }
    return pos;
}

}  // namespace

extern "C" {

const char* zstd_last_error() { return g_err.c_str(); }

long long zstd_decode(const uint8_t* src, long long n, uint8_t* dst,
                      long long cap) {
    try {
        Out out{dst, (size_t)cap};
        size_t pos = 0;
        if (n < 4) throw Bad("not a Zstandard frame");
        while (pos + 4 <= (size_t)n)
            pos += frame(src + pos, (size_t)n - pos, out);
        return (long long)out.n;
    } catch (const Bad& e) {
        g_err = e.what();
        return -1;
    } catch (const std::bad_alloc&) {
        g_err = "out of memory";
        return -1;
    }
}

}  // extern "C"
