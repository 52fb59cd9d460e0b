// JPEG 2000 codestream decoder (ISO/IEC 15444-1), written to give what
// OpenJPEG 2.5.4 gives to PIL 12's tile-by-tile decode at full resolution
// with every layer: the integer 5/3 and the float 9/7 inverse wavelets in
// OpenJPEG's operation order (its band scaling by K and 2/K' first, then
// the four lifting steps, each as w + (left + right) * c; the file is built
// with -ffp-contract=off so that no FMA changes a bit), RCT and ICT, the
// DC level shift with lrintf rounding of the float path, and the clamp to
// the component's precision.
//
// Codestream: SIZ, COD/COC, QCD/QCC, RGN, POC, PPM/PPT, SOT/SOD/EOC across
// tiles and tile-parts (TLM, PLM, PLT, CRG, COM and unknown markers are
// skipped); tier 2 with tag trees, SOP and EPH, the five progression orders
// and POC changes (OpenJPEG's packet iterator, a packet taken once); tier 1
// with the MQ decoder and the code-block styles BYPASS, RESET, TERMALL,
// VCAUSAL, PTERM and SEGSYM. High-throughput (HT) code-blocks are refused
// as unsupported.
//
// C interface (errors: 1 damaged, as OpenJPEG's strict mode fails; 2 a
// codestream the port does not decode; the message in j2k_last_error):
//   j2k_header(data, n, out, cap): out = x0, y0, x1, y1, ncomp, XTOsiz,
//       YTOsiz, XTsiz, YTsiz, then per component dx, dy, prec, sgnd.
//   j2k_decode(data, n, planes, done): every component's samples on its
//       own grid (width ceil(x1/dx) - ceil(x0/dx)), int32, concatenated;
//       done[t] = 1 for each tile whose data the codestream holds (the rest
//       are left untouched, as PIL leaves them).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

std::string g_err;

struct Bad : std::runtime_error {
    int code;
    Bad(const std::string& m, int c = 1) : std::runtime_error(m), code(c) {}
};

inline uint32_t ceildiv(uint32_t a, uint32_t b) {
    return (uint32_t)(((uint64_t)a + b - 1) / b);
}
inline int64_t ceildivpow2(int64_t a, int b) {
    return (a + ((int64_t)1 << b) - 1) >> b;
}
inline int64_t floordivpow2(int64_t a, int b) { return a >> b; }

// ------------------------------------------------------------ parameters

constexpr int kMaxRes = 33;
constexpr int kMaxBands = 3 * kMaxRes - 2;

struct TCCP {
    int csty = 0;             // precincts defined
    int numres = 1;
    int cblkw = 6, cblkh = 6;  // exponents
    int cblksty = 0;
    int qmfbid = 0;
    int prcw[kMaxRes], prch[kMaxRes];
    int qntsty = 0, numgbits = 0;
    int expn[kMaxBands], mant[kMaxBands];
    int roishift = 0;
    TCCP() {
        for (int i = 0; i < kMaxRes; i++) prcw[i] = prch[i] = 15;
        std::memset(expn, 0, sizeof expn);
        std::memset(mant, 0, sizeof mant);
    }
};

struct Poc {
    uint32_t resno0, compno0, layno1, resno1, compno1, prg;
};

struct TCP {
    int csty = 0, prg = 0, numlayers = 1, mct = 0;
    bool cod = false;
    std::vector<TCCP> tccps;
    std::vector<Poc> pocs;
    bool ppt = false;
    std::vector<std::vector<uint8_t>> ppt_parts;  // by Zppt
    std::vector<uint8_t> data;                     // SOD bodies, in order
    bool has_data = false;
    int parts_seen = 0, parts_total = 0;
};

struct Comp {
    uint32_t dx, dy, prec, sgnd;
};

struct Image {
    uint32_t x0, y0, x1, y1, tx0, ty0, tdx, tdy, numx, numy;
    std::vector<Comp> comps;
};

struct Cursor {
    const uint8_t* p;
    size_t n, pos = 0;
    uint32_t u8() {
        if (pos + 1 > n) throw Bad("marker segment too short");
        return p[pos++];
    }
    uint32_t u16() {
        if (pos + 2 > n) throw Bad("marker segment too short");
        uint32_t v = (p[pos] << 8) | p[pos + 1];
        pos += 2;
        return v;
    }
    uint32_t u32() {
        if (pos + 4 > n) throw Bad("marker segment too short");
        uint32_t v = ((uint32_t)p[pos] << 24) | (p[pos + 1] << 16) |
                     (p[pos + 2] << 8) | p[pos + 3];
        pos += 4;
        return v;
    }
    size_t left() const { return n - pos; }
};

// SPcod / SPcoc into one component's parameters
void read_spcod(Cursor& c, TCCP& t) {
    t.numres = c.u8() + 1;
    if (t.numres > kMaxRes) throw Bad("invalid number of resolutions");
    t.cblkw = c.u8() + 2;
    t.cblkh = c.u8() + 2;
    if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12)
        throw Bad("invalid code-block size");
    t.cblksty = c.u8();
    if (t.cblksty & 0x80) throw Bad("mixed HT code-blocks");
    if (t.cblksty & 0x40)
        throw Bad("high-throughput (HT) code-blocks are not decoded by the "
                  "port", 2);
    t.qmfbid = c.u8();
    if (t.qmfbid > 1) throw Bad("invalid wavelet transform");
    if (t.csty & 1) {
        if (c.left() < (size_t)t.numres) throw Bad("truncated precinct sizes");
        for (int i = 0; i < t.numres; i++) {
            uint32_t v = c.u8();
            if (i != 0 && ((v & 0xf) == 0 || (v >> 4) == 0))
                throw Bad("invalid precinct size");
            t.prcw[i] = v & 0xf;
            t.prch[i] = v >> 4;
        }
    } else {
        for (int i = 0; i < t.numres; i++) t.prcw[i] = t.prch[i] = 15;
    }
}

void read_sqcd(Cursor& c, TCCP& t, size_t size) {
    if (size < 1) throw Bad("truncated quantisation");
    uint32_t s = c.u8();
    size -= 1;
    t.qntsty = s & 0x1f;
    t.numgbits = s >> 5;
    uint32_t nb;
    if (t.qntsty == 1) {
        nb = 1;
    } else {
        nb = t.qntsty == 0 ? (uint32_t)size : (uint32_t)size / 2;
    }
    if (t.qntsty == 0) {
        for (uint32_t b = 0; b < nb; b++) {
            uint32_t v = c.u8();
            if (b < (uint32_t)kMaxBands) { t.expn[b] = v >> 3; t.mant[b] = 0; }
        }
    } else {
        for (uint32_t b = 0; b < nb; b++) {
            uint32_t v = c.u16();
            if (b < (uint32_t)kMaxBands) {
                t.expn[b] = v >> 11;
                t.mant[b] = v & 0x7ff;
            }
        }
    }
    if (t.qntsty == 1) {
        for (int b = 1; b < kMaxBands; b++) {
            int e = t.expn[0] - (b - 1) / 3;
            t.expn[b] = e > 0 ? e : 0;
            t.mant[b] = t.mant[0];
        }
    }
}

// ------------------------------------------------------------ codestream

struct Codestream {
    Image img;
    TCP def;
    std::vector<TCP> tiles;
    std::vector<int> order;       // tiles in order of their first tile-part
    bool ppm = false;
    std::vector<std::vector<uint8_t>> ppm_parts;  // by Zppm
    std::vector<uint8_t> ppm_data;
    size_t ppm_pos = 0;
};

void read_siz(Cursor& c, Image& im) {
    c.u16();                                   // Rsiz
    im.x1 = c.u32(); im.y1 = c.u32();
    im.x0 = c.u32(); im.y0 = c.u32();
    im.tdx = c.u32(); im.tdy = c.u32();
    im.tx0 = c.u32(); im.ty0 = c.u32();
    uint32_t nc = c.u16();
    if (im.x0 >= im.x1 || im.y0 >= im.y1)
        throw Bad("image size is invalid");
    if (im.tdx == 0 || im.tdy == 0) throw Bad("invalid tile size");
    if (nc == 0 || nc > 16384) throw Bad("invalid number of components");
    if (im.tx0 > im.x0 || im.ty0 > im.y0 ||
        (uint64_t)im.tx0 + im.tdx <= im.x0 ||
        (uint64_t)im.ty0 + im.tdy <= im.y0)
        throw Bad("tile origin is invalid");
    if (c.left() < 3 * nc) throw Bad("SIZ too short");
    im.comps.resize(nc);
    for (auto& cp : im.comps) {
        uint32_t s = c.u8();
        cp.prec = (s & 0x7f) + 1;
        cp.sgnd = s >> 7;
        cp.dx = c.u8();
        cp.dy = c.u8();
        if (cp.dx == 0 || cp.dy == 0) throw Bad("invalid subsampling");
        if (cp.prec > 31) throw Bad("precision above 31 bits", 2);
    }
    im.numx = ceildiv(im.x1 - im.tx0, im.tdx);
    im.numy = ceildiv(im.y1 - im.ty0, im.tdy);
    if ((uint64_t)im.numx * im.numy > 65535) throw Bad("too many tiles");
}

// A marker segment of the main or a tile-part header into `tcp`.
void read_marker(Codestream& cs, TCP& tcp, uint32_t m, Cursor& c, bool main) {
    const uint32_t nc = (uint32_t)cs.img.comps.size();
    auto comp_no = [&]() { return nc <= 256 ? c.u8() : c.u16(); };
    switch (m) {
    case 0xFF52: {                                   // COD
        if (tcp.cod) throw Bad("more than one COD marker");
        tcp.cod = true;
        tcp.csty = c.u8();
        if (tcp.csty & ~7u) throw Bad("unknown Scod value");
        tcp.prg = c.u8();
        if (tcp.prg > 4) throw Bad("unknown progression order", 1);
        tcp.numlayers = c.u16();
        if (tcp.numlayers < 1) throw Bad("invalid number of layers");
        tcp.mct = c.u8();
        if (tcp.mct > 1) throw Bad("invalid multiple component transform");
        TCCP t = tcp.tccps[0];
        t.csty = tcp.csty & 1;
        read_spcod(c, t);
        if (c.left()) throw Bad("error reading COD");
        for (auto& x : tcp.tccps) {
            x.csty = t.csty; x.numres = t.numres; x.cblkw = t.cblkw;
            x.cblkh = t.cblkh; x.cblksty = t.cblksty; x.qmfbid = t.qmfbid;
            std::memcpy(x.prcw, t.prcw, sizeof t.prcw);
            std::memcpy(x.prch, t.prch, sizeof t.prch);
        }
        break;
    }
    case 0xFF53: {                                   // COC
        uint32_t k = comp_no();
        if (k >= nc) throw Bad("invalid COC component");
        TCCP& t = tcp.tccps[k];
        t.csty = c.u8();
        read_spcod(c, t);
        if (c.left()) throw Bad("error reading COC");
        break;
    }
    case 0xFF5C: {                                   // QCD
        TCCP t;
        read_sqcd(c, t, c.left());
        if (c.left()) throw Bad("error reading QCD");
        for (auto& x : tcp.tccps) {
            x.qntsty = t.qntsty; x.numgbits = t.numgbits;
            std::memcpy(x.expn, t.expn, sizeof t.expn);
            std::memcpy(x.mant, t.mant, sizeof t.mant);
        }
        break;
    }
    case 0xFF5D: {                                   // QCC
        uint32_t k = comp_no();
        if (k >= nc) throw Bad("invalid QCC component");
        read_sqcd(c, tcp.tccps[k], c.left());
        if (c.left()) throw Bad("error reading QCC");
        break;
    }
    case 0xFF5E: {                                   // RGN
        uint32_t k = comp_no();
        c.u8();                                      // Srgn
        if (k >= nc) throw Bad("invalid RGN component");
        tcp.tccps[k].roishift = c.u8();
        break;
    }
    case 0xFF5F: {                                   // POC
        size_t room = nc <= 256 ? 1 : 2;
        size_t per = 5 + 2 * room;
        if (c.left() < per || c.left() % per) throw Bad("error reading POC");
        size_t n = c.left() / per;
        for (size_t i = 0; i < n; i++) {
            Poc p;
            p.resno0 = c.u8();
            p.compno0 = comp_no();
            p.layno1 = std::min<uint32_t>(c.u16(), tcp.numlayers);
            p.resno1 = c.u8();
            p.compno1 = comp_no();
            p.prg = c.u8();
            p.compno1 = std::min(p.compno1, nc);
            tcp.pocs.push_back(p);
        }
        break;
    }
    case 0xFF60: {                                   // PPM
        if (!main) throw Bad("PPM in a tile-part header");
        uint32_t z = c.u8();
        if (cs.ppm_parts.size() <= z) cs.ppm_parts.resize(z + 1);
        cs.ppm_parts[z].assign(c.p + c.pos, c.p + c.n);
        cs.ppm = true;
        break;
    }
    case 0xFF61: {                                   // PPT
        if (main) throw Bad("PPT in the main header");
        uint32_t z = c.u8();
        if (tcp.ppt_parts.size() <= z) tcp.ppt_parts.resize(z + 1);
        tcp.ppt_parts[z].assign(c.p + c.pos, c.p + c.n);
        tcp.ppt = true;
        break;
    }
    default:                                          // TLM, PLM, PLT, CRG,
        break;                                        // COM and the rest
    }
}

// PPM: the Ippm of every Nppm, in order, as one stream of packet headers
void merge_ppm(Codestream& cs) {
    std::vector<uint8_t> all;
    for (auto& p : cs.ppm_parts) all.insert(all.end(), p.begin(), p.end());
    size_t i = 0;
    while (i + 4 <= all.size()) {
        uint32_t n = ((uint32_t)all[i] << 24) | (all[i + 1] << 16) |
                     (all[i + 2] << 8) | all[i + 3];
        i += 4;
        if (n > all.size() - i) throw Bad("corrupted PPM marker");
        cs.ppm_data.insert(cs.ppm_data.end(), all.begin() + i,
                           all.begin() + i + n);
        i += n;
    }
    if (i != all.size()) throw Bad("corrupted PPM marker");
}

// OpenJPEG's marker table: the headers each known marker may stand in
// (1 main header, 2 tile-part header, 4 SIZ's place); 0 for unknown
enum { MH = 1, TPH = 2, MHSIZ = 4 };
int marker_states(uint32_t m) {
    switch (m) {
    case 0xFF90: return MH | TPH;                   // SOT
    case 0xFF52: case 0xFF53: case 0xFF5E: case 0xFF5C: case 0xFF5D:
    case 0xFF5F: case 0xFF64: case 0xFF74: case 0xFF75: case 0xFF77:
        return MH | TPH;                            // COD ... MCO
    case 0xFF51: return MHSIZ;                      // SIZ
    case 0xFF55: case 0xFF57: case 0xFF60: case 0xFF63: case 0xFF78:
    case 0xFF50: case 0xFF59:
        return MH;                                  // TLM PLM PPM CRG CBD CAP CPF
    case 0xFF58: case 0xFF61: return TPH;           // PLT PPT
    case 0xFF91: return 8;                          // SOP: no header's
    default: return 0;
    }
}

void parse(const uint8_t* d, size_t n, Codestream& cs, bool header_only) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0x4F) throw Bad("no SOC marker");
    size_t pos = 2;
    auto marker = [&]() -> uint32_t {
        if (pos + 2 > n) throw Bad("stream too short");
        uint32_t m = (d[pos] << 8) | d[pos + 1];
        pos += 2;
        return m;
    };
    // an unknown marker: OpenJPEG reads on two bytes at a time to the next
    // marker it knows, which must belong to the header it is in
    auto known = [&](uint32_t m, int state) -> uint32_t {
        while (!marker_states(m) && !(state == TPH && m == 0xFF93)) {
            do {
                if (pos + 2 > n) throw Bad("stream too short");
                m = (d[pos] << 8) | d[pos + 1];
                pos += 2;
            } while (m < 0xFF00);
        }
        if (m != 0xFF93 && !(marker_states(m) & state))
            throw Bad("marker is not compliant with its position");
        return m;
    };
    auto segment = [&]() -> Cursor {
        if (pos + 2 > n) throw Bad("stream too short");
        uint32_t len = (d[pos] << 8) | d[pos + 1];
        if (len < 2 || pos + len > n) throw Bad("marker segment too long");
        Cursor c{d + pos + 2, (size_t)len - 2};
        pos += len;
        return c;
    };
    uint32_t m = marker();
    if (m != 0xFF51) throw Bad("expected a SIZ marker");
    {
        Cursor c = segment();
        read_siz(c, cs.img);
    }
    cs.def.tccps.assign(cs.img.comps.size(), TCCP());
    bool cod = false, qcd = false;
    for (;;) {
        m = marker();
        if (m < 0xFF00) throw Bad("expected a marker");
        m = known(m, MH);
        if (m == 0xFF90) break;                      // SOT
        Cursor c = segment();
        if (m == 0xFF52) cod = true;
        if (m == 0xFF5C) qcd = true;
        read_marker(cs, cs.def, m, c, true);
    }
    if (!cod) throw Bad("main header has no COD");
    if (!qcd) throw Bad("main header has no QCD");
    if (cs.ppm) merge_ppm(cs);
    if (header_only) return;
    const uint32_t nt = cs.img.numx * cs.img.numy;
    cs.tiles.assign(nt, TCP());
    std::vector<bool> started(nt, false);
    // m == SOT here; a stream that ends right after a marker ends the
    // codestream there (OpenJPEG's "no EOC" state), with the tiles read
    if (pos == n) return;
    for (;;) {
        size_t sot = pos - 2;
        Cursor c = segment();
        if (c.n != 8) throw Bad("error reading SOT marker");
        uint32_t tile = c.u16(), psot = c.u32(), tpsot = c.u8(),
                 tnsot = c.u8();
        if (tile >= nt) throw Bad("invalid tile number");
        if (psot != 0 && psot < 14 && psot != 12)
            throw Bad("Psot value is not correct");
        if (tnsot && tpsot >= tnsot) throw Bad("TPsot is not valid");
        TCP& tcp = cs.tiles[tile];
        if (!started[tile]) {
            started[tile] = true;
            tcp = cs.def;
            tcp.cod = false;
            tcp.ppt = false;
            tcp.ppt_parts.clear();
            cs.order.push_back((int)tile);
        }
        if (tnsot) {
            if (tcp.parts_total && tpsot >= (uint32_t)tcp.parts_total)
                throw Bad("TPsot is not valid for the tile's tile-parts");
            tcp.parts_total = tnsot;
        }
        for (;;) {
            m = marker();
            if (m < 0xFF00) throw Bad("expected a marker");
            m = known(m, TPH);
            if (m == 0xFF93) break;                  // SOD
            if (m == 0xFF90) throw Bad("SOT inside a tile-part header");
            Cursor h = segment();
            read_marker(cs, tcp, m, h, false);
        }
        size_t end;
        if (psot == 0) {
            if (n < pos + 2) throw Bad("stream too short");
            end = n - 2;                             // all but the EOC
        } else {
            if (sot + psot < pos) throw Bad("invalid Psot");
            end = sot + psot;
            if (end > n)
                throw Bad("tile part length inconsistent with stream length");
        }
        tcp.data.insert(tcp.data.end(), d + pos, d + end);
        tcp.has_data = true;
        tcp.parts_seen++;
        pos = end;
        m = marker();                                // "stream too short"
        if (m == 0xFFD9) break;
        if (m != 0xFF90) throw Bad("expected an SOT marker");
        if (pos == n) {
            // OpenJPEG decodes a tile whose tile-parts are missing, then
            // fails on the header of the next
            if (!tcp.parts_total || tcp.parts_seen < tcp.parts_total)
                throw Bad("the stream ends inside a tile");
            break;
        }
    }
}

// ------------------------------------------------------------ bit reader

struct Bio {
    const uint8_t* bp;
    const uint8_t* end;
    const uint8_t* start;
    uint32_t buf = 0, ct = 0;
    Bio(const uint8_t* p, size_t n) : bp(p), end(p + n), start(p) {}
    void bytein() {
        buf = (buf << 8) & 0xffff;
        ct = buf == 0xff00 ? 7 : 8;
        if (bp < end) buf |= *bp++;
    }
    uint32_t bit() {
        if (ct == 0) bytein();
        ct--;
        return (buf >> ct) & 1;
    }
    uint32_t read(int n) {
        uint32_t v = 0;
        for (int i = n - 1; i >= 0; i--) v |= bit() << i;
        return v;
    }
    void inalign() {
        if ((buf & 0xff) == 0xff) bytein();
        ct = 0;
    }
    size_t numbytes() const { return bp - start; }
};

// ------------------------------------------------------------ tag tree

struct TagTree {
    struct Node { int parent, value, low; };
    std::vector<Node> nodes;
    int nleaves = 0;
    void build(int w, int h) {
        nodes.clear();
        nleaves = w * h;
        if (!nleaves) return;
        std::vector<int> lw{w}, lh{h};
        while (lw.back() > 1 || lh.back() > 1) {
            lw.push_back((lw.back() + 1) / 2);
            lh.push_back((lh.back() + 1) / 2);
        }
        std::vector<int> base;
        int total = 0;
        for (size_t l = 0; l < lw.size(); l++) {
            base.push_back(total);
            total += lw[l] * lh[l];
        }
        nodes.assign(total, Node{-1, 999, 0});
        for (size_t l = 0; l + 1 < lw.size(); l++)
            for (int j = 0; j < lh[l]; j++)
                for (int i = 0; i < lw[l]; i++)
                    nodes[base[l] + j * lw[l] + i].parent =
                        base[l + 1] + (j / 2) * lw[l + 1] + i / 2;
    }
    void reset() {
        for (auto& n : nodes) { n.value = 999; n.low = 0; }
    }
    int decode(Bio& bio, int leaf, int threshold) {
        int stk[64], sp = 0;
        int node = leaf;
        while (nodes[node].parent >= 0) {
            stk[sp++] = node;
            node = nodes[node].parent;
        }
        int low = 0;
        for (;;) {
            Node& nd = nodes[node];
            if (low > nd.low) nd.low = low; else low = nd.low;
            while (low < threshold && low < nd.value) {
                if (bio.bit()) nd.value = low; else ++low;
            }
            nd.low = low;
            if (sp == 0) break;
            node = stk[--sp];
        }
        return nodes[node].value < threshold ? 1 : 0;
    }
};

// ------------------------------------------------------------ tile layout

struct Seg { uint32_t len = 0, numpasses = 0, maxpasses = 0, newlen = 0,
             numnewpasses = 0; };

struct Cblk {
    int x0, y0, x1, y1;
    uint32_t numbps = 0, numlenbits = 0, numnewpasses = 0;
    std::vector<Seg> segs;
    uint32_t numsegs = 0;
    std::vector<uint8_t> data;                 // its chunks, in order
};

struct Precinct {
    int x0, y0, x1, y1;
    int cw = 0, ch = 0;
    std::vector<Cblk> cblks;
    TagTree incl, imsb;
};

struct Band {
    int bandno, x0, y0, x1, y1;
    int numbps;
    float stepsize;
    std::vector<Precinct> precincts;
    bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Resolution {
    int x0, y0, x1, y1;
    int pdx, pdy;
    uint32_t pw, ph;
    int numbands;
    Band bands[3];
};

struct TileComp {
    int x0, y0, x1, y1;
    int numres;
    std::vector<Resolution> res;
    std::vector<int32_t> data;      // int or float bits
};

void init_tilecomp(TileComp& tc, const TCCP& tccp, const Comp& comp,
                   int tx0, int ty0, int tx1, int ty1) {
    tc.x0 = (int)ceildiv(tx0, comp.dx);
    tc.y0 = (int)ceildiv(ty0, comp.dy);
    tc.x1 = (int)ceildiv(tx1, comp.dx);
    tc.y1 = (int)ceildiv(ty1, comp.dy);
    tc.numres = tccp.numres;
    tc.res.resize(tc.numres);
    tc.data.assign((size_t)(tc.x1 - tc.x0) * (tc.y1 - tc.y0), 0);
    for (int r = 0; r < tc.numres; r++) {
        Resolution& R = tc.res[r];
        int level = tc.numres - 1 - r;
        R.x0 = (int)ceildivpow2(tc.x0, level);
        R.y0 = (int)ceildivpow2(tc.y0, level);
        R.x1 = (int)ceildivpow2(tc.x1, level);
        R.y1 = (int)ceildivpow2(tc.y1, level);
        R.pdx = tccp.prcw[r];
        R.pdy = tccp.prch[r];
        int64_t tlx = floordivpow2(R.x0, R.pdx) << R.pdx;
        int64_t tly = floordivpow2(R.y0, R.pdy) << R.pdy;
        int64_t brx = ceildivpow2(R.x1, R.pdx) << R.pdx;
        int64_t bry = ceildivpow2(R.y1, R.pdy) << R.pdy;
        R.pw = R.x0 == R.x1 ? 0 : (uint32_t)((brx - tlx) >> R.pdx);
        R.ph = R.y0 == R.y1 ? 0 : (uint32_t)((bry - tly) >> R.pdy);
        if ((uint64_t)R.pw * R.ph > (1u << 24)) throw Bad("too many precincts");
        int64_t cbgx, cbgy;
        int cbgw, cbgh;
        if (r == 0) {
            cbgx = tlx; cbgy = tly; cbgw = R.pdx; cbgh = R.pdy;
            R.numbands = 1;
        } else {
            cbgx = ceildivpow2(tlx, 1); cbgy = ceildivpow2(tly, 1);
            cbgw = R.pdx - 1; cbgh = R.pdy - 1;
            R.numbands = 3;
        }
        int cbw = std::min(tccp.cblkw, cbgw), cbh = std::min(tccp.cblkh, cbgh);
        for (int b = 0; b < R.numbands; b++) {
            Band& B = R.bands[b];
            B.bandno = r == 0 ? 0 : b + 1;
            if (B.bandno == 0) {
                B.x0 = (int)ceildivpow2(tc.x0, level);
                B.y0 = (int)ceildivpow2(tc.y0, level);
                B.x1 = (int)ceildivpow2(tc.x1, level);
                B.y1 = (int)ceildivpow2(tc.y1, level);
            } else {
                int xob = B.bandno & 1, yob = B.bandno >> 1;
                B.x0 = (int)ceildivpow2((int64_t)tc.x0 - ((int64_t)xob << level), level + 1);
                B.y0 = (int)ceildivpow2((int64_t)tc.y0 - ((int64_t)yob << level), level + 1);
                B.x1 = (int)ceildivpow2((int64_t)tc.x1 - ((int64_t)xob << level), level + 1);
                B.y1 = (int)ceildivpow2((int64_t)tc.y1 - ((int64_t)yob << level), level + 1);
            }
            int sb = r == 0 ? 0 : 3 * (r - 1) + 1 + b;
            B.numbps = tccp.expn[sb] + tccp.numgbits - 1;
            {
                int gain = 0;   // the decoder's gain for the 9/7 (2/K' scaling)
                if (tccp.qmfbid == 1) gain = B.bandno == 0 ? 0 : B.bandno == 3 ? 2 : 1;
                int rb = (int)comp.prec + gain;
                B.stepsize = (float)((1.0 + tccp.mant[sb] / 2048.0) *
                                     std::pow(2.0, (double)(rb - tccp.expn[sb])));
            }
            B.precincts.assign((size_t)R.pw * R.ph, Precinct());
            for (uint32_t p = 0; p < R.pw * R.ph; p++) {
                Precinct& P = B.precincts[p];
                int64_t sx = cbgx + (int64_t)(p % R.pw) * ((int64_t)1 << cbgw);
                int64_t sy = cbgy + (int64_t)(p / R.pw) * ((int64_t)1 << cbgh);
                int64_t ex = sx + ((int64_t)1 << cbgw), ey = sy + ((int64_t)1 << cbgh);
                P.x0 = (int)std::max<int64_t>(sx, B.x0);
                P.y0 = (int)std::max<int64_t>(sy, B.y0);
                P.x1 = (int)std::min<int64_t>(ex, B.x1);
                P.y1 = (int)std::min<int64_t>(ey, B.y1);
                int64_t tcx = floordivpow2(P.x0, cbw) << cbw;
                int64_t tcy = floordivpow2(P.y0, cbh) << cbh;
                int64_t bcx = ceildivpow2(P.x1, cbw) << cbw;
                int64_t bcy = ceildivpow2(P.y1, cbh) << cbh;
                P.cw = (int)std::max<int64_t>(0, (bcx - tcx) >> cbw);
                P.ch = (int)std::max<int64_t>(0, (bcy - tcy) >> cbh);
                if (B.empty()) { P.cw = P.ch = 0; }
                P.cblks.resize((size_t)P.cw * P.ch);
                for (int k = 0; k < P.cw * P.ch; k++) {
                    Cblk& C = P.cblks[k];
                    int64_t cx = tcx + (int64_t)(k % P.cw) * (1 << cbw);
                    int64_t cy = tcy + (int64_t)(k / P.cw) * (1 << cbh);
                    C.x0 = (int)std::max<int64_t>(cx, P.x0);
                    C.y0 = (int)std::max<int64_t>(cy, P.y0);
                    C.x1 = (int)std::min<int64_t>(cx + (1 << cbw), P.x1);
                    C.y1 = (int)std::min<int64_t>(cy + (1 << cbh), P.y1);
                }
                P.incl.build(P.cw, P.ch);
                P.imsb.build(P.cw, P.ch);
            }
        }
    }
}

// ------------------------------------------------------------ packets

struct PacketIter {
    // OpenJPEG's pi: one of these a progression (the COD's, or each POC's);
    // layers and precincts always start at 0
    uint32_t resno0, compno0, layno1, resno1, compno1, prg;
};

struct TileDec {
    const Image* img;
    TCP* tcp;
    std::vector<TileComp>* tcs;
    int tx0, ty0, tx1, ty1;
    const uint8_t* data;
    size_t len, pos = 0;
    // packet headers outside the body (PPM or PPT)
    std::vector<uint8_t>* hdr = nullptr;
    size_t* hdr_pos = nullptr;
};

void init_seg(Cblk& c, uint32_t index, int cblksty, bool first) {
    if (c.segs.size() <= index) c.segs.resize(index + 1);
    Seg& s = c.segs[index];
    s = Seg();
    if (cblksty & 4) {
        s.maxpasses = 1;
    } else if (cblksty & 1) {
        if (first) {
            s.maxpasses = 10;
        } else {
            uint32_t prev = c.segs[index - 1].maxpasses;
            s.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
        }
    } else {
        s.maxpasses = 109;
    }
}

uint32_t getnumpasses(Bio& bio) {
    if (!bio.read(1)) return 1;
    if (!bio.read(1)) return 2;
    uint32_t n = bio.read(2);
    if (n != 3) return 3 + n;
    n = bio.read(5);
    if (n != 31) return 6 + n;
    return 37 + bio.read(7);
}

uint32_t getcommacode(Bio& bio) {
    uint32_t n = 0;
    while (bio.read(1)) ++n;
    return n;
}

inline int floorlog2(uint32_t a) {
    int l = 0;
    while (a > 1) { a >>= 1; ++l; }
    return l;
}

void read_packet(TileDec& td, uint32_t compno, uint32_t resno,
                 uint32_t precno, uint32_t layno) {
    TileComp& tc = (*td.tcs)[compno];
    Resolution& R = tc.res[resno];
    const TCCP& tccp = td.tcp->tccps[compno];
    const uint8_t* body = td.data;
    size_t& cur = td.pos;
    if (layno == 0) {
        for (int b = 0; b < R.numbands; b++) {
            Band& B = R.bands[b];
            if (B.empty()) continue;
            if (precno >= B.precincts.size()) throw Bad("invalid precinct");
            Precinct& P = B.precincts[precno];
            P.incl.reset();
            P.imsb.reset();
            for (auto& C : P.cblks) {
                C.numsegs = 0;
                C.segs.clear();
                C.data.clear();
            }
        }
    }
    // SOP
    if (td.tcp->csty & 2) {
        if (td.len - cur >= 6 && body[cur] == 0xFF && body[cur + 1] == 0x91)
            cur += 6;
    }
    const uint8_t* hp;
    size_t hlen;
    bool inband = td.hdr == nullptr;
    if (inband) {
        hp = body + cur;
        hlen = td.len - cur;
    } else {
        hp = td.hdr->data() + *td.hdr_pos;
        hlen = td.hdr->size() - *td.hdr_pos;
    }
    Bio bio(hp, hlen);
    auto finish_header = [&]() {
        bio.inalign();
        size_t used = bio.numbytes();
        if (td.tcp->csty & 4) {
            if (hlen - used >= 2 && hp[used] == 0xFF && hp[used + 1] == 0x92)
                used += 2;
        }
        if (inband) cur += used; else *td.hdr_pos += used;
    };
    if (!bio.read(1)) {
        finish_header();
        return;
    }
    for (int b = 0; b < R.numbands; b++) {
        Band& B = R.bands[b];
        if (B.empty()) continue;
        Precinct& P = B.precincts[precno];
        for (int k = 0; k < P.cw * P.ch; k++) {
            Cblk& C = P.cblks[k];
            uint32_t included;
            if (!C.numsegs)
                included = P.incl.decode(bio, k, (int)layno + 1);
            else
                included = bio.read(1);
            if (!included) { C.numnewpasses = 0; continue; }
            if (!C.numsegs) {
                int i = 0;
                while (!P.imsb.decode(bio, k, i)) ++i;
                C.numbps = (uint32_t)(B.numbps + 1 - i);
                C.numlenbits = 3;
            }
            C.numnewpasses = getnumpasses(bio);
            C.numlenbits += getcommacode(bio);
            uint32_t segno = 0;
            if (!C.numsegs) {
                init_seg(C, 0, tccp.cblksty, true);
            } else {
                segno = C.numsegs - 1;
                if (C.segs[segno].numpasses == C.segs[segno].maxpasses) {
                    ++segno;
                    init_seg(C, segno, tccp.cblksty, false);
                }
            }
            int32_t n = (int32_t)C.numnewpasses;
            do {
                Seg& s = C.segs[segno];
                s.numnewpasses = (uint32_t)std::min<int64_t>(
                    (int64_t)s.maxpasses - s.numpasses, n);
                uint32_t bits = C.numlenbits + floorlog2(s.numnewpasses);
                if (bits > 32) throw Bad("invalid bit number in a packet header");
                s.newlen = bio.read((int)bits);
                n -= (int32_t)s.numnewpasses;
                if (n > 0) {
                    ++segno;
                    init_seg(C, segno, tccp.cblksty, false);
                }
            } while (n > 0);
        }
    }
    finish_header();
    // the body
    for (int b = 0; b < R.numbands; b++) {
        Band& B = R.bands[b];
        if (B.empty()) continue;
        Precinct& P = B.precincts[precno];
        for (auto& C : P.cblks) {
            if (!C.numnewpasses) continue;
            uint32_t segi;
            if (!C.numsegs) {
                segi = 0;
                C.numsegs = 1;
            } else {
                segi = C.numsegs - 1;
                if (C.segs[segi].numpasses == C.segs[segi].maxpasses) {
                    ++segi;
                    ++C.numsegs;
                }
            }
            do {
                Seg& s = C.segs[segi];
                if ((size_t)s.newlen > td.len - cur)
                    throw Bad("segment too long for its code-block");
                C.data.insert(C.data.end(), body + cur, body + cur + s.newlen);
                cur += s.newlen;
                s.len += s.newlen;
                s.numpasses += s.numnewpasses;
                C.numnewpasses -= s.numnewpasses;
                if (C.numnewpasses > 0) {
                    ++segi;
                    ++C.numsegs;
                }
            } while (C.numnewpasses > 0);
        }
    }
}

// OpenJPEG's packet iterator (pi.c) over one progression
void iterate(TileDec& td, const PacketIter& poc, std::vector<uint8_t>& include,
             uint32_t step_l, uint32_t step_r, uint32_t step_c,
             uint32_t step_p) {
    auto& tcs = *td.tcs;
    const auto& comps = td.img->comps;
    uint32_t numcomps = (uint32_t)comps.size();
    if (poc.compno0 >= numcomps || poc.compno1 > numcomps)
        throw Bad("invalid POC component range");
    auto emit = [&](uint32_t l, uint32_t r, uint32_t c, uint32_t p) {
        size_t index = (size_t)l * step_l + (size_t)r * step_r +
                       (size_t)c * step_c + (size_t)p * step_p;
        if (index >= include.size()) throw Bad("invalid access to pi->include");
        if (include[index]) return;
        include[index] = 1;
        read_packet(td, c, r, p, l);
    };
    auto lr = [&](bool layer_first) {
        uint32_t a0 = layer_first ? 0 : poc.resno0;
        uint32_t a1 = layer_first ? poc.layno1 : poc.resno1;
        uint32_t b0 = layer_first ? poc.resno0 : 0;
        uint32_t b1 = layer_first ? poc.resno1 : poc.layno1;
        for (uint32_t a = a0; a < a1; a++)
            for (uint32_t b = b0; b < b1; b++) {
                uint32_t l = layer_first ? a : b, r = layer_first ? b : a;
                for (uint32_t c = poc.compno0; c < poc.compno1; c++) {
                    TileComp& tc = tcs[c];
                    if (r >= (uint32_t)tc.numres) continue;
                    Resolution& R = tc.res[r];
                    uint32_t p1 = R.pw * R.ph;
                    for (uint32_t p = 0; p < p1; p++) emit(l, r, c, p);
                }
            }
    };
    // the position orders: dx, dy over the components in `cset`
    auto steps = [&](uint32_t c0, uint32_t c1, uint32_t& dx, uint32_t& dy) {
        dx = dy = 0;
        for (uint32_t c = c0; c < c1; c++) {
            TileComp& tc = tcs[c];
            for (int r = 0; r < tc.numres; r++) {
                Resolution& R = tc.res[r];
                uint32_t sh = R.pdx + tc.numres - 1 - r;
                if (sh < 32 && comps[c].dx <= UINT32_MAX / (1u << sh)) {
                    uint32_t v = comps[c].dx * (1u << sh);
                    dx = !dx ? v : std::min(dx, v);
                }
                sh = R.pdy + tc.numres - 1 - r;
                if (sh < 32 && comps[c].dy <= UINT32_MAX / (1u << sh)) {
                    uint32_t v = comps[c].dy * (1u << sh);
                    dy = !dy ? v : std::min(dy, v);
                }
            }
        }
        if (dx == 0 || dy == 0) throw Bad("invalid precinct steps");
    };
    // (x, y, c, r) -> precinct, or -1 when no precinct starts there
    auto at = [&](uint32_t x, uint32_t y, uint32_t c, uint32_t r) -> int64_t {
        TileComp& tc = tcs[c];
        if (r >= (uint32_t)tc.numres) return -1;
        Resolution& R = tc.res[r];
        uint32_t levelno = tc.numres - 1 - r;
        uint64_t cdx = comps[c].dx, cdy = comps[c].dy;
        if (levelno >= 32 || ((cdx << levelno) >> levelno) != cdx ||
            ((cdy << levelno) >> levelno) != cdy)
            return -1;
        if ((cdx << levelno) > INT32_MAX || (cdy << levelno) > INT32_MAX)
            return -1;
        uint32_t trx0 = ceildiv(td.tx0, (uint32_t)(cdx << levelno));
        uint32_t try0 = ceildiv(td.ty0, (uint32_t)(cdy << levelno));
        uint32_t trx1 = ceildiv(td.tx1, (uint32_t)(cdx << levelno));
        uint32_t try1 = ceildiv(td.ty1, (uint32_t)(cdy << levelno));
        uint32_t rpx = R.pdx + levelno, rpy = R.pdy + levelno;
        if (rpx >= 31 || ((cdx << rpx) >> rpx) != cdx || rpy >= 31 ||
            ((cdy << rpy) >> rpy) != cdy)
            return -1;
        if (!(((uint64_t)y % (cdy << rpy) == 0) ||
              (y == (uint32_t)td.ty0 &&
               (((uint64_t)try0 << levelno) % ((uint64_t)1 << rpy)))))
            return -1;
        if (!(((uint64_t)x % (cdx << rpx) == 0) ||
              (x == (uint32_t)td.tx0 &&
               (((uint64_t)trx0 << levelno) % ((uint64_t)1 << rpx)))))
            return -1;
        if (R.pw == 0 || R.ph == 0) return -1;
        if (trx0 == trx1 || try0 == try1) return -1;
        uint32_t prci = (ceildiv(x, (uint32_t)(cdx << levelno)) >> R.pdx) -
                        (trx0 >> R.pdx);
        uint32_t prcj = (ceildiv(y, (uint32_t)(cdy << levelno)) >> R.pdy) -
                        (try0 >> R.pdy);
        return (int64_t)prci + (int64_t)prcj * R.pw;
    };
    auto layers = [&](uint32_t x, uint32_t y, uint32_t c, uint32_t r) {
        int64_t p = at(x, y, c, r);
        if (p < 0) return;
        for (uint32_t l = 0; l < poc.layno1; l++)
            emit(l, r, c, (uint32_t)p);
    };
    uint32_t tx0 = td.tx0, ty0 = td.ty0, tx1 = td.tx1, ty1 = td.ty1;
    switch (poc.prg) {
    case 0: lr(true); break;                          // LRCP
    case 1: lr(false); break;                         // RLCP
    case 2: {                                         // RPCL
        uint32_t dx, dy;
        steps(0, numcomps, dx, dy);
        for (uint32_t r = poc.resno0; r < poc.resno1; r++)
            for (uint32_t y = ty0; y < ty1; y += dy - (y % dy))
                for (uint32_t x = tx0; x < tx1; x += dx - (x % dx))
                    for (uint32_t c = poc.compno0; c < poc.compno1; c++)
                        layers(x, y, c, r);
        break;
    }
    case 3: {                                         // PCRL
        uint32_t dx, dy;
        steps(0, numcomps, dx, dy);
        for (uint32_t y = ty0; y < ty1; y += dy - (y % dy))
            for (uint32_t x = tx0; x < tx1; x += dx - (x % dx))
                for (uint32_t c = poc.compno0; c < poc.compno1; c++) {
                    uint32_t r1 = std::min(poc.resno1, (uint32_t)tcs[c].numres);
                    for (uint32_t r = poc.resno0; r < r1; r++)
                        layers(x, y, c, r);
                }
        break;
    }
    case 4: {                                         // CPRL
        for (uint32_t c = poc.compno0; c < poc.compno1; c++) {
            uint32_t dx, dy;
            steps(c, c + 1, dx, dy);
            uint32_t r1 = std::min(poc.resno1, (uint32_t)tcs[c].numres);
            for (uint32_t y = ty0; y < ty1; y += dy - (y % dy))
                for (uint32_t x = tx0; x < tx1; x += dx - (x % dx))
                    for (uint32_t r = poc.resno0; r < r1; r++)
                        layers(x, y, c, r);
        }
        break;
    }
    default:
        throw Bad("unknown progression order");
    }
}

// ------------------------------------------------------------ tier 1

const uint16_t kQe[47] = {
    0x5601, 0x3401, 0x1801, 0x0ac1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801,
    0x3801, 0x3001, 0x2401, 0x1c01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801,
    0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201, 0x1c01, 0x1801, 0x1601,
    0x1401, 0x1201, 0x1101, 0x0ac1, 0x09c1, 0x08a1, 0x0521, 0x0441, 0x02a1,
    0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005,
    0x0001, 0x5601};
const uint8_t kNmps[47] = {
    1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38,
    39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t kNlps[47] = {
    1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17,
    18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t kSwitch[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18 };

struct MQ {
    std::vector<uint8_t> buf;     // the segment and two artificial 0xFF
    size_t bp;
    uint32_t a, c, ct;
    uint8_t st[19], mps[19];
    void reset_states() {
        std::memset(st, 0, sizeof st);
        std::memset(mps, 0, sizeof mps);
        st[CTX_UNI] = 46;
        st[CTX_AGG] = 3;
        st[CTX_ZC] = 4;
    }
    void load(const uint8_t* p, size_t n) {
        buf.assign(p, p + n);
        buf.push_back(0xFF);
        buf.push_back(0xFF);
        bp = 0;
    }
    void bytein() {
        uint32_t l = buf[bp + 1];
        if (buf[bp] == 0xFF) {
            if (l > 0x8F) {
                c += 0xFF00;
                ct = 8;
            } else {
                bp++;
                c += l << 9;
                ct = 7;
            }
        } else {
            bp++;
            c += l << 8;
            ct = 8;
        }
    }
    void init(const uint8_t* p, size_t n) {
        load(p, n);
        c = n == 0 ? 0xFFu << 16 : (uint32_t)buf[0] << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void renorm() {
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            ct--;
        } while (a < 0x8000);
    }
    int decode(int cx) {
        uint32_t qe = kQe[st[cx]];
        int d;
        a -= qe;
        if ((c >> 16) < qe) {
            if (a < qe) {
                a = qe;
                d = mps[cx];
                st[cx] = kNmps[st[cx]];
            } else {
                a = qe;
                d = !mps[cx];
                if (kSwitch[st[cx]]) mps[cx] = !mps[cx];
                st[cx] = kNlps[st[cx]];
            }
            renorm();
        } else {
            c -= qe << 16;
            if ((a & 0x8000) == 0) {
                if (a < qe) {
                    d = !mps[cx];
                    if (kSwitch[st[cx]]) mps[cx] = !mps[cx];
                    st[cx] = kNlps[st[cx]];
                } else {
                    d = mps[cx];
                    st[cx] = kNmps[st[cx]];
                }
                renorm();
            } else {
                d = mps[cx];
            }
        }
        return d;
    }
    // raw (bypass) segments
    void raw_init(const uint8_t* p, size_t n) {
        load(p, n);
        c = 0;
        ct = 0;
    }
    int raw() {
        if (ct == 0) {
            if (c == 0xFF) {
                if (buf[bp] > 0x8F) {
                    c = 0xFF;
                    ct = 8;
                } else {
                    c = buf[bp++];
                    ct = 7;
                }
            } else {
                c = buf[bp++];
                ct = 8;
            }
        }
        ct--;
        return (c >> ct) & 1;
    }
};

enum { F_SIG = 1, F_NEG = 2, F_PI = 4, F_MU = 8 };

struct T1 {
    int w, h, stride;
    std::vector<uint8_t> f;
    std::vector<int32_t> d;
    int orient;
    bool vsc;
    MQ mq;
    void setup(int w_, int h_) {
        w = w_; h = h_; stride = w + 2;
        f.assign((size_t)(w + 2) * (h + 2), 0);
        d.assign((size_t)w * h, 0);
    }
    uint8_t& fl(int x, int y) { return f[(size_t)(y + 1) * stride + x + 1]; }
    // significance of the neighbour at (x + ox, y + oy), with the stripe
    // below hidden from a stripe's last row in the vertically causal mode
    int sig(int x, int y, int ox, int oy) {
        if (oy > 0 && vsc && (y & 3) == 3) return 0;
        return fl(x + ox, y + oy) & F_SIG;
    }
    int neighbours(int x, int y) {
        return sig(x, y, -1, -1) | sig(x, y, 0, -1) | sig(x, y, 1, -1) |
               sig(x, y, -1, 0) | sig(x, y, 1, 0) | sig(x, y, -1, 1) |
               sig(x, y, 0, 1) | sig(x, y, 1, 1);
    }
    int ctx_zc(int x, int y) {
        int hh = sig(x, y, -1, 0) + sig(x, y, 1, 0);
        int vv = sig(x, y, 0, -1) + sig(x, y, 0, 1);
        int dd = sig(x, y, -1, -1) + sig(x, y, 1, -1) + sig(x, y, -1, 1) +
                 sig(x, y, 1, 1);
        if (orient == 3) {
            int hv = hh + vv;
            if (dd >= 3) return 8;
            if (dd == 2) return hv >= 1 ? 7 : 6;
            if (dd == 1) return hv >= 2 ? 5 : hv == 1 ? 4 : 3;
            return hv >= 2 ? 2 : hv == 1 ? 1 : 0;
        }
        if (orient == 1) std::swap(hh, vv);
        if (hh == 2) return 8;
        if (hh == 1) return vv >= 1 ? 7 : dd >= 1 ? 6 : 5;
        if (vv == 2) return 4;
        if (vv == 1) return 3;
        return dd >= 2 ? 2 : dd == 1 ? 1 : 0;
    }
    int contrib(int x, int y, int ox, int oy) {
        if (!sig(x, y, ox, oy)) return 0;
        return (fl(x + ox, y + oy) & F_NEG) ? -1 : 1;
    }
    // -> context, xor bit
    void ctx_sc(int x, int y, int& cx, int& xb) {
        int hc = std::clamp(contrib(x, y, -1, 0) + contrib(x, y, 1, 0), -1, 1);
        int vc = std::clamp(contrib(x, y, 0, -1) + contrib(x, y, 0, 1), -1, 1);
        static const int ctab[3][3] = {{13, 12, 11}, {10, 9, 10}, {11, 12, 13}};
        static const int xtab[3][3] = {{0, 0, 0}, {0, 0, 1}, {1, 1, 1}};
        cx = ctab[1 - hc][1 - vc];
        xb = xtab[1 - hc][1 - vc];
    }
    void set_sig(int x, int y, int neg, int32_t oneplushalf) {
        d[(size_t)y * w + x] = neg ? -oneplushalf : oneplushalf;
        fl(x, y) |= F_SIG | (neg ? F_NEG : 0);
    }
    void sign(int x, int y, int32_t oneplushalf) {
        int cx, xb;
        ctx_sc(x, y, cx, xb);
        int v = mq.decode(CTX_SC + cx - 9) ^ xb;
        set_sig(x, y, v, oneplushalf);
    }
    template <class F> void scan(F fn) {
        for (int k = 0; k < h; k += 4)
            for (int x = 0; x < w; x++)
                for (int y = k; y < std::min(k + 4, h); y++) fn(x, y);
    }
    void sigpass(int bpno, bool raw) {
        int32_t one = 1 << bpno, half = one >> 1, oph = one | half;
        scan([&](int x, int y) {
            uint8_t& g = fl(x, y);
            if ((g & (F_SIG | F_PI)) || !neighbours(x, y)) return;
            if (raw) {
                if (mq.raw()) set_sig(x, y, mq.raw(), oph);
            } else if (mq.decode(CTX_ZC + ctx_zc(x, y))) {
                sign(x, y, oph);
            }
            fl(x, y) |= F_PI;
        });
    }
    void refpass(int bpno, bool raw) {
        int32_t poshalf = (1 << bpno) >> 1;
        scan([&](int x, int y) {
            uint8_t& g = fl(x, y);
            if ((g & (F_SIG | F_PI)) != F_SIG) return;
            int v;
            if (raw) {
                v = mq.raw();
            } else {
                int cx = (g & F_MU) ? 16 : neighbours(x, y) ? 15 : 14;
                v = mq.decode(cx);
            }
            int32_t& dv = d[(size_t)y * w + x];
            dv += (v ^ (dv < 0)) ? poshalf : -poshalf;
            g |= F_MU;
        });
    }
    void clnpass(int bpno, bool segsym) {
        int32_t one = 1 << bpno, half = one >> 1, oph = one | half;
        auto step = [&](int x, int y, bool check, bool partial) {
            if (check && (fl(x, y) & (F_SIG | F_PI))) return;
            if (!partial && !mq.decode(CTX_ZC + ctx_zc(x, y))) return;
            sign(x, y, oph);
        };
        for (int k = 0; k < h; k += 4) {
            for (int x = 0; x < w; x++) {
                if (k + 4 <= h) {
                    bool zero = true;
                    for (int y = k; y < k + 4 && zero; y++)
                        if ((fl(x, y) & (F_SIG | F_PI)) || neighbours(x, y))
                            zero = false;
                    if (zero) {
                        if (!mq.decode(CTX_AGG)) continue;
                        int run = mq.decode(CTX_UNI);
                        run = (run << 1) | mq.decode(CTX_UNI);
                        step(x, k + run, false, true);
                        for (int y = k + run + 1; y < k + 4; y++)
                            step(x, y, false, false);
                        continue;
                    }
                }
                for (int y = k; y < std::min(k + 4, h); y++)
                    step(x, y, true, false);
            }
        }
        for (auto& g : f) g &= ~F_PI;
        if (segsym) {
            for (int i = 0; i < 4; i++) mq.decode(CTX_UNI);
        }
    }
};

void decode_cblk(T1& t1, Cblk& C, int orient, int roishift, int cblksty) {
    int w = C.x1 - C.x0, h = C.y1 - C.y0;
    t1.setup(w, h);
    t1.orient = orient;
    t1.vsc = (cblksty & 8) != 0;
    t1.mq.reset_states();
    int bpno_plus_one = roishift + (int32_t)C.numbps;
    if (bpno_plus_one >= 31) throw Bad("unsupported number of bit-planes");
    int passtype = 2;
    size_t off = 0;
    for (uint32_t s = 0; s < C.numsegs; s++) {
        Seg& seg = C.segs[s];
        bool raw = (bpno_plus_one <= (int32_t)C.numbps - 4) && passtype < 2 &&
                   (cblksty & 1);
        if (off + seg.len > C.data.size()) throw Bad("code-block data");
        if (raw) t1.mq.raw_init(C.data.data() + off, seg.len);
        else t1.mq.init(C.data.data() + off, seg.len);
        off += seg.len;
        for (uint32_t p = 0; p < seg.numpasses && bpno_plus_one >= 1; p++) {
            if (passtype == 0) t1.sigpass(bpno_plus_one, raw);
            else if (passtype == 1) t1.refpass(bpno_plus_one, raw);
            else t1.clnpass(bpno_plus_one, (cblksty & 32) != 0);
            if ((cblksty & 2) && !raw) t1.mq.reset_states();
            if (++passtype == 3) {
                passtype = 0;
                bpno_plus_one--;
            }
        }
    }
}

// ------------------------------------------------------------ wavelets

void idwt53_1d(int32_t* x, int sn, int dn, int cas, std::vector<int32_t>& w) {
    int len = sn + dn;
    if (len == 1) {
        if (cas) x[0] /= 2;
        return;
    }
    w.resize(len);
    int32_t* s = x;           // sn low samples
    int32_t* dd = x + sn;     // dn high samples
    // interleave: the low sample i at 2i + cas, the high at 2i + 1 - cas
    for (int i = 0; i < sn; i++) w[2 * i + cas] = s[i];
    for (int i = 0; i < dn; i++) w[2 * i + 1 - cas] = dd[i];
    // even positions (absolute parity even) first
    auto at = [&](int k) {
        if (k < 0) k = -k;
        if (k >= len) k = 2 * (len - 1) - k;
        return w[k];
    };
    for (int k = cas; k < len; k += 2)
        w[k] -= (at(k - 1) + at(k + 1) + 2) >> 2;
    for (int k = 1 - cas; k < len; k += 2)
        w[k] += (at(k - 1) + at(k + 1)) >> 1;
    std::memcpy(x, w.data(), sizeof(int32_t) * len);
}

const float kK = 1.230174105f;
const float kTwoInvK = 1.625732422f;
const float kAlpha = -1.586134342f, kBeta = -0.052980118f,
            kGamma = 0.882911075f, kDelta = 0.443506852f;

// OpenJPEG's v8dwt step2: w[-1] += (l + w[0]) * c along the interleaved
// array, the last one against its single neighbour when m < end
void dwt97_step2(float* l, float* w, int end, int m, float c) {
    int imax = std::min(end, m);
    float t1 = l[0];
    int i = 0;
    for (; i < imax; i++) {
        float t2 = w[-1], t3 = w[0];
        w[-1] = t2 + (t1 + t3) * c;
        t1 = t3;
        w += 2;
    }
    if (m < end) {
        float cc = c + c;
        cc = cc * w[-2];
        w[-1] = w[-1] + cc;
    }
}

void idwt97_1d(float* x, int sn, int dn, int cas, std::vector<float>& wv) {
    int len = sn + dn;
    int a, b;
    if (cas == 0) {
        if (!(dn > 0 || sn > 1)) return;
        a = 0; b = 1;
    } else {
        if (!(sn > 0 || dn > 1)) return;
        a = 1; b = 0;
    }
    wv.assign(len + 2, 0.f);
    float* w = wv.data();
    for (int i = 0; i < sn; i++) w[2 * i + a] = x[i];
    for (int i = 0; i < dn; i++) w[2 * i + b] = x[sn + i];
    for (int i = 0; i < sn; i++) w[2 * i + a] *= kK;
    for (int i = 0; i < dn; i++) w[2 * i + b] *= kTwoInvK;
    dwt97_step2(w + b, w + a + 1, sn, std::min(sn, dn - a), -kDelta);
    dwt97_step2(w + a, w + b + 1, dn, std::min(dn, sn - b), -kGamma);
    dwt97_step2(w + b, w + a + 1, sn, std::min(sn, dn - a), -kBeta);
    dwt97_step2(w + a, w + b + 1, dn, std::min(dn, sn - b), -kAlpha);
    std::memcpy(x, w, sizeof(float) * len);
}

void idwt(TileComp& tc, bool rev) {
    int stride = tc.x1 - tc.x0;
    std::vector<int32_t> iw, col;
    std::vector<float> fw, fcol;
    for (int r = 1; r < tc.numres; r++) {
        Resolution& R = tc.res[r];
        Resolution& P = tc.res[r - 1];
        int rw = R.x1 - R.x0, rh = R.y1 - R.y0;
        int snh = P.x1 - P.x0, snv = P.y1 - P.y0;
        int cash = R.x0 & 1, casv = R.y0 & 1;
        if (rw == 0 || rh == 0) continue;
        for (int y = 0; y < rh; y++) {
            int32_t* row = tc.data.data() + (size_t)y * stride;
            if (rev) idwt53_1d(row, snh, rw - snh, cash, iw);
            else idwt97_1d(reinterpret_cast<float*>(row), snh, rw - snh, cash, fw);
        }
        col.resize(rh);
        fcol.resize(rh);
        for (int x = 0; x < rw; x++) {
            int32_t* base = tc.data.data() + x;
            for (int y = 0; y < rh; y++) col[y] = base[(size_t)y * stride];
            if (rev) {
                idwt53_1d(col.data(), snv, rh - snv, casv, iw);
            } else {
                std::memcpy(fcol.data(), col.data(), sizeof(float) * rh);
                idwt97_1d(fcol.data(), snv, rh - snv, casv, fw);
                std::memcpy(col.data(), fcol.data(), sizeof(float) * rh);
            }
            for (int y = 0; y < rh; y++) base[(size_t)y * stride] = col[y];
        }
    }
}

// ------------------------------------------------------------ tiles

void decode_tile(Codestream& cs, int tileno, int32_t* planes,
                 const std::vector<size_t>& plane_off) {
    const Image& im = cs.img;
    TCP& tcp = cs.tiles[tileno];
    uint32_t p = tileno % im.numx, q = tileno / im.numx;
    int tx0 = (int)std::max<uint64_t>((uint64_t)im.tx0 + p * im.tdx, im.x0);
    int ty0 = (int)std::max<uint64_t>((uint64_t)im.ty0 + q * im.tdy, im.y0);
    int tx1 = (int)std::min<uint64_t>((uint64_t)im.tx0 + (p + 1) * im.tdx, im.x1);
    int ty1 = (int)std::min<uint64_t>((uint64_t)im.ty0 + (q + 1) * im.tdy, im.y1);
    size_t nc = im.comps.size();
    std::vector<TileComp> tcs(nc);
    uint32_t maxres = 0, maxprec = 0;
    for (size_t c = 0; c < nc; c++) {
        init_tilecomp(tcs[c], tcp.tccps[c], im.comps[c], tx0, ty0, tx1, ty1);
        maxres = std::max(maxres, (uint32_t)tcs[c].numres);
        for (auto& R : tcs[c].res) maxprec = std::max(maxprec, R.pw * R.ph);
    }
    // packets
    TileDec td;
    td.img = &im;
    td.tcp = &tcp;
    td.tcs = &tcs;
    td.tx0 = tx0; td.ty0 = ty0; td.tx1 = tx1; td.ty1 = ty1;
    td.data = tcp.data.data();
    td.len = tcp.data.size();
    std::vector<uint8_t> ppt;
    size_t ppt_pos = 0;
    if (cs.ppm) {
        td.hdr = &cs.ppm_data;
        td.hdr_pos = &cs.ppm_pos;
    } else if (tcp.ppt) {
        for (auto& x : tcp.ppt_parts) ppt.insert(ppt.end(), x.begin(), x.end());
        td.hdr = &ppt;
        td.hdr_pos = &ppt_pos;
    }
    uint32_t step_p = 1, step_c = maxprec, step_r = (uint32_t)nc * step_c,
             step_l = maxres * step_r;
    std::vector<uint8_t> include((size_t)tcp.numlayers * step_l, 0);
    std::vector<PacketIter> pis;
    if (tcp.pocs.empty()) {
        pis.push_back({0, 0, (uint32_t)tcp.numlayers, maxres, (uint32_t)nc,
                       (uint32_t)tcp.prg});
    } else {
        for (auto& pc : tcp.pocs)
            pis.push_back({pc.resno0, pc.compno0,
                           std::min(pc.layno1, (uint32_t)tcp.numlayers),
                           pc.resno1, pc.compno1, pc.prg});
    }
    for (auto& pi : pis) iterate(td, pi, include, step_l, step_r, step_c, step_p);
    // tier 1, dequantisation
    T1 t1;
    for (size_t c = 0; c < nc; c++) {
        TileComp& tc = tcs[c];
        const TCCP& tccp = tcp.tccps[c];
        int stride = tc.x1 - tc.x0;
        for (int r = 0; r < tc.numres; r++) {
            Resolution& R = tc.res[r];
            for (int b = 0; b < R.numbands; b++) {
                Band& B = R.bands[b];
                if (B.empty()) continue;
                float stepsize = 0.5f * B.stepsize;
                for (auto& P : B.precincts) {
                    for (auto& C : P.cblks) {
                        int w = C.x1 - C.x0, h = C.y1 - C.y0;
                        if (w <= 0 || h <= 0) continue;
                        decode_cblk(t1, C, B.bandno, tccp.roishift,
                                    tccp.cblksty);
                        if (tccp.roishift) {
                            if (tccp.roishift >= 31) {
                                std::fill(t1.d.begin(), t1.d.end(), 0);
                            } else {
                                int32_t thresh = 1 << tccp.roishift;
                                for (auto& v : t1.d) {
                                    int32_t mag = v < 0 ? -v : v;
                                    if (mag >= thresh) {
                                        mag >>= tccp.roishift;
                                        v = v < 0 ? -mag : mag;
                                    }
                                }
                            }
                        }
                        int x = C.x0 - B.x0, y = C.y0 - B.y0;
                        if (B.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
                        if (B.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
                        for (int j = 0; j < h; j++) {
                            int32_t* dst = tc.data.data() + (size_t)(y + j) * stride + x;
                            const int32_t* src = t1.d.data() + (size_t)j * w;
                            if (tccp.qmfbid == 1) {
                                for (int i = 0; i < w; i++) dst[i] = src[i] / 2;
                            } else {
                                for (int i = 0; i < w; i++) {
                                    float v = (float)src[i] * stepsize;
                                    std::memcpy(&dst[i], &v, 4);
                                }
                            }
                        }
                    }
                }
            }
        }
        idwt(tc, tccp.qmfbid == 1);
    }
    // colour transform
    if (tcp.mct) {
        if (nc >= 3) {
            for (int c = 1; c < 3; c++)
                if (tcs[c].x1 - tcs[c].x0 != tcs[0].x1 - tcs[0].x0 ||
                    tcs[c].y1 - tcs[c].y0 != tcs[0].y1 - tcs[0].y0)
                    throw Bad("tiles don't all have the same dimension; "
                              "the MCT step fails");
            size_t n = tcs[0].data.size();
            int32_t *c0 = tcs[0].data.data(), *c1 = tcs[1].data.data(),
                    *c2 = tcs[2].data.data();
            if (tcp.tccps[0].qmfbid == 1) {
                for (size_t i = 0; i < n; i++) {
                    int32_t y = c0[i], u = c1[i], v = c2[i];
                    int32_t g = y - ((u + v) >> 2);
                    c0[i] = v + g; c1[i] = g; c2[i] = u + g;
                }
            } else {
                float *f0 = reinterpret_cast<float*>(c0),
                      *f1 = reinterpret_cast<float*>(c1),
                      *f2 = reinterpret_cast<float*>(c2);
                for (size_t i = 0; i < n; i++) {
                    float y = f0[i], u = f1[i], v = f2[i];
                    float r = y + (v * 1.402f);
                    float g = y - (u * 0.34413f) - (v * 0.71414f);
                    float b = y + (u * 1.772f);
                    f0[i] = r; f1[i] = g; f2[i] = b;
                }
            }
        }
    }
    // DC level shift and clamp, into the image planes
    for (size_t c = 0; c < nc; c++) {
        const Comp& cp = im.comps[c];
        TileComp& tc = tcs[c];
        int64_t shift = cp.sgnd ? 0 : (int64_t)1 << (cp.prec - 1);
        int64_t lo = cp.sgnd ? -((int64_t)1 << (cp.prec - 1)) : 0;
        int64_t hi = cp.sgnd ? ((int64_t)1 << (cp.prec - 1)) - 1
                             : ((int64_t)1 << cp.prec) - 1;
        int cx0 = (int)ceildiv(im.x0, cp.dx), cy0 = (int)ceildiv(im.y0, cp.dy);
        int cw = (int)ceildiv(im.x1, cp.dx) - cx0;
        int w = tc.x1 - tc.x0, h = tc.y1 - tc.y0;
        bool rev = tcp.tccps[c].qmfbid == 1;
        for (int y = 0; y < h; y++) {
            int32_t* dst = planes + plane_off[c] +
                           (size_t)(tc.y0 - cy0 + y) * cw + (tc.x0 - cx0);
            const int32_t* src = tc.data.data() + (size_t)y * w;
            for (int x = 0; x < w; x++) {
                int64_t v;
                if (rev) {
                    v = (int64_t)src[x] + shift;
                } else {
                    float f;
                    std::memcpy(&f, &src[x], 4);
                    if (f > (float)INT32_MAX) { dst[x] = (int32_t)hi; continue; }
                    if (f < (float)INT32_MIN) { dst[x] = (int32_t)lo; continue; }
                    v = (int64_t)lrintf(f) + shift;
                }
                dst[x] = (int32_t)std::clamp(v, lo, hi);
            }
        }
    }
}

int fail(const Bad& e) {
    g_err = e.what();
    return e.code;
}

}  // namespace

extern "C" {

const char* j2k_last_error() { return g_err.c_str(); }

int j2k_header(const uint8_t* data, long long n, int* out, int cap) {
    try {
        Codestream cs;
        parse(data, (size_t)n, cs, true);
        const Image& im = cs.img;
        int need = 9 + 4 * (int)im.comps.size();
        if (cap < need) throw Bad("header buffer too small");
        int v[9] = {(int)im.x0, (int)im.y0, (int)im.x1, (int)im.y1,
                    (int)im.comps.size(), (int)im.tx0, (int)im.ty0,
                    (int)im.tdx, (int)im.tdy};
        std::memcpy(out, v, sizeof v);
        for (size_t c = 0; c < im.comps.size(); c++) {
            out[9 + 4 * c] = (int)im.comps[c].dx;
            out[10 + 4 * c] = (int)im.comps[c].dy;
            out[11 + 4 * c] = (int)im.comps[c].prec;
            out[12 + 4 * c] = (int)im.comps[c].sgnd;
        }
        return 0;
    } catch (const Bad& e) {
        return fail(e);
    } catch (const std::bad_alloc&) {
        g_err = "out of memory";
        return 1;
    }
}

int j2k_decode(const uint8_t* data, long long n, int32_t* planes,
               uint8_t* done) {
    try {
        Codestream cs;
        parse(data, (size_t)n, cs, false);
        const Image& im = cs.img;
        std::vector<size_t> off;
        size_t total = 0;
        for (auto& cp : im.comps) {
            off.push_back(total);
            total += (size_t)(ceildiv(im.x1, cp.dx) - ceildiv(im.x0, cp.dx)) *
                     (ceildiv(im.y1, cp.dy) - ceildiv(im.y0, cp.dy));
        }
        for (int t : cs.order) {
            decode_tile(cs, t, planes, off);
            done[t] = 1;
        }
        return 0;
    } catch (const Bad& e) {
        return fail(e);
    } catch (const std::bad_alloc&) {
        g_err = "out of memory";
        return 1;
    }
}

}  // extern "C"
