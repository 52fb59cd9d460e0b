// CCITT fax decoding for TIFF strips and tiles, written to libtiff 4.7's
// fax3 codec (tif_fax3.c and its macros), so that what PIL reads through
// libtiff comes out bit for bit, damaged rows too: modified Huffman (TIFF
// compression 2, rows byte-aligned; 32771, rows word-aligned, with
// libtiff's accumulator-based alignment), T.4 (compression 3: an EOL
// searched for before every row, the 1D/2D tag bit when T4Options asks for
// 2D coding) and T.6 (compression 4). The bit accumulator, its zero
// padding at the end of the data, the run arrays (white first, a pass
// carried in RunLength, CLEANUP_RUNS's repair of a row that ends short or
// long) and the fill of black runs as 1 bits are libtiff's; a bad code
// ends the row there, white after it, and decoding goes on.
//
// C interface:
//   ccitt_decode(data, n, mode, width, rows, t_options, odd, noeol, out)
//   -> 1 on success, -1 where libtiff's decoder returns -1 (Huffman or
//   T.4 data that ends before its rows do, which fails the whole read in
//   PIL), 2 where T.6 data ends after its first row and before its last
//   (libtiff leaves the rest of PIL's buffer as it was, which the file does
//   not decide). `odd`: the parity of the chunk's offset in the file, which
//   decides libtiff's word alignment for 32771. `noeol`: libtiff 4.7's
//   FAXMODE_NOEOL, in and out: T.4 data whose row finds no EOL before the
//   end of the chunk is decoded again from the chunk's start without EOLs
//   (tryG3WithoutEOL), and the codec keeps that mode for the image's later
//   chunks.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum State { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW,
             S_TermB, S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL };

struct Ent { uint8_t state, width; uint32_t param; };

// ITU-T T.4 tables 2 and 3: terminating and make-up codes
const char* kWhite[] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111",
    "10011", "10100", "00111", "01000", "001000", "000011", "110100",
    "110101", "101010", "101011", "0100111", "0001100", "0001000",
    "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011",
    "00010010", "00010011", "00010100", "00010101", "00010110", "00010111",
    "00101000", "00101001", "00101010", "00101011", "00101100", "00101101",
    "00000100", "00000101", "00001010", "00001011", "01010010", "01010011",
    "01010100", "01010101", "00100100", "00100101", "01011000", "01011001",
    "01011010", "01011011", "01001010", "01001011", "00110010", "00110011",
    "00110100"};
const char* kWhiteMakeup[] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111",
    "01100100", "01100101", "01101000", "01100111", "011001100",
    "011001101", "011010010", "011010011", "011010100", "011010101",
    "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000",
    "010011011"};
const char* kBlack[] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011",
    "000101", "000100", "0000100", "0000101", "0000111", "00000100",
    "00000111", "000011000", "0000010111", "0000011000", "0000001000",
    "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010",
    "000011001011", "000011001100", "000011001101", "000001101000",
    "000001101001", "000001101010", "000001101011", "000011010010",
    "000011010011", "000011010100", "000011010101", "000011010110",
    "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110",
    "000001010111", "000001100100", "000001100101", "000001010010",
    "000001010011", "000000100100", "000000110111", "000000111000",
    "000000100111", "000000101000", "000001011000", "000001011001",
    "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111"};
const char* kBlackMakeup[] = {
    "0000001111", "000011001000", "000011001001", "000001011011",
    "000000110011", "000000110100", "000000110101", "0000001101100",
    "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101"};
const char* kExtMakeup[] = {
    "00000001000", "00000001100", "00000001101", "000000010010",
    "000000010011", "000000010100", "000000010101", "000000010110",
    "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111"};

// lookup tables indexed by the next `bits` bits, the first bit of the
// stream the lowest (libtiff's accumulator order)
struct Table {
    std::vector<Ent> e;
    explicit Table(int bits) : e((size_t)1 << bits, Ent{S_Null, 0, 0}) {}
    void add(const char* code, State s, uint32_t param) {
        int l = (int)std::strlen(code);
        uint32_t r = 0;
        for (int i = 0; i < l; i++) r |= (uint32_t)(code[i] - '0') << i;
        for (size_t idx = 0; idx < e.size(); idx++)
            if ((idx & ((1u << l) - 1)) == r) e[idx] = Ent{(uint8_t)s, (uint8_t)l, param};
    }
};

struct Tables {
    Table white{12}, black{13}, main{7};
    Tables() {
        for (int i = 0; i < 64; i++) {
            white.add(kWhite[i], S_TermW, i);
            black.add(kBlack[i], S_TermB, i);
        }
        for (int i = 0; i < 27; i++) {
            white.add(kWhiteMakeup[i], S_MakeUpW, 64 * (i + 1));
            black.add(kBlackMakeup[i], S_MakeUpB, 64 * (i + 1));
        }
        for (int i = 0; i < 13; i++) {
            white.add(kExtMakeup[i], S_MakeUp, 1792 + 64 * i);
            black.add(kExtMakeup[i], S_MakeUp, 1792 + 64 * i);
        }
        // libtiff's EOLH: eleven zero bits, whatever follows (an EOL's
        // final 1 is left to the next SYNC_EOL)
        white.add("00000000000", S_EOL, 0);
        black.add("00000000000", S_EOL, 0);
        main.add("1", S_V0, 0);
        main.add("011", S_VR, 1);
        main.add("000011", S_VR, 2);
        main.add("0000011", S_VR, 3);
        main.add("010", S_VL, 1);
        main.add("000010", S_VL, 2);
        main.add("0000010", S_VL, 3);
        main.add("001", S_Horiz, 0);
        main.add("0001", S_Pass, 0);
        main.add("0000001", S_Ext, 0);
        main.add("0000000", S_EOL, 0);
    }
};

const Tables& T() {
    static Tables t;
    return t;
}

uint8_t rev8(uint8_t b) {
    b = (uint8_t)((b & 0xF0) >> 4 | (b & 0x0F) << 4);
    b = (uint8_t)((b & 0xCC) >> 2 | (b & 0x33) << 2);
    return (uint8_t)((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

struct Dec {
    const uint8_t* start;
    const uint8_t* cp;
    const uint8_t* ep;
    size_t odd;
    uint32_t BitAcc = 0;
    int BitsAvail = 0, EOLcnt = 0;
    uint32_t lastx;
    std::vector<uint32_t> runs_a, runs_b;
    uint32_t* thisrun;
    uint32_t* refruns;
    uint32_t* pa;
    uint32_t* pb;
    int a0, RunLength, b1;

    bool EndOfData() const { return cp >= ep; }
    void load() { BitAcc |= (uint32_t)rev8(*cp++) << BitsAvail; }
    bool NeedBits8(int n) {
        if (BitsAvail < n) {
            if (EndOfData()) {
                if (BitsAvail == 0) return false;
                BitsAvail = n;
            } else {
                load();
                BitsAvail += 8;
            }
        }
        return true;
    }
    bool NeedBits16(int n) {
        if (BitsAvail < n) {
            if (EndOfData()) {
                if (BitsAvail == 0) return false;
                BitsAvail = n;
            } else {
                load();
                if ((BitsAvail += 8) < n) {
                    if (EndOfData()) {
                        BitsAvail = n;
                    } else {
                        load();
                        BitsAvail += 8;
                    }
                }
            }
        }
        return true;
    }
    uint32_t GetBits(int n) const { return BitAcc & ((1u << n) - 1); }
    void ClrBits(int n) { BitsAvail -= n; BitAcc >>= n; }
    void SETVALUE(uint32_t x) {
        *pa++ = (uint32_t)RunLength + x;
        a0 += (int)x;
        RunLength = 0;
    }
    void CLEANUP_RUNS() {
        if (RunLength) SETVALUE(0);
        if (a0 != (int)lastx) {
            while (a0 > (int)lastx && pa > thisrun) a0 -= (int)*--pa;
            if (a0 < (int)lastx) {
                if (a0 < 0) a0 = 0;
                if ((pa - thisrun) & 1) SETVALUE(0);
                SETVALUE(lastx - a0);
            } else if (a0 > (int)lastx) {
                SETVALUE(lastx);
                SETVALUE(0);
            }
        }
    }
    // LOOKUP: false at the end of the data
    bool lookup16(int wid, const Table& t, const Ent*& ent) {
        if (!NeedBits16(wid)) return false;
        ent = &t.e[GetBits(wid)];
        ClrBits(ent->width);
        return true;
    }
    bool lookup8(int wid, const Table& t, const Ent*& ent) {
        if (!NeedBits8(wid)) return false;
        ent = &t.e[GetBits(wid)];
        ClrBits(ent->width);
        return true;
    }
    // SYNC_EOL: 0 synchronized, 1 the end of the data while looking for
    // the EOL's zeros (libtiff's EOF label), 2 no 1 bit after them before
    // the end (libtiff 4.7's noEOLFound: the data is retried as G3
    // without EOLs)
    int sync_eol() {
        if (EOLcnt == 0) {
            for (;;) {
                if (!NeedBits16(11)) return 1;
                if (GetBits(11) == 0) break;
                ClrBits(1);
            }
        }
        for (;;) {
            if (!NeedBits8(8)) return 2;
            if (GetBits(8)) break;
            ClrBits(8);
        }
        while (GetBits(1) == 0) ClrBits(1);
        ClrBits(1);
        EOLcnt = 0;
        return 0;
    }
    // tryG3WithoutEOL: the state libtiff's decoder cached when the call
    // began (the chunk's first byte, an empty bit accumulator)
    void rewind() {
        cp = start;
        BitAcc = 0;
        BitsAvail = 0;
        EOLcnt = 0;
    }
    // one colour's run (make-up codes, then a terminating code): 0 done,
    // 1 bad code or EOL (row ends), 2 end of data
    int run(bool white) {
        for (;;) {
            const Ent* e;
            if (white ? !lookup16(12, T().white, e) : !lookup16(13, T().black, e))
                return 2;
            switch (e->state) {
            case S_EOL:
                if (eol_ends) { EOLcnt = 1; return 1; }
                return 3;
            case S_TermW:
            case S_TermB:
                if ((e->state == S_TermW) != white) return 3;
                SETVALUE(e->param);
                return 0;
            case S_MakeUpW:
            case S_MakeUpB:
            case S_MakeUp:
                if (e->state != S_MakeUp && (e->state == S_MakeUpW) != white)
                    return 3;
                a0 += (int)e->param;
                RunLength += (int)e->param;
                break;
            default:
                return 3;
            }
        }
    }
    bool eol_ends = true;
    // EXPAND1D: true done, false at the end of the data
    bool expand1d() {
        eol_ends = true;
        for (;;) {
            int r = run(true);
            if (r == 2) { CLEANUP_RUNS(); return false; }
            if (r) break;
            if (a0 >= (int)lastx) break;
            r = run(false);
            if (r == 2) { CLEANUP_RUNS(); return false; }
            if (r) break;
            if (a0 >= (int)lastx) break;
            if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;
        }
        CLEANUP_RUNS();
        return true;
    }
    void check_b1() {
        if (pa != thisrun)
            while (b1 <= a0 && b1 < (int)lastx) {
                b1 += (int)(pb[0] + pb[1]);
                pb += 2;
            }
    }
    // EXPAND2D: true done, false at the end of the data
    bool expand2d() {
        eol_ends = false;
        while (a0 < (int)lastx) {
            const Ent* e;
            if (!lookup8(7, T().main, e)) { CLEANUP_RUNS(); return false; }
            switch (e->state) {
            case S_Pass:
                check_b1();
                b1 += (int)*pb++;
                RunLength += b1 - a0;
                a0 = b1;
                b1 += (int)*pb++;
                break;
            case S_Horiz: {
                bool black_first = (pa - thisrun) & 1;
                int r = run(!black_first);
                if (r == 2) { CLEANUP_RUNS(); return false; }
                if (r) { CLEANUP_RUNS(); return true; }
                r = run(black_first);
                if (r == 2) { CLEANUP_RUNS(); return false; }
                if (r) { CLEANUP_RUNS(); return true; }
                check_b1();
                break;
            }
            case S_V0:
                check_b1();
                SETVALUE((uint32_t)(b1 - a0));
                b1 += (int)*pb++;
                break;
            case S_VR:
                check_b1();
                SETVALUE((uint32_t)(b1 - a0 + (int)e->param));
                b1 += (int)*pb++;
                break;
            case S_VL:
                check_b1();
                if (b1 < a0 + (int)e->param) { CLEANUP_RUNS(); return true; }
                SETVALUE((uint32_t)(b1 - a0 - (int)e->param));
                b1 -= (int)*--pb;
                break;
            case S_Ext:
                *pa++ = lastx - a0;
                CLEANUP_RUNS();
                return true;
            case S_EOL:
                *pa++ = lastx - a0;
                if (!NeedBits8(4)) { CLEANUP_RUNS(); return false; }
                ClrBits(4);
                EOLcnt = 1;
                CLEANUP_RUNS();
                return true;
            default:
                CLEANUP_RUNS();
                return true;
            }
        }
        if (RunLength) {
            if (RunLength + a0 < (int)lastx) {
                if (!NeedBits8(1)) { CLEANUP_RUNS(); return false; }
                if (!GetBits(1)) { CLEANUP_RUNS(); return true; }
                ClrBits(1);
            }
            SETVALUE(0);
        }
        CLEANUP_RUNS();
        return true;
    }
};

// _TIFFFax3fillruns: white runs 0 bits, black 1 bits; runs past the row
// are cut (in the run array too, which the next row reads)
void fillruns(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
    if ((erun - runs) & 1) *erun++ = 0;
    std::memset(buf, 0, (lastx + 7) / 8);
    uint32_t x = 0;
    for (; runs < erun; runs += 2) {
        uint32_t r = runs[0];
        if (x + r > lastx || r > lastx) r = runs[0] = lastx - x;
        x += r;
        r = runs[1];
        if (x + r > lastx || r > lastx) r = runs[1] = lastx - x;
        for (uint32_t i = 0; i < r; i++, x++) buf[x >> 3] |= 0x80 >> (x & 7);
    }
}

}  // namespace

extern "C" int ccitt_decode(const uint8_t* data, long long n, int mode,
                            int width, int rows, int t_options, int odd,
                            int* noeol, uint8_t* out) {
    Dec d;
    d.start = d.cp = data;
    d.ep = data + n;
    d.odd = (size_t)odd;
    d.lastx = (uint32_t)width;
    size_t nruns = 2 * ((size_t)width + 2) + 8;
    d.runs_a.assign(nruns, 0);
    d.runs_b.assign(nruns, 0);
    d.refruns = d.runs_b.data();
    d.refruns[0] = (uint32_t)width;
    d.refruns[1] = 0;
    uint32_t* cur = d.runs_a.data();
    int rb = (width + 7) / 8;
    bool two_d = mode == 3 && (t_options & 1);
    for (int y = 0; y < rows; y++) {
        uint8_t* buf = out + (size_t)y * rb;
        d.a0 = 0;
        d.RunLength = 0;
        d.thisrun = d.pa = cur;
        if (mode == 2 || mode == 32771) {
            bool ok = d.expand1d();
            fillruns(buf, d.thisrun, d.pa, d.lastx);
            if (!ok) return -1;
            if (mode == 2) {
                d.ClrBits(d.BitsAvail - (d.BitsAvail & ~7));
            } else {
                d.ClrBits(d.BitsAvail - (d.BitsAvail & ~15));
                if (d.BitsAvail == 0 && ((d.cp - d.start) + d.odd) & 1) d.cp++;
            }
            continue;
        }
        if (mode == 3 && !two_d) {
            // Fax3Decode1D; a row that finds no EOL sends the whole chunk
            // through again from its start, without EOLs, from this row on
            if (!*noeol) {
                const int sync = d.sync_eol();
                if (sync == 2) {
                    *noeol = 1;
                    d.rewind();
                    --y;
                    continue;
                }
                if (sync == 1) {
                    d.CLEANUP_RUNS();
                    return -1;
                }
            }
            bool ok = d.expand1d();
            fillruns(buf, d.thisrun, d.pa, d.lastx);
            if (!ok) return -1;
            continue;
        }
        d.pb = d.refruns;
        if (mode == 3) {                             // Fax3Decode2D
            if (!*noeol) {
                const int sync = d.sync_eol();
                if (sync == 2) {
                    *noeol = 1;
                    d.rewind();
                    --y;
                    continue;
                }
                if (sync == 1) return -1;
            }
            if (!d.NeedBits8(1)) return -1;
            int is1d = d.GetBits(1);
            d.ClrBits(1);
            d.b1 = (int)*d.pb++;
            bool ok = is1d ? d.expand1d() : d.expand2d();
            fillruns(buf, d.thisrun, d.pa, d.lastx);
            if (!ok) return -1;
            if (d.pa < d.thisrun + nruns) d.SETVALUE(0);
        } else {                                     // T.6
            d.b1 = (int)*d.pb++;
            bool ok = d.expand2d();
            if (!ok || d.EOLcnt) {
                // EOFB or the end of the data before the last row: libtiff
                // fails on the first row, and after it leaves the rest of
                // PIL's strip buffer as it was (memory the file does not
                // decide)
                return y ? 2 : -1;
            }
            fillruns(buf, d.thisrun, d.pa, d.lastx);
            d.SETVALUE(0);
        }
        std::swap(cur, d.refruns);
    }
    return 1;
}
