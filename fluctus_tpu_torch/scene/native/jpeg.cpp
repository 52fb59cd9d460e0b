// Huffman JPEG decoder (SOF0 baseline, SOF1 extended sequential, SOF2
// progressive; 8-bit samples) that reproduces libjpeg-turbo's default
// decompression, the one PIL's Image.open(...).convert("RGBA") runs:
// - every scan decodes into a per-component coefficient buffer (jdhuff.c
//   for sequential scans; jdphuff.c for progressive ones: DC first and
//   refining scans, AC spectral selection with end-of-band runs, and AC
//   successive approximation), with each component's quantization table
//   latched at its first scan (jdinput.c), and the IDCT runs once all
//   scans are read;
// - the JDCT_ISLOW integer IDCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2)
//   with the post-IDCT range limit of jdmaster.c;
// - the upsampling jdsample.c picks with do_fancy_upsampling on: the
//   "fancy" triangle filters for 2h1v, 1h2v and 2h2v components (box
//   replication for 2h1v / 2h2v components at most 2 samples wide, and for
//   other integral factors), with the last real sample row repeated below
//   the image and row 0 above it (jdmainct.c);
// - the fixed-point YCbCr -> RGB tables of jdcolor.c (SCALEBITS 16).
// The colour space is read as libjpeg reads it: one component is grey;
// three are YCbCr unless an Adobe marker says transform 0, or there is no
// JFIF marker and the component ids are 'R', 'G', 'B'.
//
// C interface, called through ctypes (scene/jpeg.py):
//   jpeg_info(data, n, &w, &h, &nc): parses the headers.
//   jpeg_planes(data, n, dims, cap, out): the components before upsampling.
//   jpeg_decode(data, n, out): out is h * w * nc bytes (nc 1, 3 or 4; four
//   components are CMYK as stored, or YCCK converted to CMYK by jdcolor.c's
//   ycck_cmyk_convert under an Adobe transform 2).
// Both return 0, 1 for a corrupt or truncated file or one PIL fails on
// (other than 8-bit samples, hierarchical coding, 2 or more than 4
// components), 2 for a variant this decoder does not handle (arithmetic
// or lossless coding, fractional sampling ratios, and a progressive file
// whose scans leave a low-frequency coefficient unrefined, which libjpeg
// block-smooths); jpeg_last_error() names the reason.

#include <stdint.h>
#include <string.h>

#include <string>
#include <vector>

namespace {

struct Fail {
  int code;
  std::string what;
};

std::string g_error;

struct Huff {
  bool present = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int maxcode[18];
  int valptr[17];
  int mincode[17];
  // 9-bit lookahead: (length << 8) | value, 0 when longer
  uint16_t look[512];

  void build() {
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      code += bits[l];
      k += bits[l];
      maxcode[l] = bits[l] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    memset(look, 0, sizeof(look));
    code = 0;
    k = 0;
    for (int l = 1; l <= 9; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
        const int shift = 9 - l;
        for (int j = 0; j < (1 << shift); ++j)
          look[(code << shift) | j] = (uint16_t)((l << 8) | vals[k]);
      }
      code <<= 1;
    }
  }
};

struct Comp {
  int id, h, v, tq;
  int td = 0, ta = 0;
  int bw, bh;           // blocks across and down in the plane
  int dw, dh;           // downsampled width and height (real samples)
  std::vector<int16_t> coef;    // bw x bh blocks of 64, natural order
  std::vector<uint8_t> plane;   // bw*8 x bh*8 samples
  uint16_t qlatch[64] = {0};    // the quantization table at its first scan
  int coef_bits[64] = {0};      // jdinput.c's coef_bits: -1 until seen
  int dc_pred = 0;
};

struct Reader {
  const uint8_t* d;
  size_t n, pos = 0;
  uint32_t buf = 0;
  int cnt = 0;
  bool marker_hit = false;

  int byte_at(size_t p) const {
    if (p >= n) throw Fail{1, "truncated JPEG data"};
    return d[p];
  }
  void fill() {
    while (cnt <= 24) {
      int c = 0;
      if (!marker_hit) {
        c = byte_at(pos);
        if (c == 0xFF) {
          const int c2 = byte_at(pos + 1);
          if (c2 == 0x00) {
            pos += 2;
          } else {
            marker_hit = true;   // libjpeg feeds zeros past a marker
            c = 0;
          }
        } else {
          ++pos;
        }
      }
      buf |= (uint32_t)c << (24 - cnt);
      cnt += 8;
    }
  }
  int bits(int k) {
    if (k == 0) return 0;
    fill();
    const int v = (int)(buf >> (32 - k));
    buf <<= k;
    cnt -= k;
    return v;
  }
  int bit() { return bits(1); }
  int decode(const Huff& h) {
    fill();
    const int peek = (int)(buf >> 23);
    const int e = h.look[peek];
    if (e) {
      const int l = e >> 8;
      buf <<= l;
      cnt -= l;
      return e & 0xFF;
    }
    int code = 0, l = 0;
    do {
      code = (code << 1) | bit();
      ++l;
    } while (l <= 16 && code > h.maxcode[l]);
    if (l > 16) throw Fail{1, "bad Huffman code"};
    return h.vals[h.valptr[l] + code - h.mincode[l]];
  }
  void reset() {          // byte-align after a restart
    buf = 0;
    cnt = 0;
  }
};

inline int extend(int v, int t) {
  return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
}

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jidctint.c, jpeg_idct_islow
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int32_t descale(int64_t x, int n) {
  return (int32_t)((x + ((int64_t)1 << (n - 1))) >> n);
}

inline uint8_t range_limit(int32_t x) {   // jdmaster.c's post-IDCT table
  x &= 1023;
  if (x >= 512) x -= 1024;
  x += 128;
  return (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x));
}

void idct_islow(const int32_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int32_t* in = coef + c;
    const uint16_t* qq = q + c;
    int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
    z2 = (int64_t)in[16] * qq[16];
    z3 = (int64_t)in[48] * qq[48];
    z1 = (z2 + z3) * F0541;
    t2 = z1 + z3 * (-F1847);
    t3 = z1 + z2 * F0765;
    z2 = (int64_t)in[0] * qq[0];
    z3 = (int64_t)in[32] * qq[32];
    t0 = (z2 + z3) * (1 << kConstBits);
    t1 = (z2 - z3) * (1 << kConstBits);
    t10 = t0 + t3;
    t13 = t0 - t3;
    t11 = t1 + t2;
    t12 = t1 - t2;
    t0 = (int64_t)in[56] * qq[56];
    t1 = (int64_t)in[40] * qq[40];
    t2 = (int64_t)in[24] * qq[24];
    t3 = (int64_t)in[8] * qq[8];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    z4 = t1 + t3;
    z5 = (z3 + z4) * F1175;
    t0 = t0 * F0298;
    t1 = t1 * F2053;
    t2 = t2 * F3072;
    t3 = t3 * F1501;
    z1 = z1 * (-F0899);
    z2 = z2 * (-F2562);
    z3 = z3 * (-F1961);
    z4 = z4 * (-F0390);
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    const int s = kConstBits - kPass1Bits;
    ws[c + 0] = descale(t10 + t3, s);
    ws[c + 56] = descale(t10 - t3, s);
    ws[c + 8] = descale(t11 + t2, s);
    ws[c + 48] = descale(t11 - t2, s);
    ws[c + 16] = descale(t12 + t1, s);
    ws[c + 40] = descale(t12 - t1, s);
    ws[c + 24] = descale(t13 + t0, s);
    ws[c + 32] = descale(t13 - t0, s);
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * F0541;
    t2 = z1 + z3 * (-F1847);
    t3 = z1 + z2 * F0765;
    t0 = ((int64_t)w[0] + w[4]) * (1 << kConstBits);
    t1 = ((int64_t)w[0] - w[4]) * (1 << kConstBits);
    t10 = t0 + t3;
    t13 = t0 - t3;
    t11 = t1 + t2;
    t12 = t1 - t2;
    t0 = w[7];
    t1 = w[5];
    t2 = w[3];
    t3 = w[1];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    z4 = t1 + t3;
    z5 = (z3 + z4) * F1175;
    t0 = t0 * F0298;
    t1 = t1 * F2053;
    t2 = t2 * F3072;
    t3 = t3 * F1501;
    z1 = z1 * (-F0899);
    z2 = z2 * (-F2562);
    z3 = z3 * (-F1961);
    z4 = z4 * (-F0390);
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    const int s = kConstBits + kPass1Bits + 3;
    o[0] = range_limit(descale(t10 + t3, s));
    o[7] = range_limit(descale(t10 - t3, s));
    o[1] = range_limit(descale(t11 + t2, s));
    o[6] = range_limit(descale(t11 - t2, s));
    o[2] = range_limit(descale(t12 + t1, s));
    o[5] = range_limit(descale(t12 - t1, s));
    o[3] = range_limit(descale(t13 + t0, s));
    o[4] = range_limit(descale(t13 - t0, s));
  }
}

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 2;
  int width = 0, height = 0, ncomp = 0;
  bool have_frame = false, jfif = false, adobe = false;
  bool progressive = false;
  int ss = 0, se = 63, ah = 0, al = 0;   // the current scan's parameters
  int eobrun = 0;
  int adobe_transform = -1;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart = 0;
  uint16_t q[4][64];
  bool q_present[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  std::vector<Comp> comps;
  bool headers_only = false;

  int u8(size_t p) const {
    if (p >= n) throw Fail{1, "truncated JPEG file"};
    return d[p];
  }
  int u16(size_t p) const { return (u8(p) << 8) | u8(p + 1); }

  void frame(size_t p, int len, int sof) {
    // PIL's SOF handler refuses other than 8-bit samples, whatever the
    // process; libjpeg-turbo refuses the hierarchical (differential) ones
    if (u8(p) != 8) throw Fail{1, "PIL reads only 8-bit JPEG samples"};
    if (sof == 5 || sof == 6 || sof == 7 || sof >= 13)
      throw Fail{1, "libjpeg refuses hierarchical JPEG"};
    if (sof == 3 || sof == 11)
      throw Fail{2, "lossless JPEG is not decoded by the port"};
    if (sof >= 9) throw Fail{2, "arithmetic-coded JPEG is not decoded by "
                                "the port"};
    if (have_frame) throw Fail{1, "two frames"};
    progressive = sof == 2;
    height = u16(p + 1);
    width = u16(p + 3);
    ncomp = u8(p + 5);
    if (width <= 0 || height <= 0) throw Fail{1, "bad JPEG size"};
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      throw Fail{1, "PIL reads JPEG of 1, 3 or 4 components"};
    if (len < 8 + 3 * ncomp) throw Fail{1, "short SOF"};
    for (int i = 0; i < ncomp; ++i) {
      Comp c;
      c.id = u8(p + 6 + 3 * i);
      c.h = u8(p + 7 + 3 * i) >> 4;
      c.v = u8(p + 7 + 3 * i) & 15;
      c.tq = u8(p + 8 + 3 * i);
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        throw Fail{1, "bad sampling factors"};
      comps.push_back(c);
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      if (hmax % c.h || vmax % c.v)
        throw Fail{2, "fractional JPEG sampling is not decoded by the port"};
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    }
    have_frame = true;
  }

  void tables_q(size_t p, int len) {
    size_t e = p + len - 2;
    while (p < e) {
      const int pq = u8(p) >> 4, tq = u8(p) & 15;
      if (tq > 3 || pq > 1) throw Fail{1, "bad DQT"};
      ++p;
      for (int k = 0; k < 64; ++k) {
        q[tq][kZigzag[k]] = (uint16_t)(pq ? u16(p + 2 * k) : u8(p + k));
      }
      p += pq ? 128 : 64;
      q_present[tq] = true;
    }
  }

  void tables_h(size_t p, int len) {
    size_t e = p + len - 2;
    while (p < e) {
      const int tc = u8(p) >> 4, th = u8(p) & 15;
      if (tc > 1 || th > 3) throw Fail{1, "bad DHT"};
      Huff& h = tc ? ac[th] : dc[th];
      int total = 0;
      h.bits[0] = 0;
      for (int l = 1; l <= 16; ++l) {
        h.bits[l] = (uint8_t)u8(p + l);
        total += h.bits[l];
      }
      if (total > 256) throw Fail{1, "bad DHT"};
      for (int k = 0; k < total; ++k) h.vals[k] = (uint8_t)u8(p + 17 + k);
      h.build();
      h.present = true;
      p += 17 + total;
    }
  }

  int16_t* coefs(Comp& c, int bx, int by) {
    if (bx >= c.bw || by >= c.bh) return nullptr;   // outside the plane
    return c.coef.data() + ((size_t)by * c.bw + bx) * 64;
  }

  // jdhuff.c decode_mcu: one block of a sequential scan
  void block(Reader& r, Comp& c, int bx, int by) {
    int32_t coef[64];
    memset(coef, 0, sizeof(coef));
    const int t = r.decode(dc[c.td]);
    if (t > 11) throw Fail{1, "bad DC magnitude"};
    const int diff = t ? extend(r.bits(t), t) : 0;
    c.dc_pred += diff;
    coef[0] = c.dc_pred;
    for (int k = 1; k < 64;) {
      const int rs = r.decode(ac[c.ta]);
      const int run = rs >> 4, s = rs & 15;
      if (s == 0) {
        if (run != 15) break;
        k += 16;
        continue;
      }
      k += run;
      if (k > 63) throw Fail{1, "bad AC run"};
      coef[kZigzag[k]] = extend(r.bits(s), s);
      ++k;
    }
    int16_t* out = coefs(c, bx, by);
    if (out)
      for (int k = 0; k < 64; ++k) out[k] = (int16_t)coef[k];
  }

  // jdphuff.c decode_mcu_DC_first / decode_mcu_DC_refine
  void dc_block(Reader& r, Comp& c, int bx, int by) {
    int16_t* out = coefs(c, bx, by);
    int16_t scratch[64];
    if (!out) out = scratch;
    if (ah == 0) {
      const int t = r.decode(dc[c.td]);
      if (t > 11) throw Fail{1, "bad DC magnitude"};
      const int diff = t ? extend(r.bits(t), t) : 0;
      c.dc_pred += diff;
      out[0] = (int16_t)((unsigned)c.dc_pred << al);
    } else if (r.bit()) {
      out[0] = (int16_t)(out[0] | (1 << al));
    }
  }

  // jdphuff.c decode_mcu_AC_first
  void ac_first(Reader& r, Comp& c, int bx, int by) {
    int16_t* out = coefs(c, bx, by);
    int16_t scratch[64];
    if (!out) out = scratch;
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      const int rs = r.decode(ac[c.ta]);
      int run = rs >> 4;
      const int s = rs & 15;
      if (s) {
        k += run;
        if (k > 63) throw Fail{1, "bad AC run"};
        out[kZigzag[k]] = (int16_t)((unsigned)extend(r.bits(s), s) << al);
      } else if (run == 15) {
        k += 15;
      } else {
        eobrun = 1 << run;
        if (run) eobrun += r.bits(run);
        --eobrun;
        break;
      }
    }
  }

  // jdphuff.c decode_mcu_AC_refine
  void ac_refine(Reader& r, Comp& c, int bx, int by) {
    int16_t* out = coefs(c, bx, by);
    int16_t scratch[64] = {0};
    if (!out) out = scratch;
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    auto correct = [&](int16_t& coef) {
      if (r.bit() && (coef & p1) == 0)
        coef = (int16_t)(coef >= 0 ? coef + p1 : coef + m1);
    };
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = r.decode(ac[c.ta]);
        int run = rs >> 4, s = rs & 15;
        if (s) {
          s = r.bit() ? p1 : m1;   // s != 1 is only a warning in libjpeg
        } else if (run != 15) {
          eobrun = 1 << run;
          if (run) eobrun += r.bits(run);
          break;
        }
        do {
          int16_t& coef = out[kZigzag[k]];
          if (coef != 0) {
            correct(coef);
          } else if (--run < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s && k <= 63) out[kZigzag[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& coef = out[kZigzag[k]];
        if (coef != 0) correct(coef);
      }
      --eobrun;
    }
  }

  void unit(Reader& r, Comp& c, int bx, int by) {
    if (!progressive) block(r, c, bx, by);
    else if (ss == 0) dc_block(r, c, bx, by);
    else if (ah == 0) ac_first(r, c, bx, by);
    else ac_refine(r, c, bx, by);
  }

  // jdphuff.c start_pass_phuff_decoder's checks and jdinput.c's latches
  void start_scan(const std::vector<Comp*>& sc) {
    if (!progressive) {
      if (ss != 0 || se != 63 || ah != 0 || al != 0)
        throw Fail{1, "bad spectral selection for a sequential scan"};
    } else {
      bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || sc.size() != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) throw Fail{1, "bad progressive scan parameters"};
    }
    for (auto* c : sc) {
      const bool first_dc = !progressive || (ss == 0 && ah == 0);
      const bool need_ac = !progressive || ss > 0;
      if (c->td > 3 || c->ta > 3 || (first_dc && !dc[c->td].present) ||
          (need_ac && !ac[c->ta].present))
        throw Fail{1, "SOS names a missing Huffman table"};
      if (c->coef.empty()) {
        if (!q_present[c->tq]) throw Fail{1, "missing quantization table"};
        memcpy(c->qlatch, q[c->tq], sizeof(c->qlatch));
        c->coef.assign((size_t)c->bw * c->bh * 64, 0);
      }
      for (int k = ss; k <= se; ++k) c->coef_bits[k] = progressive ? al : 0;
      c->dc_pred = 0;
    }
    eobrun = 0;
  }

  // Returns the position after the scan's entropy-coded data.
  size_t scan(size_t p, int len) {
    const int ns = u8(p);
    if (ns < 1 || ns > 4 || len < 6 + 2 * ns) throw Fail{1, "bad SOS"};
    std::vector<Comp*> sc;
    for (int i = 0; i < ns; ++i) {
      const int id = u8(p + 1 + 2 * i), tt = u8(p + 2 + 2 * i);
      Comp* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) throw Fail{1, "SOS names an unknown component"};
      found->td = tt >> 4;
      found->ta = tt & 15;
      sc.push_back(found);
    }
    const size_t s0 = p + 1 + 2 * ns;
    ss = u8(s0);
    se = u8(s0 + 1);
    ah = u8(s0 + 2) >> 4;
    al = u8(s0 + 2) & 15;
    start_scan(sc);
    Reader r{d, n, p + len - 2};
    int units_x, units_y;
    if (ns == 1) {   // non-interleaved: one block per unit
      units_x = (sc[0]->dw + 7) / 8;
      units_y = (sc[0]->dh + 7) / 8;
    } else {
      units_x = mcux;
      units_y = mcuy;
    }
    const long total = (long)units_x * units_y;
    int next_rst = 0;
    for (long u = 0; u < total; ++u) {
      if (restart && u > 0 && u % restart == 0) {
        // the RST marker: skip fill bytes, then expect RSTn
        size_t q2 = r.pos;
        while (q2 < n && d[q2] != 0xFF) ++q2;
        while (q2 + 1 < n && d[q2] == 0xFF && d[q2 + 1] == 0xFF) ++q2;
        if (q2 + 1 >= n) throw Fail{1, "truncated JPEG data"};
        if (d[q2 + 1] != 0xD0 + next_rst) throw Fail{1, "bad restart marker"};
        next_rst = (next_rst + 1) & 7;
        r.pos = q2 + 2;
        r.reset();
        r.marker_hit = false;
        for (auto* c : sc) c->dc_pred = 0;
        eobrun = 0;
      }
      const int ux = (int)(u % units_x), uy = (int)(u / units_x);
      if (ns == 1) {
        unit(r, *sc[0], ux, uy);
      } else {
        for (auto* c : sc)
          for (int by = 0; by < c->v; ++by)
            for (int bx = 0; bx < c->h; ++bx)
              unit(r, *c, ux * c->h + bx, uy * c->v + by);
      }
    }
    // the data ends at the next marker that is not a stuffed 0xFF00 or RST
    size_t q2 = r.pos;
    for (;;) {
      if (q2 + 1 >= n) throw Fail{1, "truncated JPEG file"};
      if (d[q2] == 0xFF && d[q2 + 1] != 0x00 &&
          !(d[q2 + 1] >= 0xD0 && d[q2 + 1] <= 0xD7) && d[q2 + 1] != 0xFF)
        return q2;
      ++q2;
    }
  }

  void parse() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) throw Fail{1, "not a JPEG"};
    bool scanned = false;
    for (;;) {
      if (u8(pos) != 0xFF) throw Fail{1, "expected a marker"};
      while (u8(pos + 1) == 0xFF) ++pos;
      const int m = u8(pos + 1);
      pos += 2;
      if (m == 0xD9) break;                         // EOI
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      const int len = u16(pos);
      if (len < 2) throw Fail{1, "bad segment length"};
      const size_t body = pos + 2;
      u8(pos + len - 1);                            // present in full
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        frame(body, len, m - 0xC0);
        if (headers_only) return;
      } else if (m == 0xC4) {
        tables_h(body, len);
      } else if (m == 0xCC) {
        throw Fail{2, "arithmetic-coded JPEG is not decoded by the port"};
      } else if (m == 0xC8) {
        throw Fail{1, "libjpeg refuses the JPG marker"};
      } else if (m == 0xDB) {
        tables_q(body, len);
      } else if (m == 0xDD) {
        restart = u16(body);
      } else if (m == 0xE0) {
        if (len >= 7 && memcmp(d + body, "JFIF\0", 5) == 0) jfif = true;
      } else if (m == 0xEE) {
        if (len >= 14 && memcmp(d + body, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = u8(body + 11);
        }
      } else if (m == 0xDA) {
        if (!have_frame) throw Fail{1, "scan before frame"};
        pos = scan(body, len);
        scanned = true;
        continue;
      }
      pos += len;
    }
    if (!have_frame || !scanned) throw Fail{1, "no image data"};
    for (auto& c : comps) {
      if (c.coef.empty() || c.coef_bits[0] < 0)
        throw Fail{1, "a component has no scan"};
      // jdcoefct.c smoothing_ok: libjpeg-turbo smooths the blocks of a
      // progressive image while coefficient 0-9 is not fully refined
      for (int k = 0; k < 10; ++k)
        if (progressive && c.coef_bits[k] != 0)
          throw Fail{2, "a progressive JPEG with unrefined coefficients "
                        "(block smoothing) is not decoded by the port"};
    }
    if (headers_only) return;
    for (auto& c : comps) {   // the IDCT of every block, once
      const int stride = c.bw * 8;
      c.plane.assign((size_t)c.bw * c.bh * 64, 0);
      int32_t blk[64];
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx) {
          const int16_t* in = c.coef.data() + ((size_t)by * c.bw + bx) * 64;
          for (int k = 0; k < 64; ++k) blk[k] = in[k];
          idct_islow(blk, c.qlatch, c.plane.data() + (size_t)by * 8 * stride +
                                        (size_t)bx * 8, stride);
        }
    }
  }

  bool rgb_space() const {
    if (ncomp != 3) return false;
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
  }

  // Upsampled component ci as a full-size plane (width x height).
  std::vector<uint8_t> upsample(const Comp& c) const {
    const int fh = hmax / c.h, fv = vmax / c.v;
    const int stride = c.bw * 8;
    std::vector<uint8_t> out((size_t)width * height);
    auto at = [&](int y, int x) -> int {
      y = y < 0 ? 0 : (y >= c.dh ? c.dh - 1 : y);   // context rows
      return c.plane[(size_t)y * stride + x];
    };
    const int ow = c.dw * fh;   // upsampled width before the crop
    std::vector<uint8_t> row(ow);
    for (int oy = 0; oy < height; ++oy) {
      if (fh == 1 && fv == 1) {
        for (int x = 0; x < width; ++x) row[x] = (uint8_t)at(oy, x);
      } else if (fh == 2 && fv == 1 && c.dw > 2) {          // h2v1 fancy
        const int y = oy;
        int in = at(y, 0);
        row[0] = (uint8_t)in;
        row[1] = (uint8_t)((in * 3 + at(y, 1) + 2) >> 2);
        for (int x = 1; x < c.dw - 1; ++x) {
          const int v3 = at(y, x) * 3;
          row[2 * x] = (uint8_t)((v3 + at(y, x - 1) + 1) >> 2);
          row[2 * x + 1] = (uint8_t)((v3 + at(y, x + 1) + 2) >> 2);
        }
        const int last = c.dw - 1;
        in = at(y, last);
        row[2 * last] = (uint8_t)((in * 3 + at(y, last - 1) + 1) >> 2);
        row[2 * last + 1] = (uint8_t)in;
      } else if (fh == 1 && fv == 2) {                     // h1v2 fancy
        const int y = oy / 2, v = oy & 1;
        const int y1 = v == 0 ? y - 1 : y + 1;
        const int bias = v == 0 ? 1 : 2;
        for (int x = 0; x < c.dw; ++x)
          row[x] = (uint8_t)((at(y, x) * 3 + at(y1, x) + bias) >> 2);
      } else if (fh == 2 && fv == 2 && c.dw > 2) {          // h2v2 fancy
        const int y = oy / 2, v = oy & 1;
        const int y1 = v == 0 ? y - 1 : y + 1;
        auto cs = [&](int x) { return at(y, x) * 3 + at(y1, x); };
        int this_ = cs(0), next = cs(1), last;
        row[0] = (uint8_t)((this_ * 4 + 8) >> 4);
        row[1] = (uint8_t)((this_ * 3 + next + 7) >> 4);
        last = this_;
        this_ = next;
        for (int x = 1; x < c.dw - 1; ++x) {
          next = cs(x + 1);
          row[2 * x] = (uint8_t)((this_ * 3 + last + 8) >> 4);
          row[2 * x + 1] = (uint8_t)((this_ * 3 + next + 7) >> 4);
          last = this_;
          this_ = next;
        }
        const int lx = c.dw - 1;
        row[2 * lx] = (uint8_t)((this_ * 3 + last + 8) >> 4);
        row[2 * lx + 1] = (uint8_t)((this_ * 4 + 7) >> 4);
      } else {                                             // box
        const int y = oy / fv;
        for (int x = 0; x < ow; ++x) row[x] = (uint8_t)at(y, x / fh);
      }
      memcpy(out.data() + (size_t)oy * width, row.data(), width);
    }
    return out;
  }

  void output(uint8_t* out) const {
    if (ncomp == 1) {
      std::vector<uint8_t> y = upsample(comps[0]);
      memcpy(out, y.data(), y.size());
      return;
    }
    if (ncomp == 4) {   // CMYK, or YCCK under an Adobe transform 2
      std::vector<uint8_t> p[4];
      for (int c = 0; c < 4; ++c) p[c] = upsample(comps[c]);
      const size_t np = (size_t)width * height;
      for (size_t i = 0; i < np; ++i)
        for (int c = 0; c < 4; ++c) out[4 * i + c] = p[c][i];
      if (adobe && adobe_transform == 2) ycck(out, np);
      return;
    }
    std::vector<uint8_t> p0 = upsample(comps[0]), p1 = upsample(comps[1]),
                         p2 = upsample(comps[2]);
    const size_t np = (size_t)width * height;
    if (rgb_space()) {
      for (size_t i = 0; i < np; ++i) {
        out[3 * i] = p0[i];
        out[3 * i + 1] = p1[i];
        out[3 * i + 2] = p2[i];
      }
      return;
    }
    ycc_rgb(out, p0, p1, p2, np, false);
  }

  // jdcolor.c ycck_cmyk_convert: the YCC part as RGB, subtracted from 255
  void ycck(uint8_t* out, size_t np) const {
    std::vector<uint8_t> y(np), cb(np), cr(np);
    for (size_t i = 0; i < np; ++i) {
      y[i] = out[4 * i];
      cb[i] = out[4 * i + 1];
      cr[i] = out[4 * i + 2];
    }
    std::vector<uint8_t> rgb(3 * np);
    ycc_rgb(rgb.data(), y, cb, cr, np, true);
    for (size_t i = 0; i < np; ++i)
      for (int c = 0; c < 3; ++c) out[4 * i + c] = rgb[3 * i + c];
  }

  void ycc_rgb(uint8_t* out, const std::vector<uint8_t>& p0,
               const std::vector<uint8_t>& p1,
               const std::vector<uint8_t>& p2, size_t np,
               bool inverted) const {
    // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
    const int64_t one_half = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255
                                                                   : v)); };
    const int m = inverted ? 255 : 0, sgn = inverted ? -1 : 1;
    for (size_t i = 0; i < np; ++i) {
      const int y = p0[i], cb = p1[i], cr = p2[i];
      out[3 * i] = clamp(m + sgn * (y + cr_r[cr]));
      out[3 * i + 1] = clamp(m + sgn * (y + (int)((cb_g[cb] + cr_g[cr]) >>
                                                  16)));
      out[3 * i + 2] = clamp(m + sgn * (y + cb_b[cb]));
    }
  }
};

}  // namespace

extern "C" const char* jpeg_last_error() { return g_error.c_str(); }

extern "C" int jpeg_info(const uint8_t* data, long long n, int* w, int* h,
                         int* nc) {
  try {
    Decoder dec{data, (size_t)n};
    dec.headers_only = true;
    dec.parse();
    if (!dec.have_frame) throw Fail{1, "no frame"};
    *w = dec.width;
    *h = dec.height;
    *nc = dec.ncomp;
    return 0;
  } catch (const Fail& f) {
    g_error = f.what;
    return f.code;
  }
}

// The components after the IDCT, before upsampling and colour conversion
// (libjpeg's raw data, which libtiff's old-style JPEG reads): dims gets
// the component count, then each component's h and v sampling factors
// and its plane's width and height (whole MCUs); out (when not null) the
// planes in turn.
extern "C" int jpeg_planes(const uint8_t* data, long long n, int* dims,
                           int cap, uint8_t* out) {
  try {
    Decoder dec{data, (size_t)n};
    dec.headers_only = out == nullptr;
    dec.parse();
    if (!dec.have_frame) throw Fail{1, "no frame"};
    if (cap < 1 + 4 * dec.ncomp) throw Fail{1, "dims buffer too small"};
    dims[0] = dec.ncomp;
    size_t off = 0;
    for (int i = 0; i < dec.ncomp; ++i) {
      const Comp& c = dec.comps[i];
      dims[1 + 4 * i] = c.h;
      dims[2 + 4 * i] = c.v;
      dims[3 + 4 * i] = c.bw * 8;
      dims[4 + 4 * i] = c.bh * 8;
      if (out) {
        memcpy(out + off, c.plane.data(), c.plane.size());
        off += c.plane.size();
      }
    }
    return 0;
  } catch (const Fail& f) {
    g_error = f.what;
    return f.code;
  } catch (...) {
    g_error = "out of memory";
    return 1;
  }
}

extern "C" int jpeg_decode(const uint8_t* data, long long n, uint8_t* out) {
  try {
    Decoder dec{data, (size_t)n};
    dec.parse();
    dec.output(out);
    return 0;
  } catch (const Fail& f) {
    g_error = f.what;
    return f.code;
  } catch (...) {
    g_error = "out of memory";
    return 1;
  }
}
