// Block-compressed texture decoding (BC1-BC7) that gives the bytes PIL 12's
// "bcn" decoder gives: its colour and alpha interpolation in integer
// arithmetic with truncating division, its BC7 mode table, anchor
// indices, weights and rotations, and its black opaque block for the
// reserved BC7 mode (a first byte of zero); for BC6H its endpoint layouts,
// unquantisation, interpolation and half-float finish, scaled to 8 bits
// by truncation (black for the reserved modes).
//
// One entry point, bcn_decode(src, n, fmt, w, h, out): fmt 1-7 is PIL's
// BCn number (5 unsigned; -5 BC5 signed; 6 BC6H unsigned, -6 signed), out
// is w * h RGBA bytes,
// rows top first; BC4 gives grey in R, G and B, BC5 red and green with
// blue 0 (128 when signed), and both alpha 255, as PIL's convert("RGBA") of its L and RGB
// images. Returns 0, or 1 when src holds fewer bytes than the blocks need.
#include <cstdint>
#include <cstring>

namespace {

struct rgba {
  uint8_t r, g, b, a;
};

inline int load16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t load32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}

rgba decode_565(int x) {
  rgba c;
  int r = (x & 0xf800) >> 8;
  r |= r >> 5;
  int g = (x & 0x7e0) >> 3;
  g |= g >> 6;
  int b = (x & 0x1f) << 3;
  b |= b >> 5;
  c.r = uint8_t(r);
  c.g = uint8_t(g);
  c.b = uint8_t(b);
  c.a = 255;
  return c;
}

// BC2 and BC3 colour blocks always take the four-colour form
void decode_bc1_color(rgba* dst, const uint8_t* src, bool separate_alpha) {
  int c0 = load16(src), c1 = load16(src + 2);
  uint32_t lut = load32(src + 4);
  rgba p[4];
  p[0] = decode_565(c0);
  p[1] = decode_565(c1);
  int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b;
  int r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || separate_alpha) {
    p[2] = {uint8_t((2 * r0 + r1) / 3), uint8_t((2 * g0 + g1) / 3),
            uint8_t((2 * b0 + b1) / 3), 255};
    p[3] = {uint8_t((r0 + 2 * r1) / 3), uint8_t((g0 + 2 * g1) / 3),
            uint8_t((b0 + 2 * b1) / 3), 255};
  } else {
    p[2] = {uint8_t((r0 + r1) / 2), uint8_t((g0 + g1) / 2),
            uint8_t((b0 + b1) / 2), 255};
    p[3] = {0, 0, 0, 0};
  }
  for (int n = 0; n < 16; n++) dst[n] = p[3 & (lut >> (2 * n))];
}

// an 8-value alpha (BC3), grey (BC4) or channel (BC5) block into byte o of
// each `stride`-byte pixel; `sign`: BC5 signed endpoints (+128)
void decode_bc3_alpha(uint8_t* dst, const uint8_t* src, int stride, int o,
                      bool sign) {
  int a0, a1;
  if (sign) {
    a0 = int(int8_t(src[0])) + 128;
    a1 = int(int8_t(src[1])) + 128;
  } else {
    a0 = src[0];
    a1 = src[1];
  }
  int lut1 = src[2] | (src[3] << 8) | (src[4] << 16);
  int lut2 = src[5] | (src[6] << 8) | (src[7] << 16);
  uint8_t a[8];
  a[0] = uint8_t(a0);
  a[1] = uint8_t(a1);
  if (a0 > a1) {
    for (int k = 1; k < 7; k++) a[k + 1] = uint8_t(((7 - k) * a0 + k * a1) / 7);
  } else {
    for (int k = 1; k < 5; k++) a[k + 1] = uint8_t(((5 - k) * a0 + k * a1) / 5);
    a[6] = 0;
    a[7] = 0xff;
  }
  for (int n = 0; n < 8; n++) dst[stride * n + o] = a[7 & (lut1 >> (3 * n))];
  for (int n = 0; n < 8; n++)
    dst[stride * (n + 8) + o] = a[7 & (lut2 >> (3 * n))];
}

// ------------------------------------------------------------------ BC7

struct bc7_mode_info {
  uint8_t ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};

const bc7_mode_info bc7_modes[] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

// subset of each texel: two subsets one bit each, three two bits each
const uint16_t bc7_si2[] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80,
    0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000,
    0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce,
    0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c,
    0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a,
    0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660,
    0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6, 0x639c,
    0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};
const uint32_t bc7_si3[] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050,
    0x5555a0a0, 0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090,
    0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054,
    0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414,
    0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424,
    0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580,
    0xaa141414, 0x96960000, 0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000,
    0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254};
// anchor indices: the second subset's of two, the second's and third's of
// three
const uint8_t bc7_ai0[] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
    15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
    6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t bc7_ai1[] = {
    3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
    3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
    8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
    3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t bc7_ai2[] = {
    15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
    15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
    15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
    15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};

const uint8_t bc7_weights2[] = {0, 21, 43, 64};
const uint8_t bc7_weights3[] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t bc7_weights4[] = {0,  4,  9,  13, 17, 21, 26, 30,
                                34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* bc7_get_weights(int n) {
  if (n == 2) return bc7_weights2;
  if (n == 3) return bc7_weights3;
  return bc7_weights4;
}

int bc7_get_subset(int ns, int partition, int n) {
  if (ns == 2) return 1 & (bc7_si2[partition] >> n);
  if (ns == 3) return 3 & (bc7_si3[partition] >> (2 * n));
  return 0;
}

uint8_t get_bits(const uint8_t* src, int bit, int count) {
  int by = bit >> 3;
  bit &= 7;
  if (!count) return 0;
  if (bit + count <= 8) return uint8_t((src[by] >> bit) & ((1 << count) - 1));
  int x = src[by] | (src[by + 1] << 8);
  return uint8_t((x >> bit) & ((1 << count) - 1));
}

uint8_t expand_quantized(uint8_t v, int bits) {
  v = uint8_t(v << (8 - bits));
  return uint8_t(v | (v >> bits));
}

void bc7_lerp(rgba* dst, const rgba* e, int s0, int s1) {
  int t0 = 64 - s0, t1 = 64 - s1;
  dst->r = uint8_t((t0 * e[0].r + s0 * e[1].r + 32) >> 6);
  dst->g = uint8_t((t0 * e[0].g + s0 * e[1].g + 32) >> 6);
  dst->b = uint8_t((t0 * e[0].b + s0 * e[1].b + 32) >> 6);
  dst->a = uint8_t((t1 * e[0].a + s1 * e[1].a + 32) >> 6);
}

void decode_bc7_block(rgba* col, const uint8_t* src) {
  int mode = src[0];
  if (!mode) {      // reserved mode: PIL writes black, opaque
    for (int i = 0; i < 16; i++) col[i] = {0, 0, 0, 255};
    return;
  }
  int bit = 0;
  while (!(mode & (1 << bit++))) {
  }
  mode = bit - 1;
  const bc7_mode_info& info = bc7_modes[mode];
  int cb = info.cb, ab = info.ab;
  const uint8_t* cw = bc7_get_weights(info.ib);
  const uint8_t* aw = bc7_get_weights((ab && info.ib2) ? info.ib2 : info.ib);
  auto load = [&](int n) {
    uint8_t v = get_bits(src, bit, n);
    bit += n;
    return v;
  };
  uint8_t partition = load(info.pb);
  uint8_t rotation = load(info.rb);
  uint8_t index_sel = load(info.isb);
  int numep = info.ns << 1;
  rgba ep[6];
  for (int i = 0; i < numep; i++) ep[i].r = load(cb);
  for (int i = 0; i < numep; i++) ep[i].g = load(cb);
  for (int i = 0; i < numep; i++) ep[i].b = load(cb);
  for (int i = 0; i < numep; i++) ep[i].a = ab ? load(ab) : 255;
  auto pbit = [&](uint8_t& x, uint8_t v) { x = uint8_t((x << 1) | v); };
  if (info.epb) {   // a p-bit per endpoint
    cb++;
    if (ab) ab++;
    for (int i = 0; i < numep; i++) {
      uint8_t v = load(1);
      pbit(ep[i].r, v);
      pbit(ep[i].g, v);
      pbit(ep[i].b, v);
      if (ab) pbit(ep[i].a, v);
    }
  }
  if (info.spb) {   // a p-bit per subset
    cb++;
    if (ab) ab++;
    for (int i = 0; i < numep; i += 2) {
      uint8_t v = load(1);
      for (int j = 0; j < 2; j++) {
        pbit(ep[i + j].r, v);
        pbit(ep[i + j].g, v);
        pbit(ep[i + j].b, v);
        if (ab) pbit(ep[i + j].a, v);
      }
    }
  }
  for (int i = 0; i < numep; i++) {
    ep[i].r = expand_quantized(ep[i].r, cb);
    ep[i].g = expand_quantized(ep[i].g, cb);
    ep[i].b = expand_quantized(ep[i].b, cb);
    if (ab) ep[i].a = expand_quantized(ep[i].a, ab);
  }
  int cibit = bit;
  int aibit = cibit + 16 * info.ib - info.ns;
  for (int i = 0; i < 16; i++) {
    int s = bc7_get_subset(info.ns, partition, i) << 1;
    int ib = info.ib;
    if (i == 0) {
      ib--;
    } else if (info.ns == 2) {
      if (i == bc7_ai0[partition]) ib--;
    } else if (info.ns == 3) {
      if (i == bc7_ai1[partition]) {
        ib--;
      } else if (i == bc7_ai2[partition]) {
        ib--;
      }
    }
    int i0 = get_bits(src, cibit, ib);
    cibit += ib;
    if (ab && info.ib2) {
      int ib2 = info.ib2;
      if (i == 0) ib2--;
      int i1 = get_bits(src, aibit, ib2);
      aibit += ib2;
      if (index_sel)
        bc7_lerp(&col[i], &ep[s], aw[i1], cw[i0]);
      else
        bc7_lerp(&col[i], &ep[s], cw[i0], aw[i1]);
    } else {
      bc7_lerp(&col[i], &ep[s], cw[i0], cw[i0]);
    }
    uint8_t v;
    if (rotation == 1) {
      v = col[i].r; col[i].r = col[i].a; col[i].a = v;
    } else if (rotation == 2) {
      v = col[i].g; col[i].g = col[i].a; col[i].a = v;
    } else if (rotation == 3) {
      v = col[i].b; col[i].b = col[i].a; col[i].a = v;
    }
  }
}


// ------------------------------------------------------------------ BC6H

// the bit layout of each mode's endpoints (the format's table, as PIL
// encodes it): bit i of the block after the mode bits goes to bit
// (v & 15) of endpoint value (v >> 4), values ordered r0 g0 b0 r1 g1 b1 r2
// g2 b2 r3 g3 b3
const uint8_t bc6_bit_packings[1050] = {
    116, 132, 180, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52,
    164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163,
    80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178,
    144, 145, 146, 147, 148, 179, 117, 164, 165, 0, 1, 2, 3, 4, 5, 6, 176,
    177, 132, 16, 17, 18, 19, 20, 21, 22, 133, 178, 116, 32, 33, 34, 35, 36,
    37, 38, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64,
    65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128,
    129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149,
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
    32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 10, 112,
    113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82,
    83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145,
    146, 147, 148, 179, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18,
    19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48,
    49, 50, 51, 10, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 26, 160,
    161, 162, 163, 80, 81, 82, 83, 42, 177, 128, 129, 130, 131, 96, 97, 98,
    99, 176, 178, 144, 145, 146, 147, 116, 179, 0, 0, 0, 0, 1, 2, 3, 4, 5,
    6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36,
    37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 132, 112, 113, 114, 115, 64, 65,
    66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 42, 128, 129,
    130, 131, 96, 97, 98, 99, 177, 178, 144, 145, 146, 147, 180, 179, 0, 0,
    0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 132, 16, 17, 18, 19, 20, 21, 22, 23, 24,
    116, 32, 33, 34, 35, 36, 37, 38, 39, 40, 180, 48, 49, 50, 51, 52, 164,
    112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81,
    82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145,
    146, 147, 148, 179, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 164, 132, 16, 17,
    18, 19, 20, 21, 22, 23, 178, 116, 32, 33, 34, 35, 36, 37, 38, 39, 179,
    180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68,
    176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131,
    96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149, 0, 0, 0, 0, 1,
    2, 3, 4, 5, 6, 7, 176, 132, 16, 17, 18, 19, 20, 21, 22, 23, 117, 116,
    32, 33, 34, 35, 36, 37, 38, 39, 165, 180, 48, 49, 50, 51, 52, 164, 112,
    113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82,
    83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145,
    146, 147, 148, 179, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 177, 132, 16, 17,
    18, 19, 20, 21, 22, 23, 133, 116, 32, 33, 34, 35, 36, 37, 38, 39, 181,
    180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68,
    176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96,
    97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179, 0, 0, 0, 0, 1, 2, 3,
    4, 5, 164, 176, 177, 132, 16, 17, 18, 19, 20, 21, 117, 133, 178, 116,
    32, 33, 34, 35, 36, 37, 165, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112,
    113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82,
    83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146,
    147, 148, 149, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49,
    50, 51, 52, 53, 54, 55, 56, 57, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73,
    80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52,
    53, 54, 55, 56, 10, 64, 65, 66, 67, 68, 69, 70, 71, 72, 26, 80, 81, 82,
    83, 84, 85, 86, 87, 88, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
    32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55,
    11, 10, 64, 65, 66, 67, 68, 69, 70, 71, 27, 26, 80, 81, 82, 83, 84, 85,
    86, 87, 43, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 2, 3,
    4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34,
    35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 15, 14, 13, 12, 11, 10, 64,
    65, 66, 67, 31, 30, 29, 28, 27, 26, 80, 81, 82, 83, 47, 46, 45, 44, 43,
    42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
// per mode: subsets, transformed, partition bits, endpoint bits, delta
// bits of red, green and blue
const uint8_t bc6_modes[98] = {
    2, 1, 5, 10, 5, 5, 5, 2, 1, 5, 7, 6, 6, 6, 2, 1, 5, 11, 5, 4, 4, 2, 1,
    5, 11, 4, 5, 4, 2, 1, 5, 11, 4, 4, 5, 2, 1, 5, 9, 5, 5, 5, 2, 1, 5, 8,
    6, 5, 5, 2, 1, 5, 8, 5, 6, 5, 2, 1, 5, 8, 5, 5, 6, 2, 0, 5, 6, 6, 6, 6,
    1, 0, 0, 10, 10, 10, 10, 1, 1, 0, 11, 9, 9, 9, 1, 1, 0, 12, 8, 8, 8, 1,
    1, 0, 16, 4, 4, 4};

int get_bit(const uint8_t* src, int bit) {
  return (src[bit >> 3] >> (bit & 7)) & 1;
}

void bc6_sign_extend(uint16_t* v, int prec) {
  int x = *v;
  if (x & (1 << (prec - 1))) x |= -1 << prec;
  *v = uint16_t(x);
}

int bc6_unquantize(uint16_t v, int bits, int sign) {
  if (!sign) {
    if (bits >= 15) return v;
    if (!v) return 0;
    if (v == ((1 << bits) - 1)) return 0xffff;
    return ((v << 16) + 0x8000) >> bits;
  }
  int x = int16_t(v), s = 0;
  if (bits >= 16) return x;
  if (x < 0) {
    s = 1;
    x = -x;
  }
  if (x != 0) {
    if (x >= ((1 << (bits - 1)) - 1))
      x = 0x7fff;
    else
      x = ((x << 15) + 0x4000) >> (bits - 1);
  }
  return s ? -x : x;
}

float half_to_float(uint16_t h) {
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000;
  o.u = uint32_t(h & 0x7fff) << 13;
  o.f *= m.f;
  m.u = 0x47800000;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= uint32_t(h & 0x8000) << 16;
  return o.f;
}

float bc6_finalize(int v, int sign) {
  if (sign) {
    if (v < 0) {
      v = ((-v) * 31) / 32;
      return half_to_float(uint16_t(0x8000 | v));
    }
    return half_to_float(uint16_t((v * 31) / 32));
  }
  return half_to_float(uint16_t((v * 31) / 64));
}

uint8_t bc6_clamp(float value) {
  if (value < 0.0f) return 0;
  if (value > 1.0f) return 255;
  return uint8_t(value * 255.0f);
}

void bc6_lerp(rgba* col, const int* e0, const int* e1, int s, int sign) {
  int t = 64 - s;
  int r = (e0[0] * t + e1[0] * s) >> 6;
  int g = (e0[1] * t + e1[1] * s) >> 6;
  int b = (e0[2] * t + e1[2] * s) >> 6;
  col->r = bc6_clamp(bc6_finalize(r, sign));
  col->g = bc6_clamp(bc6_finalize(g, sign));
  col->b = bc6_clamp(bc6_finalize(b, sign));
  col->a = 255;
}

void decode_bc6_block(rgba* col, const uint8_t* src, int sign) {
  uint16_t endpoints[12];
  int ueps[12];
  int bit = 5, epbits = 75, ib = 3;
  int mode = src[0] & 0x1f;
  if ((mode & 3) == 0 || (mode & 3) == 1) {
    mode &= 3;
    bit = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
    epbits = 72;
  } else {
    mode = 10 + (mode >> 2);
    epbits = 60;
    ib = 4;
  }
  if (mode >= 14) {   // reserved mode: PIL writes black
    for (int i = 0; i < 16; i++) col[i] = {0, 0, 0, 255};
    return;
  }
  const uint8_t* info = &bc6_modes[mode * 7];
  const int ns = info[0], tr = info[1], pb = info[2], epb = info[3];
  const int rb = info[4], gb = info[5], bb = info[6];
  const uint8_t* cw = bc7_get_weights(ib);
  const int numep = ns == 2 ? 12 : 6;
  for (int i = 0; i < 12; i++) endpoints[i] = 0;
  for (int i = 0; i < epbits; i++) {
    int di = bc6_bit_packings[mode * 75 + i];
    int dw = di >> 4;
    di &= 15;
    endpoints[dw] |= uint16_t(get_bit(src, bit + i) << di);
  }
  bit += epbits;
  int partition = get_bits(src, bit, pb);
  bit += pb;
  const int mask = (1 << epb) - 1;
  if (sign) {
    bc6_sign_extend(&endpoints[0], epb);
    bc6_sign_extend(&endpoints[1], epb);
    bc6_sign_extend(&endpoints[2], epb);
  }
  if (sign || tr) {
    for (int i = 3; i < numep; i += 3) {
      bc6_sign_extend(&endpoints[i], rb);
      bc6_sign_extend(&endpoints[i + 1], gb);
      bc6_sign_extend(&endpoints[i + 2], bb);
    }
  }
  if (tr) {   // deltas: masked to the endpoint width and, as in PIL, not
              // sign-extended again when signed
    for (int i = 3; i < numep; i += 3) {
      endpoints[i] = uint16_t((endpoints[i] + endpoints[0]) & mask);
      endpoints[i + 1] = uint16_t((endpoints[i + 1] + endpoints[1]) & mask);
      endpoints[i + 2] = uint16_t((endpoints[i + 2] + endpoints[2]) & mask);
    }
  }
  for (int i = 0; i < numep; i++)
    ueps[i] = bc6_unquantize(endpoints[i], epb, sign);
  for (int i = 0; i < 16; i++) {
    int s = bc7_get_subset(ns, partition, i) * 6;
    int ib2 = ib;
    if (i == 0) {
      ib2--;
    } else if (ns == 2 && i == bc7_ai0[partition]) {
      ib2--;
    }
    int i0 = get_bits(src, bit, ib2);
    bit += ib2;
    bc6_lerp(&col[i], &ueps[s], &ueps[s + 3], cw[i0], sign);
  }
}

}  // namespace

extern "C" int bcn_decode(const uint8_t* src, long long n, int fmt, int w,
                          int h, uint8_t* out) {
  const int bw = (w + 3) / 4, bh = (h + 3) / 4;
  const int block = (fmt == 1 || fmt == 4) ? 8 : 16;
  if (n < (long long)bw * bh * block) return 1;
  rgba col[16];
  for (int by = 0; by < bh; by++) {
    for (int bx = 0; bx < bw; bx++) {
      const uint8_t* p = src + ((long long)by * bw + bx) * block;
      std::memset(col, 0, sizeof(col));
      switch (fmt) {
        case 1:
          decode_bc1_color(col, p, false);
          break;
        case 2:
          decode_bc1_color(col, p + 8, true);
          for (int k = 0; k < 16; k++) {
            int bitI = k * 4;
            int av = 0xf & (p[bitI >> 3] >> (bitI & 7));
            col[k].a = uint8_t((av << 4) | av);
          }
          break;
        case 3:
          decode_bc1_color(col, p + 8, true);
          decode_bc3_alpha(reinterpret_cast<uint8_t*>(col), p, 4, 3, false);
          break;
        case 4:
          decode_bc3_alpha(reinterpret_cast<uint8_t*>(col), p, 4, 0, false);
          for (int k = 0; k < 16; k++) {
            col[k].g = col[k].b = col[k].r;
            col[k].a = 255;
          }
          break;
        case 5:
        case -5:
          decode_bc3_alpha(reinterpret_cast<uint8_t*>(col), p, 4, 0,
                           fmt < 0);
          decode_bc3_alpha(reinterpret_cast<uint8_t*>(col), p + 8, 4, 1,
                           fmt < 0);
          for (int k = 0; k < 16; k++) {
            col[k].b = fmt < 0 ? 128 : 0;   // a signed zero, as PIL stores
            col[k].a = 255;
          }
          break;
        case 6:
        case -6:
          decode_bc6_block(col, p, fmt < 0);
          break;
        case 7:
          decode_bc7_block(col, p);
          break;
        default:
          return 2;
      }
      for (int j = 0; j < 4; j++) {
        int y = by * 4 + j;
        if (y >= h) continue;
        for (int i = 0; i < 4; i++) {
          int x = bx * 4 + i;
          if (x >= w) continue;
          std::memcpy(out + 4 * ((long long)y * w + x), &col[j * 4 + i], 4);
        }
      }
    }
  }
  return 0;
}
