// JPEG decoder that reproduces libjpeg-turbo 3's default decompression, the
// one PIL's Image.open(...).convert("RGBA") runs, for every process PIL
// reads (8-bit samples):
// - SOF0/1 sequential and SOF2 progressive Huffman (jdhuff.c, jdphuff.c),
//   SOF9/10 sequential and progressive arithmetic coding (jdarith.c: the
//   QM decoder of ITU-T T.81 Annex D, DAC conditioning), and SOF3 lossless
//   Huffman (jdlhuff.c, jddiffct.c, jdlossls.c: predictors 1-7, the point
//   transform, the predictor reset at each restart);
// - libjpeg's recovery from damaged entropy data: a bad Huffman code
//   decodes as 0 after 17 bits, a marker met inside the data feeds zero
//   bits and leaves the rest of the restart interval as libjpeg leaves it,
//   jdarith's "ct = -1" stops a segment at a bad code, and jdmarker.c's
//   read_restart_marker / resync_to_restart handle a wrong, missing or
//   skipped RST number; next_marker skips extraneous bytes;
// - every scan decodes into a per-component coefficient buffer (each
//   component's quantization table latched at its first scan, jdinput.c),
//   and once all scans are read the blocks go through the islow IDCT as
//   libjpeg-turbo's SIMD code computes it (16-bit dequantization and sums,
//   saturating packs; on valid data it equals jidctint.c), with the block
//   smoothing of jdcoefct.c (libjpeg-turbo >= 2.1: a 5x5 neighbourhood of
//   DC values predicts AC coefficients 1-9, or the DC and AC 1-9 when no AC
//   scan was read) for a progressive image whose first nine AC
//   coefficients are not all fully refined;
// - the upsampling jdsample.c picks: the "fancy" triangle filters for
//   2h1v, 1h2v and 2h2v components of DCT images (box replication for
//   2h1v / 2h2v components at most 2 samples wide, for other integral
//   factors, and for every lossless image), with the last real sample row
//   repeated below the image and row 0 above it (jdmainct.c);
// - the fixed-point YCbCr -> RGB tables of jdcolor.c (SCALEBITS 16).
// The colour space is read as libjpeg reads it: one component is grey;
// three are YCbCr unless an Adobe marker says transform 0, or there is no
// JFIF marker and the component ids are 'R', 'G', 'B' (or 1, 2, 3 in a
// lossless image); four are CMYK, or YCCK under an Adobe transform other
// than 0.
//
// The source is read as the caller's library feeds it to libjpeg (`mode`):
// 0 is PIL's ImageFile.load, 64 KiB at a time into a suspending source, so
// a stream that ends early fails and arithmetic-coded data (jdarith.c
// cannot suspend) fails where it runs past the bytes read so far; 1 is
// libtiff's JPEG codec, whose source gives a fake EOI marker at the end of
// the data and which ignores the errors of jpeg_finish_decompress; 2 is
// libtiff's old-style JPEG codec, as 1 but whose source fails where
// libjpeg would resynchronize at a restart marker. `mode` >> 2 sets the
// colour spaces as a caller may set them after the headers: 1 passes every
// component through (libtiff's JCS_UNKNOWN), 2 converts YCbCr to RGB,
// whatever JFIF or Adobe markers the stream carries.
//
// C interface, called through ctypes (scene/jpeg.py):
//   jpeg_info(data, n, mode, &w, &h, &nc): parses the headers.
//   jpeg_factors(data, n, mode, hv, cap): the components' sampling factors.
//   jpeg_planes(data, n, mode, dims, cap, out): the components before
//   upsampling.
//   jpeg_decode(data, n, mode, out): out is h * w * nc bytes (nc 1, 3 or
//   4; four components are CMYK as stored, or YCCK converted to CMYK by
//   jdcolor.c's ycck_cmyk_convert).
//   jpeg_arith_table(out): the 114 entries of libjpeg's jpeg_aritab.
// They return 0, or 1 for a file PIL fails on (corrupt or truncated, other
// than 8-bit samples, hierarchical or arithmetic lossless coding, 2 or
// more than 4 components, fractional sampling ratios); jpeg_last_error()
// names the reason.

#include <stdint.h>
#include <string.h>

#include <string>
#include <vector>

namespace {

struct Fail {
  int code;
  std::string what;
};

struct EndOfInput {};   // the source ran out where libjpeg may stop
struct Suspend {};      // PIL's buffer ran out inside an MCU

std::string g_error;

constexpr size_t kChunk = 65536;   // PIL's ImageFile.MAXBLOCK

// jpeg_natural_order with its 16 extra entries for corrupt data (jutils.c)
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ITU-T T.81 Table D.2 as jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8
// | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 estimate.
#define V(i, qe, lps, mps, sw) \
  ((int64_t)(qe) << 16 | (int64_t)(mps) << 8 | (int64_t)(sw) << 7 | (lps))
const int64_t kAritab[114] = {
    V(0, 0x5a1d, 1, 1, 1),      V(1, 0x2586, 14, 2, 0),
    V(2, 0x1114, 16, 3, 0),     V(3, 0x080b, 18, 4, 0),
    V(4, 0x03d8, 20, 5, 0),     V(5, 0x01da, 23, 6, 0),
    V(6, 0x00e5, 25, 7, 0),     V(7, 0x006f, 28, 8, 0),
    V(8, 0x0036, 30, 9, 0),     V(9, 0x001a, 33, 10, 0),
    V(10, 0x000d, 35, 11, 0),   V(11, 0x0006, 9, 12, 0),
    V(12, 0x0003, 10, 13, 0),   V(13, 0x0001, 12, 13, 0),
    V(14, 0x5a7f, 15, 15, 1),   V(15, 0x3f25, 36, 16, 0),
    V(16, 0x2cf2, 38, 17, 0),   V(17, 0x207c, 39, 18, 0),
    V(18, 0x17b9, 40, 19, 0),   V(19, 0x1182, 42, 20, 0),
    V(20, 0x0cef, 43, 21, 0),   V(21, 0x09a1, 45, 22, 0),
    V(22, 0x072f, 46, 23, 0),   V(23, 0x055c, 48, 24, 0),
    V(24, 0x0406, 49, 25, 0),   V(25, 0x0303, 51, 26, 0),
    V(26, 0x0240, 52, 27, 0),   V(27, 0x01b1, 54, 28, 0),
    V(28, 0x0144, 56, 29, 0),   V(29, 0x00f5, 57, 30, 0),
    V(30, 0x00b7, 59, 31, 0),   V(31, 0x008a, 60, 32, 0),
    V(32, 0x0068, 62, 33, 0),   V(33, 0x004e, 63, 34, 0),
    V(34, 0x003b, 32, 35, 0),   V(35, 0x002c, 33, 9, 0),
    V(36, 0x5ae1, 37, 37, 1),   V(37, 0x484c, 64, 38, 0),
    V(38, 0x3a0d, 65, 39, 0),   V(39, 0x2ef1, 67, 40, 0),
    V(40, 0x261f, 68, 41, 0),   V(41, 0x1f33, 69, 42, 0),
    V(42, 0x19a8, 70, 43, 0),   V(43, 0x1518, 72, 44, 0),
    V(44, 0x1177, 73, 45, 0),   V(45, 0x0e74, 74, 46, 0),
    V(46, 0x0bfb, 75, 47, 0),   V(47, 0x09f8, 77, 48, 0),
    V(48, 0x0861, 78, 49, 0),   V(49, 0x0706, 79, 50, 0),
    V(50, 0x05cd, 48, 51, 0),   V(51, 0x04de, 50, 52, 0),
    V(52, 0x040f, 50, 53, 0),   V(53, 0x0363, 51, 54, 0),
    V(54, 0x02d4, 52, 55, 0),   V(55, 0x025c, 53, 56, 0),
    V(56, 0x01f8, 54, 57, 0),   V(57, 0x01a4, 55, 58, 0),
    V(58, 0x0160, 56, 59, 0),   V(59, 0x0125, 57, 60, 0),
    V(60, 0x00f6, 58, 61, 0),   V(61, 0x00cb, 59, 62, 0),
    V(62, 0x00ab, 61, 63, 0),   V(63, 0x008f, 61, 32, 0),
    V(64, 0x5b12, 65, 65, 1),   V(65, 0x4d04, 80, 66, 0),
    V(66, 0x412c, 81, 67, 0),   V(67, 0x37d8, 82, 68, 0),
    V(68, 0x2fe8, 83, 69, 0),   V(69, 0x293c, 84, 70, 0),
    V(70, 0x2379, 86, 71, 0),   V(71, 0x1edf, 87, 72, 0),
    V(72, 0x1aa9, 87, 73, 0),   V(73, 0x174e, 72, 74, 0),
    V(74, 0x1424, 72, 75, 0),   V(75, 0x119c, 74, 76, 0),
    V(76, 0x0f6b, 74, 77, 0),   V(77, 0x0d51, 75, 78, 0),
    V(78, 0x0bb6, 77, 79, 0),   V(79, 0x0a40, 77, 48, 0),
    V(80, 0x5832, 80, 81, 1),   V(81, 0x4d1c, 88, 82, 0),
    V(82, 0x438e, 89, 83, 0),   V(83, 0x3bdd, 90, 84, 0),
    V(84, 0x34ee, 91, 85, 0),   V(85, 0x2eae, 92, 86, 0),
    V(86, 0x299a, 93, 87, 0),   V(87, 0x2516, 86, 71, 0),
    V(88, 0x5570, 88, 89, 1),   V(89, 0x4ca9, 95, 90, 0),
    V(90, 0x44d9, 96, 91, 0),   V(91, 0x3e22, 97, 92, 0),
    V(92, 0x3824, 99, 93, 0),   V(93, 0x32b4, 99, 94, 0),
    V(94, 0x2e17, 93, 86, 0),   V(95, 0x56a8, 95, 96, 1),
    V(96, 0x4f46, 101, 97, 0),  V(97, 0x47e5, 102, 98, 0),
    V(98, 0x41cf, 103, 99, 0),  V(99, 0x3c3d, 104, 100, 0),
    V(100, 0x375e, 99, 93, 0),  V(101, 0x5231, 105, 102, 0),
    V(102, 0x4c0f, 106, 103, 0), V(103, 0x4639, 107, 104, 0),
    V(104, 0x415e, 103, 99, 0), V(105, 0x5627, 105, 106, 1),
    V(106, 0x50e7, 108, 107, 0), V(107, 0x4b85, 109, 103, 0),
    V(108, 0x5597, 110, 109, 0), V(109, 0x504f, 111, 107, 0),
    V(110, 0x5a10, 110, 111, 1), V(111, 0x5522, 112, 109, 0),
    V(112, 0x59eb, 112, 111, 1), V(113, 0x5a1d, 113, 113, 0)};
#undef V

// The tables of ITU-T T.81 Annex K.3 that jstdhuff.c supplies when a scan
// names a missing table 0 or 1 (Motion-JPEG streams carry none).
const uint8_t kStdBits[4][17] = {
    {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},
    {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
     0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
     0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
     0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
     0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
     0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
     0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

// A Huffman table as DHT gives it, and jdhuff.c's derived tables
// (jpeg_make_d_derived_tbl): 8-bit lookahead, maxcode and valoffset.
struct Huff {
  bool present = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int64_t maxcode[18];
  int64_t valoffset[18];
  int lookup[256];

  void derive(bool dc, int maxsym) {
    int size[257], code_of[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (p + bits[l] > 256) throw Fail{1, "bad Huffman table"};
      for (int i = 0; i < bits[l]; ++i) size[p++] = l;
    }
    size[p] = 0;
    const int nsym = p;
    int64_t code = 0;
    int si = size[0];
    p = 0;
    while (size[p]) {
      while (size[p] == si) code_of[p++] = (int)code++;
      if (code >= ((int64_t)1 << si)) throw Fail{1, "bad Huffman table"};
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = (int64_t)p - code_of[p];
        p += bits[l];
        maxcode[l] = code_of[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    for (int i = 0; i < 256; ++i) lookup[i] = 9 << 8;
    p = 0;
    for (int l = 1; l <= 8; ++l)
      for (int i = 1; i <= bits[l]; ++i, ++p) {
        int look = code_of[p] << (8 - l);
        for (int c = 1 << (8 - l); c > 0; --c) lookup[look++] = l << 8 | vals[p];
      }
    if (dc)
      for (int i = 0; i < nsym; ++i)
        if (vals[i] > maxsym) throw Fail{1, "bad Huffman table"};
  }
};

struct Comp {
  int id = 0, h = 0, v = 0, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;   // blocks across and down in the buffer (whole MCUs)
  int wib = 0, hib = 0; // blocks (samples, lossless) holding image data
  int dw = 0, dh = 0;   // downsampled width and height (real samples)
  std::vector<int16_t> coef;   // bw x bh blocks of 64, natural order
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples (dw x dh, lossless)
  bool latched = false;
  uint16_t qval[64] = {0};     // the quantization table at its first scan
  int coef_bits[64] = {0};     // jdinput.c's coef_bits: -1 until seen
  int prev_bits[64] = {0};     // libjpeg-turbo's second half of coef_bits
  int dc_pred = 0, dc_context = 0;
};

inline int extend(int v, int t) {
  return v < (1 << (t - 1)) ? v + (int)(((unsigned)-1 << t) + 1) : v;
}

inline int16_t sat16(int32_t x) {
  return (int16_t)(x < -32768 ? -32768 : (x > 32767 ? 32767 : x));
}

// jidctint.c's islow IDCT as libjpeg-turbo's x86 SIMD code computes it
// (jidctint-avx2.asm, jidctint-sse2.asm): the dequantized coefficients,
// the sums of two inputs and the pass-1 results are 16-bit (wrapping adds,
// saturating packs), pmaddwd pairs the multiplications, and the output is
// saturated to -128..127 before the +128 centring. A block whose rows 1-7
// are all zero takes the column shortcut of the SIMD code.
constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int32_t w32(int64_t x) { return (int32_t)(uint32_t)(uint64_t)x; }

// One 1-D pass over 8 inputs; out[i] gets (x + round) >> shift of the 32-bit
// results, in the order of their rows.
inline void idct_1d(const int16_t* in, int stride, int32_t* out, int shift) {
  const int32_t i0 = in[0], i1 = in[stride], i2 = in[2 * stride],
                i3 = in[3 * stride], i4 = in[4 * stride], i5 = in[5 * stride],
                i6 = in[6 * stride], i7 = in[7 * stride];
  const int32_t t3 = w32((int64_t)i2 * (F0541 + F0765) + (int64_t)i6 * F0541);
  const int32_t t2 = w32((int64_t)i2 * F0541 + (int64_t)i6 * (F0541 - F1847));
  const int32_t t0 = w32((int64_t)(int16_t)(i0 + i4) * (1 << 13));
  const int32_t t1 = w32((int64_t)(int16_t)(i0 - i4) * (1 << 13));
  const int32_t t10 = w32((int64_t)t0 + t3), t13 = w32((int64_t)t0 - t3);
  const int32_t t11 = w32((int64_t)t1 + t2), t12 = w32((int64_t)t1 - t2);
  const int32_t z3 = (int16_t)(i7 + i3), z4 = (int16_t)(i5 + i1);
  const int32_t z3p = w32((int64_t)z3 * (F1175 - F1961) + (int64_t)z4 * F1175);
  const int32_t z4p = w32((int64_t)z3 * F1175 + (int64_t)z4 * (F1175 - F0390));
  const int32_t o0 = w32((int64_t)i7 * (F0298 - F0899) + (int64_t)i1 * -F0899 +
                         z3p);
  const int32_t o3 = w32((int64_t)i7 * -F0899 + (int64_t)i1 * (F1501 - F0899) +
                         z4p);
  const int32_t o1 = w32((int64_t)i5 * (F2053 - F2562) + (int64_t)i3 * -F2562 +
                         z4p);
  const int32_t o2 = w32((int64_t)i5 * -F2562 + (int64_t)i3 * (F3072 - F2562) +
                         z3p);
  const int64_t rnd = (int64_t)1 << (shift - 1);
  auto d = [&](int64_t x) { return (int32_t)(w32(w32(x) + rnd) >> shift); };
  out[0] = d((int64_t)t10 + o3);
  out[7] = d((int64_t)t10 - o3);
  out[1] = d((int64_t)t11 + o2);
  out[6] = d((int64_t)t11 - o2);
  out[2] = d((int64_t)t12 + o1);
  out[5] = d((int64_t)t12 - o1);
  out[3] = d((int64_t)t13 + o0);
  out[4] = d((int64_t)t13 - o0);
}

void idct_islow(const int16_t* coef, const int16_t* mult, uint8_t* out,
                int stride) {
  int16_t dq[64], ws[64];
  bool ac_zero = true;
  for (int k = 8; k < 64; ++k) ac_zero = ac_zero && coef[k] == 0;
  for (int k = 0; k < 64; ++k) dq[k] = (int16_t)(coef[k] * mult[k]);
  if (ac_zero) {
    for (int c = 0; c < 8; ++c) {
      const int16_t dc = (int16_t)(uint16_t)((uint16_t)dq[c] << 2);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
    }
  } else {
    int32_t col[8];
    for (int c = 0; c < 8; ++c) {
      idct_1d(dq + c, 8, col, 11);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = sat16(col[r]);
    }
  }
  int32_t row[8];
  for (int r = 0; r < 8; ++r) {
    idct_1d(ws + r * 8, 1, row, 18);
    uint8_t* o = out + (size_t)r * stride;
    for (int c = 0; c < 8; ++c) {
      int32_t x = sat16(row[c]);
      x = x < -128 ? -128 : (x > 127 ? 127 : x);
      o[c] = (uint8_t)(x + 128);
    }
  }
}

struct Decoder {
  const uint8_t* d;
  size_t n;
  int mode = 0;              // the source: 0 PIL, 1 libtiff, 2 OJPEG
  int colour = 0;            // 0 as read, 1 passed through, 2 YCbCr
  size_t pos = 0;
  size_t window = kChunk;    // bytes PIL has read so far (mode 0)
  bool no_suspend = false;   // inside jdarith.c, which cannot suspend
  bool suspendable = false;  // inside a sequential Huffman MCU
  bool eof_ok = false;       // a single-scan image wants only its markers
  bool rows_done = false;    // a single-scan image's rows are all out
  int unread_marker = 0;
  int next_restart = 0;

  int width = 0, height = 0, ncomp = 0;
  bool have_frame = false, jfif = false, adobe = false;
  bool progressive = false, arith = false, lossless = false;
  bool multi_scan = false, scanned = false;
  int ss = 0, se = 63, ah = 0, al = 0;   // the current scan's parameters
  int scan_number = 0;
  int adobe_transform = -1;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart = 0;
  uint16_t q[4][64];
  bool q_present[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  uint8_t dac_l[16], dac_u[16], dac_k[16];
  std::vector<Comp> comps;
  bool headers_only = false;
  int last_good_row = 0;     // jdmaster's last_good_iMCU_row

  // Huffman bit reader (jdhuff.h / jdhuff.c), 64-bit get_buffer
  uint64_t gbuf = 0;
  int bits_left = 0;
  bool insufficient = false;
  int eobrun = 0;

  // arithmetic decoder (jdarith.c)
  int64_t ac_c = 0, ac_a = 0;
  int ac_ct = -16;
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin[4] = {113, 0, 0, 0};

  // ------------------------------------------------------------ source
  int next_byte() {
    if (mode == 0 && pos >= window) {
      if (no_suspend)
        throw Fail{1, "arithmetic-coded data runs past the bytes PIL has "
                      "read (libjpeg cannot suspend there)"};
      if (suspendable && window < n) throw Suspend{};
      while (pos >= window) window += kChunk;   // PIL reads another block
    }
    if (pos >= n) {
      if (mode >= 1) return ((pos++ - n) & 1) ? 0xD9 : 0xFF;   // fake EOI
      if (eof_ok) throw EndOfInput{};
      throw Fail{1, "truncated JPEG file"};
    }
    return d[pos++];
  }
  int u16() {
    const int a = next_byte();
    return a << 8 | next_byte();
  }
  void skip(long k) {
    while (k-- > 0) next_byte();
  }

  // jdmarker.c next_marker: skip to FF, swallow FF fill, FF 00 is data
  void next_marker() {
    int c;
    for (;;) {
      c = next_byte();
      while (c != 0xFF) c = next_byte();
      do c = next_byte();
      while (c == 0xFF);
      if (c != 0) break;
    }
    unread_marker = c;
  }

  // jdmarker.c read_restart_marker and jpeg_resync_to_restart
  void read_restart_marker() {
    if (unread_marker == 0) next_marker();
    if (unread_marker == 0xD0 + next_restart) {
      unread_marker = 0;
    } else if (mode == 2) {
      throw Fail{1, "libtiff's old-style JPEG source fails where libjpeg "
                    "would resynchronize at a restart marker"};
    } else {
      const int desired = next_restart;
      int marker = unread_marker;
      for (;;) {
        int action;
        if (marker < 0xC0) action = 2;
        else if (marker < 0xD0 || marker > 0xD7) action = 3;
        else if (marker == 0xD0 + ((desired + 1) & 7) ||
                 marker == 0xD0 + ((desired + 2) & 7)) action = 3;
        else if (marker == 0xD0 + ((desired - 1) & 7) ||
                 marker == 0xD0 + ((desired - 2) & 7)) action = 2;
        else action = 1;
        if (action == 1) {
          unread_marker = 0;
          break;
        }
        if (action == 3) break;
        next_marker();
        marker = unread_marker;
      }
    }
    next_restart = (next_restart + 1) & 7;
  }

  // ------------------------------------------------------ Huffman bits
  // jpeg_fill_bit_buffer: up to 57 bits unless a marker stops it; past
  // the marker, zero bits, and insufficient_data once a request needs them
  void fill(int nbits) {
    if (unread_marker == 0) {
      while (bits_left < 57) {
        int c = next_byte();
        if (c == 0xFF) {
          do c = next_byte();
          while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            unread_marker = c;
            goto no_more;
          }
        }
        gbuf = gbuf << 8 | (uint64_t)c;
        bits_left += 8;
      }
      return;
    }
  no_more:
    if (nbits > bits_left) {
      insufficient = true;
      gbuf <<= 57 - bits_left;
      bits_left = 57;
    }
  }
  int get(int k) {
    if (bits_left < k) fill(k);
    bits_left -= k;
    return (int)((gbuf >> bits_left) & ((1u << k) - 1));
  }
  // HUFF_DECODE and jpeg_huff_decode: a code longer than 16 bits is 0
  int huff(const Huff& h) {
    int nb;
    if (bits_left < 8) {
      fill(0);
      if (bits_left < 8) {
        nb = 1;
        goto slow;
      }
    }
    {
      const int e = h.lookup[(gbuf >> (bits_left - 8)) & 0xFF];
      nb = e >> 8;
      if (nb <= 8) {
        bits_left -= nb;
        return e & 0xFF;
      }
    }
  slow:
    int l = nb;
    int64_t code = get(l);
    while (code > h.maxcode[l]) {
      code = code << 1 | get(1);
      ++l;
    }
    if (l > 16) return 0;
    return h.vals[(int)(code + h.valoffset[l])];
  }
  int huff_value(const Huff& h) {   // a DC difference or AC value
    const int s = huff(h);
    return s ? extend(get(s), s) : 0;
  }

  // ---------------------------------------------------- arithmetic bits
  int arith_decode(uint8_t* st) {
    while (ac_a < 0x8000) {
      if (--ac_ct < 0) {
        int data = 0;
        if (!unread_marker) {
          data = next_byte();
          if (data == 0xFF) {
            do data = next_byte();
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              unread_marker = data;
              data = 0;
            }
          }
        }
        ac_c = ac_c << 8 | data;
        if ((ac_ct += 8) < 0)
          if (++ac_ct == 0) ac_a = 0x8000;
      }
      ac_a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const int nl = (int)(qe & 0xFF);
    qe >>= 8;
    const int nm = (int)(qe & 0xFF);
    qe >>= 8;
    int64_t temp = ac_a - qe;
    ac_a = temp;
    temp <<= ac_ct;
    if (ac_c >= temp) {
      ac_c -= temp;
      if (ac_a < qe) {
        ac_a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        ac_a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (ac_a < 0x8000) {
      if (ac_a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // Figures F.19-F.24: a DC difference with its conditioning; false on a
  // magnitude overflow (jdarith's ct = -1)
  bool arith_dc(Comp& c, int* out) {
    uint8_t* st = dc_stats[c.td] + c.dc_context;
    if (arith_decode(st) == 0) {
      c.dc_context = 0;
      *out = 0;
      return true;
    }
    const int sign = arith_decode(st + 1);
    st += 2 + sign;
    int m = arith_decode(st);
    if (m != 0) {
      st = dc_stats[c.td] + 20;
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    if (m < (int)((1L << dac_l[c.td]) >> 1)) c.dc_context = 0;
    else if (m > (int)((1L << dac_u[c.td]) >> 1)) c.dc_context = 12 + sign * 4;
    else c.dc_context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    *out = sign ? -v : v;
    return true;
  }
  // an AC value after its zero run (Figures F.21-F.24); false on overflow
  bool arith_ac_value(int tbl, int k, uint8_t* st, int* out) {
    const int sign = arith_decode(fixed_bin);
    st += 2;
    int m = arith_decode(st);
    if (m != 0 && arith_decode(st)) {
      m <<= 1;
      st = ac_stats[tbl] + (k <= dac_k[tbl] ? 189 : 217);
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    *out = sign ? -v : v;
    return true;
  }

  // ------------------------------------------------------------ headers
  void frame(int len, int sof) {
    // PIL's SOF handler refuses other than 8-bit samples, whatever the
    // process; libjpeg-turbo refuses the hierarchical (differential) ones
    // and jdmaster.c arithmetic-coded lossless
    if (have_frame) throw Fail{1, "two frames"};
    const int prec = next_byte();
    height = u16();
    width = u16();
    ncomp = next_byte();
    if (prec != 8) throw Fail{1, "PIL reads only 8-bit JPEG samples"};
    if (sof == 5 || sof == 6 || sof == 7 || sof >= 13 || sof == 8)
      throw Fail{1, "libjpeg refuses hierarchical JPEG"};
    if (sof == 11) throw Fail{1, "libjpeg-turbo refuses arithmetic-coded "
                                 "lossless JPEG"};
    progressive = sof == 2 || sof == 10;
    arith = sof >= 9;
    lossless = sof == 3;
    if (width <= 0 || height <= 0 || ncomp <= 0)
      throw Fail{1, "empty JPEG image"};
    if (len - 8 != 3 * ncomp) throw Fail{1, "bad SOF length"};
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      throw Fail{1, "PIL reads JPEG of 1, 3 or 4 components"};
    for (int i = 0; i < ncomp; ++i) {
      Comp c;
      c.id = next_byte();
      const int hv = next_byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = next_byte();
      comps.push_back(c);
    }
    have_frame = true;
  }

  // jdinput.c initial_setup, at the first SOS
  void initial_setup() {
    if (width > 65500 || height > 65500) throw Fail{1, "image too big"};
    hmax = vmax = 1;
    for (auto& c : comps) {
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        throw Fail{1, "bad sampling factors"};
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    const int du = lossless ? 1 : 8;
    mcux = (width + du * hmax - 1) / (du * hmax);
    mcuy = (height + du * vmax - 1) / (du * vmax);
    for (auto& c : comps) {
      // jdsample.c: only integral sampling ratios are upsampled
      if (hmax % c.h || vmax % c.v)
        throw Fail{1, "libjpeg refuses fractional sampling ratios"};
      c.dw = (int)(((long)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((long)height * c.v + vmax - 1) / vmax);
      c.wib = (c.dw + du - 1) / du;
      c.hib = (c.dh + du - 1) / du;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = c.prev_bits[k] = -1;
      if (lossless) c.plane.assign((size_t)c.dw * c.dh, 0);
      else c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
  }

  void tables_q(long len) {   // jdmarker.c get_dqt
    while (len > 0) {
      const int b = next_byte();
      const int pq = b >> 4, tq = b & 15;
      if (tq > 3) throw Fail{1, "bad DQT index"};
      for (int k = 0; k < 64; ++k)
        q[tq][kNatural[k]] = (uint16_t)(pq ? u16() : next_byte());
      len -= pq ? 129 : 65;
      q_present[tq] = true;
    }
    if (len != 0) throw Fail{1, "bad DQT length"};
  }

  void tables_h(long len) {
    while (len > 16) {
      const int index = next_byte();
      Huff h;
      int total = 0;
      for (int l = 1; l <= 16; ++l) {
        h.bits[l] = (uint8_t)next_byte();
        total += h.bits[l];
      }
      len -= 17;
      if (total > 256 || total > len) throw Fail{1, "bad DHT"};
      for (int k = 0; k < total; ++k) h.vals[k] = (uint8_t)next_byte();
      len -= total;
      h.present = true;
      if (index & 0x10) {
        if (index - 0x10 > 3) throw Fail{1, "bad DHT index"};
        ac[index - 0x10] = h;
      } else {
        if (index > 3) throw Fail{1, "bad DHT index"};
        dc[index] = h;
      }
    }
    if (len != 0) throw Fail{1, "bad DHT length"};
  }

  void tables_ac(long len) {   // jdmarker.c get_dac
    while (len > 0) {
      const int index = next_byte(), val = next_byte();
      len -= 2;
      if (index >= 32) throw Fail{1, "bad DAC index"};
      if (index >= 16) {
        dac_k[index - 16] = (uint8_t)val;
      } else {
        dac_l[index] = (uint8_t)(val & 15);
        dac_u[index] = (uint8_t)(val >> 4);
        if (dac_l[index] > dac_u[index]) throw Fail{1, "bad DAC value"};
      }
    }
    if (len != 0) throw Fail{1, "bad DAC length"};
  }

  // APP0 / APP14 as jdmarker.c's get_interesting_appn reads them
  void app(int m, long len) {
    uint8_t b[14];
    const int k = len >= 14 ? 14 : (len > 0 ? (int)len : 0);
    for (int i = 0; i < k; ++i) b[i] = (uint8_t)next_byte();
    if (m == 0xE0 && k >= 14 && memcmp(b, "JFIF\0", 5) == 0) jfif = true;
    if (m == 0xEE && k >= 12 && memcmp(b, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = b[11];
    }
    skip(len - k);
  }

  // jstdhuff.c std_huff_tables, as jinit_huff_decoder calls it for a
  // sequential Huffman image: tables 0 and 1 still undefined at the first
  // scan become the tables of T.81 Annex K.3 (Motion-JPEG streams carry
  // none); the progressive decoder installs none
  void std_tables() {
    for (int t = 0; t < 2; ++t)
      for (int is_dc = 0; is_dc < 2; ++is_dc) {
        Huff& h = is_dc ? dc[t] : ac[t];
        if (h.present) continue;
        memcpy(h.bits, kStdBits[(is_dc ? 0 : 2) + t], 17);
        memcpy(h.vals, is_dc ? kStdDcVals : kStdAcVals[t],
               is_dc ? 12 : 162);
        h.present = true;
      }
  }

  // The derived Huffman table `t` of a scan (jpeg_make_d_derived_tbl)
  const Huff& table(Huff* set, int t, bool is_dc) {
    if (t > 3 || !set[t].present)
      throw Fail{1, "SOS names a missing Huffman table"};
    set[t].derive(is_dc, lossless ? 16 : 15);
    return set[t];
  }

  // ------------------------------------------------------------ scans
  void scan() {
    const long len = u16();
    const int ns = next_byte();
    if (len != ns * 2 + 6 || ns < 1 || ns > 4) throw Fail{1, "bad SOS"};
    // jdmarker.c get_sos: a component is looked up among those whose
    // index is still free as a scan slot, and may not repeat
    std::vector<Comp*> sc;
    Comp* slot[4] = {nullptr, nullptr, nullptr, nullptr};
    for (int i = 0; i < ns; ++i) {
      const int id = next_byte(), tt = next_byte();
      Comp* found = nullptr;
      for (int ci = 0; ci < ncomp && ci < 4; ++ci)
        if (comps[ci].id == id && !slot[ci]) {
          found = &comps[ci];
          break;
        }
      if (!found) throw Fail{1, "SOS names an unknown component"};
      slot[i] = found;
      found->td = tt >> 4;
      found->ta = tt & 15;
      for (auto* s : sc)
        if (s == found) throw Fail{1, "SOS names a component twice"};
      sc.push_back(found);
    }
    ss = next_byte();
    se = next_byte();
    ah = next_byte();
    al = ah & 15;
    ah >>= 4;
    next_restart = 0;
    ++scan_number;
    if (!scanned) {
      initial_setup();
      multi_scan = ns < ncomp || progressive;
      if (!progressive && !arith && !lossless) std_tables();
      // jdcolor.c allows no colour conversion of a lossless image
      if (lossless && ((ncomp == 3 && !rgb_space()) || ycck_space()))
        throw Fail{1, "libjpeg converts no colours of a lossless JPEG"};
      if (colour == 2 && ncomp != 3)
        throw Fail{1, "YCbCr asked of other than three components"};
    } else if (!multi_scan) {
      throw Fail{1, "a second scan in a single-scan image"};
    }
    scanned = true;
    // jdinput.c per_scan_setup
    if (ns > 1) {
      int blocks = 0;
      for (auto* c : sc) blocks += c->h * c->v;
      if (blocks > 10) throw Fail{1, "bad MCU size"};
    }
    if (lossless) {
      for (auto* c : sc) table(dc, c->td, true);
      if (!headers_only) lossless_scan(sc);
      return;
    }
    for (auto* c : sc)
      if (!c->latched) {   // jdinput.c latch_quant_tables
        if (c->tq > 3 || !q_present[c->tq])
          throw Fail{1, "missing quantization table"};
        memcpy(c->qval, q[c->tq], sizeof(c->qval));
        c->latched = true;
      }
    start_pass(sc);
    // headers_only stops where jpeg_start_decompress would have checked
    // the first scan
    if (!headers_only) decode_scan(sc);
  }

  // jdhuff.c / jdphuff.c / jdarith.c start_pass
  void start_pass(const std::vector<Comp*>& sc) {
    if (progressive) {
      bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || sc.size() != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) throw Fail{1, "bad progressive scan parameters"};
      for (auto* c : sc) {
        const int lo = ss < 1 ? ss : 1, hi = se > 9 ? se : 9;
        for (int k = lo; k <= hi; ++k)
          c->prev_bits[k] = scan_number > 1 ? c->coef_bits[k] : 0;
        for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
      }
    }
    const bool dc_first = !progressive || (ss == 0 && ah == 0);
    const bool need_ac = !progressive || ss > 0;
    for (auto* c : sc) {
      if (arith) {
        if (dc_first) {
          memset(dc_stats[c->td], 0, 64);
          c->dc_pred = 0;
          c->dc_context = 0;
        }
        if (need_ac) memset(ac_stats[c->ta], 0, 256);
      } else {
        if (dc_first) table(dc, c->td, true);
        if (need_ac) table(ac, c->ta, false);
        c->dc_pred = 0;
      }
    }
    bits_left = 0;
    gbuf = 0;
    insufficient = false;
    eobrun = 0;
    ac_c = 0;
    ac_a = 0;
    ac_ct = -16;
  }

  void process_restart(const std::vector<Comp*>& sc) {
    if (arith) {
      read_restart_marker();
      for (auto* c : sc) {
        if (!progressive || (ss == 0 && ah == 0)) {
          memset(dc_stats[c->td], 0, 64);
          c->dc_pred = 0;
          c->dc_context = 0;
        }
        if (!progressive || ss) memset(ac_stats[c->ta], 0, 256);
      }
      ac_c = 0;
      ac_a = 0;
      ac_ct = -16;
      return;
    }
    bits_left = 0;
    read_restart_marker();
    for (auto* c : sc) c->dc_pred = 0;
    eobrun = 0;
    if (unread_marker == 0) insufficient = false;
  }

  int16_t* block_at(Comp& c, int bx, int by, int16_t* scratch) {
    if (bx >= c.bw || by >= c.bh) {
      memset(scratch, 0, 64 * sizeof(int16_t));
      return scratch;
    }
    return c.coef.data() + ((size_t)by * c.bw + bx) * 64;
  }

  void decode_scan(const std::vector<Comp*>& sc) {
    const int ns = (int)sc.size();
    int units_x, units_y;
    if (ns == 1) {   // non-interleaved: one block per MCU
      units_x = sc[0]->wib;
      units_y = sc[0]->hib;
    } else {
      units_x = mcux;
      units_y = mcuy;
    }
    const int rows_per_imcu = ns == 1 ? sc[0]->v : 1;
    int restarts_to_go = restart;
    const long total = (long)units_x * units_y;
    int16_t scratch[64];
    no_suspend = arith;
    for (long u = 0; u < total; ++u) {
      if (restart && restarts_to_go == 0) {
        process_restart(sc);
        restarts_to_go = restart;
      }
      const int ux = (int)(u % units_x), uy = (int)(u / units_x);
      if (!insufficient) last_good_row = uy / rows_per_imcu;
      if (arith) {
        if (ac_ct != -1) {
          bool ok = true;
          for (auto* c : sc) {
            const int nb = ns == 1 ? 1 : c->v;
            for (int by = 0; ok && by < nb; ++by)
              for (int bx = 0; ok && bx < (ns == 1 ? 1 : c->h); ++bx) {
                const int x = ns == 1 ? ux : ux * c->h + bx;
                const int y = ns == 1 ? uy : uy * c->v + by;
                ok = arith_unit(*c, block_at(*c, x, y, scratch));
              }
            if (!ok) break;
          }
          if (!ok) ac_ct = -1;
        }
      } else if (!progressive) {
        if (!insufficient) sequential_mcu(sc, ux, uy, scratch);
      } else if (!insufficient) {
        for (auto* c : sc) {
          if (ns == 1) {
            huff_unit(*c, block_at(*c, ux, uy, scratch));
            continue;
          }
          for (int by = 0; by < c->v; ++by)
            for (int bx = 0; bx < c->h; ++bx)
              huff_unit(*c, block_at(*c, ux * c->h + bx, uy * c->v + by,
                                     scratch));
        }
      }
      if (restart) --restarts_to_go;
    }
    no_suspend = false;
  }

  // jdhuff.c decode_mcu: decode_mcu_fast where no restart interval is
  // set and PIL's buffer holds 512 bytes a block (its 6-byte fills, and
  // the slow decoder again from the MCU's start after a marker), else
  // decode_mcu_slow; an MCU that runs out of PIL's buffer is decoded again
  // once PIL has read more. Both decode the same bits: they differ only in
  // how far they read ahead, which decides where a stream without its EOI
  // runs out.
  void sequential_mcu(const std::vector<Comp*>& sc, int ux, int uy,
                      int16_t* scratch) {
    const int ns = (int)sc.size();
    int blocks = 0;
    for (auto* c : sc) blocks += ns == 1 ? 1 : c->h * c->v;
    auto each = [&](bool fast) {
      for (auto* c : sc)
        for (int by = 0; by < (ns == 1 ? 1 : c->v); ++by)
          for (int bx = 0; bx < (ns == 1 ? 1 : c->h); ++bx) {
            int16_t* out = ns == 1 ? block_at(*c, ux, uy, scratch)
                                   : block_at(*c, ux * c->h + bx,
                                              uy * c->v + by, scratch);
            seq_block(*c, out, fast);
          }
    };
    for (;;) {
      const uint64_t g0 = gbuf;
      const int b0 = bits_left;
      const size_t p0 = pos;
      int pred[4];
      for (int i = 0; i < ns; ++i) pred[i] = sc[i]->dc_pred;
      auto restore = [&]() {
        gbuf = g0;
        bits_left = b0;
        pos = p0;
        for (int i = 0; i < ns; ++i) sc[i]->dc_pred = pred[i];
      };
      try {
        suspendable = true;
        const size_t avail = (mode == 0 && window < n ? window : n) - pos;
        bool fast = !restart && unread_marker == 0 &&
                    avail >= (size_t)512 * blocks;
        if (fast) {
          each(true);
          if (unread_marker) {
            unread_marker = 0;
            restore();
            fast = false;
          }
        }
        if (!fast) each(false);
        suspendable = false;
        return;
      } catch (const Suspend&) {
        restore();
        window += kChunk;                  // PIL reads another block
      }
    }
  }

  // FILL_BIT_BUFFER_FAST and GET_BYTE: six bytes when 16 bits or fewer
  // are left; a marker backs up and feeds zeros
  void fill_fast() {
    if (bits_left > 16) return;
    for (int i = 0; i < 6; ++i) {
      const int c0 = d[pos++], c1 = d[pos];
      gbuf = gbuf << 8 | (uint64_t)c0;
      bits_left += 8;
      if (c0 == 0xFF) {
        ++pos;
        if (c1 != 0) {
          unread_marker = c1;
          pos -= 2;
          gbuf &= ~(uint64_t)0xFF;
        }
      }
    }
  }
  int bits_fast(int k) {
    bits_left -= k;
    return (int)((gbuf >> bits_left) & ((1u << k) - 1));
  }
  int huff_fast(const Huff& h) {   // HUFF_DECODE_FAST
    fill_fast();
    const int e = h.lookup[(gbuf >> (bits_left - 8)) & 0xFF];
    int nb = e >> 8;
    bits_left -= nb;
    if (nb <= 8) return e & 0xFF;
    int64_t code = (int64_t)((gbuf >> bits_left) & ((1u << nb) - 1));
    while (code > h.maxcode[nb]) {
      code = code << 1 | bits_fast(1);
      ++nb;
    }
    return nb > 16 ? 0 : h.vals[(int)(code + h.valoffset[nb]) & 0xFF];
  }

  // one block of a sequential scan (decode_mcu_fast / decode_mcu_slow)
  void seq_block(Comp& c, int16_t* out, bool fast) {
    auto value = [&](int s) {
      if (!fast) return extend(get(s), s);
      fill_fast();
      return extend(bits_fast(s), s);
    };
    int s = fast ? huff_fast(dc[c.td]) : huff(dc[c.td]);
    c.dc_pred = (int)((unsigned)c.dc_pred + (unsigned)(s ? value(s) : 0));
    out[0] = (int16_t)c.dc_pred;
    const Huff& t = ac[c.ta];
    for (int k = 1; k < 64; ++k) {
      const int rs = fast ? huff_fast(t) : huff(t);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        out[kNatural[k]] = (int16_t)value(s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void huff_unit(Comp& c, int16_t* out) {
    if (ss == 0) {
      if (ah == 0) {
        c.dc_pred = (int)((unsigned)c.dc_pred + (unsigned)huff_value(dc[c.td]));
        out[0] = (int16_t)((unsigned)c.dc_pred << al);
      } else if (get(1)) {
        out[0] = (int16_t)(out[0] | (1 << al));
      }
    } else if (ah == 0) {
      ac_first(c, out);
    } else {
      ac_refine(c, out);
    }
  }

  // jdphuff.c decode_mcu_AC_first
  void ac_first(Comp& c, int16_t* out) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const Huff& t = ac[c.ta];
    for (int k = ss; k <= se; ++k) {
      const int rs = huff(t);
      int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        k += r;
        out[kNatural[k]] = (int16_t)((unsigned)extend(get(s), s) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += get(r);
        --eobrun;
        break;
      }
    }
  }

  // jdphuff.c decode_mcu_AC_refine
  void ac_refine(Comp& c, int16_t* out) {
    const int p1 = 1 << al, m1 = (int)((unsigned)-1 << al);
    const Huff& t = ac[c.ta];
    int k = ss;
    auto correct = [&](int16_t& coef) {
      if (get(1) && (coef & p1) == 0)
        coef = (int16_t)(coef >= 0 ? coef + p1 : coef + m1);
    };
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = huff(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += get(r);
          break;
        }
        do {
          int16_t& coef = out[kNatural[k]];
          if (coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) out[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& coef = out[kNatural[k]];
        if (coef != 0) correct(coef);
      }
      --eobrun;
    }
  }

  // jdarith.c decode_mcu and the four progressive decoders; false where
  // jdarith sets ct = -1 (the rest of the segment is left alone)
  bool arith_unit(Comp& c, int16_t* out) {
    if (!progressive || (ss == 0 && ah == 0)) {
      int v;
      if (!arith_dc(c, &v)) return false;
      c.dc_pred = (c.dc_pred + v) & 0xffff;
      out[0] = progressive ? (int16_t)((unsigned)c.dc_pred << al)
                           : (int16_t)c.dc_pred;
      if (progressive) return true;
    }
    if (progressive && ss == 0) {   // DC refinement: one fixed-bin bit
      if (arith_decode(fixed_bin)) out[0] = (int16_t)(out[0] | (1 << al));
      return true;
    }
    const int tbl = c.ta;
    const int lo = progressive ? ss : 1, hi = progressive ? se : 63;
    if (!progressive || ah == 0) {
      for (int k = lo; k <= hi; ++k) {
        uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
        if (arith_decode(st)) break;   // EOB
        while (arith_decode(st + 1) == 0) {
          st += 3;
          if (++k > hi) return false;   // spectral overflow
        }
        int v;
        if (!arith_ac_value(tbl, k, st, &v)) return false;
        out[kNatural[k]] = progressive ? (int16_t)((unsigned)v << al)
                                       : (int16_t)v;
      }
      return true;
    }
    const int p1 = 1 << al, m1 = (int)((unsigned)-1 << al);
    int kex = se;
    for (; kex > 0; --kex)
      if (out[kNatural[kex]]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && arith_decode(st)) break;   // EOB
      for (;;) {
        int16_t& coef = out[kNatural[k]];
        if (coef) {
          if (arith_decode(st + 2))
            coef = (int16_t)(coef < 0 ? coef + m1 : coef + p1);
          break;
        }
        if (arith_decode(st + 1)) {
          coef = (int16_t)(arith_decode(fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) return false;
      }
    }
    return true;
  }

  // ------------------------------------------------------------ lossless
  // jddiffct.c decompress_data over jdlhuff.c decode_mcus, then
  // jdlossls.c's undifferencing and point transform, an iMCU row at a time
  void lossless_scan(const std::vector<Comp*>& sc) {
    if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8)
      throw Fail{1, "bad lossless scan parameters"};
    for (auto* c : sc) table(dc, c->td, true);
    const int ns = (int)sc.size();
    const int mcus_per_row = ns == 1 ? sc[0]->wib : mcux;
    if (restart % mcus_per_row != 0)
      throw Fail{1, "restart interval is not a whole number of MCU rows"};
    bits_left = 0;
    gbuf = 0;
    insufficient = false;
    int rows_to_go = restart / mcus_per_row;
    // undifferencing state of every component of the frame: the first-row
    // predictor after a reset, and each component's previous row
    std::vector<int> first(ncomp, 1);
    std::vector<std::vector<int>> diff(ncomp), undiff(ncomp);
    auto reset = [&]() {
      for (auto& f : first) f = 1;
    };
    const int total_imcu = mcuy;
    for (int row = 0; row < total_imcu; ++row) {
      const bool last = row == total_imcu - 1;
      int mcu_rows;
      if (ns > 1) {
        mcu_rows = 1;
      } else {
        const int v = sc[0]->v;
        const int lrh = sc[0]->hib % v ? sc[0]->hib % v : v;
        mcu_rows = last ? lrh : v;
      }
      for (auto* c : sc) {
        const int ci = (int)(c - comps.data());
        diff[ci].assign((size_t)c->v * mcus_per_row * c->h, 0);
        if (undiff[ci].empty()) undiff[ci].assign((size_t)c->v * c->wib, 0);
      }
      for (int yo = 0; yo < mcu_rows; ++yo) {
        if (restart && rows_to_go == 0) {
          bits_left = 0;
          read_restart_marker();
          if (unread_marker == 0) insufficient = false;
          reset();
          rows_to_go = restart / mcus_per_row;
        }
        if (insufficient) {
          reset();   // zero differences from the reset predictor
        } else {
          for (int m = 0; m < mcus_per_row; ++m)
            for (auto* c : sc) {
              const int ci = (int)(c - comps.data());
              const int hh = ns == 1 ? 1 : c->h, vv = ns == 1 ? 1 : c->v;
              const int stride = mcus_per_row * (ns == 1 ? 1 : c->h);
              for (int y = 0; y < vv; ++y)
                for (int x = 0; x < hh; ++x) {
                  int s = huff(dc[c->td]);
                  if (s == 16) s = 32768;
                  else if (s) s = extend(get(s), s);
                  const int r = ns == 1 ? yo : y;
                  diff[ci][(size_t)r * stride + m * hh + x] = s;
                }
            }
        }
        if (restart) --rows_to_go;
      }
      for (auto* c : sc) {
        const int ci = (int)(c - comps.data());
        const int v = c->v;
        const int lrh = c->hib % v ? c->hib % v : v;
        const int nrows = last ? lrh : v;
        const int stride = mcus_per_row * (ns == 1 ? 1 : c->h);
        const int w = c->wib;
        for (int r = 0, prev = v - 1; r < nrows; prev = r, ++r) {
          const int* df = diff[ci].data() + (size_t)r * stride;
          const int* pr = undiff[ci].data() + (size_t)prev * w;
          int* ud = undiff[ci].data() + (size_t)r * w;
          if (first[ci]) {
            int ra = (df[0] + (1 << (7 - al))) & 0xFFFF;
            ud[0] = ra;
            for (int x = 1; x < w; ++x) ud[x] = ra = (df[x] + ra) & 0xFFFF;
            first[ci] = 0;
          } else {
            int rb = pr[0];
            int ra = (df[0] + rb) & 0xFFFF;
            ud[0] = ra;
            for (int x = 1; x < w; ++x) {
              const int rc = rb;
              rb = pr[x];
              int p;
              switch (ss) {
                case 1: p = ra; break;
                case 2: p = rb; break;
                case 3: p = rc; break;
                case 4: p = ra + rb - rc; break;
                case 5: p = ra + ((rb - rc) >> 1); break;
                case 6: p = rb + ((ra - rc) >> 1); break;
                default: p = (ra + rb) >> 1; break;
              }
              ud[x] = ra = (df[x] + p) & 0xFFFF;
            }
          }
          const int y = row * v + r;
          if (y < c->dh)
            for (int x = 0; x < w; ++x)
              c->plane[(size_t)y * c->dw + x] = (uint8_t)(ud[x] << al);
        }
      }
    }
  }

  // ------------------------------------------------------------ file
  void parse() {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) throw Fail{1, "not a JPEG"};
    pos = 2;
    for (int k = 0; k < 16; ++k) {
      dac_l[k] = 0;
      dac_u[k] = 1;
      dac_k[k] = 5;
    }
    for (;;) {
      if (unread_marker == 0) {
        try {
          next_marker();
        } catch (const EndOfInput&) {
          return;   // PIL stops after the image's last row
        }
      }
      const int m = unread_marker;
      unread_marker = 0;
      try {
        if (m == 0xD9) break;                         // EOI
        if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
        if (m == 0xD8) throw Fail{1, "a second SOI"};
        if (m == 0xDA) {
          if (!have_frame) throw Fail{1, "scan before frame"};
          scan();
          if (headers_only) return;
          rows_done = !multi_scan;
          eof_ok = rows_done && mode == 0;
          continue;
        }
        const bool known = (m >= 0xC0 && m <= 0xCF) || (m >= 0xDB && m <= 0xDD) ||
                           (m >= 0xE0 && m <= 0xEF) || m == 0xFE;
        if (!known) throw Fail{1, "unknown JPEG marker"};
        const long len = u16() - 2;
        if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
          frame((int)len + 2, m - 0xC0);
        } else if (m == 0xC8) {
          throw Fail{1, "libjpeg refuses the JPG marker"};
        } else if (m == 0xC4) {
          tables_h(len);
        } else if (m == 0xCC) {
          tables_ac(len);
        } else if (m == 0xDB) {
          tables_q(len);
        } else if (m == 0xDD) {
          if (len != 2) throw Fail{1, "bad DRI length"};
          restart = u16();
        } else if (m == 0xE0 || m == 0xEE) {
          app(m, len);
        } else {
          skip(len);
        }
      } catch (const EndOfInput&) {
        return;
      } catch (const Fail&) {
        // libtiff's JPEGDecode ignores what jpeg_finish_decompress fails
        // on once a single-scan image has given its rows
        if (mode >= 1 && rows_done) return;
        throw;
      }
    }
    if (!scanned) throw Fail{1, "no image data"};
  }

  // ------------------------------------------------------------ output
  // jdcoefct.c smoothing_ok
  bool smoothing_ok(int (*latch)[10], int (*prev)[10]) const {
    if (!progressive) return false;
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp; ++i) {
      const Comp& c = comps[i];
      if (!c.latched) return false;
      for (int k = 0; k < 10; ++k)
        if (c.qval[kPos[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      latch[i][0] = c.coef_bits[0];
      for (int k = 1; k < 10; ++k) {
        prev[i][k] = scan_number > 1 ? c.prev_bits[k] : -1;
        latch[i][k] = c.coef_bits[k];
        if (c.coef_bits[k] != 0) useful = true;
      }
    }
    return useful;
  }

  // The IDCT of every block, with jdcoefct.c decompress_smooth_data's
  // estimates where smoothing applies.
  void idct_all() {
    int latch[4][10], prev[4][10];
    const bool smooth = smoothing_ok(latch, prev);
    for (int ci = 0; ci < ncomp; ++ci) {
      Comp& c = comps[ci];
      int16_t mult[64];
      for (int k = 0; k < 64; ++k) mult[k] = c.latched ? (int16_t)c.qval[k] : 0;
      const int stride = c.bw * 8;
      c.plane.assign((size_t)c.bw * c.bh * 64, 0);
      if (!smooth) {
        for (int by = 0; by < c.bh; ++by)
          for (int bx = 0; bx < c.bw; ++bx)
            idct_islow(c.coef.data() + ((size_t)by * c.bw + bx) * 64, mult,
                       c.plane.data() + (size_t)by * 8 * stride + bx * 8,
                       stride);
        continue;
      }
      for (int row = 0; row < mcuy; ++row)
        smooth_row(c, row, mult, latch[ci], prev[ci]);
    }
  }

  void smooth_row(Comp& c, int out_row, const int16_t* mult,
                  const int* latch, const int* prev) {
    const int last_row = mcuy - 1;
    int block_rows;
    if (out_row < last_row) {
      block_rows = c.v;
    } else {
      block_rows = c.hib % c.v;
      if (block_rows == 0) block_rows = c.v;
    }
    const int* bits = out_row > last_good_row ? prev : latch;
    const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 &&
                           bits[4] == -1 && bits[5] == -1 && bits[6] == -1 &&
                           bits[7] == -1 && bits[8] == -1 && bits[9] == -1;
    const int64_t Q00 = c.qval[0], Q01 = c.qval[1], Q10 = c.qval[8],
                  Q20 = c.qval[16], Q11 = c.qval[9], Q02 = c.qval[2],
                  Q03 = c.qval[3], Q12 = c.qval[10], Q21 = c.qval[17],
                  Q30 = c.qval[24];
    const int image_block_rows = block_rows * mcuy;
    const int stride = c.bw * 8;
    auto dcat = [&](int r, int x) {
      return (int)c.coef[((size_t)r * c.bw + x) * 64];
    };
    for (int br = 0; br < block_rows; ++br) {
      const int ibr = out_row * block_rows + br;
      const int r = out_row * c.v + br;   // the block row in the buffer
      const int rp = ibr > 0 ? r - 1 : r;
      const int rpp = ibr > 1 ? r - 2 : rp;
      const int rn = ibr < image_block_rows - 1 ? r + 1 : r;
      const int rnn = ibr < image_block_rows - 2 ? r + 2 : rn;
      int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10, DC11,
          DC12, DC13, DC14, DC15, DC16, DC17, DC18, DC19, DC20, DC21, DC22,
          DC23, DC24, DC25;
      DC01 = DC02 = DC03 = DC04 = DC05 = dcat(rpp, 0);
      DC06 = DC07 = DC08 = DC09 = DC10 = dcat(rp, 0);
      DC11 = DC12 = DC13 = DC14 = DC15 = dcat(r, 0);
      DC16 = DC17 = DC18 = DC19 = DC20 = dcat(rn, 0);
      DC21 = DC22 = DC23 = DC24 = DC25 = dcat(rnn, 0);
      const int last_col = c.wib - 1;
      for (int b = 0; b <= last_col; ++b) {
        int16_t ws[64];
        memcpy(ws, c.coef.data() + ((size_t)r * c.bw + b) * 64, sizeof(ws));
        if (b == 0 && b < last_col) {
          DC04 = dcat(rpp, 1);
          DC09 = dcat(rp, 1);
          DC14 = dcat(r, 1);
          DC19 = dcat(rn, 1);
          DC24 = dcat(rnn, 1);
        }
        if (b + 1 < last_col) {
          DC05 = dcat(rpp, b + 2);
          DC10 = dcat(rp, b + 2);
          DC15 = dcat(r, b + 2);
          DC20 = dcat(rn, b + 2);
          DC25 = dcat(rnn, b + 2);
        }
        auto pred = [&](int Al, int64_t Qk, int64_t num) {
          int p;
          if (num >= 0) {
            p = (int)(((Qk << 7) + num) / (Qk << 8));
            if (Al > 0 && p >= (1 << Al)) p = (1 << Al) - 1;
          } else {
            p = (int)(((Qk << 7) - num) / (Qk << 8));
            if (Al > 0 && p >= (1 << Al)) p = (1 << Al) - 1;
            p = -p;
          }
          return (int16_t)p;
        };
        int Al;
        if ((Al = bits[1]) != 0 && ws[1] == 0) {
          const int64_t num = Q00 * (change_dc ?
              (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
               13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 +
               3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 -
               DC21 - DC22 + DC24 + DC25) :
              (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
          ws[1] = pred(Al, Q01, num);
        }
        if ((Al = bits[2]) != 0 && ws[8] == 0) {
          const int64_t num = Q00 * (change_dc ?
              (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
               13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
               13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
               3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
              (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
          ws[8] = pred(Al, Q10, num);
        }
        if ((Al = bits[3]) != 0 && ws[16] == 0) {
          const int64_t num = Q00 * (change_dc ?
              (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 -
               5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23) :
              (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
          ws[16] = pred(Al, Q20, num);
        }
        if ((Al = bits[4]) != 0 && ws[9] == 0) {
          const int64_t num = Q00 * (change_dc ?
              (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
               9 * DC19 + DC21 - DC25) :
              (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
               DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09));
          ws[9] = pred(Al, Q11, num);
        }
        if ((Al = bits[5]) != 0 && ws[2] == 0) {
          const int64_t num = Q00 * (change_dc ?
              (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
               7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19) :
              (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
          ws[2] = pred(Al, Q02, num);
        }
        if (change_dc) {
          if ((Al = bits[6]) != 0 && ws[3] == 0)
            ws[3] = pred(Al, Q03, Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 +
                                         DC17 - DC19));
          if ((Al = bits[7]) != 0 && ws[10] == 0)
            ws[10] = pred(Al, Q12, Q00 * (DC07 - 3 * DC08 + DC09 - DC17 +
                                          3 * DC18 - DC19));
          if ((Al = bits[8]) != 0 && ws[17] == 0)
            ws[17] = pred(Al, Q21, Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 +
                                          DC17 - DC19));
          if ((Al = bits[9]) != 0 && ws[24] == 0)
            ws[24] = pred(Al, Q30, Q00 * (DC07 + 2 * DC08 + DC09 - DC17 -
                                          2 * DC18 - DC19));
          const int64_t num = Q00 *
              (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
               6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
               8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 -
               6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
               2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
          ws[0] = pred(0, Q00, num);
        }
        idct_islow(ws, mult, c.plane.data() + (size_t)r * 8 * stride + b * 8,
                   stride);
        DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
        DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
        DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
        DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
        DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
      }
    }
  }

  bool rgb_space() const {
    if (ncomp != 3 || colour == 2) return false;
    if (colour == 1) return true;
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    if (lossless && comps[0].id == 1 && comps[1].id == 2 && comps[2].id == 3)
      return true;
    return comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
  }

  bool ycck_space() const {
    return ncomp == 4 && colour == 0 && adobe && adobe_transform != 0;
  }

  // Upsampled component c as a full-size plane (width x height).
  std::vector<uint8_t> upsample(const Comp& c) const {
    const int fh = hmax / c.h, fv = vmax / c.v;
    const int stride = lossless ? c.dw : c.bw * 8;
    std::vector<uint8_t> out((size_t)width * height);
    auto at = [&](int y, int x) -> int {
      y = y < 0 ? 0 : (y >= c.dh ? c.dh - 1 : y);   // context rows
      return c.plane[(size_t)y * stride + x];
    };
    const int ow = c.dw * fh;   // upsampled width before the crop
    std::vector<uint8_t> row(ow > width ? ow : width);
    const bool fancy = !lossless;
    for (int oy = 0; oy < height; ++oy) {
      if (fh == 1 && fv == 1) {
        for (int x = 0; x < width; ++x) row[x] = (uint8_t)at(oy, x);
      } else if (fancy && fh == 2 && fv == 1 && c.dw > 2) {   // h2v1 fancy
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
      } else if (fancy && fh == 1 && fv == 2) {               // h1v2 fancy
        const int y = oy / 2, v = oy & 1;
        const int y1 = v == 0 ? y - 1 : y + 1;
        const int bias = v == 0 ? 1 : 2;
        for (int x = 0; x < c.dw; ++x)
          row[x] = (uint8_t)((at(y, x) * 3 + at(y1, x) + bias) >> 2);
      } else if (fancy && fh == 2 && fv == 2 && c.dw > 2) {   // h2v2 fancy
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
      } else {                                                // box
        const int y = oy / fv;
        for (int x = 0; x < width; ++x) {
          const int sx = x / fh;
          row[x] = (uint8_t)at(y, sx < c.dw ? sx : c.dw - 1);
        }
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
    if (ncomp == 4) {   // CMYK, or YCCK under an Adobe transform
      std::vector<uint8_t> p[4];
      for (int c = 0; c < 4; ++c) p[c] = upsample(comps[c]);
      const size_t np = (size_t)width * height;
      for (size_t i = 0; i < np; ++i)
        for (int c = 0; c < 4; ++c) out[4 * i + c] = p[c][i];
      if (ycck_space()) ycck(out, np);
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

  void decode() {
    parse();
    if (!lossless) idct_all();
  }
};

template <class F>
int guarded(F&& f) {
  try {
    f();
    return 0;
  } catch (const Fail& e) {
    g_error = e.what;
    return e.code;
  } catch (const EndOfInput&) {
    g_error = "truncated JPEG file";
    return 1;
  } catch (...) {
    g_error = "out of memory";
    return 1;
  }
}

}  // namespace

extern "C" const char* jpeg_last_error() { return g_error.c_str(); }

extern "C" void jpeg_arith_table(long long* out) {
  for (int i = 0; i < 114; ++i) out[i] = kAritab[i];
}

extern "C" int jpeg_info(const uint8_t* data, long long n, int mode, int* w,
                         int* h, int* nc) {
  return guarded([&] {
    Decoder dec{data, (size_t)n, mode & 3};
    dec.colour = mode >> 2;
    dec.headers_only = true;
    dec.parse();
    if (!dec.have_frame) throw Fail{1, "no frame"};
    *w = dec.width;
    *h = dec.height;
    *nc = dec.ncomp;
  });
}

// The frame's sampling factors: hv gets the component count, then each
// component's h and v factors.
extern "C" int jpeg_factors(const uint8_t* data, long long n, int mode,
                            int* hv, int cap) {
  return guarded([&] {
    Decoder dec{data, (size_t)n, mode & 3};
    dec.headers_only = true;
    dec.parse();
    if (!dec.have_frame) throw Fail{1, "no frame"};
    if (cap < 1 + 2 * dec.ncomp) throw Fail{1, "factor buffer too small"};
    hv[0] = dec.ncomp;
    for (int i = 0; i < dec.ncomp; ++i) {
      hv[1 + 2 * i] = dec.comps[i].h;
      hv[2 + 2 * i] = dec.comps[i].v;
    }
  });
}

// The components after the IDCT, before upsampling and colour conversion
// (libjpeg's raw data, which libtiff's old-style JPEG reads): dims gets
// the component count, then each component's h and v sampling factors
// and its plane's width and height (whole MCUs); out (when not null) the
// planes in turn.
extern "C" int jpeg_planes(const uint8_t* data, long long n, int mode,
                           int* dims, int cap, uint8_t* out) {
  return guarded([&] {
    Decoder dec{data, (size_t)n, mode & 3};
    dec.colour = mode >> 2;
    dec.headers_only = out == nullptr;
    if (out) dec.decode();
    else dec.parse();
    if (!dec.have_frame || !dec.scanned) throw Fail{1, "no image data"};
    if (dec.lossless) throw Fail{1, "libjpeg gives no raw data of lossless "
                                    "JPEG"};
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
  });
}

extern "C" int jpeg_decode(const uint8_t* data, long long n, int mode,
                           uint8_t* out) {
  return guarded([&] {
    Decoder dec{data, (size_t)n, mode & 3};
    dec.colour = mode >> 2;
    dec.decode();
    dec.output(out);
  });
}
