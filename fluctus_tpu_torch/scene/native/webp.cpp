// WebP decoder that reproduces what PIL 12 gives through libwebp 1.6.0's
// WebPAnimDecoder (RGBA output, the default decoder options):
// - the container as the demuxer reads it: a simple file ("VP8 " or
//   "VP8L"), or VP8X with ICCP / EXIF / XMP / unknown chunks skipped, an
//   ALPH chunk before a lossy frame (dropped when the VP8X flags carry no
//   alpha), and ANIM / ANMF, of which the first frame is drawn at its
//   offset on a transparent black canvas;
// - VP8L (lossless): the predictor (14 modes), cross-colour,
//   subtract-green and colour-indexing transforms with pixel bundling, the
//   colour cache, LZ77 backward references with the distance map, and
//   meta prefix codes;
// - VP8 (lossy key frames): the boolean decoder, segments with their
//   quantiser and filter deltas, skip, 1-8 token partitions, intra 16x16,
//   4x4 and chroma prediction on unfiltered samples, dequantisation, the
//   WHT and the IDCT, the simple and normal loop filters with sharpness
//   and mode deltas; then RGB through the "fancy" chroma upsampler (the
//   9-3-3-1 filter) and the 14-bit fixed-point YUV -> RGB of libwebp's
//   yuv.h, without dithering;
// - ALPH: raw or VP8L-compressed alpha with the none, horizontal,
//   vertical and gradient filters (level dequantisation is a no-op without
//   alpha dithering, libwebp's default).
//
// C interface, called through ctypes (scene/webp.py):
//   webp_info(data, n, &w, &h, &rgba): the canvas size, and 1 when the
//     container flags alpha (PIL's "RGBA"; 0 is its "RGBX", whose fourth
//     byte PIL drops);
//   webp_decode(data, n, out): out is h * w RGBA bytes of the first frame.
// Both return 0, or 1 for a file libwebp refuses; webp_last_error() says
// why.

#include <stdint.h>
#include <string.h>

#include <string>
#include <vector>

namespace {

struct Fail {
  std::string what;
};

std::string g_error;

[[noreturn]] void fail(const char* what) { throw Fail{what}; }

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16);
}
inline uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}

// libwebp's tables, which are the VP8 format's (RFC 6386: the DC and AC
// quantiser lookups, the key-frame 4x4 mode probabilities in libwebp's
// mode order, the default and update coefficient probabilities) and
// VP8L's distance map (kCodeToPlane)
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20,
    20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33,
    34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49,
    50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67,
    68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84,
    85, 86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108,
    110, 112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138,
    140, 143, 145, 148, 151, 154, 157};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
    41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94,
    96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128,
    131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170,
    173, 177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225,
    229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};
const uint8_t kBModesProba[900] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118,
    46, 70, 95, 175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171,
    218, 189, 17, 13, 152, 114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24,
    80, 195, 26, 62, 44, 64, 85, 144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71, 63, 20, 8, 114, 114, 208, 12, 9,
    226, 81, 40, 11, 96, 182, 84, 29, 16, 36, 134, 183, 89, 137, 98, 101,
    106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80, 66, 102, 167,
    99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107, 74, 43,
    26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186,
    23, 47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189,
    23, 18, 22, 88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117,
    85, 38, 35, 179, 61, 39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51,
    104, 114, 102, 29, 93, 77, 39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22,
    116, 206, 23, 34, 43, 166, 73, 107, 54, 32, 26, 51, 1, 81, 43, 31, 68,
    25, 106, 22, 64, 171, 36, 225, 114, 34, 19, 21, 102, 132, 188, 16, 76,
    124, 62, 18, 78, 95, 85, 57, 50, 48, 51, 193, 101, 35, 159, 215, 111,
    89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111, 112, 113, 77, 85,
    179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109, 88, 43,
    29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197,
    171, 41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23,
    25, 82, 138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82,
    115, 26, 59, 179, 63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21,
    116, 143, 209, 34, 39, 175, 47, 15, 16, 183, 34, 223, 49, 45, 183, 46,
    17, 33, 183, 6, 98, 15, 32, 183, 57, 46, 22, 24, 128, 1, 54, 17, 37, 65,
    32, 73, 115, 28, 128, 23, 128, 205, 40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47, 104, 55, 44, 218, 9, 54, 53, 130,
    226, 64, 90, 70, 205, 40, 41, 23, 26, 57, 54, 57, 112, 184, 5, 41, 38,
    166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134, 39, 19, 53, 221, 26,
    114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73, 75, 32, 12, 51,
    192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85, 56, 21, 23,
    111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98, 125, 98,
    42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41,
    49, 38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90,
    47, 114, 115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128,
    101, 196, 26, 57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36,
    163, 128, 68, 1, 26, 102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71,
    38, 73, 119, 28, 222, 37, 68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17,
    19, 70, 146, 85, 55, 62, 70, 37, 43, 37, 154, 100, 163, 85, 160, 1, 63,
    9, 92, 136, 28, 64, 32, 201, 85, 75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1, 56, 8, 17, 132, 137, 255, 55, 116,
    128, 58, 15, 20, 82, 135, 57, 26, 121, 40, 164, 50, 31, 137, 154, 133,
    25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158, 86, 40, 64, 135,
    148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209, 45, 16,
    21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213, 83,
    12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146,
    171, 18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12,
    26, 128, 190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176,
    51, 41, 20, 32, 101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15,
    176, 236, 85, 37, 9, 62, 71, 30, 17, 119, 118, 255, 17, 18, 138, 101,
    38, 60, 138, 55, 70, 43, 26, 142, 146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64, 32, 41, 20, 117, 151, 142, 20, 21,
    163, 112, 19, 12, 61, 195, 128, 48, 4, 24};
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54,
    58, 37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75,
    52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104,
    2, 103, 105, 18, 30, 102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78, 118, 122, 33, 47,
    117, 123, 49, 63, 99, 109, 82, 94, 0, 116, 124, 65, 79, 16, 32, 98, 110,
    48, 115, 125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112};
const uint8_t kCoeffsProba0[1056] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128,
    128, 128, 189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106,
    126, 227, 252, 214, 209, 255, 255, 128, 128, 128, 1, 98, 248, 255, 236,
    226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154,
    128, 128, 128, 78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1,
    185, 249, 255, 243, 255, 128, 128, 128, 128, 128, 184, 150, 247, 255,
    236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128,
    128, 128, 128, 128, 1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128, 37, 116, 196,
    243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128,
    128, 128, 128, 128, 207, 160, 250, 255, 238, 128, 128, 128, 128, 128,
    128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128, 1, 152, 252,
    255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225,
    128, 128, 128, 128, 128, 80, 129, 211, 255, 194, 224, 128, 128, 128,
    128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 246, 1,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 198, 35, 237, 223, 193, 187, 162, 160,
    145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1, 68,
    47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221,
    224, 255, 255, 128, 128, 128, 184, 141, 234, 253, 222, 220, 255, 199,
    128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128, 1,
    129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250,
    201, 198, 255, 202, 128, 128, 128, 23, 91, 163, 242, 170, 187, 247, 210,
    255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128, 109,
    178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253,
    205, 192, 255, 255, 128, 128, 128, 1, 132, 239, 251, 219, 209, 255, 165,
    128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128, 22,
    100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232,
    235, 128, 128, 128, 128, 128, 124, 143, 241, 255, 227, 234, 128, 128,
    128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128, 1,
    157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255,
    225, 227, 255, 255, 128, 128, 128, 45, 99, 188, 251, 195, 217, 255, 224,
    128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128, 203,
    1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224,
    255, 128, 128, 128, 128, 128, 253, 9, 248, 251, 207, 208, 255, 192, 128,
    128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128, 73, 17,
    171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183,
    255, 255, 128, 128, 128, 239, 90, 244, 250, 211, 209, 255, 255, 128,
    128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128, 1, 24,
    239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196,
    186, 128, 128, 128, 128, 128, 69, 46, 190, 239, 201, 218, 255, 228, 128,
    128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128, 223, 165,
    249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255,
    128, 128, 128, 128, 128, 128, 1, 16, 248, 255, 255, 128, 128, 128, 128,
    128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128, 149, 1,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128,
    128, 128, 128, 128, 128, 247, 192, 255, 128, 128, 128, 128, 128, 128,
    128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 134,
    252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255,
    128, 128, 128, 128, 128, 128, 55, 93, 255, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 202, 24, 213, 235, 186, 191, 220,
    160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187,
    128, 61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230,
    250, 199, 191, 247, 159, 255, 255, 128, 166, 109, 228, 252, 211, 215,
    255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255,
    128, 1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191,
    243, 183, 193, 250, 221, 255, 255, 128, 24, 71, 130, 219, 154, 170, 243,
    182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170,
    242, 183, 194, 254, 223, 255, 255, 128, 1, 81, 230, 252, 204, 203, 255,
    192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128,
    128, 20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248,
    255, 216, 213, 128, 128, 128, 128, 128, 168, 175, 246, 252, 235, 205,
    255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128,
    128, 128, 1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84,
    213, 252, 201, 202, 255, 219, 128, 128, 128, 42, 80, 160, 240, 162, 185,
    255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128,
    128, 244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255,
    128, 128, 128, 128, 128, 128, 128, 128};
const uint8_t kCoeffsUpdateProba[1056] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249,
    253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 244, 252, 255,
    255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255, 239, 253,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 248, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250,
    255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 217, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255,
    255, 254, 255, 255, 255, 255, 234, 250, 241, 250, 253, 255, 253, 254,
    255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 247, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 186, 251, 250, 255,
    255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255,
    255, 255, 255, 255, 251, 251, 243, 253, 254, 255, 254, 255, 255, 255,
    255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 236, 253,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254,
    255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 248, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255,
    255, 255, 248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 246, 253, 253, 255,
    255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255,
    255, 255, 255, 255, 255, 254, 252, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 245, 251, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255,
    255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255};

// ================================================================ VP8L

struct LBits {
  std::vector<uint8_t> buf;   // the stream and 8 zero bytes
  size_t len = 0;
  uint64_t pos = 0;           // bits consumed

  void init(const uint8_t* p, size_t n) {
    buf.assign(p, p + n);
    buf.resize(n + 8, 0);
    len = n;
    pos = 0;
  }
  inline uint32_t peek(int n) const {   // n < 32
    size_t byte = pos >> 3;
    if (byte >= len) return 0;
    uint64_t v;
    memcpy(&v, &buf[byte], 8);
    return (uint32_t)(v >> (pos & 7)) & ((1u << n) - 1);
  }
  inline uint32_t read(int n) {
    uint32_t v = n ? peek(n) : 0;
    pos += n;
    return v;
  }
  // libwebp's end of stream: more bits read than the stream holds (a
  // stream shorter than 8 bytes reads zeros up to 64 bits)
  bool eos() const {
    uint64_t have = len < 8 ? 64 : (uint64_t)len * 8;
    return pos > have;
  }
};

// canonical prefix code, LSB-first lookup: an 8-bit root table and
// second-level tables for the longer codes
struct Prefix {
  struct Entry {
    uint16_t value;   // symbol, or the offset of a second-level table
    uint8_t bits;     // code length, or 8 + second-level bits when sub
    uint8_t sub;
  };
  std::vector<Entry> table;
  int single = -1;    // the symbol of a one-symbol (zero-bit) code

  static uint32_t reverse(uint32_t c, int len) {
    uint32_t r = 0;
    for (int i = 0; i < len; i++) r |= ((c >> i) & 1) << (len - 1 - i);
    return r;
  }

  // false when the lengths are not a complete code of 2 or more symbols
  bool build(const int* lengths, int n) {
    int count[16] = {0};
    int nsym = 0, last = -1;
    for (int s = 0; s < n; s++) {
      if (lengths[s] > 15) return false;
      if (lengths[s]) {
        count[lengths[s]]++;
        nsym++;
        last = s;
      }
    }
    table.clear();
    single = -1;
    if (nsym == 1) {
      single = last;
      return true;
    }
    if (nsym == 0) return false;
    int left = 1;
    for (int l = 1; l < 16; l++) {
      left = 2 * left - count[l];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    int next[16] = {0};
    int code = 0;
    for (int l = 1; l < 16; l++) {
      code = (code + count[l - 1]) << 1;
      next[l] = code;
    }
    // the longest code under each root prefix sizes its second level
    int maxsub[256] = {0};
    std::vector<uint32_t> rev(n);
    {
      int nx[16];
      memcpy(nx, next, sizeof(nx));
      for (int s = 0; s < n; s++) {
        int l = lengths[s];
        if (!l) continue;
        rev[s] = reverse(nx[l]++, l);
        if (l > 8) {
          int p = rev[s] & 0xff;
          if (l - 8 > maxsub[p]) maxsub[p] = l - 8;
        }
      }
    }
    table.assign(256, Entry{0, 0, 0});
    for (int p = 0; p < 256; p++) {
      if (maxsub[p]) {
        table[p].value = (uint16_t)table.size();
        table[p].bits = (uint8_t)(8 + maxsub[p]);
        table[p].sub = 1;
        table.resize(table.size() + (1u << maxsub[p]), Entry{0, 0, 0});
      }
    }
    for (int s = 0; s < n; s++) {
      int l = lengths[s];
      if (!l) continue;
      uint32_t r = rev[s];
      if (l <= 8) {
        for (uint32_t k = r; k < 256; k += 1u << l)
          table[k] = Entry{(uint16_t)s, (uint8_t)l, 0};
      } else {
        Entry& root = table[r & 0xff];
        int sb = root.bits - 8;
        uint32_t sr = r >> 8;
        for (uint32_t k = sr; k < (1u << sb); k += 1u << (l - 8))
          table[root.value + k] = Entry{(uint16_t)s, (uint8_t)l, 0};
      }
    }
    return true;
  }

  inline int read(LBits& br) const {
    if (single >= 0) return single;
    uint32_t b = br.peek(15);
    const Entry& e = table[b & 0xff];
    if (!e.sub) {
      br.pos += e.bits;
      return e.value;
    }
    const Entry& s = table[e.value + ((b >> 8) & ((1u << (e.bits - 8)) - 1))];
    br.pos += s.bits;
    return s.value;
  }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                  7,  8,  9, 10, 11, 12, 13, 14, 15};
const int kAlphabet[5] = {280, 256, 256, 256, 40};

struct Group {
  Prefix code[5];   // green + lengths + cache, red, blue, alpha, distance
};

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

inline int subsample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

struct VP8LDecoder {
  LBits br;
  // an ALPH stream: libwebp decodes one of a single colour-indexing
  // transform, no colour cache and one-symbol red, blue and alpha codes
  // 8 bits a pixel, and there an over-read at the last pixel is no error
  bool alpha = false;

  void read_code(int alphabet, Prefix& out) {
    std::vector<int> lengths(alphabet, 0);
    if (br.read(1)) {      // simple code: one or two symbols
      int num = br.read(1) + 1;
      int first8 = br.read(1);
      int s = br.read(first8 ? 8 : 1);
      if (s < alphabet) lengths[s] = 1;
      if (num == 2) {
        s = br.read(8);
        if (s < alphabet) lengths[s] = 1;
      }
    } else {
      int cl[19] = {0};
      int num = br.read(4) + 4;
      for (int i = 0; i < num; i++) cl[kCodeLengthOrder[i]] = br.read(3);
      Prefix lcode;
      if (!lcode.build(cl, 19)) fail("VP8L: bad code-length code");
      int max_symbol;
      if (br.read(1)) {
        int nbits = 2 + 2 * br.read(3);
        max_symbol = 2 + br.read(nbits);
        if (max_symbol > alphabet) fail("VP8L: bad code-length count");
      } else {
        max_symbol = alphabet;
      }
      int sym = 0, prev = 8;
      while (sym < alphabet) {
        if (max_symbol-- == 0) break;
        int c = lcode.read(br);
        if (c < 16) {
          lengths[sym++] = c;
          if (c) prev = c;
        } else {
          static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
          int rep = br.read(extra[c - 16]) + offset[c - 16];
          if (sym + rep > alphabet) fail("VP8L: bad code-length repeat");
          int v = c == 16 ? prev : 0;
          while (rep-- > 0) lengths[sym++] = v;
        }
      }
    }
    if (br.eos()) fail("VP8L: truncated");
    if (!out.build(lengths.data(), alphabet)) fail("VP8L: bad prefix code");
  }

  static int copy_length(int sym, LBits& br) {
    if (sym < 4) return sym + 1;
    int extra = (sym - 2) >> 1;
    int offset = (2 + (sym & 1)) << extra;
    return offset + br.read(extra) + 1;
  }

  // the entropy-coded pixels of one image: xsize * ysize ARGB words
  std::vector<uint32_t> decode_pixels(int xsize, int ysize, int cache_bits,
                                      const std::vector<Group>& groups,
                                      const std::vector<uint32_t>& meta,
                                      int meta_bits, int meta_xsize,
                                      bool end_overread_ok) {
    std::vector<uint32_t> px((size_t)xsize * ysize);
    std::vector<uint32_t> cache(cache_bits ? (1u << cache_bits) : 0, 0);
    const size_t total = px.size();
    size_t i = 0, cached = 0;
    int x = 0, y = 0;
    auto insert = [&]() {
      while (cached < i) {
        uint32_t v = px[cached++];
        cache[(0x1e35a7bdu * v) >> (32 - cache_bits)] = v;
      }
    };
    while (i < total) {
      const Group& g = meta.empty()
          ? groups[0]
          : groups[meta[(size_t)meta_xsize * (y >> meta_bits) +
                        (x >> meta_bits)]];
      int code = g.code[0].read(br);
      if (code < 256) {
        int red = g.code[1].read(br);
        int blue = g.code[2].read(br);
        int alpha = g.code[3].read(br);
        px[i++] = ((uint32_t)alpha << 24) | (red << 16) | (code << 8) | blue;
        if (++x >= xsize) {
          x = 0;
          ++y;
        }
      } else if (code < 256 + 24) {
        int length = copy_length(code - 256, br);
        int dsym = g.code[4].read(br);
        int dcode = copy_length(dsym, br);
        int dist;
        if (dcode > 120) {
          dist = dcode - 120;
        } else {
          int c = kCodeToPlane[dcode - 1];
          dist = (c >> 4) * xsize + (8 - (c & 0xf));
          if (dist < 1) dist = 1;
        }
        if (br.eos() && !end_overread_ok) break;
        if ((size_t)dist > i || total - i < (size_t)length)
          fail("VP8L: bad backward reference");
        for (int k = 0; k < length; k++, i++) px[i] = px[i - dist];
        x += length;
        while (x >= xsize) {
          x -= xsize;
          ++y;
        }
      } else {
        int key = code - 256 - 24;
        if (!cache_bits || key >= (1 << cache_bits))
          fail("VP8L: bad symbol");
        insert();
        px[i++] = cache[key];
        if (++x >= xsize) {
          x = 0;
          ++y;
        }
      }
      if (cache_bits) insert();
      if (br.eos()) break;
    }
    if (br.eos() && !(end_overread_ok && i == total))
      fail("VP8L: truncated");
    return px;
  }

  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0) {
    std::vector<Transform> transforms;
    int txsize = xsize;
    if (level0) {
      unsigned seen = 0;
      while (br.read(1)) {
        Transform t;
        t.type = br.read(2);
        if (seen & (1u << t.type)) fail("VP8L: repeated transform");
        seen |= 1u << t.type;
        t.xsize = txsize;
        t.ysize = ysize;
        t.bits = 0;
        if (t.type == 0 || t.type == 1) {
          t.bits = br.read(3) + 2;
          t.data = decode_stream(subsample(txsize, t.bits),
                                 subsample(ysize, t.bits), false);
        } else if (t.type == 3) {
          int n = br.read(8) + 1;
          t.bits = n > 16 ? 0 : n > 4 ? 1 : n > 2 ? 2 : 3;
          std::vector<uint32_t> pal = decode_stream(n, 1, false);
          // delta-coded entries, zero past the palette
          t.data.assign(1u << (8 >> t.bits), 0);
          for (int k = 0; k < n; k++) {
            uint32_t v = pal[k];
            if (k) {
              uint32_t p = t.data[k - 1];
              v = (((v & 0xff00ff00u) + (p & 0xff00ff00u)) & 0xff00ff00u) |
                  (((v & 0x00ff00ffu) + (p & 0x00ff00ffu)) & 0x00ff00ffu);
            }
            t.data[k] = v;
          }
          txsize = subsample(txsize, t.bits);
        }
        transforms.push_back(std::move(t));
      }
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = br.read(4);
      if (cache_bits < 1 || cache_bits > 11) fail("VP8L: bad cache size");
    }
    std::vector<uint32_t> meta;
    int meta_bits = 0, meta_xsize = 0, ngroups = 1;
    if (level0 && br.read(1)) {
      meta_bits = br.read(3) + 2;
      meta_xsize = subsample(txsize, meta_bits);
      meta = decode_stream(meta_xsize, subsample(ysize, meta_bits), false);
      for (auto& v : meta) {
        v = (v >> 8) & 0xffff;
        if ((int)v + 1 > ngroups) ngroups = v + 1;
      }
    }
    if (br.eos()) fail("VP8L: truncated");
    std::vector<Group> groups(ngroups);
    for (auto& g : groups) {
      for (int j = 0; j < 5; j++) {
        int a = kAlphabet[j] + (j == 0 && cache_bits ? (1 << cache_bits) : 0);
        read_code(a, g.code[j]);
      }
    }
    bool eight_bit = alpha && level0 && transforms.size() == 1 &&
                     transforms[0].type == 3 && cache_bits == 0;
    for (const auto& g : groups)
      for (int j = 1; j < 4; j++) eight_bit = eight_bit && g.code[j].single >= 0;
    std::vector<uint32_t> px = decode_pixels(txsize, ysize, cache_bits, groups,
                                             meta, meta_bits, meta_xsize,
                                             eight_bit);
    for (int k = (int)transforms.size() - 1; k >= 0; k--)
      px = inverse(transforms[k], px);
    return px;
  }

  static inline uint32_t add(uint32_t a, uint32_t b) {
    return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
           (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
  }
  static inline uint32_t avg2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
  }
  static inline int clip255(int a) { return a < 0 ? 0 : a > 255 ? 255 : a; }
  static inline int sub3(int a, int b, int c) {
    int pb = b - c, pa = a - c;
    return (pb < 0 ? -pb : pb) - (pa < 0 ? -pa : pa);
  }
  static uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
    int d = sub3(a >> 24, b >> 24, c >> 24) +
            sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
            sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
            sub3(a & 0xff, b & 0xff, c & 0xff);
    return d <= 0 ? a : b;
  }
  static uint32_t add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8)
      out |= (uint32_t)clip255((int)((a >> s) & 0xff) + ((b >> s) & 0xff) -
                               (int)((c >> s) & 0xff)) << s;
    return out;
  }
  static uint32_t add_sub_half(uint32_t a, uint32_t c) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
      int x = (a >> s) & 0xff, y = (c >> s) & 0xff;
      out |= (uint32_t)clip255(x + (x - y) / 2) << s;
    }
    return out;
  }
  static uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TR,
                          uint32_t TL) {
    switch (mode) {
      case 1: return L;
      case 2: return T;
      case 3: return TR;
      case 4: return TL;
      case 5: return avg2(avg2(L, TR), T);
      case 6: return avg2(L, TL);
      case 7: return avg2(L, T);
      case 8: return avg2(TL, T);
      case 9: return avg2(T, TR);
      case 10: return avg2(avg2(L, TL), avg2(T, TR));
      case 11: return select(T, L, TL);
      case 12: return add_sub_full(L, T, TL);
      case 13: return add_sub_half(avg2(L, T), TL);
      default: return 0xff000000u;   // 0, and 14 and 15 as libwebp pads
    }
  }

  static std::vector<uint32_t> inverse(const Transform& t,
                                       std::vector<uint32_t>& in) {
    const int w = t.xsize, h = t.ysize;
    if (t.type == 0) {
      std::vector<uint32_t>& p = in;
      const int tw = subsample(w, t.bits);
      for (int y = 0; y < h; y++) {
        uint32_t* row = &p[(size_t)y * w];
        for (int x = 0; x < w; x++) {
          uint32_t pred;
          if (y == 0) {
            pred = x == 0 ? 0xff000000u : row[x - 1];
          } else if (x == 0) {
            pred = row[x - w];
          } else {
            int mode = (t.data[(size_t)(y >> t.bits) * tw + (x >> t.bits)] >>
                        8) & 0xf;
            // top-right of the last column: the row's first pixel, as
            // libwebp reads it from memory
            pred = predict(mode, row[x - 1], row[x - w], row[x - w + 1],
                           row[x - w - 1]);
          }
          row[x] = add(row[x], pred);
        }
      }
      return std::move(in);
    }
    if (t.type == 1) {
      const int tw = subsample(w, t.bits);
      for (int y = 0; y < h; y++) {
        for (int x = 0; x < w; x++) {
          uint32_t m = t.data[(size_t)(y >> t.bits) * tw + (x >> t.bits)];
          int8_t g2r = (int8_t)(m & 0xff), g2b = (int8_t)((m >> 8) & 0xff),
                 r2b = (int8_t)((m >> 16) & 0xff);
          uint32_t& a = in[(size_t)y * w + x];
          int8_t green = (int8_t)(a >> 8);
          int r = (a >> 16) & 0xff, b = a & 0xff;
          r = (r + ((g2r * green) >> 5)) & 0xff;
          b += (g2b * green) >> 5;
          b += (r2b * (int8_t)r) >> 5;
          b &= 0xff;
          a = (a & 0xff00ff00u) | (r << 16) | b;
        }
      }
      return std::move(in);
    }
    if (t.type == 2) {
      for (auto& a : in) {
        uint32_t g = (a >> 8) & 0xff;
        a = (a & 0xff00ff00u) | ((((a >> 16) + g) & 0xff) << 16) |
            ((a + g) & 0xff);
      }
      return std::move(in);
    }
    // colour indexing: indices in the green channel, packed LSB first
    std::vector<uint32_t> out((size_t)w * h);
    const int pw = subsample(w, t.bits);
    const int bpp = 8 >> t.bits, per = 1 << t.bits;
    const uint32_t mask = (1u << bpp) - 1;
    for (int y = 0; y < h; y++) {
      for (int x = 0; x < w; x++) {
        uint32_t g = (in[(size_t)y * pw + (x >> t.bits)] >> 8) & 0xff;
        uint32_t idx = (g >> (bpp * (x & (per - 1)))) & mask;
        out[(size_t)y * w + x] = t.data[idx];
      }
    }
    return out;
  }
};

// a VP8L chunk's payload -> ARGB; *has_alpha: its alpha_is_used bit
std::vector<uint32_t> decode_vp8l(const uint8_t* p, size_t n, int* w, int* h,
                                  int* has_alpha) {
  if (n < 5 || p[0] != 0x2f || (p[4] >> 5) != 0) fail("VP8L: bad header");
  VP8LDecoder d;
  d.br.init(p, n);
  d.br.read(8);
  *w = d.br.read(14) + 1;
  *h = d.br.read(14) + 1;
  *has_alpha = d.br.read(1);
  d.br.read(3);
  return d.decode_stream(*w, *h, true);
}

// ================================================================= VP8

// libwebp's VP8 bit reader on a 64-bit build: 56 bits at a time while 8
// bytes remain, then byte by byte, then one zero byte that sets eof. The
// register's width matters where a damaged stream breaks the coder's
// invariant (value <= range), so it is kept as libwebp keeps it.
struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  const uint8_t* buf_max = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;   // range - 1
  bool eof = false;

  void init(const uint8_t* p, size_t n) {
    buf = p;
    end = p + n;
    buf_max = n >= 8 ? p + n - 8 + 1 : p;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (buf < buf_max) {
      uint64_t in = 0;
      for (int k = 0; k < 7; k++) in = (in << 8) | buf[k];
      buf += 7;
      value = in | (value << 56);
      bits += 56;
    } else if (buf < end) {
      bits += 8;
      value = (value << 8) | *buf++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  inline int get_bit(int prob) {
    if (bits < 0) load();
    uint32_t r = range;
    const uint32_t split = (r * prob) >> 8;
    const uint32_t v = (uint32_t)(value >> bits);
    int bit = v > split;
    if (bit) {
      r -= split;
      value -= (uint64_t)(split + 1) << bits;
    } else {
      r = split + 1;
    }
    int shift = 0;
    while ((r << shift) < 128) shift++;
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  // libwebp's VP8GetSigned for a coefficient's sign: a one-bit shift
  // and a sign mask from a 32-bit difference, which differs from
  // get_bit(0x80) only on a damaged stream
  inline int get_signed(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = (uint32_t)(value >> pos);
    const int32_t mask = (int32_t)(split - val) >> 31;
    bits -= 1;
    range += (uint32_t)mask;
    range |= 1;
    value -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
    return (v ^ mask) - mask;
  }
  inline int get_value(int n) {
    int v = 0;
    while (n-- > 0) v |= get_bit(0x80) << n;
    return v;
  }
  inline int get_signed_value(int n) {
    int v = get_value(n);
    return get_bit(0x80) ? -v : v;
  }
};

enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };

const int8_t kYModesIntra4[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6,
                                  -B_HE, 5, -B_RD, -B_VR, -B_LD, 7,
                                  -B_VL, 8, -B_HD, -B_HU};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11,
                             14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7,
                            0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153,
                         140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

struct FilterInfo {
  int f_limit = 0, f_ilevel = 0, f_inner = 0, hev_thresh = 0;
};

struct MBInfo : FilterInfo {
  int segment = 0, skip = 0, is_i4x4 = 0;
  uint8_t imodes[16];
  int uvmode = 0;
  int16_t coeffs[384];
  uint32_t non_zero_y = 0, non_zero_uv = 0;
};

struct Quant {
  int y1[2], y2[2], uv[2];
};

inline int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }
inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

struct VP8Decoder {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolReader br;
  BoolReader parts[8];
  int num_parts = 1;
  // segment header
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0}, filter_strength[4] = {0};
  uint8_t seg_proba[3] = {255, 255, 255};
  // filter header
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0;
  Quant dqm[4];
  uint8_t proba[4][8][3][11];
  int use_skip_proba = 0, skip_p = 0;
  // planes, macroblock-aligned
  std::vector<uint8_t> Y, U, V;
  int ys = 0, uvs = 0;

  void parse_header(const uint8_t* data, size_t size) {
    if (size < 10) fail("VP8: truncated header");
    uint32_t bits = le24(data);
    int key_frame = !(bits & 1), profile = (bits >> 1) & 7;
    int show = (bits >> 4) & 1;
    uint32_t part_len = bits >> 5;
    if (!key_frame || profile > 3 || !show || part_len >= size)
      fail("VP8: bad frame tag");
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a)
      fail("VP8: bad start code");
    width = le16(data + 6) & 0x3fff;
    height = le16(data + 8) & 0x3fff;
    if (!width || !height) fail("VP8: zero size");
    mb_w = (width + 15) >> 4;
    mb_h = (height + 15) >> 4;
    const uint8_t* buf = data + 10;
    size_t left = size - 10;
    memcpy(proba, kCoeffsProba0, sizeof(proba));
    if (part_len > left) fail("VP8: bad partition length");
    br.init(buf, part_len);
    buf += part_len;
    left -= part_len;
    br.get_value(1);   // colour space
    br.get_value(1);   // clamping type
    use_segment = br.get_value(1);
    if (use_segment) {
      update_map = br.get_value(1);
      if (br.get_value(1)) {
        absolute_delta = br.get_value(1);
        for (int s = 0; s < 4; s++)
          quantizer[s] = br.get_value(1) ? br.get_signed_value(7) : 0;
        for (int s = 0; s < 4; s++)
          filter_strength[s] = br.get_value(1) ? br.get_signed_value(6) : 0;
      }
      if (update_map)
        for (int s = 0; s < 3; s++)
          seg_proba[s] = br.get_value(1) ? br.get_value(8) : 255;
    }
    if (br.eof) fail("VP8: cannot parse segment header");
    simple = br.get_value(1);
    level = br.get_value(6);
    sharpness = br.get_value(3);
    use_lf_delta = br.get_value(1);
    if (use_lf_delta && br.get_value(1)) {
      for (int i = 0; i < 4; i++)
        if (br.get_value(1)) ref_lf_delta[i] = br.get_signed_value(6);
      for (int i = 0; i < 4; i++)
        if (br.get_value(1)) mode_lf_delta[i] = br.get_signed_value(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    if (br.eof) fail("VP8: cannot parse filter header");
    // token partitions
    num_parts = 1 << br.get_value(2);
    size_t last = num_parts - 1;
    if (left < 3 * last) fail("VP8: cannot parse partitions");
    const uint8_t* sz = buf;
    const uint8_t* start = buf + 3 * last;
    size_t size_left = left - 3 * last;
    for (size_t p = 0; p < last; p++) {
      size_t psize = le24(sz);
      if (psize > size_left) psize = size_left;
      parts[p].init(start, psize);
      start += psize;
      size_left -= psize;
      sz += 3;
    }
    parts[last].init(start, size_left);
    if (start >= buf + left) fail("VP8: cannot parse partitions");
    // quantisers
    int base_q0 = br.get_value(7);
    int dqy1_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    int dqy2_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    int dqy2_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
    int dquv_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    int dquv_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
    for (int i = 0; i < 4; i++) {
      int q;
      if (use_segment) {
        q = quantizer[i];
        if (!absolute_delta) q += base_q0;
      } else {
        if (i > 0) {
          dqm[i] = dqm[0];
          continue;
        }
        q = base_q0;
      }
      Quant& m = dqm[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
    br.get_value(1);   // refresh entropy probabilities: ignored
    for (int t = 0; t < 4; t++)
      for (int b = 0; b < 8; b++)
        for (int c = 0; c < 3; c++)
          for (int p = 0; p < 11; p++) {
            int i = ((t * 8 + b) * 3 + c) * 11 + p;
            if (br.get_bit(kCoeffsUpdateProba[i]))
              proba[t][b][c][p] = br.get_value(8);
          }
    use_skip_proba = br.get_value(1);
    if (use_skip_proba) skip_p = br.get_value(8);
  }

  void parse_intra_mode(MBInfo& b, uint8_t* top, uint8_t* left) {
    if (update_map) {
      b.segment = !br.get_bit(seg_proba[0]) ? br.get_bit(seg_proba[1])
                                            : br.get_bit(seg_proba[2]) + 2;
    } else {
      b.segment = 0;
    }
    if (use_skip_proba) b.skip = br.get_bit(skip_p);
    b.is_i4x4 = !br.get_bit(145);
    if (!b.is_i4x4) {
      int ymode = br.get_bit(156) ? (br.get_bit(128) ? B_TM : B_HE)
                                  : (br.get_bit(163) ? B_VE : B_DC);
      b.imodes[0] = ymode;
      memset(top, ymode, 4);
      memset(left, ymode, 4);
    } else {
      uint8_t* modes = b.imodes;
      for (int y = 0; y < 4; y++) {
        int ymode = left[y];
        for (int x = 0; x < 4; x++) {
          const uint8_t* prob = &kBModesProba[(top[x] * 10 + ymode) * 9];
          int i = kYModesIntra4[br.get_bit(prob[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br.get_bit(prob[i])];
          ymode = -i;
          top[x] = ymode;
        }
        memcpy(modes, top, 4);
        modes += 4;
        left[y] = ymode;
      }
    }
    b.uvmode = !br.get_bit(142) ? B_DC
             : !br.get_bit(114) ? B_VE
             : br.get_bit(183) ? B_TM : B_HE;
  }

  static int large_value(BoolReader& r, const uint8_t* p) {
    int v;
    if (!r.get_bit(p[3])) {
      if (!r.get_bit(p[4])) {
        v = 2;
      } else {
        v = 3 + r.get_bit(p[5]);
      }
    } else {
      if (!r.get_bit(p[6])) {
        if (!r.get_bit(p[7])) {
          v = 5 + r.get_bit(159);
        } else {
          v = 7 + 2 * r.get_bit(165);
          v += r.get_bit(145);
        }
      } else {
        const int bit1 = r.get_bit(p[8]);
        const int bit0 = r.get_bit(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
          v += v + r.get_bit(*tab);
        v += 3 + (8 << cat);
      }
    }
    return v;
  }

  // libwebp's GetCoeffs: returns the position after the last non-zero
  int get_coeffs(BoolReader& r, int type, int ctx, const int* dq, int n,
                 int16_t* out) {
    const uint8_t* p = proba[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!r.get_bit(p[0])) return n;
      while (!r.get_bit(p[1])) {
        p = proba[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      const uint8_t(*pn)[11] = proba[type][kBands[n + 1]];
      if (!r.get_bit(p[2])) {
        v = 1;
        p = pn[1];
      } else {
        v = large_value(r, p);
        p = pn[2];
      }
      out[kZigzag[n]] = (int16_t)(r.get_signed(v) * dq[n > 0]);
    }
    return 16;
  }

  static void transform_wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
      const int a0 = in[0 + i] + in[12 + i];
      const int a1 = in[4 + i] + in[8 + i];
      const int a2 = in[4 + i] - in[8 + i];
      const int a3 = in[0 + i] - in[12 + i];
      tmp[0 + i] = a0 + a1;
      tmp[8 + i] = a0 - a1;
      tmp[4 + i] = a3 + a2;
      tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
      const int dc = tmp[0 + i * 4] + 3;
      const int a0 = dc + tmp[3 + i * 4];
      const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
      const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
      const int a3 = dc - tmp[3 + i * 4];
      out[0] = (int16_t)((a0 + a1) >> 3);
      out[16] = (int16_t)((a3 + a2) >> 3);
      out[32] = (int16_t)((a0 - a1) >> 3);
      out[48] = (int16_t)((a3 - a2) >> 3);
      out += 64;
    }
  }

  static inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
    return nz_coeffs;
  }

  // the residuals of one macroblock; false when it has none
  bool parse_residuals(MBInfo& b, uint8_t& t_nz, uint8_t& t_nz_dc,
                       uint8_t& l_nz, uint8_t& l_nz_dc, BoolReader& r) {
    const Quant& q = dqm[b.segment];
    int16_t* dst = b.coeffs;
    memset(dst, 0, sizeof(b.coeffs));
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    int first, ac_type;
    if (!b.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = t_nz_dc + l_nz_dc;
      const int nz = get_coeffs(r, 1, ctx, q.y2, 0, dc);
      t_nz_dc = l_nz_dc = (nz > 0);
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint8_t tnz = t_nz & 0x0f;
    uint8_t lnz = l_nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(r, ac_type, ctx, q.y1, first, dst);
        l = (nz > first);
        tnz = (uint8_t)((tnz >> 1) | (l << 7));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = (uint8_t)((lnz >> 1) | (l << 7));
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz;
    uint32_t out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = t_nz >> (4 + ch);
      lnz = l_nz >> (4 + ch);
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = get_coeffs(r, 2, ctx, q.uv, 0, dst);
          l = (nz > 0);
          tnz = (uint8_t)((tnz >> 1) | (l << 3));
          nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = (uint8_t)((lnz >> 1) | (l << 5));
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= (tnz << 4) << ch;
      out_l_nz |= (lnz & 0xf0) << ch;
    }
    t_nz = (uint8_t)out_t_nz;
    l_nz = (uint8_t)out_l_nz;
    b.non_zero_y = non_zero_y;
    b.non_zero_uv = non_zero_uv;
    return (non_zero_y | non_zero_uv) != 0;
  }

  // ---- reconstruction: BPS-strided work buffer as in libwebp

  static const int BPS = 32;

  static inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
  static inline int mul2(int a) { return (a * 35468) >> 16; }

  static void transform_one(const int16_t* in, uint8_t* dst) {
    int C[16], *tmp = C;
    for (int i = 0; i < 4; ++i) {
      const int a = in[0] + in[8];
      const int b = in[0] - in[8];
      const int c = mul2(in[4]) - mul1(in[12]);
      const int d = mul1(in[4]) + mul2(in[12]);
      tmp[0] = a + d;
      tmp[1] = b + c;
      tmp[2] = b - c;
      tmp[3] = a - d;
      tmp += 4;
      in++;
    }
    tmp = C;
    for (int i = 0; i < 4; ++i) {
      const int dc = tmp[0] + 4;
      const int a = dc + tmp[8];
      const int b = dc - tmp[8];
      const int c = mul2(tmp[4]) - mul1(tmp[12]);
      const int d = mul1(tmp[4]) + mul2(tmp[12]);
      dst[0] = clip8(dst[0] + ((a + d) >> 3));
      dst[1] = clip8(dst[1] + ((b + c) >> 3));
      dst[2] = clip8(dst[2] + ((b - c) >> 3));
      dst[3] = clip8(dst[3] + ((a - d) >> 3));
      tmp++;
      dst += BPS;
    }
  }

  // libwebp's SSE2 transform (the one PIL's build runs for blocks with
  // more than three coefficients): 16-bit lanes that wrap, products by
  // mulhi with the constants less 1 << 16, and an unsigned saturating
  // pack; equal to transform_one while no sum leaves 16 bits
  static inline int16_t w16(int v) { return (int16_t)v; }
  static inline int16_t mulhi(int16_t a, int k) {
    return (int16_t)(((int32_t)a * k) >> 16);
  }
  static void transform_sse2(const int16_t* in, uint8_t* dst) {
    int16_t t[4][4], T[4][4];   // t[k][i]: pass output k, lane i
    for (int i = 0; i < 4; ++i) {
      const int16_t i0 = in[i], i1 = in[4 + i], i2 = in[8 + i],
                    i3 = in[12 + i];
      const int16_t a = w16(i0 + i2), b = w16(i0 - i2);
      const int16_t c = w16(w16(i1 - i3) +
                            w16(mulhi(i1, -30068) - mulhi(i3, 20091)));
      const int16_t d = w16(w16(i1 + i3) +
                            w16(mulhi(i1, 20091) + mulhi(i3, -30068)));
      t[0][i] = w16(a + d);
      t[1][i] = w16(b + c);
      t[2][i] = w16(b - c);
      t[3][i] = w16(a - d);
    }
    for (int k = 0; k < 4; ++k)
      for (int i = 0; i < 4; ++i) T[k][i] = t[i][k];
    for (int i = 0; i < 4; ++i) {
      const int16_t dc = w16(T[0][i] + 4);
      const int16_t a = w16(dc + T[2][i]), b = w16(dc - T[2][i]);
      const int16_t c = w16(w16(T[1][i] - T[3][i]) +
                            w16(mulhi(T[1][i], -30068) -
                                mulhi(T[3][i], 20091)));
      const int16_t d = w16(w16(T[1][i] + T[3][i]) +
                            w16(mulhi(T[1][i], 20091) +
                                mulhi(T[3][i], -30068)));
      t[0][i] = (int16_t)(w16(a + d) >> 3);
      t[1][i] = (int16_t)(w16(b + c) >> 3);
      t[2][i] = (int16_t)(w16(b - c) >> 3);
      t[3][i] = (int16_t)(w16(a - d) >> 3);
    }
    for (int y = 0; y < 4; ++y)   // row y, column x: t[x][y]
      for (int x = 0; x < 4; ++x)
        dst[x + y * BPS] = clip8(w16(dst[x + y * BPS] + t[x][y]));
  }

  // the transform variant libwebp picks: SSE2 for more than three
  // coefficients, the C AC3 and DC forms (the full transform on the
  // coefficients they read) for fewer
  static void do_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
    switch (bits >> 30) {
      case 3: transform_sse2(src, dst); break;
      case 2:
      case 1: transform_one(src, dst); break;
      default: break;
    }
  }
  static void do_uv_transform(uint32_t bits, const int16_t* src,
                              uint8_t* dst) {
    if (!(bits & 0xff)) return;
    for (int k = 0; k < 4; k++) {
      uint8_t* d = dst + (k & 1) * 4 + (k >> 1) * 4 * BPS;
      if (bits & 0xaa) {
        transform_sse2(src + 16 * k, d);
      } else if (src[16 * k]) {
        transform_one(src + 16 * k, d);
      }
    }
  }

  static inline uint8_t avg3(int a, int b, int c) {
    return (uint8_t)((a + 2 * b + c + 2) >> 2);
  }
  static inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }

  static void true_motion(uint8_t* dst, int size) {
    const uint8_t* top = dst - BPS;
    const int tl = top[-1];
    for (int y = 0; y < size; ++y) {
      const int l = dst[-1];
      for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + l - tl);
      dst += BPS;
    }
  }

  static void pred16(int mode, uint8_t* dst) {
    switch (mode) {
      case B_DC: {   // with both edges; see the edge variants below
        int dc = 16;
        for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
        fill(dst, 16, dc >> 5);
        break;
      }
      case B_TM: true_motion(dst, 16); break;
      case B_VE:
        for (int j = 0; j < 16; ++j) memcpy(dst + j * BPS, dst - BPS, 16);
        break;
      case B_HE:
        for (int j = 0; j < 16; ++j) memset(dst + j * BPS, dst[j * BPS - 1], 16);
        break;
    }
  }
  static void fill(uint8_t* dst, int size, int v) {
    for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
  }
  static void pred8(int mode, uint8_t* dst) {
    switch (mode) {
      case B_DC: {
        int dc0 = 8;
        for (int i = 0; i < 8; ++i) dc0 += dst[i - BPS] + dst[-1 + i * BPS];
        fill(dst, 8, dc0 >> 4);
        break;
      }
      case B_TM: true_motion(dst, 8); break;
      case B_VE:
        for (int j = 0; j < 8; ++j) memcpy(dst + j * BPS, dst - BPS, 8);
        break;
      case B_HE:
        for (int j = 0; j < 8; ++j) memset(dst + j * BPS, dst[j * BPS - 1], 8);
        break;
    }
  }
  // DC prediction where the top row or left column lies outside the frame
  static void dc16_edge(uint8_t* dst, bool top, bool left) {
    if (top && left) return pred16(B_DC, dst);
    int dc = 8;
    if (left) {
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
      return fill(dst, 16, dc >> 4);
    }
    if (top) {
      for (int j = 0; j < 16; ++j) dc += dst[j - BPS];
      return fill(dst, 16, dc >> 4);
    }
    fill(dst, 16, 0x80);
  }
  static void dc8_edge(uint8_t* dst, bool top, bool left) {
    if (top && left) return pred8(B_DC, dst);
    int dc = 4;
    if (left) {
      for (int i = 0; i < 8; ++i) dc += dst[-1 + i * BPS];
      return fill(dst, 8, dc >> 3);
    }
    if (top) {
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS];
      return fill(dst, 8, dc >> 3);
    }
    fill(dst, 8, 0x80);
  }

#define DST(x, y) dst[(x) + (y) * BPS]
  static void pred4(int mode, uint8_t* dst) {
    const uint8_t* top = dst - BPS;
    switch (mode) {
      case B_DC: {
        uint32_t dc = 4;
        for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
        fill(dst, 4, dc >> 3);
        break;
      }
      case B_TM: true_motion(dst, 4); break;
      case B_VE: {
        const uint8_t vals[4] = {avg3(top[-1], top[0], top[1]),
                                 avg3(top[0], top[1], top[2]),
                                 avg3(top[1], top[2], top[3]),
                                 avg3(top[2], top[3], top[4])};
        for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
        break;
      }
      case B_HE: {
        const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS],
                  D = dst[-1 + 2 * BPS], E = dst[-1 + 3 * BPS];
        memset(dst + 0 * BPS, avg3(A, B, C), 4);
        memset(dst + 1 * BPS, avg3(B, C, D), 4);
        memset(dst + 2 * BPS, avg3(C, D, E), 4);
        memset(dst + 3 * BPS, avg3(D, E, E), 4);
        break;
      }
      case B_RD: {
        const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS],
                  K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS],
                  X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                  C = dst[2 - BPS], D = dst[3 - BPS];
        DST(0, 3) = avg3(J, K, L);
        DST(1, 3) = DST(0, 2) = avg3(I, J, K);
        DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
        DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
        DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
        DST(3, 1) = DST(2, 0) = avg3(C, B, A);
        DST(3, 0) = avg3(D, C, B);
        break;
      }
      case B_LD: {
        const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS],
                  D = dst[3 - BPS], E = dst[4 - BPS], F = dst[5 - BPS],
                  G = dst[6 - BPS], H = dst[7 - BPS];
        DST(0, 0) = avg3(A, B, C);
        DST(1, 0) = DST(0, 1) = avg3(B, C, D);
        DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
        DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
        DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
        DST(3, 2) = DST(2, 3) = avg3(F, G, H);
        DST(3, 3) = avg3(G, H, H);
        break;
      }
      case B_VR: {
        const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS],
                  K = dst[-1 + 2 * BPS], X = dst[-1 - BPS],
                  A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS],
                  D = dst[3 - BPS];
        DST(0, 0) = DST(1, 2) = avg2(X, A);
        DST(1, 0) = DST(2, 2) = avg2(A, B);
        DST(2, 0) = DST(3, 2) = avg2(B, C);
        DST(3, 0) = avg2(C, D);
        DST(0, 3) = avg3(K, J, I);
        DST(0, 2) = avg3(J, I, X);
        DST(0, 1) = DST(1, 3) = avg3(I, X, A);
        DST(1, 1) = DST(2, 3) = avg3(X, A, B);
        DST(2, 1) = DST(3, 3) = avg3(A, B, C);
        DST(3, 1) = avg3(B, C, D);
        break;
      }
      case B_VL: {
        const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS],
                  D = dst[3 - BPS], E = dst[4 - BPS], F = dst[5 - BPS],
                  G = dst[6 - BPS], H = dst[7 - BPS];
        DST(0, 0) = avg2(A, B);
        DST(1, 0) = DST(0, 2) = avg2(B, C);
        DST(2, 0) = DST(1, 2) = avg2(C, D);
        DST(3, 0) = DST(2, 2) = avg2(D, E);
        DST(0, 1) = avg3(A, B, C);
        DST(1, 1) = DST(0, 3) = avg3(B, C, D);
        DST(2, 1) = DST(1, 3) = avg3(C, D, E);
        DST(3, 1) = DST(2, 3) = avg3(D, E, F);
        DST(3, 2) = avg3(E, F, G);
        DST(3, 3) = avg3(F, G, H);
        break;
      }
      case B_HU: {
        const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS],
                  K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
        DST(0, 0) = avg2(I, J);
        DST(2, 0) = DST(0, 1) = avg2(J, K);
        DST(2, 1) = DST(0, 2) = avg2(K, L);
        DST(1, 0) = avg3(I, J, K);
        DST(3, 0) = DST(1, 1) = avg3(J, K, L);
        DST(3, 1) = DST(1, 2) = avg3(K, L, L);
        DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
            DST(3, 3) = (uint8_t)L;
        break;
      }
      case B_HD: {
        const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS],
                  K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS],
                  X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                  C = dst[2 - BPS];
        DST(0, 0) = DST(2, 1) = avg2(I, X);
        DST(0, 1) = DST(2, 2) = avg2(J, I);
        DST(0, 2) = DST(2, 3) = avg2(K, J);
        DST(0, 3) = avg2(L, K);
        DST(3, 0) = avg3(A, B, C);
        DST(2, 0) = avg3(X, A, B);
        DST(1, 0) = DST(3, 1) = avg3(I, X, A);
        DST(1, 1) = DST(3, 2) = avg3(J, I, X);
        DST(1, 2) = DST(3, 3) = avg3(K, J, I);
        DST(1, 3) = avg3(L, K, J);
        break;
      }
    }
  }
#undef DST

  // ---- loop filter (dsp/dec.c)

  static inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
  static inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }
  static inline int abs0(int v) { return v < 0 ? -v : v; }

  static inline void do_filter2(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
  }
  static inline void do_filter4(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    const int a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip8(p1 + a3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a3);
  }
  static inline void do_filter6(uint8_t* p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7;
    const int a2 = (18 * a + 63) >> 7;
    const int a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip8(p2 + a3);
    p[-2 * step] = clip8(p1 + a2);
    p[-step] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a2);
    p[2 * step] = clip8(q2 - a3);
  }
  static inline bool hev(const uint8_t* p, int step, int thresh) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return abs0(p1 - p0) > thresh || abs0(q1 - q0) > thresh;
  }
  static inline bool needs_filter(const uint8_t* p, int step, int t) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return 4 * abs0(p0 - q0) + abs0(p1 - q1) <= t;
  }
  static inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
    const int p0 = p[-step], q0 = p[0];
    const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * abs0(p0 - q0) + abs0(p1 - q1) > t) return false;
    return abs0(p3 - p2) <= it && abs0(p2 - p1) <= it &&
           abs0(p1 - p0) <= it && abs0(q3 - q2) <= it &&
           abs0(q2 - q1) <= it && abs0(q1 - q0) <= it;
  }
  static void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
    const int thresh2 = 2 * thresh + 1;
    for (int i = 0; i < 16; ++i)
      if (needs_filter(p + i * vstride, hstride, thresh2))
        do_filter2(p + i * vstride, hstride);
  }
  static void filter_loop26(uint8_t* p, int hstride, int vstride, int size,
                            int thresh, int ithresh, int hev_thresh) {
    const int thresh2 = 2 * thresh + 1;
    while (size-- > 0) {
      if (needs_filter2(p, hstride, thresh2, ithresh)) {
        if (hev(p, hstride, hev_thresh)) {
          do_filter2(p, hstride);
        } else {
          do_filter6(p, hstride);
        }
      }
      p += vstride;
    }
  }
  static void filter_loop24(uint8_t* p, int hstride, int vstride, int size,
                            int thresh, int ithresh, int hev_thresh) {
    const int thresh2 = 2 * thresh + 1;
    while (size-- > 0) {
      if (needs_filter2(p, hstride, thresh2, ithresh)) {
        if (hev(p, hstride, hev_thresh)) {
          do_filter2(p, hstride);
        } else {
          do_filter4(p, hstride);
        }
      }
      p += vstride;
    }
  }

  void filter_mb(const FilterInfo& b, int mb_x, int mb_y) {
    const int limit = b.f_limit;
    if (limit == 0) return;
    uint8_t* y_dst = &Y[(size_t)mb_y * 16 * ys + mb_x * 16];
    const int ilevel = b.f_ilevel;
    if (filter_type == 1) {
      if (mb_x > 0) simple_filter(y_dst, 1, ys, limit + 4);
      if (b.f_inner)
        for (int k = 1; k < 4; k++) simple_filter(y_dst + 4 * k, 1, ys, limit);
      if (mb_y > 0) simple_filter(y_dst, ys, 1, limit + 4);
      if (b.f_inner)
        for (int k = 1; k < 4; k++)
          simple_filter(y_dst + 4 * k * ys, ys, 1, limit);
      return;
    }
    uint8_t* u_dst = &U[(size_t)mb_y * 8 * uvs + mb_x * 8];
    uint8_t* v_dst = &V[(size_t)mb_y * 8 * uvs + mb_x * 8];
    const int hev_t = b.hev_thresh;
    if (mb_x > 0) {
      filter_loop26(y_dst, 1, ys, 16, limit + 4, ilevel, hev_t);
      filter_loop26(u_dst, 1, uvs, 8, limit + 4, ilevel, hev_t);
      filter_loop26(v_dst, 1, uvs, 8, limit + 4, ilevel, hev_t);
    }
    if (b.f_inner) {
      for (int k = 1; k < 4; k++)
        filter_loop24(y_dst + 4 * k, 1, ys, 16, limit, ilevel, hev_t);
      filter_loop24(u_dst + 4, 1, uvs, 8, limit, ilevel, hev_t);
      filter_loop24(v_dst + 4, 1, uvs, 8, limit, ilevel, hev_t);
    }
    if (mb_y > 0) {
      filter_loop26(y_dst, ys, 1, 16, limit + 4, ilevel, hev_t);
      filter_loop26(u_dst, uvs, 1, 8, limit + 4, ilevel, hev_t);
      filter_loop26(v_dst, uvs, 1, 8, limit + 4, ilevel, hev_t);
    }
    if (b.f_inner) {
      for (int k = 1; k < 4; k++)
        filter_loop24(y_dst + 4 * k * ys, ys, 1, 16, limit, ilevel, hev_t);
      filter_loop24(u_dst + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t);
      filter_loop24(v_dst + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t);
    }
  }

  void filter_strengths(MBInfo& b, bool skip) {
    if (filter_type == 0) {
      b.f_limit = 0;
      return;
    }
    int base = level;
    if (use_segment) {
      base = filter_strength[b.segment];
      if (!absolute_delta) base += level;
    }
    int lv = base;
    if (use_lf_delta) {
      lv += ref_lf_delta[0];
      if (b.is_i4x4) lv += mode_lf_delta[0];
    }
    lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
    if (lv > 0) {
      int il = lv;
      if (sharpness > 0) {
        il >>= sharpness > 4 ? 2 : 1;
        if (il > 9 - sharpness) il = 9 - sharpness;
      }
      if (il < 1) il = 1;
      b.f_ilevel = il;
      b.f_limit = 2 * lv + il;
      b.hev_thresh = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
    } else {
      b.f_limit = 0;
    }
    b.f_inner = b.is_i4x4 | !skip;
  }

  // decode the frame into Y, U, V (unfiltered prediction, then the loop
  // filter in macroblock order)
  void decode(const uint8_t* data, size_t size) {
    parse_header(data, size);
    ys = mb_w * 16;
    uvs = mb_w * 8;
    Y.assign((size_t)ys * mb_h * 16, 0);
    U.assign((size_t)uvs * mb_h * 8, 0);
    V.assign((size_t)uvs * mb_h * 8, 0);
    std::vector<MBInfo> row(mb_w);
    std::vector<FilterInfo> all;   // filtered once the frame is whole
    all.reserve((size_t)mb_w * mb_h);
    std::vector<uint8_t> intra_t(4 * mb_w, B_DC);
    std::vector<uint8_t> t_nz(mb_w, 0), t_nz_dc(mb_w, 0);
    // top samples (unfiltered) of each macroblock column
    std::vector<uint8_t> top_y(16 * mb_w), top_u(8 * mb_w), top_v(8 * mb_w);
    uint8_t yuv_b[BPS * 17 + BPS * 9 * 2 + 64];
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
      for (int mb_x = 0; mb_x < mb_w; ++mb_x)
        parse_intra_mode(row[mb_x], &intra_t[4 * mb_x], intra_l);
      if (br.eof) fail("VP8: premature end of partition 0");
      BoolReader& tr = parts[mb_y & (num_parts - 1)];
      uint8_t l_nz = 0, l_nz_dc = 0;
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        MBInfo& b = row[mb_x];
        bool skip = use_skip_proba ? b.skip : 0;
        if (!skip) {
          skip = !parse_residuals(b, t_nz[mb_x], t_nz_dc[mb_x], l_nz,
                                  l_nz_dc, tr);
        } else {
          l_nz = t_nz[mb_x] = 0;
          if (!b.is_i4x4) l_nz_dc = t_nz_dc[mb_x] = 0;
          b.non_zero_y = b.non_zero_uv = 0;
        }
        filter_strengths(b, skip);
        if (tr.eof) fail("VP8: premature end of file");
      }
      // reconstruct the row
      uint8_t* y_dst = yuv_b + BPS + 8;
      uint8_t* u_dst = yuv_b + BPS * 18 + BPS + 8;
      uint8_t* v_dst = u_dst + BPS * 9;
      for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
      for (int j = 0; j < 8; ++j) {
        u_dst[j * BPS - 1] = 129;
        v_dst[j * BPS - 1] = 129;
      }
      if (mb_y > 0) {
        y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
      } else {
        memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
        memset(u_dst - BPS - 1, 127, 8 + 1);
        memset(v_dst - BPS - 1, 127, 8 + 1);
      }
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const MBInfo& b = row[mb_x];
        if (mb_x > 0) {
          for (int j = -1; j < 16; ++j)
            memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
          for (int j = -1; j < 8; ++j) {
            memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
            memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
          }
        }
        if (mb_y > 0) {
          memcpy(y_dst - BPS, &top_y[16 * mb_x], 16);
          memcpy(u_dst - BPS, &top_u[8 * mb_x], 8);
          memcpy(v_dst - BPS, &top_v[8 * mb_x], 8);
        }
        const int16_t* coeffs = b.coeffs;
        uint32_t bits = b.non_zero_y;
        if (b.is_i4x4) {
          uint8_t* top_right = y_dst - BPS + 16;
          if (mb_y > 0) {
            if (mb_x >= mb_w - 1) {
              memset(top_right, top_y[16 * mb_x + 15], 4);
            } else {
              memcpy(top_right, &top_y[16 * (mb_x + 1)], 4);
            }
          }
          for (int k = 1; k < 4; k++) memcpy(top_right + k * 4 * BPS, top_right, 4);
          for (int n = 0; n < 16; ++n, bits <<= 2) {
            uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
            pred4(b.imodes[n], dst);
            do_transform(bits, coeffs + n * 16, dst);
          }
        } else {
          if (b.imodes[0] == B_DC) {
            dc16_edge(y_dst, mb_y > 0, mb_x > 0);
          } else {
            pred16(b.imodes[0], y_dst);
          }
          if (bits != 0)
            for (int n = 0; n < 16; ++n, bits <<= 2)
              do_transform(bits, coeffs + n * 16,
                           y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
        }
        if (b.uvmode == B_DC) {
          dc8_edge(u_dst, mb_y > 0, mb_x > 0);
          dc8_edge(v_dst, mb_y > 0, mb_x > 0);
        } else {
          pred8(b.uvmode, u_dst);
          pred8(b.uvmode, v_dst);
        }
        do_uv_transform(b.non_zero_uv >> 0, coeffs + 16 * 16, u_dst);
        do_uv_transform(b.non_zero_uv >> 8, coeffs + 20 * 16, v_dst);
        if (mb_y < mb_h - 1) {
          memcpy(&top_y[16 * mb_x], y_dst + 15 * BPS, 16);
          memcpy(&top_u[8 * mb_x], u_dst + 7 * BPS, 8);
          memcpy(&top_v[8 * mb_x], v_dst + 7 * BPS, 8);
        }
        for (int j = 0; j < 16; ++j)
          memcpy(&Y[(size_t)(mb_y * 16 + j) * ys + mb_x * 16],
                 y_dst + j * BPS, 16);
        for (int j = 0; j < 8; ++j) {
          memcpy(&U[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8], u_dst + j * BPS, 8);
          memcpy(&V[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8], v_dst + j * BPS, 8);
        }
        all.push_back(b);
      }
    }
    if (filter_type > 0)
      for (int mb_y = 0; mb_y < mb_h; ++mb_y)
        for (int mb_x = 0; mb_x < mb_w; ++mb_x)
          filter_mb(all[(size_t)mb_y * mb_w + mb_x], mb_x, mb_y);
  }
};

// ---- YUV -> RGB (yuv.h) and the fancy upsampler (upsampling.c)

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int yuv_clip8(int v) {
  return ((v & ~16383) == 0) ? (v >> 6) : (v < 0) ? 0 : 255;
}
inline void yuv_to_rgba(int y, int u, int v, uint8_t* rgba) {
  rgba[0] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgba[1] = (uint8_t)yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) -
                               mult_hi(v, 13320) + 8708);
  rgba[2] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
  rgba[3] = 0xff;
}

void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y,
                   const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
#define LOAD_UV(u, v) ((uint32_t)(u) | ((uint32_t)(v) << 16))
  const int last_pixel_pair = (len - 1) >> 1;
  uint32_t tl_uv = LOAD_UV(top_u[0], top_v[0]);
  uint32_t l_uv = LOAD_UV(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_rgba(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
  }
  if (bottom_y) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_rgba(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
  }
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const uint32_t t_uv = LOAD_UV(top_u[x], top_v[x]);
    const uint32_t uv = LOAD_UV(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      yuv_to_rgba(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16,
                  top_dst + (2 * x - 1) * 4);
      yuv_to_rgba(top_y[2 * x], uv1 & 0xff, uv1 >> 16, top_dst + 2 * x * 4);
    }
    if (bottom_y) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      yuv_to_rgba(bottom_y[2 * x - 1], uv0 & 0xff, uv0 >> 16,
                  bottom_dst + (2 * x - 1) * 4);
      yuv_to_rgba(bottom_y[2 * x], uv1 & 0xff, uv1 >> 16,
                  bottom_dst + 2 * x * 4);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_rgba(top_y[len - 1], uv0 & 0xff, uv0 >> 16,
                  top_dst + (len - 1) * 4);
    }
    if (bottom_y) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_rgba(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16,
                  bottom_dst + (len - 1) * 4);
    }
  }
#undef LOAD_UV
}

// ---- ALPH

void unfilter_alpha(int filter, const uint8_t* prev, const uint8_t* in,
                    uint8_t* out, int width) {
  if (filter == 0) {
    memcpy(out, in, width);
    return;
  }
  if (filter == 1 || prev == nullptr) {
    uint8_t pred = prev == nullptr ? 0 : prev[0];
    for (int i = 0; i < width; ++i) {
      out[i] = (uint8_t)(pred + in[i]);
      pred = out[i];
    }
    return;
  }
  if (filter == 2) {
    for (int i = 0; i < width; ++i) out[i] = (uint8_t)(prev[i] + in[i]);
    return;
  }
  uint8_t top = prev[0], top_left = top, left = top;
  for (int i = 0; i < width; ++i) {
    top = prev[i];
    int g = left + top - top_left;
    left = (uint8_t)(in[i] + (g < 0 ? 0 : g > 255 ? 255 : g));
    top_left = top;
    out[i] = left;
  }
}

std::vector<uint8_t> decode_alpha(const uint8_t* data, size_t size, int w,
                                  int h) {
  if (size <= 1) fail("ALPH: too short");
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3;
  const int pre = (data[0] >> 4) & 3, rsrv = (data[0] >> 6) & 3;
  if (method > 1 || pre > 1 || rsrv != 0) fail("ALPH: bad header");
  std::vector<uint8_t> deltas((size_t)w * h);
  if (method == 0) {
    if (size - 1 < (size_t)w * h) fail("ALPH: truncated");
    memcpy(deltas.data(), data + 1, deltas.size());
  } else {
    VP8LDecoder d;
    d.alpha = true;
    d.br.init(data + 1, size - 1);
    std::vector<uint32_t> argb = d.decode_stream(w, h, true);
    for (size_t i = 0; i < deltas.size(); i++)
      deltas[i] = (argb[i] >> 8) & 0xff;
  }
  std::vector<uint8_t> out((size_t)w * h);
  for (int y = 0; y < h; y++)
    unfilter_alpha(filter, y ? &out[(size_t)(y - 1) * w] : nullptr,
                   &deltas[(size_t)y * w], &out[(size_t)y * w], w);
  return out;
}

// a lossy frame (with its alpha, if any) -> RGBA rows of `stride` bytes
void decode_lossy(const uint8_t* data, size_t size, const uint8_t* alpha,
                  size_t alpha_size, uint8_t* out, size_t stride, int* w,
                  int* h) {
  VP8Decoder d;
  d.decode(data, size);
  const int W = d.width, H = d.height;
  *w = W;
  *h = H;
  const uint8_t* Y = d.Y.data();
  const uint8_t* U = d.U.data();
  const uint8_t* V = d.V.data();
  upsample_pair(Y, nullptr, U, V, U, V, out, nullptr, W);
  for (int k = 1; 2 * k - 1 < H; ++k) {
    const uint8_t* tu = U + (size_t)(k - 1) * d.uvs;
    const uint8_t* tv = V + (size_t)(k - 1) * d.uvs;
    if (2 * k < H) {
      const uint8_t* cu = U + (size_t)k * d.uvs;
      const uint8_t* cv = V + (size_t)k * d.uvs;
      upsample_pair(Y + (size_t)(2 * k - 1) * d.ys, Y + (size_t)(2 * k) * d.ys,
                    tu, tv, cu, cv, out + (2 * k - 1) * stride,
                    out + 2 * k * stride, W);
    } else {
      upsample_pair(Y + (size_t)(2 * k - 1) * d.ys, nullptr, tu, tv, tu, tv,
                    out + (2 * k - 1) * stride, nullptr, W);
    }
  }
  if (alpha) {
    std::vector<uint8_t> a = decode_alpha(alpha, alpha_size, W, H);
    for (int y = 0; y < H; y++)
      for (int x = 0; x < W; x++) out[y * stride + 4 * x + 3] = a[(size_t)y * W + x];
  }
}

// ---- the container (demux.c, as WebPAnimDecoder opens a file)

struct Frame {
  size_t img_off = 0, img_size = 0;       // the VP8/VP8L chunk, header too
  size_t alpha_off = 0, alpha_size = 0;   // the ALPH chunk, header too
  int x = 0, y = 0, w = 0, h = 0;
  int has_alpha = 0, complete = 0, num = 0;
  bool lossless = false;
};

const uint32_t ALPHA_FLAG = 0x10, ANIMATION_FLAG = 0x02;
const uint32_t ALL_VALID_FLAGS = 0x3e;   // ALPHA | ANIM | ICCP | EXIF | XMP
const uint32_t MAX_CHUNK_PAYLOAD = ~0u - 8 - 1;

inline uint32_t fourcc(const char* s) { return le32((const uint8_t*)s); }

struct Demux {
  const uint8_t* buf;
  size_t end;          // the RIFF's end
  size_t pos = 12;
  int is_ext = 0;
  uint32_t flags = 0;
  int canvas_w = 0, canvas_h = 0;
  std::vector<Frame> frames;

  size_t avail() const { return end - pos; }

  // WebPGetFeatures on a VP8 / VP8L chunk: its size and alpha bit
  void features(size_t off, size_t size, Frame& f) {
    const uint8_t* c = buf + off;
    const uint8_t* p = c + 8;
    size_t n = size - 8;
    uint32_t chunk = le32(c + 4);
    if (le32(c) == fourcc("VP8L")) {
      if (n < 5 || p[0] != 0x2f || (p[4] >> 5) != 0) fail("VP8L: bad header");
      uint32_t bits = le32(p + 1);
      f.w = (bits & 0x3fff) + 1;
      f.h = ((bits >> 14) & 0x3fff) + 1;
      f.has_alpha |= (bits >> 28) & 1;
      f.lossless = true;
    } else {
      if (n < 10) fail("VP8: truncated header");
      uint32_t bits = le24(p);
      if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) ||
          (bits >> 5) >= chunk)
        fail("VP8: bad frame tag");
      if (p[3] != 0x9d || p[4] != 0x01 || p[5] != 0x2a)
        fail("VP8: bad start code");
      f.w = le16(p + 6) & 0x3fff;
      f.h = le16(p + 8) & 0x3fff;
      if (!f.w || !f.h) fail("VP8: zero size");
      f.lossless = false;
    }
  }

  // StoreFrame: the ALPH / VP8 / VP8L chunks of one frame from pos
  void store_frame(int num, Frame& f) {
    int alpha_chunks = 0, image_chunks = 0;
    if (avail() < 8) fail("WebP: truncated frame");
    bool done = false;
    do {
      const size_t start = pos;
      const uint32_t cc = le32(buf + pos);
      const uint32_t payload = le32(buf + pos + 4);
      if (payload > MAX_CHUNK_PAYLOAD) fail("WebP: bad chunk size");
      const uint32_t padded = payload + (payload & 1);
      pos += 8;
      if (padded > end - pos) fail("WebP: chunk past the RIFF's end");
      const size_t chunk = 8 + padded;
      if (cc == fourcc("ALPH") && alpha_chunks == 0) {
        ++alpha_chunks;
        f.alpha_off = start;
        f.alpha_size = chunk;
        f.has_alpha = 1;
        f.num = num;
        pos += padded;
      } else if ((cc == fourcc("VP8L") || cc == fourcc("VP8 ")) &&
                 image_chunks == 0) {
        if (cc == fourcc("VP8L") && alpha_chunks > 0)
          fail("WebP: ALPH before VP8L");
        features(start, chunk, f);
        ++image_chunks;
        f.img_off = start;
        f.img_size = chunk;
        f.num = num;
        f.complete = 1;
        pos += padded;
      } else {
        pos = start;
        done = true;
      }
      if (pos == end) {
        done = true;
      } else if (avail() < 8) {
        fail("WebP: truncated chunk header");
      }
    } while (!done);
  }

  void add_frame(Frame& f) {
    if (!frames.empty() && !frames.back().complete)
      fail("WebP: incomplete frame");
    if (f.complete) frames.push_back(f);
  }

  void parse_single() {
    if (!frames.empty()) fail("WebP: a second image");
    if (avail() < 8) fail("WebP: truncated");
    Frame f;
    store_frame(1, f);
    if (!(flags & ALPHA_FLAG) && f.alpha_size > 0) {
      f.alpha_off = f.alpha_size = 0;   // alpha without the flag is dropped
      f.has_alpha = 0;
    }
    if (!is_ext && f.w > 0 && f.h > 0) {
      canvas_w = f.w;
      canvas_h = f.h;
      flags |= f.has_alpha ? ALPHA_FLAG : 0;
    }
    add_frame(f);
  }

  void parse_anmf(uint32_t padded) {
    const bool anim = flags & ANIMATION_FLAG;
    if (padded < 16) fail("WebP: bad ANMF");
    if (avail() < padded) fail("WebP: truncated ANMF");
    const uint8_t* p = buf + pos;
    Frame f;
    f.x = 2 * le24(p);
    f.y = 2 * le24(p + 3);
    f.w = 1 + le24(p + 6);
    f.h = 1 + le24(p + 9);
    pos += 16;
    const size_t start = pos;
    const uint32_t payload = padded - 16;
    if (avail() < 8 || avail() < payload) fail("WebP: truncated frame");
    store_frame((int)frames.size() + 1, f);
    if (pos - start > payload) fail("WebP: frame past its ANMF");
    if (anim && f.num > 0) add_frame(f);
  }

  void parse_vp8x() {
    is_ext = 1;
    uint32_t size = le32(buf + pos + 4);
    pos += 8;
    if (size > MAX_CHUNK_PAYLOAD || size < 10) fail("WebP: bad VP8X");
    size += size & 1;
    if (size > avail()) fail("WebP: VP8X past the RIFF's end");
    flags = buf[pos];
    canvas_w = 1 + le24(buf + pos + 4);
    canvas_h = 1 + le24(buf + pos + 7);
    if ((uint64_t)canvas_w * canvas_h >= (1ull << 32))
      fail("WebP: canvas too large");
    pos += size;
    if (avail() < 8) fail("WebP: no chunks after VP8X");
    const bool anim = flags & ANIMATION_FLAG;
    int anim_chunks = 0;
    for (;;) {
      const uint32_t cc = le32(buf + pos);
      const uint32_t chunk_size = le32(buf + pos + 4);
      if (chunk_size > MAX_CHUNK_PAYLOAD) fail("WebP: bad chunk size");
      const uint32_t padded = chunk_size + (chunk_size & 1);
      if (padded > avail() - 8) fail("WebP: chunk past the RIFF's end");
      if (cc == fourcc("VP8X")) {
        fail("WebP: a second VP8X");
      } else if (cc == fourcc("ALPH") || cc == fourcc("VP8 ") ||
                 cc == fourcc("VP8L")) {
        if (anim_chunks > 0 || anim) fail("WebP: a still image in an animation");
        parse_single();
      } else if (cc == fourcc("ANIM") && anim_chunks == 0) {
        if (padded < 6) fail("WebP: bad ANIM");
        pos += 8 + padded;
        ++anim_chunks;
      } else if (cc == fourcc("ANMF")) {
        if (anim_chunks == 0) fail("WebP: ANMF before ANIM");
        pos += 8;
        parse_anmf(padded);
      } else {
        pos += 8 + padded;   // ICCP, EXIF, XMP, unknown: skipped
      }
      if (pos == end) break;
      if (avail() < 8) fail("WebP: truncated chunk header");
    }
  }

  void parse(const uint8_t* data, size_t n) {
    buf = data;
    if (n < 20) fail("WebP: truncated");
    if (memcmp(data, "RIFF", 4) || memcmp(data + 8, "WEBP", 4))
      fail("WebP: not a WebP file");
    uint32_t riff = le32(data + 4);
    if (riff < 8 || riff > MAX_CHUNK_PAYLOAD) fail("WebP: bad RIFF size");
    end = (size_t)riff + 8;
    if (n < end) fail("WebP: truncated");
    const uint32_t cc = le32(data + 12);
    if (cc == fourcc("VP8X")) {
      parse_vp8x();
      validate_ext();
    } else if (cc == fourcc("VP8 ") || cc == fourcc("VP8L")) {
      parse_single();
      if (frames.empty() || canvas_w <= 0) fail("WebP: no image");
      const Frame& f = frames[0];
      if (f.alpha_size > 0 && f.alpha_off > f.img_off)
        fail("WebP: ALPH after the image");
    } else {
      fail("WebP: no image chunk");
    }
  }

  void validate_ext() {
    const bool anim = flags & ANIMATION_FLAG;
    if (canvas_w <= 0 || canvas_h <= 0) fail("WebP: bad canvas");
    if (frames.empty()) fail("WebP: no frames");
    if (flags & ~ALL_VALID_FLAGS) fail("WebP: bad VP8X flags");
    for (const Frame& f : frames) {
      if (!anim && f.num > 1) fail("WebP: frames in a still image");
      if (f.alpha_size == 0 && f.img_size == 0) fail("WebP: empty frame");
      if (f.alpha_size > 0 && f.alpha_off > f.img_off)
        fail("WebP: ALPH after the image");
      if (f.w <= 0 || f.h <= 0) fail("WebP: empty frame");
      if (!anim) {
        if (f.x != 0 || f.y != 0 || f.w != canvas_w || f.h != canvas_h)
          fail("WebP: frame does not fill the canvas");
      } else if (f.x + f.w > canvas_w || f.y + f.h > canvas_h) {
        fail("WebP: frame outside the canvas");
      }
    }
  }
};

// the first frame, decoded as WebPDecode decodes the demuxer's fragment,
// into a zeroed canvas
void decode_first(const Demux& dm, uint8_t* canvas) {
  const Frame& f = dm.frames[0];
  const size_t stride = (size_t)dm.canvas_w * 4;
  uint8_t* dst = canvas + (size_t)f.y * stride + (size_t)f.x * 4;
  // the decoders read on to the end of the demuxer's fragment: the
  // chunk's pad byte is part of the stream
  const uint8_t* data = dm.buf + f.img_off + 8;
  const size_t payload = f.img_size - 8;
  int w, h;
  if (f.lossless) {
    int alpha;
    std::vector<uint32_t> argb = decode_vp8l(data, payload, &w, &h, &alpha);
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++) {
        uint32_t v = argb[(size_t)y * w + x];
        uint8_t* o = dst + y * stride + 4 * x;
        o[0] = (v >> 16) & 0xff;
        o[1] = (v >> 8) & 0xff;
        o[2] = v & 0xff;
        o[3] = v >> 24;
      }
  } else {
    const uint8_t* alpha = nullptr;
    size_t alpha_size = 0;
    if (f.alpha_size > 0) {
      alpha = dm.buf + f.alpha_off + 8;
      alpha_size = le32(dm.buf + f.alpha_off + 4);
    }
    decode_lossy(data, payload, alpha, alpha_size, dst, stride, &w, &h);
  }
}

}  // namespace

extern "C" const char* webp_last_error() { return g_error.c_str(); }

extern "C" int webp_info(const uint8_t* data, long long n, int* w, int* h,
                         int* rgba) {
  try {
    Demux dm;
    dm.parse(data, (size_t)n);
    *w = dm.canvas_w;
    *h = dm.canvas_h;
    *rgba = (dm.flags & ALPHA_FLAG) ? 1 : 0;
    return 0;
  } catch (const Fail& e) {
    g_error = e.what;
    return 1;
  } catch (const std::bad_alloc&) {
    g_error = "out of memory";
    return 1;
  }
}

extern "C" int webp_decode(const uint8_t* data, long long n, uint8_t* out) {
  try {
    Demux dm;
    dm.parse(data, (size_t)n);
    memset(out, 0, (size_t)dm.canvas_w * dm.canvas_h * 4);
    decode_first(dm, out);
    return 0;
  } catch (const Fail& e) {
    g_error = e.what;
    return 1;
  } catch (const std::bad_alloc&) {
    g_error = "out of memory";
    return 1;
  }
}
