// WebP decoding as libwebp 1.6 decodes for OpenCV.
//
// The JAX package reads WMS replies and replay files with cv2.imdecode /
// cv2.imread, which read WebP through libwebp (WebPDecodeBGRInto and
// WebPDecodeBGRAInto, and WebPAnimDecoder for animated files). The card
// machine has neither OpenCV nor libwebp, so the port carries this decoder,
// built at first use with the host compiler and bound with ctypes
// (gisnav_tpu_torch/gis/webp.py). Each stage follows libwebp's C code at
// the defaults OpenCV decodes with, so the pixels are those of cv2:
//
// Container (webp_dec.c): RIFF/WEBP, the simple "VP8 " and "VP8L" files,
// raw VP8 and VP8L bitstreams, VP8X with its optional chunks (the last ALPH
// before the image counts), chunk padding, the RIFF and chunk size checks
// and WebPGetFeatures on a 32-byte header (OpenCV's signature test).
// Demux (demux.c): the chunk walk that finds an animation's first frame and
// the EXIF chunk (stored only when the VP8X EXIF flag is set), with its
// validity rules.
// VP8L (vp8l_dec.c, lossless.c, huffman_utils.c; RFC 9649): the bit reader
// and its end-of-stream rule, simple and normal prefix codes with the
// code-length code, meta prefix codes, the colour cache, LZ77 with the
// 120-code distance map, and the predictor (14 modes), cross-colour,
// subtract-green and colour-indexing transforms.
// VP8 (vp8_dec.c, tree_dec.c, quant_dec.c, frame_dec.c, dec.c; RFC 6386):
// the boolean decoder with libwebp's end-of-data rule, the frame header,
// segments, filter header, partitions, quantiser tables, coefficient
// probabilities and tokens, intra prediction (16x16, 4x4 with ten modes,
// 8x8 chroma; 127/129 borders), the inverse DCT and WHT, and the simple and
// normal loop filters.
// Output (upsampling.c, yuv.h, io_dec.c): the "fancy" 4:2:0 upsampler
// (9/3/3/1 with edge replication) and the 14-bit fixed-point YUV->BGR.
// Alpha (alpha_dec.c, filters.c): ALPH raw or VP8L-compressed, with the
// horizontal, vertical and gradient unfilters; BGRA is not premultiplied.
// Animation (anim_decode.c): frame 1 on a transparent black canvas at its
// offset (frame 1 is a key frame: no blending).
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

struct Invalid {  // bytes cv2 gives None for
  std::string msg;
};

[[noreturn]] void fail(const char* msg) { throw Invalid{msg}; }

// libwebp's VP8StatusCode values that the header parse distinguishes
enum Status { kOk = 0, kBitstreamError = 3, kNotEnoughData = 7 };

constexpr size_t kTagSize = 4, kChunkHeaderSize = 8, kRiffHeaderSize = 12;
constexpr size_t kVp8xChunkSize = 10, kVp8FrameHeaderSize = 10;
constexpr size_t kVp8lFrameHeaderSize = 5, kAnmfChunkSize = 16;
constexpr size_t kAnimChunkSize = 6;
constexpr uint32_t kMaxChunkPayload = ~0u - kChunkHeaderSize - 1;
constexpr uint64_t kMaxImageArea = uint64_t(1) << 32;
constexpr uint32_t kAlphaFlag = 0x10, kAnimationFlag = 0x02,
                   kExifFlag = 0x08, kIccpFlag = 0x20, kXmpFlag = 0x04;
constexpr uint32_t kAllValidFlags =
    kAlphaFlag | kAnimationFlag | kIccpFlag | kExifFlag | kXmpFlag;

uint32_t le16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
uint32_t le24(const uint8_t* p) { return le16(p) | (uint32_t(p[2]) << 16); }
uint32_t le32(const uint8_t* p) { return le16(p) | (le16(p + 2) << 16); }
bool tag_is(const uint8_t* p, const char* t) {
  return std::memcmp(p, t, kTagSize) == 0;
}

// ---- tables (RFC 6386 and RFC 9649) ------------------------------------

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

// [type][band][context][node]
const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

// [top mode][left mode][node], libwebp's mode order (DC, TM, VE, HE, RD,
// VR, LD, VL, HD, HU)
const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

// (y << 4) | (8 - x) of the 120 short distance codes
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

// ---- VP8L: the lossless bitstream (vp8l_dec.c) ------------------------------

// bit_reader_utils.c's VP8LBitReader: a 64-bit window read LSB first,
// refilled a byte at a time. The stream ends (eos) once more bits are
// consumed than it holds, counting a stream under 8 bytes as 8 (its window
// reads zeros).
class LBitReader {
 public:
  void init(const uint8_t* start, size_t length) {
    buf_ = start;
    len_ = length;
    val_ = 0;
    bit_pos_ = 0;
    eos_ = false;
    const size_t n = length < 8 ? length : 8;
    for (size_t i = 0; i < n; ++i) val_ |= uint64_t(start[i]) << (8 * i);
    pos_ = n;
  }
  uint32_t read(int n) {  // VP8LReadBits, n <= 24
    if (!eos_ && n <= 24) {
      const uint32_t v = prefetch() & ((1u << n) - 1u);
      bit_pos_ += n;
      shift_bytes();
      return v;
    }
    set_eos();
    return 0;
  }
  uint32_t prefetch() const { return uint32_t(val_ >> (bit_pos_ & 63)); }
  void skip(int n) { bit_pos_ += n; }  // VP8LSetBitPos
  void fill() {                        // VP8LFillBitWindow
    if (bit_pos_ >= 32) shift_bytes();
  }
  bool at_end() const { return eos_ || (pos_ == len_ && bit_pos_ > 64); }
  bool eos() const { return eos_; }

 private:
  void shift_bytes() {
    while (bit_pos_ >= 8 && pos_ < len_) {
      val_ >>= 8;
      val_ |= uint64_t(buf_[pos_]) << 56;
      ++pos_;
      bit_pos_ -= 8;
    }
    if (at_end()) set_eos();
  }
  void set_eos() {
    eos_ = true;
    bit_pos_ = 0;
  }
  const uint8_t* buf_ = nullptr;
  size_t len_ = 0, pos_ = 0;
  uint64_t val_ = 0;
  int bit_pos_ = 0;
  bool eos_ = false;
};

constexpr int kMaxCodeLength = 15;
constexpr int kNumLiteralCodes = 256, kNumLengthCodes = 24;
constexpr int kNumDistanceCodes = 40, kMaxCacheBits = 11;
constexpr int kCodeLengthCodes = 19;
constexpr uint8_t kCodeLengthCodeOrder[kCodeLengthCodes] = {
    17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
constexpr int kRootBits = 8;

// A canonical prefix code as huffman_utils.c builds it: either one symbol
// read with no bits, or a complete code; a root table resolves codes of up
// to 8 bits, longer ones are walked bit by bit.
struct PrefixCode {
  int single = -1;
  std::vector<uint32_t> root;  // (length << 16) | symbol; 0: a longer code
  uint16_t count[kMaxCodeLength + 1] = {};
  std::vector<uint16_t> sorted;
};

// VP8LBuildHuffmanTable's checks: no length over 15, not all zero, one
// symbol or a complete code.
bool build_code(PrefixCode* code, const int* lengths, int n) {
  int count[kMaxCodeLength + 1] = {};
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > kMaxCodeLength) return false;
    ++count[lengths[s]];
  }
  if (count[0] == n) return false;
  for (int len = 1; len < kMaxCodeLength; ++len)
    if (count[len] > (1 << len)) return false;
  const int used = n - count[0];
  if (used > 1) {
    int open = 1;
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      open = (open << 1) - count[len];
      if (open < 0) return false;
    }
    if (open != 0) return false;
  }
  if (code == nullptr) return true;
  code->sorted.clear();
  for (int len = 1; len <= kMaxCodeLength; ++len)
    for (int s = 0; s < n; ++s)
      if (lengths[s] == len) code->sorted.push_back(uint16_t(s));
  if (used == 1) {
    code->single = code->sorted[0];
    return true;
  }
  code->single = -1;
  for (int len = 0; len <= kMaxCodeLength; ++len)
    code->count[len] = uint16_t(len ? count[len] : 0);
  code->root.assign(size_t(1) << kRootBits, 0);
  uint32_t next = 0;
  size_t k = 0;
  for (int len = 1; len <= kMaxCodeLength; ++len) {
    for (int i = 0; i < count[len]; ++i, ++next, ++k) {
      if (len > kRootBits) continue;
      uint32_t rev = 0;
      for (int b = 0; b < len; ++b) rev |= ((next >> b) & 1u) << (len - 1 - b);
      for (uint32_t key = rev; key < (1u << kRootBits); key += 1u << len)
        code->root[key] = (uint32_t(len) << 16) | code->sorted[k];
    }
    next <<= 1;
  }
  return true;
}

// ReadSymbol: the bits of the window are consumed as the code's length.
int read_symbol(const PrefixCode& code, LBitReader* br) {
  if (code.single >= 0) return code.single;
  const uint32_t bits = br->prefetch();
  const uint32_t e = code.root[bits & ((1u << kRootBits) - 1)];
  if (e >> 16) {
    br->skip(int(e >> 16));
    return int(e & 0xffff);
  }
  int c = 0, first = 0, index = 0;
  for (int len = 1; len <= kMaxCodeLength; ++len) {
    c |= int((bits >> (len - 1)) & 1u);
    const int n = code.count[len];
    if (c - first < n) {
      br->skip(len);
      return code.sorted[size_t(index + c - first)];
    }
    index += n;
    first = (first + n) << 1;
    c <<= 1;
  }
  return 0;  // not reached for a complete code
}

int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

// The five codes of a meta prefix code: green + lengths + cache, red, blue,
// alpha, distance.
struct CodeGroup {
  PrefixCode codes[5];
};

struct Metadata {
  int cache_bits = 0;
  int huffman_bits = 0, huffman_xsize = 0;
  std::vector<uint32_t> huffman_image;  // group per tile
  std::vector<CodeGroup> groups;
};

enum { kPredictor = 0, kCrossColor = 1, kSubtractGreen = 2,
       kColorIndexing = 3 };

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
int clip255(int a) { return a < 0 ? 0 : a > 255 ? 255 : a; }
int sub3(int a, int b, int c) {
  const int pb = b - c, pa = a - c;
  return std::abs(pb) - std::abs(pa);
}
uint32_t select_pixel(uint32_t a, uint32_t b, uint32_t c) {
  const int pa_minus_pb =
      sub3(int(a >> 24), int(b >> 24), int(c >> 24)) +
      sub3(int((a >> 16) & 0xff), int((b >> 16) & 0xff),
           int((c >> 16) & 0xff)) +
      sub3(int((a >> 8) & 0xff), int((b >> 8) & 0xff), int((c >> 8) & 0xff)) +
      sub3(int(a & 0xff), int(b & 0xff), int(c & 0xff));
  return pa_minus_pb <= 0 ? a : b;
}
uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = int((c0 >> s) & 0xff) + int((c1 >> s) & 0xff) -
                  int((c2 >> s) & 0xff);
    out |= uint32_t(clip255(v)) << s;
  }
  return out;
}
uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = int((ave >> s) & 0xff), b = int((c2 >> s) & 0xff);
    out |= uint32_t(clip255(a + (a - b) / 2)) << s;
  }
  return out;
}

// lossless.c's predictors (modes 14 and 15 are black, as mode 0)
uint32_t predict(int mode, uint32_t left, const uint32_t* top) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10:
      return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select_pixel(top[0], left, top[-1]);
    case 12: return clamped_add_subtract_full(left, top[0], top[-1]);
    case 13: return clamped_add_subtract_half(left, top[0], top[-1]);
    default: return 0xff000000u;
  }
}

int color_delta(int8_t pred, int8_t color) { return (int(pred) * color) >> 5; }

class VP8LDecoder {
 public:
  // VP8LDecodeHeader + VP8LDecodeImage: a whole VP8L bitstream -> ARGB.
  bool decode(const uint8_t* data, size_t size, int* w, int* h,
              std::vector<uint32_t>* argb) {
    br_.init(data, size);
    if (br_.read(8) != 0x2f) return false;
    *w = int(br_.read(14)) + 1;
    *h = int(br_.read(14)) + 1;
    br_.read(1);
    if (br_.read(3) != 0 || br_.eos()) return false;
    return decode_level0(*w, *h, argb);
  }
  // VP8LDecodeAlphaHeader + VP8LDecodeAlphaImageStream: an ALPH chunk's
  // headerless stream -> the green channel, one byte a pixel.
  bool decode_alpha(const uint8_t* data, size_t size, int w, int h,
                    uint8_t* out) {
    br_.init(data, size);
    std::vector<uint32_t> argb;
    if (!decode_level0(w, h, &argb)) return false;
    for (size_t i = 0; i < argb.size(); ++i) out[i] = uint8_t(argb[i] >> 8);
    return true;
  }

 private:
  bool decode_level0(int w, int h, std::vector<uint32_t>* argb) {
    std::vector<uint32_t> px;
    if (!decode_stream(w, h, true, &px)) return false;
    for (int i = num_transforms_ - 1; i >= 0; --i)
      inverse_transform(transforms_[i], &px);
    argb->swap(px);
    return true;
  }

  // DecodeImageStream: transforms (level 0 only), colour cache, codes,
  // then the entropy-coded pixels.
  bool decode_stream(int xsize, int ysize, bool level0,
                     std::vector<uint32_t>* out) {
    int txsize = xsize;
    if (level0) {
      while (br_.read(1))
        if (!read_transform(&txsize, ysize)) return false;
    }
    Metadata meta;
    if (br_.read(1)) {
      meta.cache_bits = int(br_.read(4));
      if (meta.cache_bits < 1 || meta.cache_bits > kMaxCacheBits)
        return false;
    }
    if (!read_codes(txsize, ysize, level0, &meta)) return false;
    out->assign(size_t(txsize) * size_t(ysize), 0);
    return decode_pixels(out->data(), txsize, ysize, meta) && !br_.eos();
  }

  bool read_transform(int* xsize, int ysize) {
    const int type = int(br_.read(2));
    if (seen_ & (1u << type)) return false;
    seen_ |= 1u << type;
    Transform& t = transforms_[num_transforms_++];
    t.type = type;
    t.xsize = *xsize;
    t.ysize = ysize;
    switch (type) {
      case kPredictor:
      case kCrossColor:
        t.bits = int(br_.read(3)) + 2;
        return decode_stream(subsample(t.xsize, t.bits),
                             subsample(t.ysize, t.bits), false, &t.data);
      case kColorIndexing: {
        const int num_colors = int(br_.read(8)) + 1;
        const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1
                         : num_colors > 2 ? 2 : 3;
        *xsize = subsample(t.xsize, bits);
        t.bits = bits;
        if (!decode_stream(num_colors, 1, false, &t.data)) return false;
        // ExpandColorMap: each entry a byte-wise delta from the last
        const size_t final_colors = size_t(1) << (8 >> bits);
        std::vector<uint32_t> map(final_colors, 0);
        map[0] = t.data[0];
        for (size_t i = 1; i < size_t(num_colors) && i < final_colors; ++i)
          map[i] = add_pixels(t.data[i], map[i - 1]);
        t.data.swap(map);
        return true;
      }
      default:
        return true;
    }
  }

  // ReadHuffmanCodes + ReadHuffmanCodesHelper: the meta image, then every
  // group's five codes; groups the meta image never names are read and
  // checked but not kept.
  bool read_codes(int xsize, int ysize, bool allow_recursion,
                  Metadata* meta) {
    int num_groups = 1;
    std::vector<int> mapping;
    if (allow_recursion && br_.read(1)) {
      const int bits = int(br_.read(3)) + 2;
      const int hx = subsample(xsize, bits), hy = subsample(ysize, bits);
      if (!decode_stream(hx, hy, false, &meta->huffman_image)) return false;
      meta->huffman_bits = bits;
      meta->huffman_xsize = hx;
      int max_group = 0;
      for (uint32_t& g : meta->huffman_image) {
        g = (g >> 8) & 0xffff;
        if (int(g) > max_group) max_group = int(g);
      }
      mapping.assign(size_t(max_group) + 1, -1);
      num_groups = 0;
      for (uint32_t& g : meta->huffman_image) {
        if (mapping[g] < 0) mapping[g] = num_groups++;
        g = uint32_t(mapping[g]);
      }
    }
    if (br_.eos()) return false;
    const int cache_size = meta->cache_bits ? 1 << meta->cache_bits : 0;
    const int alphabet[5] = {kNumLiteralCodes + kNumLengthCodes + cache_size,
                             kNumLiteralCodes, kNumLiteralCodes,
                             kNumLiteralCodes, kNumDistanceCodes};
    std::vector<int> lengths(size_t(alphabet[0]), 0);
    meta->groups.resize(size_t(num_groups));
    const size_t total = mapping.empty() ? 1 : mapping.size();
    for (size_t i = 0; i < total; ++i) {
      const int slot = mapping.empty() ? 0 : mapping[i];
      for (int j = 0; j < 5; ++j) {
        PrefixCode* code =
            slot < 0 ? nullptr : &meta->groups[size_t(slot)].codes[j];
        if (!read_code(alphabet[j], &lengths, code)) return false;
      }
    }
    return true;
  }

  // ReadHuffmanCode: a simple code (one or two symbols of length 1) or the
  // code lengths through the code-length code.
  bool read_code(int alphabet_size, std::vector<int>* lengths,
                 PrefixCode* code) {
    std::fill(lengths->begin(), lengths->begin() + alphabet_size, 0);
    bool ok = true;
    if (br_.read(1)) {
      const int num_symbols = int(br_.read(1)) + 1;
      const int first_bits = br_.read(1) ? 8 : 1;
      (*lengths)[br_.read(first_bits)] = 1;
      if (num_symbols == 2) (*lengths)[br_.read(8)] = 1;
    } else {
      int cl[kCodeLengthCodes] = {};
      const int num_codes = int(br_.read(4)) + 4;
      for (int i = 0; i < num_codes; ++i)
        cl[kCodeLengthCodeOrder[i]] = int(br_.read(3));
      ok = read_code_lengths(cl, alphabet_size, lengths);
    }
    if (!ok || br_.eos()) return false;
    PrefixCode scratch;
    return build_code(code ? code : &scratch, lengths->data(), alphabet_size);
  }

  bool read_code_lengths(const int* cl, int num_symbols,
                         std::vector<int>* lengths) {
    PrefixCode code;
    if (!build_code(&code, cl, kCodeLengthCodes)) return false;
    int max_symbol = num_symbols;
    if (br_.read(1)) {
      const int nbits = 2 + 2 * int(br_.read(3));
      max_symbol = 2 + int(br_.read(nbits));
      if (max_symbol > num_symbols) return false;
    }
    int symbol = 0, prev = 8;
    while (symbol < num_symbols) {
      if (max_symbol-- == 0) break;
      br_.fill();
      const int len = read_symbol(code, &br_);
      if (len < 16) {
        (*lengths)[size_t(symbol++)] = len;
        if (len != 0) prev = len;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        int repeat = int(br_.read(kExtra[len - 16])) + kOffset[len - 16];
        if (symbol + repeat > num_symbols) return false;
        const int value = len == 16 ? prev : 0;
        while (repeat-- > 0) (*lengths)[size_t(symbol++)] = value;
      }
    }
    return true;
  }

  int copy_value(int symbol) {  // GetCopyDistance / GetCopyLength
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + int(br_.read(extra)) + 1;
  }

  static int plane_distance(int xsize, int code) {
    if (code > 120) return code - 120;
    const int dist_code = kCodeToPlane[code - 1];
    const int yoffset = dist_code >> 4, xoffset = 8 - (dist_code & 0xf);
    const int dist = yoffset * xsize + xoffset;
    return dist >= 1 ? dist : 1;
  }

  // DecodeImageData: literals, backward references and cache hits; the
  // colour cache is filled at row ends, before a hit and after a copy.
  bool decode_pixels(uint32_t* data, int width, int height,
                     const Metadata& meta) {
    const size_t total = size_t(width) * size_t(height);
    const int cache_bits = meta.cache_bits;
    std::vector<uint32_t> cache(cache_bits ? size_t(1) << cache_bits : 0);
    const int len_limit = kNumLiteralCodes + kNumLengthCodes;
    const int cache_limit = len_limit + int(cache.size());
    const int mask =
        meta.huffman_bits ? (1 << meta.huffman_bits) - 1 : ~0;
    auto group_at = [&](int x, int y) -> const CodeGroup& {
      if (meta.huffman_bits == 0) return meta.groups[0];
      const size_t i = size_t(meta.huffman_xsize) * size_t(y >> meta.huffman_bits) +
                       size_t(x >> meta.huffman_bits);
      return meta.groups[meta.huffman_image[i]];
    };
    auto flush_cache = [&](size_t* last, size_t upto) {
      for (; *last < upto; ++*last)
        cache[(0x1e35a7bdu * data[*last]) >> (32 - cache_bits)] = data[*last];
    };
    size_t src = 0, last_cached = 0;
    int col = 0, row = 0;
    const CodeGroup* group = total ? &group_at(0, 0) : nullptr;
    while (src < total) {
      if ((col & mask) == 0) group = &group_at(col, row);
      br_.fill();
      const int code = read_symbol(group->codes[0], &br_);
      if (br_.at_end()) break;
      bool advance = false;
      if (code < kNumLiteralCodes) {
        const int red = read_symbol(group->codes[1], &br_);
        br_.fill();
        const int blue = read_symbol(group->codes[2], &br_);
        const int alpha = read_symbol(group->codes[3], &br_);
        if (br_.at_end()) break;
        data[src] = (uint32_t(alpha) << 24) | (uint32_t(red) << 16) |
                    (uint32_t(code) << 8) | uint32_t(blue);
        advance = true;
      } else if (code < len_limit) {
        const int length = copy_value(code - kNumLiteralCodes);
        const int dist_symbol = read_symbol(group->codes[4], &br_);
        br_.fill();
        const int dist = plane_distance(width, copy_value(dist_symbol));
        if (br_.at_end()) break;
        if (src < size_t(dist) || total - src < size_t(length)) return false;
        for (int k = 0; k < length; ++k) data[src + k] = data[src + k - dist];
        src += size_t(length);
        col += length;
        while (col >= width) {
          col -= width;
          ++row;
        }
        if (col & mask) group = &group_at(col, row);
        if (cache_bits) flush_cache(&last_cached, src);
      } else if (code < cache_limit) {
        if (cache_bits) flush_cache(&last_cached, src);
        data[src] = cache[size_t(code - len_limit)];
        advance = true;
      } else {
        return false;
      }
      if (advance) {
        ++src;
        if (++col >= width) {
          col = 0;
          ++row;
          if (cache_bits) flush_cache(&last_cached, src);
        }
      }
    }
    return !br_.at_end();
  }

  static void inverse_transform(const Transform& t,
                                std::vector<uint32_t>* px) {
    const int w = t.xsize, h = t.ysize;
    uint32_t* p = px->data();
    switch (t.type) {
      case kPredictor: {
        const int tiles = subsample(w, t.bits);
        for (int y = 0; y < h; ++y) {
          uint32_t* out = p + size_t(y) * size_t(w);
          const uint32_t* top = out - w;
          for (int x = 0; x < w; ++x) {
            int mode;
            if (y == 0) mode = x == 0 ? 0 : 1;
            else if (x == 0) mode = 2;
            else mode = int((t.data[size_t(y >> t.bits) * size_t(tiles) +
                                    size_t(x >> t.bits)] >> 8) & 0xf);
            const uint32_t pred =
                predict(mode, x ? out[x - 1] : 0, y ? top + x : nullptr);
            out[x] = add_pixels(out[x], pred);
          }
        }
        break;
      }
      case kCrossColor: {
        const int tiles = subsample(w, t.bits);
        for (int y = 0; y < h; ++y) {
          uint32_t* out = p + size_t(y) * size_t(w);
          for (int x = 0; x < w; ++x) {
            const uint32_t m = t.data[size_t(y >> t.bits) * size_t(tiles) +
                                      size_t(x >> t.bits)];
            const int8_t g2r = int8_t(m & 0xff), g2b = int8_t((m >> 8) & 0xff),
                         r2b = int8_t((m >> 16) & 0xff);
            const uint32_t argb = out[x];
            const int8_t green = int8_t(argb >> 8);
            int red = int((argb >> 16) & 0xff), blue = int(argb & 0xff);
            red = (red + color_delta(g2r, green)) & 0xff;
            blue += color_delta(g2b, green);
            blue = (blue + color_delta(r2b, int8_t(red))) & 0xff;
            out[x] = (argb & 0xff00ff00u) | (uint32_t(red) << 16) |
                     uint32_t(blue);
          }
        }
        break;
      }
      case kSubtractGreen:
        for (size_t i = 0; i < size_t(w) * size_t(h); ++i) {
          const uint32_t g = (p[i] >> 8) & 0xff;
          const uint32_t rb = ((p[i] & 0x00ff00ffu) + ((g << 16) | g)) &
                              0x00ff00ffu;
          p[i] = (p[i] & 0xff00ff00u) | rb;
        }
        break;
      case kColorIndexing: {
        const int bits_per_pixel = 8 >> t.bits;
        const int count_mask = (1 << t.bits) - 1;
        const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
        const int packed_w = subsample(w, t.bits);
        std::vector<uint32_t> out(size_t(w) * size_t(h));
        for (int y = 0; y < h; ++y) {
          const uint32_t* src = p + size_t(y) * size_t(packed_w);
          uint32_t* dst = out.data() + size_t(y) * size_t(w);
          uint32_t packed = 0;
          for (int x = 0; x < w; ++x) {
            if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
            dst[x] = t.data[packed & bit_mask];
            packed >>= bits_per_pixel;
          }
        }
        px->swap(out);
        break;
      }
    }
  }

  LBitReader br_;
  Transform transforms_[4];
  int num_transforms_ = 0;
  uint32_t seen_ = 0;
};

// ---- VP8: the lossy bitstream (vp8_dec.c, tree_dec.c, frame_dec.c) ---------

// bit_reader_utils.c's VP8BitReader, a byte at a time: range_ holds the
// range less one; past the end one zero byte is shifted in and eof set.
class BoolReader {
 public:
  void init(const uint8_t* start, size_t size) {
    buf_ = start;
    end_ = start + size;
    range_ = 255 - 1;
    value_ = 0;
    bits_ = -8;
    eof_ = false;
    load();
  }
  int get(int prob) {  // VP8GetBit
    uint32_t range = range_;
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = (range * uint32_t(prob)) >> 8;
    const uint32_t value = uint32_t(value_ >> pos);
    int bit;
    if (value > split) {
      range -= split;
      value_ -= uint64_t(split + 1) << pos;
      bit = 1;
    } else {
      range = split + 1;
      bit = 0;
    }
    const int shift = 7 ^ (31 ^ __builtin_clz(range));
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return bit;
  }
  uint32_t value(int bits) {  // VP8GetValue
    uint32_t v = 0;
    while (bits-- > 0) v |= uint32_t(get(0x80)) << bits;
    return v;
  }
  int signed_value(int bits) {  // VP8GetSignedValue
    const int v = int(value(bits));
    return get(0x80) ? -v : v;
  }
  bool eof() const { return eof_; }

 private:
  void load() {  // VP8LoadFinalBytes
    if (buf_ < end_) {
      bits_ += 8;
      value_ = uint64_t(*buf_++) | (value_ << 8);
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;
    }
  }
  const uint8_t* buf_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  uint32_t range_ = 0;
  int bits_ = 0;
  bool eof_ = false;
};

constexpr int kBps = 32;  // the work buffers' stride
constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6,
                                 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6,
                                6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177,
                             153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

// libwebp's mode numbers: 4x4 modes, and the 16x16 / chroma ones among them
enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
enum { DC_PRED = B_DC, TM_PRED = B_TM, V_PRED = B_VE, H_PRED = B_HE,
       DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6 };

uint8_t clip8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }
uint8_t avg3(int a, int b, int c) { return uint8_t((a + 2 * b + c + 2) >> 2); }
uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }

// dec.c's TransformOne, added to the prediction at dst
void idct_add(const int16_t* in, uint8_t* dst) {
  auto mul1 = [](int a) { return ((a * 20091) >> 16) + a; };
  auto mul2 = [](int a) { return (a * 35468) >> 16; };
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a = in[i] + in[8 + i];
    const int b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i];
    const int b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    uint8_t* row = dst + i * kBps;
    row[0] = clip8(row[0] + ((a + d) >> 3));
    row[1] = clip8(row[1] + ((b + c) >> 3));
    row[2] = clip8(row[2] + ((b - c) >> 3));
    row[3] = clip8(row[3] + ((a - d) >> 3));
  }
}

void inverse_wht(const int16_t* in, int16_t* out) {  // TransformWHT
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
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
    out += 64;
  }
}

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - kBps;
  for (int y = 0; y < size; ++y, dst += kBps)
    for (int x = 0; x < size; ++x)
      dst[x] = clip8(top[x] + dst[-1] - top[-1]);
}

void fill_block(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * kBps, v, size_t(size));
}

// 16x16 luma (size 16) and 8x8 chroma (size 8) prediction, dec.c's
// VE16/HE16/DC16*/TM16 and their 8x8 counterparts
void predict_block(int mode, uint8_t* dst, int size) {
  const int shift = size == 16 ? 4 : 3;
  int dc;
  switch (mode) {
    case V_PRED:
      for (int y = 0; y < size; ++y)
        std::memcpy(dst + y * kBps, dst - kBps, size_t(size));
      return;
    case H_PRED:
      for (int y = 0; y < size; ++y)
        std::memset(dst + y * kBps, dst[y * kBps - 1], size_t(size));
      return;
    case TM_PRED:
      true_motion(dst, size);
      return;
    case DC_PRED:
      dc = size;
      for (int j = 0; j < size; ++j) dc += dst[j * kBps - 1] + dst[j - kBps];
      fill_block(dst, size, dc >> (shift + 1));
      return;
    case DC_NOTOP:
      dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j * kBps - 1];
      fill_block(dst, size, dc >> shift);
      return;
    case DC_NOLEFT:
      dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - kBps];
      fill_block(dst, size, dc >> shift);
      return;
    default:
      fill_block(dst, size, 0x80);
  }
}

#define DST(x, y) dst[(x) + (y) * kBps]

void predict4(int mode, uint8_t* dst) {  // dec.c's 4x4 predictors
  const uint8_t* top = dst - kBps;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + kBps], K = dst[-1 + 2 * kBps],
            L = dst[-1 + 3 * kBps];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * kBps];
      fill_block(dst, 4, dc >> 3);
      break;
    }
    case B_TM:
      true_motion(dst, 4);
      break;
    case B_VE: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                            avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * kBps, v, 4);
      break;
    }
    case B_HE:
      std::memset(dst + 0 * kBps, avg3(X, I, J), 4);
      std::memset(dst + 1 * kBps, avg3(I, J, K), 4);
      std::memset(dst + 2 * kBps, avg3(J, K, L), 4);
      std::memset(dst + 3 * kBps, avg3(K, L, L), 4);
      break;
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
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
    case B_VL:
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
    case B_HD:
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
    default:  // B_HU
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) =
          uint8_t(L);
  }
}

#undef DST

// ---- the loop filters (dec.c) -------------------------------------------
int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}
void do_filter4(uint8_t* p, int step) {
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
void do_filter6(uint8_t* p, int step) {
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
bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}
bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}
bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
// SimpleVFilter16 / SimpleHFilter16: `step` across the edge, `stride` along
void simple_filter(uint8_t* p, int step, int stride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += stride)
    if (needs_filter(p, step, t2)) do_filter2(p, step);
}
// FilterLoop26 (macroblock edges) and FilterLoop24 (inner edges)
void filter_loop(uint8_t* p, int step, int stride, int size, int thresh,
                 int ithresh, int hev_t, bool edge) {
  const int t2 = 2 * thresh + 1;
  for (; size-- > 0; p += stride) {
    if (!needs_filter2(p, step, t2, ithresh)) continue;
    if (hev(p, step, hev_t)) do_filter2(p, step);
    else if (edge) do_filter6(p, step);
    else do_filter4(p, step);
  }
}

struct FilterInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};

// The VP8 decoder: a key frame's header, modes and tokens, then the whole
// frame reconstructed (predicted from unfiltered neighbours) and loop
// filtered macroblock by macroblock, as libwebp's row pipeline ends.
class VP8Decoder {
 public:
  // VP8GetHeaders + VP8Decode on `size` bytes at `data` -> the Y, U and V
  // planes of the macroblock-aligned frame (strides mb_w * 16 and * 8).
  void decode(const uint8_t* data, size_t size) {
    if (size < 4) fail("VP8: truncated header");
    const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
    const bool key_frame = !(bits & 1);
    if (((bits >> 1) & 7) > 3) fail("VP8: incorrect keyframe parameters");
    if (!((bits >> 4) & 1)) fail("VP8: frame not displayable");
    const uint32_t partition_length = bits >> 5;
    data += 3;
    size -= 3;
    if (key_frame) {
      if (size < 7) fail("VP8: cannot parse picture header");
      if (data[0] != 0x9d || data[1] != 0x01 || data[2] != 0x2a)
        fail("VP8: bad code word");
      width = ((data[4] << 8) | data[3]) & 0x3fff;
      height = ((data[6] << 8) | data[5]) & 0x3fff;
      data += 7;
      size -= 7;
      mb_w = (width + 15) >> 4;
      mb_h = (height + 15) >> 4;
      std::memcpy(proba_, kCoeffsProba0, sizeof(proba_));
    }
    if (partition_length > size) fail("VP8: bad partition length");
    br_.init(data, partition_length);
    data += partition_length;
    size -= partition_length;
    if (key_frame) {
      br_.get(0x80);  // colour space
      br_.get(0x80);  // clamping type
    }
    parse_segment_header();
    if (br_.eof()) fail("VP8: cannot parse segment header");
    parse_filter_header();
    if (br_.eof()) fail("VP8: cannot parse filter header");
    parse_partitions(data, size);
    parse_quant();
    if (!key_frame) fail("VP8: not a key frame");
    br_.get(0x80);  // update_proba, ignored
    parse_proba();
    decode_frame();
  }

  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  std::vector<uint8_t> y_plane, u_plane, v_plane;

 private:
  void parse_segment_header() {
    use_segment_ = br_.get(0x80);
    if (use_segment_) {
      update_map_ = br_.get(0x80);
      if (br_.get(0x80)) {
        absolute_delta_ = br_.get(0x80);
        for (int s = 0; s < 4; ++s)
          quantizer_[s] = br_.get(0x80) ? br_.signed_value(7) : 0;
        for (int s = 0; s < 4; ++s)
          filter_strength_[s] = br_.get(0x80) ? br_.signed_value(6) : 0;
      }
      if (update_map_)
        for (int s = 0; s < 3; ++s)
          segment_proba_[s] = br_.get(0x80) ? uint8_t(br_.value(8)) : 255;
    } else {
      update_map_ = 0;
    }
  }

  void parse_filter_header() {
    simple_ = br_.get(0x80);
    level_ = int(br_.value(6));
    sharpness_ = int(br_.value(3));
    use_lf_delta_ = br_.get(0x80);
    if (use_lf_delta_ && br_.get(0x80)) {
      for (int i = 0; i < 4; ++i)
        if (br_.get(0x80)) ref_lf_delta_[i] = br_.signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br_.get(0x80)) mode_lf_delta_[i] = br_.signed_value(6);
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
  }

  // ParsePartitions: the last partition runs to the end of the data
  void parse_partitions(const uint8_t* buf, size_t size) {
    const uint8_t* sz = buf;
    const uint8_t* end = buf + size;
    num_parts_ = 1 << br_.value(2);
    const size_t last = size_t(num_parts_ - 1);
    if (size < 3 * last) fail("VP8: cannot parse partitions");
    const uint8_t* start = buf + last * 3;
    size_t left = size - last * 3;
    for (size_t p = 0; p < last; ++p, sz += 3) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > left) psize = left;
      parts_[p].init(start, psize);
      start += psize;
      left -= psize;
    }
    parts_[last].init(start, left);
    if (!(start < end)) fail("VP8: cannot parse partitions");
  }

  void parse_quant() {  // VP8ParseQuant
    const int base_q0 = int(br_.value(7));
    auto delta = [&]() { return br_.get(0x80) ? br_.signed_value(4) : 0; };
    const int dqy1_dc = delta(), dqy2_dc = delta(), dqy2_ac = delta();
    const int dquv_dc = delta(), dquv_ac = delta();
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment_) {
        q = quantizer_[i];
        if (!absolute_delta_) q += base_q0;
      } else if (i > 0) {
        dqm_[i] = dqm_[0];
        continue;
      } else {
        q = base_q0;
      }
      QuantMatrix& m = dqm_[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }

  void parse_proba() {  // VP8ParseProba
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            proba_[t][b][c][p] = br_.get(kCoeffsUpdateProba[t][b][c][p])
                                     ? uint8_t(br_.value(8))
                                     : kCoeffsProba0[t][b][c][p];
    use_skip_proba_ = br_.get(0x80);
    if (use_skip_proba_) skip_p_ = int(br_.value(8));
  }

  struct MB {  // one macroblock's modes and residuals
    uint8_t segment = 0, is_i4x4 = 0, uvmode = 0, skip = 0;
    uint8_t imodes[16] = {};
    int16_t coeffs[384];
    uint32_t nz_y = 0, nz_uv = 0;
  };

  void parse_intra_mode(MB* mb, uint8_t* top, uint8_t* left) {
    if (update_map_) {
      mb->segment = !br_.get(segment_proba_[0])
                        ? uint8_t(br_.get(segment_proba_[1]))
                        : uint8_t(br_.get(segment_proba_[2]) + 2);
    } else {
      mb->segment = 0;
    }
    if (use_skip_proba_) mb->skip = uint8_t(br_.get(skip_p_));
    mb->is_i4x4 = !br_.get(145);
    if (!mb->is_i4x4) {
      const int ymode = br_.get(156) ? (br_.get(128) ? TM_PRED : H_PRED)
                                     : (br_.get(163) ? V_PRED : DC_PRED);
      mb->imodes[0] = uint8_t(ymode);
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = mb->imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* p = kBModesProba[top[x]][ymode];
          ymode = !br_.get(p[0])   ? B_DC
                  : !br_.get(p[1]) ? B_TM
                  : !br_.get(p[2]) ? B_VE
                  : !br_.get(p[3])
                      ? (!br_.get(p[4]) ? B_HE
                                        : (!br_.get(p[5]) ? B_RD : B_VR))
                      : (!br_.get(p[6])
                             ? B_LD
                             : (!br_.get(p[7])
                                    ? B_VL
                                    : (!br_.get(p[8]) ? B_HD : B_HU)));
          top[x] = uint8_t(ymode);
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = uint8_t(ymode);
      }
    }
    mb->uvmode = !br_.get(142)   ? DC_PRED
                 : !br_.get(114) ? V_PRED
                 : br_.get(183)  ? TM_PRED
                                 : H_PRED;
  }

  int large_value(BoolReader* br, const uint8_t* p) {  // GetLargeValue
    int v;
    if (!br->get(p[3])) {
      v = !br->get(p[4]) ? 2 : 3 + br->get(p[5]);
    } else if (!br->get(p[6])) {
      if (!br->get(p[7])) {
        v = 5 + br->get(159);
      } else {
        v = 7 + 2 * br->get(165);
        v += br->get(145);
      }
    } else {
      const int bit1 = br->get(p[8]);
      const int bit0 = br->get(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
        v += v + br->get(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // GetCoeffs: tokens from position n -> dequantised coefficients in
  // raster order; returns the position after the last token read
  int get_coeffs(BoolReader* br, int type, int ctx, const int* dq, int n,
                 int16_t* out) {
    const uint8_t* p = proba_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br->get(p[0])) return n;
      while (!br->get(p[1])) {
        p = proba_[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      if (!br->get(p[2])) {
        v = 1;
        p = proba_[type][kBands[n + 1]][1];
      } else {
        v = large_value(br, p);
        p = proba_[type][kBands[n + 1]][2];
      }
      const int s = br->get(0x80) ? -v : v;
      out[kZigzag[n]] = int16_t(s * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : uint32_t(dc_nz);
    return nz_coeffs;
  }

  // ParseResiduals; returns whether every coefficient is zero
  bool parse_residuals(MB* block, uint8_t* mb_nz, uint8_t* mb_nz_dc,
                       BoolReader* br) {
    const QuantMatrix& q = dqm_[block->segment];
    int16_t* dst = block->coeffs;
    std::memset(dst, 0, sizeof(block->coeffs));
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    int first, ac_type;
    if (!block->is_i4x4) {
      int16_t dc[16] = {};
      const int ctx = *mb_nz_dc + left_nz_dc_;
      const int nz = get_coeffs(br, 1, ctx, q.y2, 0, dc);
      *mb_nz_dc = left_nz_dc_ = uint8_t(nz > 0);
      if (nz > 1) {
        inverse_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 16 * 16; i += 16) dst[i] = int16_t(dc0);
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint32_t tnz = *mb_nz & 0x0f, lnz = left_nz_ & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + int(tnz & 1);
        const int nz = get_coeffs(br, ac_type, ctx, q.y1, first, dst);
        l = nz > first;
        tnz = (tnz >> 1) | (uint32_t(l) << 7);
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = (lnz >> 1) | (uint32_t(l) << 7);
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = uint32_t(*mb_nz) >> (4 + ch);
      lnz = uint32_t(left_nz_) >> (4 + ch);
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + int(tnz & 1);
          const int nz = get_coeffs(br, 2, ctx, q.uv, 0, dst);
          l = nz > 0;
          tnz = (tnz >> 1) | (uint32_t(l) << 3);
          nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = (lnz >> 1) | (uint32_t(l) << 5);
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= (tnz << 4) << ch;
      out_l_nz |= (lnz & 0xf0) << ch;
    }
    *mb_nz = uint8_t(out_t_nz);
    left_nz_ = uint8_t(out_l_nz);
    block->nz_y = non_zero_y;
    block->nz_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }

  // PrecomputeFilterStrengths for one segment and block kind
  FilterInfo filter_strength(int segment, int i4x4) const {
    FilterInfo info;
    int level = level_;
    if (use_segment_) {
      level = filter_strength_[segment];
      if (!absolute_delta_) level += level_;
    }
    if (use_lf_delta_) {
      level += ref_lf_delta_[0];
      if (i4x4) level += mode_lf_delta_[0];
    }
    level = level < 0 ? 0 : level > 63 ? 63 : level;
    if (level > 0) {
      int ilevel = level;
      if (sharpness_ > 0) {
        ilevel >>= sharpness_ > 4 ? 2 : 1;
        if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
      }
      if (ilevel < 1) ilevel = 1;
      info.ilevel = uint8_t(ilevel);
      info.limit = uint8_t(2 * level + ilevel);
      info.hev_thresh = uint8_t(level >= 40 ? 2 : level >= 15 ? 1 : 0);
    }
    info.inner = uint8_t(i4x4);
    return info;
  }

  void decode_frame() {
    const size_t ys = size_t(mb_w) * 16, us = size_t(mb_w) * 8;
    y_plane.assign(ys * size_t(mb_h) * 16, 0);
    u_plane.assign(us * size_t(mb_h) * 8, 0);
    v_plane.assign(us * size_t(mb_h) * 8, 0);
    std::vector<FilterInfo> finfo(size_t(mb_w) * size_t(mb_h));
    std::vector<uint8_t> top_nz(size_t(mb_w), 0), top_nz_dc(size_t(mb_w), 0);
    std::vector<uint8_t> intra_t(size_t(mb_w) * 4, B_DC);
    std::vector<MB> row(static_cast<size_t>(mb_w));
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      BoolReader* token_br = &parts_[mb_y & (num_parts_ - 1)];
      uint8_t intra_l[4];
      std::memset(intra_l, B_DC, 4);
      for (int mb_x = 0; mb_x < mb_w; ++mb_x)
        parse_intra_mode(&row[size_t(mb_x)], &intra_t[size_t(mb_x) * 4],
                         intra_l);
      if (br_.eof()) fail("VP8: premature end of partition 0");
      left_nz_ = left_nz_dc_ = 0;
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        MB* block = &row[size_t(mb_x)];
        int skip = use_skip_proba_ ? block->skip : 0;
        if (!skip) {
          skip = parse_residuals(block, &top_nz[size_t(mb_x)],
                                 &top_nz_dc[size_t(mb_x)], token_br);
        } else {
          left_nz_ = top_nz[size_t(mb_x)] = 0;
          if (!block->is_i4x4) left_nz_dc_ = top_nz_dc[size_t(mb_x)] = 0;
          block->nz_y = block->nz_uv = 0;
          std::memset(block->coeffs, 0, sizeof(block->coeffs));
        }
        if (filter_type_ > 0) {
          FilterInfo f = filter_strength(block->segment, block->is_i4x4);
          f.inner |= uint8_t(!skip);
          finfo[size_t(mb_y) * size_t(mb_w) + size_t(mb_x)] = f;
        }
        if (token_br->eof()) fail("VP8: premature end of file");
        reconstruct(*block, mb_x, mb_y);
      }
    }
    if (filter_type_ > 0)
      for (int mb_y = 0; mb_y < mb_h; ++mb_y)
        for (int mb_x = 0; mb_x < mb_w; ++mb_x)
          filter_mb(finfo[size_t(mb_y) * size_t(mb_w) + size_t(mb_x)], mb_x,
                    mb_y);
  }

  // ReconstructRow for one macroblock: borders (127 above the frame, 129
  // left of it), prediction and residuals in a work buffer, then into the
  // (unfiltered) planes
  void reconstruct(const MB& block, int mb_x, int mb_y) {
    const size_t ys = size_t(mb_w) * 16, us = size_t(mb_w) * 8;
    uint8_t yw[17 * kBps], uw[9 * kBps], vw[9 * kBps];
    uint8_t* y_dst = yw + kBps + 8;
    uint8_t* u_dst = uw + kBps + 8;
    uint8_t* v_dst = vw + kBps + 8;
    uint8_t* ypl = y_plane.data() + size_t(mb_y) * 16 * ys + size_t(mb_x) * 16;
    uint8_t* upl = u_plane.data() + size_t(mb_y) * 8 * us + size_t(mb_x) * 8;
    uint8_t* vpl = v_plane.data() + size_t(mb_y) * 8 * us + size_t(mb_x) * 8;
    if (mb_y == 0) {
      std::memset(y_dst - kBps - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - kBps - 1, 127, 8 + 1);
      std::memset(v_dst - kBps - 1, 127, 8 + 1);
    } else {
      y_dst[-kBps - 1] = mb_x == 0 ? 129 : ypl[-std::ptrdiff_t(ys) - 1];
      u_dst[-kBps - 1] = mb_x == 0 ? 129 : upl[-std::ptrdiff_t(us) - 1];
      v_dst[-kBps - 1] = mb_x == 0 ? 129 : vpl[-std::ptrdiff_t(us) - 1];
      std::memcpy(y_dst - kBps, ypl - ys, 16);
      std::memcpy(u_dst - kBps, upl - us, 8);
      std::memcpy(v_dst - kBps, vpl - us, 8);
      if (mb_x >= mb_w - 1)
        std::memset(y_dst - kBps + 16, ypl[-std::ptrdiff_t(ys) + 15], 4);
      else
        std::memcpy(y_dst - kBps + 16, ypl - ys + 16, 4);
    }
    for (int j = 0; j < 16; ++j)
      y_dst[j * kBps - 1] = mb_x == 0 ? 129 : ypl[size_t(j) * ys - 1];
    for (int j = 0; j < 8; ++j) {
      u_dst[j * kBps - 1] = mb_x == 0 ? 129 : upl[size_t(j) * us - 1];
      v_dst[j * kBps - 1] = mb_x == 0 ? 129 : vpl[size_t(j) * us - 1];
    }
    auto check_mode = [&](int mode) {
      if (mode != B_DC) return mode;
      if (mb_x == 0) return mb_y == 0 ? int(DC_NOTOPLEFT) : int(DC_NOLEFT);
      return mb_y == 0 ? int(DC_NOTOP) : int(DC_PRED);
    };
    const int16_t* coeffs = block.coeffs;
    if (block.is_i4x4) {
      uint8_t* top_right = y_dst - kBps + 16;
      for (int r = 1; r <= 3; ++r)
        std::memcpy(top_right + 4 * r * kBps, top_right, 4);
      for (int n = 0; n < 16; ++n) {
        uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * kBps;
        predict4(block.imodes[n], dst);
        idct_add(coeffs + n * 16, dst);
      }
    } else {
      predict_block(check_mode(block.imodes[0]), y_dst, 16);
      for (int n = 0; n < 16; ++n)
        idct_add(coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * kBps);
    }
    const int uvmode = check_mode(block.uvmode);
    predict_block(uvmode, u_dst, 8);
    predict_block(uvmode, v_dst, 8);
    for (int n = 0; n < 4; ++n) {
      const int off = (n & 1) * 4 + (n >> 1) * 4 * kBps;
      idct_add(coeffs + 256 + n * 16, u_dst + off);
      idct_add(coeffs + 320 + n * 16, v_dst + off);
    }
    for (int j = 0; j < 16; ++j)
      std::memcpy(ypl + size_t(j) * ys, y_dst + j * kBps, 16);
    for (int j = 0; j < 8; ++j) {
      std::memcpy(upl + size_t(j) * us, u_dst + j * kBps, 8);
      std::memcpy(vpl + size_t(j) * us, v_dst + j * kBps, 8);
    }
  }

  void filter_mb(const FilterInfo& f, int mb_x, int mb_y) {  // DoFilter
    const int limit = f.limit;
    if (limit == 0) return;
    const int ys = mb_w * 16, us = mb_w * 8;
    uint8_t* y = y_plane.data() + size_t(mb_y) * 16 * size_t(ys) +
                 size_t(mb_x) * 16;
    if (filter_type_ == 1) {
      if (mb_x > 0) simple_filter(y, 1, ys, limit + 4);
      if (f.inner)
        for (int k = 4; k < 16; k += 4) simple_filter(y + k, 1, ys, limit);
      if (mb_y > 0) simple_filter(y, ys, 1, limit + 4);
      if (f.inner)
        for (int k = 4; k < 16; k += 4)
          simple_filter(y + k * ys, ys, 1, limit);
      return;
    }
    const size_t uoff = size_t(mb_y) * 8 * size_t(us) + size_t(mb_x) * 8;
    uint8_t* u = u_plane.data() + uoff;
    uint8_t* v = v_plane.data() + uoff;
    const int il = f.ilevel, hev_t = f.hev_thresh;
    if (mb_x > 0) {
      filter_loop(y, 1, ys, 16, limit + 4, il, hev_t, true);
      filter_loop(u, 1, us, 8, limit + 4, il, hev_t, true);
      filter_loop(v, 1, us, 8, limit + 4, il, hev_t, true);
    }
    if (f.inner) {
      for (int k = 4; k < 16; k += 4)
        filter_loop(y + k, 1, ys, 16, limit, il, hev_t, false);
      filter_loop(u + 4, 1, us, 8, limit, il, hev_t, false);
      filter_loop(v + 4, 1, us, 8, limit, il, hev_t, false);
    }
    if (mb_y > 0) {
      filter_loop(y, ys, 1, 16, limit + 4, il, hev_t, true);
      filter_loop(u, us, 1, 8, limit + 4, il, hev_t, true);
      filter_loop(v, us, 1, 8, limit + 4, il, hev_t, true);
    }
    if (f.inner) {
      for (int k = 4; k < 16; k += 4)
        filter_loop(y + k * ys, ys, 1, 16, limit, il, hev_t, false);
      filter_loop(u + 4 * us, us, 1, 8, limit, il, hev_t, false);
      filter_loop(v + 4 * us, us, 1, 8, limit, il, hev_t, false);
    }
  }

  BoolReader br_, parts_[8];
  int num_parts_ = 1;
  uint8_t proba_[4][8][3][11];
  int use_segment_ = 0, update_map_ = 0, absolute_delta_ = 1;
  int quantizer_[4] = {}, filter_strength_[4] = {};
  uint8_t segment_proba_[3] = {255, 255, 255};
  int simple_ = 0, level_ = 0, sharpness_ = 0, use_lf_delta_ = 0;
  int ref_lf_delta_[4] = {}, mode_lf_delta_[4] = {};
  int filter_type_ = 0;
  QuantMatrix dqm_[4] = {};
  int use_skip_proba_ = 0, skip_p_ = 0;
  uint8_t left_nz_ = 0, left_nz_dc_ = 0;
};

// ---- container (webp_dec.c) -------------------------------------------------

struct Features {
  int width = 0, height = 0, has_alpha = 0, has_animation = 0;
};

struct Headers {
  bool have_all_data = false;
  size_t offset = 0;  // of the VP8 / VP8L data
  const uint8_t* alpha = nullptr;
  size_t alpha_size = 0;
  bool lossless = false;
};

int parse_optional_chunks(const uint8_t** data, size_t* size,
                          size_t riff_size, const uint8_t** alpha,
                          size_t* alpha_size) {
  const uint8_t* buf = *data;
  size_t n = *size;
  uint32_t total = uint32_t(kTagSize + kChunkHeaderSize + kVp8xChunkSize);
  *alpha = nullptr;
  *alpha_size = 0;
  while (true) {
    *data = buf;
    *size = n;
    if (n < kChunkHeaderSize) return kNotEnoughData;
    const uint32_t chunk_size = le32(buf + kTagSize);
    if (chunk_size > kMaxChunkPayload) return kBitstreamError;
    const uint32_t disk_size =
        (uint32_t(kChunkHeaderSize) + chunk_size + 1) & ~1u;
    total += disk_size;
    if (riff_size > 0 && total > riff_size) return kBitstreamError;
    if (tag_is(buf, "VP8 ") || tag_is(buf, "VP8L")) return kOk;
    if (n < disk_size) return kNotEnoughData;
    if (tag_is(buf, "ALPH")) {
      *alpha = buf + kChunkHeaderSize;
      *alpha_size = chunk_size;
    }
    buf += disk_size;
    n -= disk_size;
  }
}

int parse_vp8_header(const uint8_t** data, size_t* size, bool have_all_data,
                     size_t riff_size, size_t* chunk_size, bool* lossless) {
  const uint8_t* p = *data;
  const bool is_vp8 = tag_is(p, "VP8 "), is_vp8l = tag_is(p, "VP8L");
  const size_t minimal = kTagSize + kChunkHeaderSize;
  if (*size < kChunkHeaderSize) return kNotEnoughData;
  if (is_vp8 || is_vp8l) {
    const uint32_t n = le32(p + kTagSize);
    if (riff_size >= minimal && n > riff_size - minimal)
      return kBitstreamError;
    if (have_all_data && n > *size - kChunkHeaderSize) return kNotEnoughData;
    *chunk_size = n;
    *data += kChunkHeaderSize;
    *size -= kChunkHeaderSize;
    *lossless = is_vp8l;
  } else {  // a raw bitstream
    *lossless = *size >= kVp8lFrameHeaderSize && p[0] == 0x2f &&
                (p[4] >> 5) == 0;
    *chunk_size = *size;
  }
  return kOk;
}

bool vp8_get_info(const uint8_t* data, size_t size, size_t chunk_size,
                  int* w, int* h) {
  if (size < kVp8FrameHeaderSize) return false;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return false;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  const int width = int(le16(data + 6) & 0x3fff);
  const int height = int(le16(data + 8) & 0x3fff);
  if (bits & 1) return false;                 // not a key frame
  if (((bits >> 1) & 7) > 3) return false;    // unknown profile
  if (!((bits >> 4) & 1)) return false;       // not shown
  if ((bits >> 5) >= chunk_size) return false;  // partition 0 too long
  if (width == 0 || height == 0) return false;
  *w = width;
  *h = height;
  return true;
}

bool vp8l_get_info(const uint8_t* data, size_t size, int* w, int* h,
                   int* has_alpha) {
  if (size < kVp8lFrameHeaderSize || data[0] != 0x2f || (data[4] >> 5) != 0)
    return false;
  LBitReader br;
  br.init(data, size);
  if (br.read(8) != 0x2f) return false;
  const int width = int(br.read(14)) + 1, height = int(br.read(14)) + 1;
  const int alpha = int(br.read(1));
  if (br.read(3) != 0 || br.eos()) return false;
  *w = width;
  *h = height;
  *has_alpha = alpha;
  return true;
}

// ParseHeadersInternal: GetFeatures when `hdrs` is null, the decoder's
// header parse (with all the data) otherwise
int parse_headers(const uint8_t* data, size_t size, Features* f,
                  Headers* hdrs) {
  if (size < kRiffHeaderSize) return kNotEnoughData;
  const bool have_all = hdrs != nullptr && hdrs->have_all_data;
  const uint8_t* p = data;
  size_t n = size;
  size_t riff_size = 0;
  if (tag_is(p, "RIFF")) {  // ParseRIFF
    if (!tag_is(p + 8, "WEBP")) return kBitstreamError;
    const uint32_t rs = le32(p + kTagSize);
    if (rs < kTagSize + kChunkHeaderSize || rs > kMaxChunkPayload)
      return kBitstreamError;
    if (have_all && rs > n - kChunkHeaderSize) return kNotEnoughData;
    riff_size = rs;
    p += kRiffHeaderSize;
    n -= kRiffHeaderSize;
  }
  const bool found_riff = riff_size > 0;
  bool found_vp8x = false;
  uint32_t flags = 0;
  int canvas_w = 0, canvas_h = 0;
  if (n < kChunkHeaderSize) return kNotEnoughData;  // ParseVP8X
  if (tag_is(p, "VP8X")) {
    if (le32(p + kTagSize) != kVp8xChunkSize) return kBitstreamError;
    if (n < kChunkHeaderSize + kVp8xChunkSize) return kNotEnoughData;
    flags = le32(p + 8);
    const int w = 1 + int(le24(p + 12)), h = 1 + int(le24(p + 15));
    if (uint64_t(w) * uint64_t(h) >= kMaxImageArea) return kBitstreamError;
    canvas_w = w;
    canvas_h = h;
    p += kChunkHeaderSize + kVp8xChunkSize;
    n -= kChunkHeaderSize + kVp8xChunkSize;
    found_vp8x = true;
  }
  if (!found_riff && found_vp8x) return kBitstreamError;
  const bool animation = flags & kAnimationFlag;
  int has_alpha = (flags & kAlphaFlag) ? 1 : 0;
  int image_w = canvas_w, image_h = canvas_h;
  Headers h;
  int status = kOk;
  auto finish = [&]() {
    if (status == kOk ||
        (status == kNotEnoughData && found_vp8x && hdrs == nullptr)) {
      f->width = image_w;
      f->height = image_h;
      f->has_alpha = has_alpha | (h.alpha != nullptr);
      f->has_animation = animation;
      return int(kOk);
    }
    return status;
  };
  if (found_vp8x && animation && hdrs == nullptr) return finish();
  if (n < kTagSize) {
    status = kNotEnoughData;
    return finish();
  }
  if ((found_riff && found_vp8x) ||
      (!found_riff && !found_vp8x && tag_is(p, "ALPH"))) {
    status = parse_optional_chunks(&p, &n, riff_size, &h.alpha,
                                   &h.alpha_size);
    if (status != kOk) return finish();
  }
  size_t compressed_size = 0;
  status = parse_vp8_header(&p, &n, have_all, riff_size, &compressed_size,
                            &h.lossless);
  if (status != kOk) return finish();
  if (compressed_size > kMaxChunkPayload) return kBitstreamError;
  if (!h.lossless) {
    if (n < kVp8FrameHeaderSize) {
      status = kNotEnoughData;
      return finish();
    }
    if (!vp8_get_info(p, n, compressed_size, &image_w, &image_h))
      return kBitstreamError;
  } else {
    if (n < kVp8lFrameHeaderSize) {
      status = kNotEnoughData;
      return finish();
    }
    if (!vp8l_get_info(p, n, &image_w, &image_h, &has_alpha))
      return kBitstreamError;
  }
  if (found_vp8x && (canvas_w != image_w || canvas_h != image_h))
    return kBitstreamError;
  if (hdrs != nullptr) {
    h.have_all_data = hdrs->have_all_data;
    h.offset = size_t(p - data);
    *hdrs = h;
  }
  return finish();
}

// ---- output (yuv.h, upsampling.c) -------------------------------------------

int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
uint8_t yuv_clip8(int v) {
  return (v & ~16383) == 0 ? uint8_t(v >> 6) : v < 0 ? 0 : 255;
}

// The fancy upsampler: each output pixel's chroma is (9 a + 3 b + 3 c + d +
// 8) >> 4 of the nearest chroma sample a, its neighbours b (across) and c
// (along the other axis) toward the pixel, and d diagonally, the last row
// and column repeated; then VP8YuvToBgr. Writes (h, w, 4), alpha 255.
void yuv_to_bgra(const VP8Decoder& d, uint8_t* out) {
  const int w = d.width, h = d.height;
  const size_t ys = size_t(d.mb_w) * 16, us = size_t(d.mb_w) * 8;
  const int uw = (w + 1) / 2, uh = (h + 1) / 2;
  for (int y = 0; y < h; ++y) {
    const int ny = y >> 1;
    int fy = (y & 1) ? ny + 1 : ny - 1;
    fy = fy < 0 ? 0 : fy >= uh ? uh - 1 : fy;
    const uint8_t* yrow = d.y_plane.data() + size_t(y) * ys;
    const size_t n_off = size_t(ny) * us, f_off = size_t(fy) * us;
    uint8_t* dst = out + size_t(y) * size_t(w) * 4;
    for (int x = 0; x < w; ++x, dst += 4) {
      const int nx = x >> 1;
      int fx = (x & 1) ? nx + 1 : nx - 1;
      fx = fx < 0 ? 0 : fx >= uw ? uw - 1 : fx;
      auto blend = [&](const std::vector<uint8_t>& p) {
        return (9 * p[n_off + size_t(nx)] + 3 * p[n_off + size_t(fx)] +
                3 * p[f_off + size_t(nx)] + p[f_off + size_t(fx)] + 8) >> 4;
      };
      const int u = blend(d.u_plane), v = blend(d.v_plane);
      const int yy = mult_hi(yrow[x], 19077);
      dst[0] = yuv_clip8(yy + mult_hi(u, 33050) - 17685);
      dst[1] = yuv_clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
      dst[2] = yuv_clip8(yy + mult_hi(v, 26149) - 14234);
      dst[3] = 255;
    }
  }
}

// ---- alpha (alpha_dec.c, filters.c) ----------------------------------------

void unfilter(int filter, const uint8_t* prev, uint8_t* row, int width) {
  if (filter == 0) return;
  if (prev == nullptr || filter == 1) {  // horizontal (the first row always)
    uint8_t pred = prev == nullptr ? 0 : prev[0];
    for (int i = 0; i < width; ++i) pred = row[i] = uint8_t(pred + row[i]);
  } else if (filter == 2) {  // vertical
    for (int i = 0; i < width; ++i) row[i] = uint8_t(prev[i] + row[i]);
  } else {  // gradient
    int top = prev[0], top_left = top, left = top;
    for (int i = 0; i < width; ++i) {
      top = prev[i];
      const int g = left + top - top_left;
      left = uint8_t(row[i] + (g < 0 ? 0 : g > 255 ? 255 : g));
      top_left = top;
      row[i] = uint8_t(left);
    }
  }
}

// ALPHInit + ALPHDecode: the ALPH payload -> (h, w) alpha
bool decode_alpha(const uint8_t* data, size_t size, int w, int h,
                  uint8_t* out) {
  if (size <= 1) return false;
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3;
  const int pre_processing = (data[0] >> 4) & 3, rsrv = (data[0] >> 6) & 3;
  if (method > 1 || pre_processing > 1 || rsrv != 0) return false;
  const size_t n = size_t(w) * size_t(h);
  if (method == 0) {
    if (size - 1 < n) return false;
    std::memcpy(out, data + 1, n);
  } else {
    VP8LDecoder dec;
    if (!dec.decode_alpha(data + 1, size - 1, w, h, out)) return false;
  }
  for (int y = 0; y < h; ++y)
    unfilter(filter, y ? out + size_t(y - 1) * size_t(w) : nullptr,
             out + size_t(y) * size_t(w), w);
  return true;
}

// DecodeInto (WebPDecodeBGRAInto): a still image -> (h, w, 4) BGRA
std::vector<uint8_t> decode_still(const uint8_t* data, size_t size, int* w,
                                  int* h) {
  Features f;
  Headers hd;
  hd.have_all_data = true;
  if (parse_headers(data, size, &f, &hd) != kOk)
    fail("WebP: invalid or truncated headers");
  if (f.has_animation) fail("WebP: an animation");
  const uint8_t* p = data + hd.offset;
  const size_t n = size - hd.offset;
  std::vector<uint8_t> out;
  if (!hd.lossless) {
    VP8Decoder dec;
    dec.decode(p, n);
    *w = dec.width;
    *h = dec.height;
    out.resize(size_t(*w) * size_t(*h) * 4);
    yuv_to_bgra(dec, out.data());
    if (hd.alpha != nullptr) {
      std::vector<uint8_t> alpha(size_t(*w) * size_t(*h));
      if (!decode_alpha(hd.alpha, hd.alpha_size, *w, *h, alpha.data()))
        fail("WebP: could not decode alpha data");
      for (size_t i = 0; i < alpha.size(); ++i) out[i * 4 + 3] = alpha[i];
    }
  } else {
    VP8LDecoder dec;
    std::vector<uint32_t> argb;
    if (!dec.decode(p, n, w, h, &argb)) fail("WebP: VP8L bitstream error");
    out.resize(argb.size() * 4);
    for (size_t i = 0; i < argb.size(); ++i) {
      out[i * 4 + 0] = uint8_t(argb[i]);
      out[i * 4 + 1] = uint8_t(argb[i] >> 8);
      out[i * 4 + 2] = uint8_t(argb[i] >> 16);
      out[i * 4 + 3] = uint8_t(argb[i] >> 24);
    }
  }
  return out;
}

// ---- demux (demux.c) and the first frame of an animation (anim_decode.c) ----

struct DemuxFrame {
  int x = 0, y = 0, w = 0, h = 0, num = 0;
  bool complete = false;
  size_t img_off = 0, img_size = 0, alpha_off = 0, alpha_size = 0;
};

// WebPDemux on a whole file (no partial data): the frames of a VP8X file
// and the EXIF chunks it stores; parse() is false where WebPDemux gives
// NULL.
class Demuxer {
 public:
  bool parse(const uint8_t* data, size_t size) {
    buf_ = data;
    if (size < kRiffHeaderSize + kChunkHeaderSize) return false;
    if (!tag_is(data, "RIFF") || !tag_is(data + 8, "WEBP")) return false;
    const uint32_t riff_size = le32(data + 4);
    if (riff_size < kChunkHeaderSize || riff_size > kMaxChunkPayload)
      return false;
    riff_end_ = size_t(riff_size) + kChunkHeaderSize;
    end_ = size < riff_end_ ? size : riff_end_;
    if (end_ < riff_end_) return false;  // partial data
    start_ = kRiffHeaderSize;
    if (!tag_is(buf_ + start_, "VP8X")) return false;  // stills: no EXIF
    if (parse_vp8x() != kParseOk) return false;
    return valid();
  }

  uint32_t flags = 0;
  int canvas_w = 0, canvas_h = 0;
  std::vector<DemuxFrame> frames;
  std::vector<std::pair<size_t, size_t>> exif;  // payload offset, size

 private:
  enum { kParseOk, kParseNeedMore, kParseError };
  size_t avail() const { return end_ - start_; }
  bool size_invalid(size_t s) const { return s > riff_end_ - start_; }
  uint32_t read32() {
    const uint32_t v = le32(buf_ + start_);
    start_ += 4;
    return v;
  }
  int read24() {
    const int v = int(le24(buf_ + start_));
    start_ += 3;
    return v;
  }

  int parse_vp8x() {
    if (avail() < kChunkHeaderSize) return kParseNeedMore;
    start_ += kTagSize;
    uint32_t vp8x_size = read32();
    if (vp8x_size > kMaxChunkPayload || vp8x_size < kVp8xChunkSize)
      return kParseError;
    vp8x_size += vp8x_size & 1;
    if (size_invalid(vp8x_size)) return kParseError;
    if (avail() < vp8x_size) return kParseNeedMore;
    flags = buf_[start_];
    start_ += 4;
    canvas_w = 1 + read24();
    canvas_h = 1 + read24();
    if (uint64_t(canvas_w) * uint64_t(canvas_h) >= kMaxImageArea)
      return kParseError;
    start_ += vp8x_size - kVp8xChunkSize;
    parsed_header_ = true;
    if (size_invalid(kChunkHeaderSize)) return kParseError;
    if (avail() < kChunkHeaderSize) return kParseNeedMore;
    const int status = parse_chunks();
    if (status == kParseOk) done_ = true;
    return status;
  }

  int parse_chunks() {  // ParseVP8XChunks
    const bool is_animation = flags & kAnimationFlag;
    int anim_chunks = 0;
    int status = kParseOk;
    do {
      const size_t chunk_start = start_;
      const uint8_t* tag = buf_ + start_;
      start_ += kTagSize;
      const uint32_t chunk_size = read32();
      if (chunk_size > kMaxChunkPayload) return kParseError;
      const uint32_t padded = chunk_size + (chunk_size & 1);
      if (size_invalid(padded)) return kParseError;
      bool store = true, skip = false;
      if (tag_is(tag, "VP8X")) {
        return kParseError;
      } else if (tag_is(tag, "ALPH") || tag_is(tag, "VP8 ") ||
                 tag_is(tag, "VP8L")) {
        if (anim_chunks > 0 || is_animation) return kParseError;
        start_ = chunk_start;
        status = parse_single_image();
      } else if (tag_is(tag, "ANIM")) {
        if (padded < kAnimChunkSize) return kParseError;
        if (avail() < padded) {
          status = kParseNeedMore;
        } else if (anim_chunks == 0) {
          ++anim_chunks;
          start_ += padded;  // background colour and loop count
        } else {
          store = false;
          skip = true;
        }
      } else if (tag_is(tag, "ANMF")) {
        if (anim_chunks == 0) return kParseError;
        status = parse_frame(padded);
      } else {
        if (tag_is(tag, "ICCP")) store = flags & kIccpFlag;
        else if (tag_is(tag, "EXIF")) store = flags & kExifFlag;
        else if (tag_is(tag, "XMP ")) store = flags & kXmpFlag;
        skip = true;
      }
      if (skip) {
        if (padded <= avail()) {
          if (store && tag_is(tag, "EXIF"))
            exif.emplace_back(chunk_start + kChunkHeaderSize, chunk_size);
          start_ += padded;
        } else {
          status = kParseNeedMore;
        }
      }
      if (start_ == riff_end_) break;
      if (avail() < kChunkHeaderSize) status = kParseNeedMore;
    } while (status == kParseOk);
    return status;
  }

  int parse_single_image() {
    if (!frames.empty()) return kParseError;
    if (size_invalid(kChunkHeaderSize)) return kParseError;
    if (avail() < kChunkHeaderSize) return kParseNeedMore;
    DemuxFrame frame;
    const int status = store_frame(1, 0, &frame);
    if (status != kParseError) {
      if (!(flags & kAlphaFlag) && frame.alpha_size > 0)
        frame.alpha_off = frame.alpha_size = 0;
      if (!add_frame(frame)) return kParseError;
    }
    return status;
  }

  int parse_frame(uint32_t frame_chunk_size) {  // ParseAnimationFrame
    const bool is_animation = flags & kAnimationFlag;
    if (size_invalid(kAnmfChunkSize)) return kParseError;
    if (frame_chunk_size < kAnmfChunkSize) return kParseError;
    if (avail() < kAnmfChunkSize) return kParseNeedMore;
    const uint32_t payload = frame_chunk_size - uint32_t(kAnmfChunkSize);
    DemuxFrame frame;
    frame.x = 2 * read24();
    frame.y = 2 * read24();
    frame.w = 1 + read24();
    frame.h = 1 + read24();
    start_ += 4;  // duration, blend and dispose bits
    if (uint64_t(frame.w) * uint64_t(frame.h) >= kMaxImageArea)
      return kParseError;
    const size_t start = start_;
    int status = store_frame(int(frames.size()) + 1, payload, &frame);
    if (status != kParseError && start_ - start > payload)
      status = kParseError;
    if (status != kParseError && is_animation && frame.num > 0 &&
        !add_frame(frame))
      status = kParseError;
    return status;
  }

  int store_frame(int frame_num, uint32_t min_size, DemuxFrame* frame) {
    int alpha_chunks = 0, image_chunks = 0;
    if (avail() < kChunkHeaderSize || avail() < min_size)
      return kParseNeedMore;
    int status = kParseOk;
    bool done = false;
    do {
      const size_t chunk_start = start_;
      const uint8_t* tag = buf_ + start_;
      start_ += kTagSize;
      const uint32_t payload = read32();
      if (payload > kMaxChunkPayload) return kParseError;
      const uint32_t padded = payload + (payload & 1);
      const size_t available = padded > avail() ? avail() : padded;
      const size_t chunk_size = kChunkHeaderSize + available;
      if (size_invalid(padded)) return kParseError;
      if (padded > avail()) status = kParseNeedMore;
      bool image = false;
      if (tag_is(tag, "ALPH") && alpha_chunks == 0) {
        ++alpha_chunks;
        frame->alpha_off = chunk_start;
        frame->alpha_size = chunk_size;
        frame->num = frame_num;
        start_ += available;
      } else if (tag_is(tag, "VP8L") && alpha_chunks > 0) {
        return kParseError;  // VP8L has its own alpha
      } else if ((tag_is(tag, "VP8L") || tag_is(tag, "VP8 ")) &&
                 image_chunks == 0) {
        image = true;
      } else {
        start_ = chunk_start;
        done = true;
      }
      if (image) {
        Features f;
        const int st = parse_headers(buf_ + chunk_start, chunk_size, &f,
                                     nullptr);
        if (status == kParseNeedMore && st == kNotEnoughData)
          return kParseNeedMore;
        if (st != kOk) return kParseError;
        ++image_chunks;
        frame->img_off = chunk_start;
        frame->img_size = chunk_size;
        frame->w = f.width;
        frame->h = f.height;
        frame->num = frame_num;
        frame->complete = status == kParseOk;
        start_ += available;
      }
      if (start_ == riff_end_) done = true;
      else if (avail() < kChunkHeaderSize) status = kParseNeedMore;
    } while (!done && status == kParseOk);
    return status;
  }

  bool add_frame(const DemuxFrame& frame) {
    if (!frames.empty() && !frames.back().complete) return false;
    frames.push_back(frame);
    return true;
  }

  bool valid() const {  // IsValidExtendedFormat
    const bool is_animation = flags & kAnimationFlag;
    if (!parsed_header_) return true;
    if (canvas_w <= 0 || canvas_h <= 0) return false;
    if (done_ && frames.empty()) return false;
    if (flags & ~kAllValidFlags) return false;
    for (const DemuxFrame& f : frames) {
      if (!is_animation && f.num > 1) return false;
      if (f.complete) {
        if (f.alpha_size == 0 && f.img_size == 0) return false;
        if (f.alpha_size > 0 && f.alpha_off > f.img_off) return false;
        if (f.w <= 0 || f.h <= 0) return false;
      } else {
        if (done_) return false;
        if (f.alpha_size > 0 && f.img_size > 0 && f.alpha_off > f.img_off)
          return false;
        if (&f != &frames.back()) return false;
      }
      if (f.w > 0 && f.h > 0) {
        if (!is_animation) {
          if (f.x != 0 || f.y != 0 || f.w != canvas_w || f.h != canvas_h)
            return false;
        } else if (f.x < 0 || f.y < 0 || f.w + f.x > canvas_w ||
                   f.h + f.y > canvas_h) {
          return false;
        }
      }
    }
    return true;
  }

  const uint8_t* buf_ = nullptr;
  size_t start_ = 0, end_ = 0, riff_end_ = 0;
  bool parsed_header_ = false, done_ = false;
};

// WebPAnimDecoderGetNext for frame 1: a transparent black canvas, the frame
// decoded (not blended) into its rectangle.
std::vector<uint8_t> decode_first_frame(const uint8_t* data,
                                        const Demuxer& dmux) {
  if (dmux.frames.empty()) fail("WebP: an animation without frames");
  const DemuxFrame& f = dmux.frames[0];
  size_t start = f.img_off, n = f.img_size;
  if (f.alpha_size > 0) {
    const size_t inter = f.img_off > 0 ? f.img_off - (f.alpha_off + f.alpha_size)
                                       : 0;
    start = f.alpha_off;
    n += f.alpha_size + inter;
  }
  Features ff;
  if (parse_headers(data + start, n, &ff, nullptr) != kOk)
    fail("WebP: a frame's headers");
  int w = 0, h = 0;
  const std::vector<uint8_t> frame = decode_still(data + start, n, &w, &h);
  if (w != f.w || h != f.h) fail("WebP: a frame's size");
  std::vector<uint8_t> canvas(size_t(dmux.canvas_w) * size_t(dmux.canvas_h) *
                                  4, 0);
  for (int y = 0; y < h; ++y)
    std::memcpy(&canvas[(size_t(f.y + y) * size_t(dmux.canvas_w) +
                         size_t(f.x)) * 4],
                &frame[size_t(y) * size_t(w) * 4], size_t(w) * 4);
  return canvas;
}

void set_msg(char* msg, int len, const std::string& s) {
  if (msg != nullptr && len > 0) {
    std::strncpy(msg, s.c_str(), size_t(len - 1));
    msg[len - 1] = 0;
  }
}

}  // namespace

extern "C" {

// WebPGetFeatures on `size` bytes (OpenCV tests the first 32): 0 with
// info = {width, height, has_alpha, has_animation}, or libwebp's status.
int gwebp_features(const uint8_t* data, uint64_t size, int* info) {
  Features f;
  const int status = parse_headers(data, size_t(size), &f, nullptr);
  info[0] = f.width;
  info[1] = f.height;
  info[2] = f.has_alpha;
  info[3] = f.has_animation;
  return status;
}

// Decodes a WebP file as OpenCV's WebP decoder does: the first 32 bytes'
// features (info as gwebp_features) and, for an animation, its first frame
// on the canvas. Returns a malloc'd (info[1], info[0], 4) BGRA buffer (free
// it with gwebp_free), or NULL with *status 1 (bytes cv2 gives None for;
// msg says why). exif[0] and exif[1] get the offset and size of the first
// stored EXIF chunk's payload (size 0 when there is none).
uint8_t* gwebp_decode(const uint8_t* data, uint64_t size, int* info,
                      uint64_t* exif, int* status, char* msg, int msglen) {
  *status = 0;
  exif[0] = exif[1] = 0;
  try {
    const size_t n = size_t(size);
    if (n < 32 || gwebp_features(data, 32, info) != kOk)
      fail("WebP: not a WebP header");
    Demuxer dmux;
    const bool demuxed = dmux.parse(data, n);
    std::vector<uint8_t> out;
    if (info[3]) {
      if (!demuxed) fail("WebP: the animation does not demux");
      out = decode_first_frame(data, dmux);
      if (dmux.canvas_w != info[0] || dmux.canvas_h != info[1])
        fail("WebP: canvas size");
    } else {
      int w = 0, h = 0;
      out = decode_still(data, n, &w, &h);
      if (w != info[0] || h != info[1]) fail("WebP: image size");
    }
    if (demuxed && !dmux.exif.empty()) {
      exif[0] = dmux.exif[0].first;
      exif[1] = dmux.exif[0].second;
    }
    uint8_t* p = static_cast<uint8_t*>(std::malloc(out.size()));
    if (p == nullptr) fail("out of memory");
    std::memcpy(p, out.data(), out.size());
    return p;
  } catch (const Invalid& e) {
    *status = 1;
    set_msg(msg, msglen, e.msg);
  } catch (const std::bad_alloc&) {
    *status = 1;
    set_msg(msg, msglen, "out of memory");
  }
  return nullptr;
}

void gwebp_free(void* p) { std::free(p); }

}  // extern "C"
