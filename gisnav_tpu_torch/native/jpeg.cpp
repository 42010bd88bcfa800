// JPEG codec with libjpeg(-turbo)'s integer arithmetic.
//
// The JAX package reads and writes WMS rasters and replay files with
// OpenCV (cv2.imdecode / cv2.imread / cv2.imencode over libjpeg-turbo). The
// card machine has neither OpenCV nor Pillow, so the port carries this
// codec, built at first use with the host compiler and bound with ctypes
// (gisnav_tpu_torch/gis/jpeg.py). Every stage follows the libjpeg-turbo C
// code that OpenCV calls at its defaults, so decoded pixels and encoded bytes
// are those of cv2:
//
// Decoder: sequential Huffman (SOF0/SOF1), progressive Huffman (SOF2),
// arithmetic-coded sequential and progressive (SOF9/SOF10) and lossless
// Huffman (SOF3), 1, 3 or 4 components, any integral sampling ratio; 8- or
// 16-bit
// DQT, DHT (the standard tables where a scan's table is missing, as
// libjpeg-turbo does for Motion-JPEG), DRI and RSTn with jdmarker.c's
// resync, fill bytes, APPn / COM skipped, several scans. jdhuff.c's bit
// reader (57-bit refills, zero bits past a marker and grey for the rest of
// a segment, a stream that ends without a marker is no image unless it is a
// file read as cv2.imread reads one: libjpeg's stdio source then supplies
// EOI markers), jdphuff.c's four progressive scan types (DC first and
// refine over MCUs, AC first with EOB runs and AC refine with correction
// bits over a component's own block grid, restarts resetting the EOB run)
// into the whole-image coefficient buffer, jdcoefct.c's block smoothing of a
// progressive image cut short (the first nine AC coefficients, and DC when
// no AC data came, estimated from the 5x5 neighbouring DC values),
// jidctint.c's islow IDCT (with the 16-bit sums and saturation of
// libjpeg-turbo's SIMD IDCT, where a damaged stream overflows them),
// jdsample.c's fancy upsampling (h2v1, h1v2, h2v2 with jdmainct.c's context
// rows: the last real chroma row and column repeat), box upsampling
// elsewhere, jdcolor.c's fixed-point YCbCr->BGR and YCCK->CMYK, and for
// CMYK OpenCV's own CMYK->BGR and CMYK->grey (not libjpeg's). Grey output
// is libjpeg's JCS_GRAYSCALE: the Y plane of a YCbCr file, never chroma. The
// first APP1 "Exif" segment before the first scan is located for
// gis/exif.py, which reads its orientation as OpenCV does.
//
// Arithmetic coding is jdarith.c's: the Q-coder of T.81 Annex D with
// jaricom.c's probability table, DAC conditioning (L, U, Kx), the DC and AC
// statistics areas zeroed at each scan and restart, the four progressive
// scan types into the same coefficient buffer (so the IDCT, upsampling,
// colour conversion, block smoothing and EXIF above apply unchanged), zero
// data past a marker and no output after a bad code until the next restart
// ("Corrupt JPEG data: bad arithmetic code"). Lossless is jdlhuff.c,
// jddiffct.c and jdlossls.c: Huffman-coded differences (symbol 16 is
// 32768), predictors 1-7 mod 2^16, the 1-D first row from
// 2^(P - Pt - 1) after the scan's start, a restart (every whole MCU row)
// and the end of the data (where the differences are zero), the point
// transform Pt, 2- to 8-bit samples through libjpeg's 8-bit output (the
// values as they are, not scaled), box upsampling, and libjpeg's refusal of
// any lossy colour conversion (grey, RGB and CMYK files only as they are).
//
// Encoder: cv2.imencode(".jpg") at its defaults for grey and BGR images:
// jpeg_set_quality's table scaling, standard Huffman tables, jccolor.c's
// RGB->YCbCr, 4:2:0 by jcsample.c's h2v2 average with its 1,2 bias, edge
// replication and DC-copy dummy blocks for partial MCUs, jfdctint.c's islow
// FDCT, libjpeg-turbo's reciprocal quantiser, a JFIF 1.01 APP0 and libjpeg's
// marker order.
//
// Lossless arithmetic-coded (SOF11), hierarchical, 12-bit and 9- to 16-bit
// lossless files, which cv2 does not read either, are refused with a
// message naming the variant.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// jpeg_natural_order[]: zigzag index -> natural index, with 16 spare entries
// that absorb a corrupt run past the block's end.
constexpr int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jdcoefct.c: natural positions of DC and the first nine AC coefficients
// (zigzag order), those block smoothing estimates.
constexpr int kSmoothPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

// jstdhuff.c: counts of codes of length 1..16, then the symbols.
const uint8_t kStdDcLuma[28] = {
    0x00, 0x01, 0x05, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07,
    0x08, 0x09, 0x0a, 0x0b};
const uint8_t kStdAcLuma[178] = {
    0x00, 0x02, 0x01, 0x03, 0x03, 0x02, 0x04, 0x03, 0x05, 0x05, 0x04, 0x04,
    0x00, 0x00, 0x01, 0x7d, 0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
    0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32,
    0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a,
    0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55,
    0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85,
    0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2,
    0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5,
    0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea,
    0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdDcChroma[28] = {
    0x00, 0x03, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07,
    0x08, 0x09, 0x0a, 0x0b};
const uint8_t kStdAcChroma[178] = {
    0x00, 0x02, 0x01, 0x02, 0x04, 0x04, 0x03, 0x04, 0x07, 0x05, 0x04, 0x04,
    0x00, 0x01, 0x02, 0x77, 0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
    0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81,
    0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0,
    0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17,
    0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54,
    0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9,
    0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9,
    0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// jcparam.c: the JPEG standard's sample tables (K.1, K.2), natural order.
const int kStdLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kStdChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jfdctint.c / jidctint.c constants (CONST_BITS 13).
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                  F0_899 = 7373, F1_175 = 9633, F1_501 = 12299,
                  F1_847 = 15137, F1_961 = 16069, F2_053 = 16819,
                  F2_562 = 20995, F3_072 = 25172;

// jaricom.c jpeg_aritab (T.81 Table D.2): Qe_Value << 16 | Next_Index_MPS << 8
// | Switch_MPS << 7 | Next_Index_LPS; the last entry is the fixed
// probability 0.5 (T.851) that signs and DC refinement bits use.
#define ARI(qe, nlps, nmps, sw) \
  ((int32_t(qe) << 16) | (int32_t(nmps) << 8) | (int32_t(sw) << 7) | (nlps))
constexpr int32_t kAritab[114] = {
    ARI(0x5a1d, 1, 1, 1), ARI(0x2586, 14, 2, 0), ARI(0x1114, 16, 3, 0),
    ARI(0x080b, 18, 4, 0), ARI(0x03d8, 20, 5, 0), ARI(0x01da, 23, 6, 0),
    ARI(0x00e5, 25, 7, 0), ARI(0x006f, 28, 8, 0), ARI(0x0036, 30, 9, 0),
    ARI(0x001a, 33, 10, 0), ARI(0x000d, 35, 11, 0), ARI(0x0006, 9, 12, 0),
    ARI(0x0003, 10, 13, 0), ARI(0x0001, 12, 13, 0), ARI(0x5a7f, 15, 15, 1),
    ARI(0x3f25, 36, 16, 0), ARI(0x2cf2, 38, 17, 0), ARI(0x207c, 39, 18, 0),
    ARI(0x17b9, 40, 19, 0), ARI(0x1182, 42, 20, 0), ARI(0x0cef, 43, 21, 0),
    ARI(0x09a1, 45, 22, 0), ARI(0x072f, 46, 23, 0), ARI(0x055c, 48, 24, 0),
    ARI(0x0406, 49, 25, 0), ARI(0x0303, 51, 26, 0), ARI(0x0240, 52, 27, 0),
    ARI(0x01b1, 54, 28, 0), ARI(0x0144, 56, 29, 0), ARI(0x00f5, 57, 30, 0),
    ARI(0x00b7, 59, 31, 0), ARI(0x008a, 60, 32, 0), ARI(0x0068, 62, 33, 0),
    ARI(0x004e, 63, 34, 0), ARI(0x003b, 32, 35, 0), ARI(0x002c, 33, 9, 0),
    ARI(0x5ae1, 37, 37, 1), ARI(0x484c, 64, 38, 0), ARI(0x3a0d, 65, 39, 0),
    ARI(0x2ef1, 67, 40, 0), ARI(0x261f, 68, 41, 0), ARI(0x1f33, 69, 42, 0),
    ARI(0x19a8, 70, 43, 0), ARI(0x1518, 72, 44, 0), ARI(0x1177, 73, 45, 0),
    ARI(0x0e74, 74, 46, 0), ARI(0x0bfb, 75, 47, 0), ARI(0x09f8, 77, 48, 0),
    ARI(0x0861, 78, 49, 0), ARI(0x0706, 79, 50, 0), ARI(0x05cd, 48, 51, 0),
    ARI(0x04de, 50, 52, 0), ARI(0x040f, 50, 53, 0), ARI(0x0363, 51, 54, 0),
    ARI(0x02d4, 52, 55, 0), ARI(0x025c, 53, 56, 0), ARI(0x01f8, 54, 57, 0),
    ARI(0x01a4, 55, 58, 0), ARI(0x0160, 56, 59, 0), ARI(0x0125, 57, 60, 0),
    ARI(0x00f6, 58, 61, 0), ARI(0x00cb, 59, 62, 0), ARI(0x00ab, 61, 63, 0),
    ARI(0x008f, 61, 32, 0), ARI(0x5b12, 65, 65, 1), ARI(0x4d04, 80, 66, 0),
    ARI(0x412c, 81, 67, 0), ARI(0x37d8, 82, 68, 0), ARI(0x2fe8, 83, 69, 0),
    ARI(0x293c, 84, 70, 0), ARI(0x2379, 86, 71, 0), ARI(0x1edf, 87, 72, 0),
    ARI(0x1aa9, 87, 73, 0), ARI(0x174e, 72, 74, 0), ARI(0x1424, 72, 75, 0),
    ARI(0x119c, 74, 76, 0), ARI(0x0f6b, 74, 77, 0), ARI(0x0d51, 75, 78, 0),
    ARI(0x0bb6, 77, 79, 0), ARI(0x0a40, 77, 48, 0), ARI(0x5832, 80, 81, 1),
    ARI(0x4d1c, 88, 82, 0), ARI(0x438e, 89, 83, 0), ARI(0x3bdd, 90, 84, 0),
    ARI(0x34ee, 91, 85, 0), ARI(0x2eae, 92, 86, 0), ARI(0x299a, 93, 87, 0),
    ARI(0x2516, 86, 71, 0), ARI(0x5570, 88, 89, 1), ARI(0x4ca9, 95, 90, 0),
    ARI(0x44d9, 96, 91, 0), ARI(0x3e22, 97, 92, 0), ARI(0x3824, 99, 93, 0),
    ARI(0x32b4, 99, 94, 0), ARI(0x2e17, 93, 86, 0), ARI(0x56a8, 95, 96, 1),
    ARI(0x4f46, 101, 97, 0), ARI(0x47e5, 102, 98, 0), ARI(0x41cf, 103, 99, 0),
    ARI(0x3c3d, 104, 100, 0), ARI(0x375e, 99, 93, 0), ARI(0x5231, 105, 102, 0),
    ARI(0x4c0f, 106, 103, 0), ARI(0x4639, 107, 104, 0),
    ARI(0x415e, 103, 99, 0), ARI(0x5627, 105, 106, 1),
    ARI(0x50e7, 108, 107, 0), ARI(0x4b85, 109, 103, 0),
    ARI(0x5597, 110, 109, 0), ARI(0x504f, 111, 107, 0),
    ARI(0x5a10, 110, 111, 1), ARI(0x5522, 112, 109, 0),
    ARI(0x59eb, 112, 111, 1), ARI(0x5a1d, 113, 113, 0)};
#undef ARI
constexpr int kFixedBin = 113;  // jdarith.c fixed_bin[0]

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// cv2.imdecode gives None for these bytes.
struct Invalid {
  std::string msg;
};
// A JPEG variant the codec does not read.
struct Unsupported {
  std::string msg;
};
// A header over loadsave.cpp's validateInputImageSize limits (2^20 rows or
// columns, 2^30 pixels): cv2.imdecode raises cv2.error.
struct TooLarge {
  int h, w;
};

// ------------------------------------------------------------------------
// Decoder

struct HuffSpec {  // a DHT table as defined in the stream
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
};

void std_spec(HuffSpec* s, const uint8_t* table, int n) {
  s->defined = true;
  s->bits[0] = 0;
  std::memcpy(s->bits + 1, table, 16);
  std::memset(s->vals, 0, sizeof(s->vals));
  std::memcpy(s->vals, table + 16, n - 16);
}

struct Derived {  // jdhuff.c d_derived_tbl
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t lookup[256];  // (length << 8) | symbol; length 9 = longer code
};

// max_dc: the largest DC symbol allowed (15; 16 in lossless mode).
void derive(const HuffSpec& spec, bool dc, Derived* t, int max_dc = 15) {
  char huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    int i = spec.bits[l];
    if (p + i > 256) throw Invalid{"bad Huffman table"};
    while (i--) huffsize[p++] = char(l);
  }
  huffsize[p] = 0;
  int nsym = p;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      code++;
    }
    if (int64_t(code) >= (int64_t(1) << si)) throw Invalid{"bad Huffman table"};
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (spec.bits[l]) {
      t->valoffset[l] = int32_t(p) - int32_t(huffcode[p]);
      p += spec.bits[l];
      t->maxcode[l] = int32_t(huffcode[p - 1]);
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;
  std::memcpy(t->vals, spec.vals, 256);
  for (int i = 0; i < 256; i++) t->lookup[i] = 9 << 8;
  p = 0;
  for (int l = 1; l <= 8; l++) {
    for (int i = 1; i <= spec.bits[l]; i++, p++) {
      int look = int(huffcode[p] << (8 - l));
      for (int ctr = 1 << (8 - l); ctr > 0; ctr--)
        t->lookup[look++] = uint16_t((l << 8) | spec.vals[p]);
    }
  }
  if (dc)
    for (int i = 0; i < nsym; i++)
      if (spec.vals[i] > max_dc) throw Invalid{"bad Huffman table"};
}

// Past its last byte a file read as cv2.imread reads it (libjpeg's stdio
// source) goes on as a fake EOI marker, FF D9, again and again; bytes given
// to cv2.imdecode (OpenCV's memory source) end there.
inline uint8_t past_end(size_t i, size_t n) {
  return (i - n) & 1 ? 0xD9 : 0xFF;
}

inline int extend(int x, int s) {  // HUFF_EXTEND
  return x < (1 << (s - 1)) ? x - (1 << s) + 1 : x;
}

constexpr int kMinGetBits = 57;  // jdhuff.h MIN_GET_BITS, 64-bit buffer

struct BitReader {  // jdhuff.c bitread state
  const uint8_t* data;
  size_t size;
  size_t pos;
  uint64_t buf = 0;
  int bits = 0;
  int marker = 0;  // marker met in the entropy data (unread_marker)
  bool insufficient = false;
  bool file = false;  // read as cv2.imread reads a file

  uint8_t next_byte() {
    if (pos >= size) {
      // A suspending source: OpenCV's gives up, and cv2.imdecode gives None.
      if (!file) throw Invalid{"JPEG data ends without a marker"};
      pos++;
      return past_end(pos - 1, size);
    }
    return data[pos++];
  }

  void fill(int nbits) {  // jpeg_fill_bit_buffer
    if (marker == 0) {
      while (bits < kMinGetBits) {
        int c = next_byte();
        if (c == 0xFF) {
          do c = next_byte(); while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            marker = c;
            break;
          }
        }
        buf = (buf << 8) | uint64_t(c);
        bits += 8;
      }
      if (marker == 0) return;
    }
    if (nbits > bits) {  // past the marker: zero bits, grey to the restart
      insufficient = true;
      buf <<= kMinGetBits - bits;
      bits = kMinGetBits;
    }
  }

  int get(int n) {
    if (bits < n) fill(n);
    bits -= n;
    return int((buf >> bits) & ((uint64_t(1) << n) - 1));
  }

  int decode(const Derived& t) {  // HUFF_DECODE
    int nb;
    if (bits < 8) {
      fill(0);
      if (bits < 8) {
        nb = 1;
        return decode_slow(t, nb);
      }
    }
    int e = t.lookup[(buf >> (bits - 8)) & 0xFF];
    nb = e >> 8;
    if (nb <= 8) {
      bits -= nb;
      return e & 0xFF;
    }
    return decode_slow(t, nb);
  }

  int decode_slow(const Derived& t, int l) {  // jpeg_huff_decode
    int32_t code = get(l);
    while (code > t.maxcode[l]) {
      code = (code << 1) | get(1);
      l++;
    }
    if (l > 16) return 0;  // a bad code: libjpeg fakes a zero
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
};

struct ArithReader {  // jdarith.c: the C and A registers and get_byte
  const uint8_t* data;
  size_t size;
  size_t pos;
  int marker = 0;  // marker met in the entropy data (unread_marker)
  bool file = false;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: two bytes to read first; -1: a bad code, no output

  uint8_t next_byte() {
    if (pos >= size) {
      if (!file) throw Invalid{"JPEG data ends without a marker"};
      pos++;
      return past_end(pos - 1, size);
    }
    return data[pos++];
  }

  void reset() {
    c = 0;
    a = 0;
    ct = -16;
  }

  // arith_decode: one binary decision with the statistics bin *st
  // (bit 7 the more probable symbol, the rest its index in kAritab).
  int decode(uint8_t* st) {
    while (a < 0x8000) {  // renormalisation and data input (D.2.6)
      if (--ct < 0) {
        int d = 0;  // past a marker: zero data to the end of the scan
        if (marker == 0) {
          d = next_byte();
          if (d == 0xFF) {
            do d = next_byte(); while (d == 0xFF);
            if (d == 0) {
              d = 0xFF;
            } else {
              marker = d;
              d = 0;
            }
          }
        }
        c = (c << 8) | d;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // two initial bytes read
      }
      a <<= 1;
    }
    int sv = *st;
    int32_t qe = kAritab[sv & 0x7F];
    const uint8_t nl = uint8_t(qe & 0xFF);
    qe >>= 8;
    const uint8_t nm = uint8_t(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional LPS exchange
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {  // conditional MPS exchange
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;  // blocks stored (MCU-padded)
  int wib = 0, hib = 0;  // width_in_blocks, height_in_blocks
  int dw = 0, dh = 0;  // downsampled_width, downsampled_height
  bool latched = false;
  uint16_t quant[64] = {};
  std::vector<int16_t> coef;  // bh x bw blocks of 64
  // lossless: hib x wib samples scaled to 8 bits (jdlossls.c's output),
  // and the last row undifferenced, at 16 bits (the next row's Rb / Rc)
  std::vector<uint8_t> samples;
  std::vector<uint16_t> last_row;
  // the number of rows in the last iMCU row (jdinput.c last_row_height)
  int last_row_height() const {
    int r = hib % v;
    return r ? r : v;
  }
};

struct Decoder {
  const uint8_t* d = nullptr;
  size_t n = 0;
  size_t pos = 0;
  int width = 0, height = 0, precision = 0;
  int max_h = 1, max_v = 1;
  int mcus_x = 0, mcus_y = 0;
  bool saw_sof = false, saw_jfif = false, saw_adobe = false;
  bool progressive = false, saw_sos = false;
  bool arith = false, lossless = false;  // SOF9 / SOF10; SOF3
  // the components a lossless scan has held: jddiffct.c's image buffers
  // are not pre-zeroed, so reading one no scan wrote is an error
  std::vector<bool> lossless_scanned;
  // DAC conditioning (jdmarker.c get_soi's defaults: L 0, U 1, Kx 5)
  uint8_t arith_dc_L[16], arith_dc_U[16], arith_ac_K[16];
  int adobe_transform = 0;
  int restart_interval = 0;
  bool file = false;  // read as cv2.imread reads a file
  // The first APP1 before the first scan that starts "Exif\0\0": its TIFF
  // body (OpenCV's JpegDecoder hands that to its ExifReader).
  size_t exif_off = 0, exif_len = 0;
  std::vector<Component> comps;
  // jdinput.c coef_bits: per component, the Al of the last scan that
  // carried each coefficient (-1 before any), and jdphuff.c's copy of it
  // from before the component's latest scan; the scans read so far, and
  // jdcoefct.c's last iMCU row that a scan reached with data left.
  std::vector<std::array<int, 64>> coef_bits, prev_coef_bits;
  int scans = 0;
  int last_good_imcu_row = 0;
  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {};
  HuffSpec dc_spec[4], ac_spec[4];
  int unread_marker = 0;

  Decoder() {
    std::memset(arith_dc_L, 0, sizeof(arith_dc_L));
    std::memset(arith_dc_U, 1, sizeof(arith_dc_U));
    std::memset(arith_ac_K, 5, sizeof(arith_ac_K));
  }

  uint8_t byte() {
    if (pos >= n) {
      if (!file) throw Invalid{"JPEG ends inside its headers"};
      pos++;
      return past_end(pos - 1, n);
    }
    return d[pos++];
  }
  // Whether `len` more bytes lie in the data (always, for a file).
  bool have(size_t len) const { return file || (pos <= n && len <= n - pos); }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  int next_marker() {  // jdmarker.c next_marker
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do c = byte(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  // A length under 2 skips nothing: jdmarker.c's skip_variable,
  // get_interesting_appn and save_marker pass a bogus length word by.
  void skip_variable() {
    int len = word();
    len = len < 2 ? 0 : len - 2;
    if (!have(size_t(len))) throw Invalid{"JPEG ends inside a marker"};
    pos += size_t(len);
  }

  void get_app(int marker) {
    size_t start = pos;
    int len = word();
    size_t body = len < 2 ? 0 : size_t(len - 2);
    if (!have(body)) throw Invalid{"JPEG ends inside a marker"};
    uint8_t b[14];
    for (size_t i = 0; i < sizeof(b); i++)
      b[i] = pos + i < n ? d[pos + i] : past_end(pos + i, n);
    if (marker == 0xE0 && body >= 14 && std::memcmp(b, "JFIF\0", 5) == 0)
      saw_jfif = true;
    if (marker == 0xEE && body >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = b[11];
    }
    if (marker == 0xE1 && !saw_sos && exif_len == 0 && body > 6 &&
        std::memcmp(b, "Exif\0\0", 6) == 0) {
      exif_off = std::min(pos + 6, n);
      exif_len = std::min(body - 6, n - exif_off);
    }
    pos = start + 2 + body;
  }

  void get_sof(int marker) {
    // a second SOF is a damaged stream (jdmarker.c), whatever its kind
    if (saw_sof) throw Invalid{"duplicate SOF"};
    if ((marker >= 0xC5 && marker <= 0xC7) || marker >= 0xCD)
      throw Unsupported{"hierarchical JPEG is not supported"};
    if (marker == 0xCB)  // libjpeg-turbo has no lossless arithmetic decoder
      throw Unsupported{"lossless arithmetic-coded JPEG (SOF11) is not "
                        "supported"};
    progressive = marker == 0xC2 || marker == 0xCA;
    arith = marker >= 0xC9;
    lossless = marker == 0xC3;
    int len = word();
    precision = byte();
    height = word();
    width = word();
    int nc = byte();
    if (height <= 0 || width <= 0 || nc <= 0) throw Invalid{"empty image"};
    if (len != 8 + 3 * nc) throw Invalid{"bad SOF length"};
    comps.assign(size_t(nc), Component());
    for (auto& c : comps) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
    }
    saw_sof = true;
    if (lossless) {  // cv2 reads lossless JPEG through libjpeg's 8-bit API
      if (precision < 2 || precision > 16)
        throw Invalid{"bad lossless JPEG precision"};
      if (precision > 8)
        throw Unsupported{std::to_string(precision) +
                          "-bit lossless JPEG is not supported (2 to 8 "
                          "bits)"};
    } else if (precision != 8) {
      throw Unsupported{std::to_string(precision) +
                        "-bit JPEG is not supported (8-bit only)"};
    }
    if (nc != 1 && nc != 3 && nc != 4)
      throw Unsupported{std::to_string(nc) +
                        "-component JPEG is not supported"};
    if (width > 65500 || height > 65500) throw Invalid{"image too large"};
    for (auto& c : comps) {
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        throw Invalid{"bad sampling factors"};
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    // jdinput.c initial_setup: a lossless data unit is one sample
    const int du = lossless ? 1 : 8;
    mcus_x = (width + du * max_h - 1) / (du * max_h);
    mcus_y = (height + du * max_v - 1) / (du * max_v);
    for (auto& c : comps) {
      c.wib = int((int64_t(width) * c.h + du * max_h - 1) / (du * max_h));
      c.hib = int((int64_t(height) * c.v + du * max_v - 1) / (du * max_v));
      c.dw = int((int64_t(width) * c.h + max_h - 1) / max_h);
      c.dh = int((int64_t(height) * c.v + max_v - 1) / max_v);
      c.bw = mcus_x * c.h;
      c.bh = mcus_y * c.v;
      if (lossless) {
        c.samples.assign(size_t(c.wib) * c.hib, 0);
        c.last_row.assign(size_t(c.wib), 0);
      } else {
        c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
      }
    }
    coef_bits.assign(size_t(nc), {});
    for (auto& cb : coef_bits) cb.fill(-1);
    prev_coef_bits.assign(size_t(nc), {});
  }

  void get_dht() {
    int len = word() - 2;
    while (len > 16) {
      int index = byte();
      uint8_t bits[17] = {0};
      int count = 0;
      for (int i = 1; i <= 16; i++) {
        bits[i] = byte();
        count += bits[i];
      }
      len -= 17;
      if (count > 256 || count > len) throw Invalid{"bad Huffman table"};
      HuffSpec spec;
      for (int i = 0; i < count; i++) spec.vals[i] = byte();
      len -= count;
      HuffSpec* tbl = dc_spec;
      if (index & 0x10) {
        index -= 0x10;
        tbl = ac_spec;
      }
      if (index < 0 || index >= 4) throw Invalid{"bad DHT index"};
      spec.defined = true;
      std::memcpy(spec.bits, bits, sizeof(bits));
      tbl[index] = spec;
    }
    if (len != 0) throw Invalid{"bad DHT length"};
  }

  void get_dqt() {
    int len = word() - 2;
    while (len > 0) {
      len--;
      int nq = byte();
      int prec = nq >> 4;
      nq &= 15;
      if (nq >= 4) throw Invalid{"bad DQT index"};
      for (int i = 0; i < 64; i++) {
        int v = prec ? word() : byte();
        qt[nq][kNatural[i]] = uint16_t(v);
      }
      qt_defined[nq] = true;
      len -= 64;
      if (prec) len -= 64;
    }
    if (len != 0) throw Invalid{"bad DQT length"};
  }

  void get_dac() {  // jdmarker.c get_dac
    int len = word() - 2;
    while (len > 0) {
      int index = byte(), val = byte();
      len -= 2;
      if (index >= 32) throw Invalid{"bad DAC index"};
      if (index >= 16) {
        arith_ac_K[index - 16] = uint8_t(val);
      } else {
        arith_dc_L[index] = uint8_t(val & 0x0F);
        arith_dc_U[index] = uint8_t(val >> 4);
        if (arith_dc_L[index] > arith_dc_U[index])
          throw Invalid{"bad DAC value"};
      }
    }
    if (len != 0) throw Invalid{"bad DAC length"};
  }

  void get_dri() {
    if (word() != 4) throw Invalid{"bad DRI length"};
    restart_interval = word();
  }

  // Reads markers up to SOS (returns true) or EOI (false).
  bool read_markers() {
    for (;;) {
      int m = unread_marker ? unread_marker : next_marker();
      unread_marker = 0;
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        get_sof(m);
      } else if (m == 0xC4) {
        get_dht();
      } else if (m == 0xCC) {
        get_dac();
      } else if (m == 0xDB) {
        get_dqt();
      } else if (m == 0xDD) {
        get_dri();
      } else if (m == 0xDA) {
        if (!saw_sof) throw Invalid{"SOS before SOF"};
        saw_sos = true;
        return true;
      } else if (m == 0xD9) {
        return false;
      } else if (m == 0xD8) {
        throw Invalid{"duplicate SOI"};
      } else if (m >= 0xE0 && m <= 0xEF) {
        get_app(m);
      } else if (m == 0xFE || m == 0xDC) {
        skip_variable();
      } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        // parameterless markers
      } else {
        throw Invalid{"unknown JPEG marker"};
      }
    }
  }

  // jpeg_resync_to_restart over an entropy reader's marker and position
  void resync_to_restart(int* reader_marker, size_t* reader_pos,
                         int desired) {
    int marker = *reader_marker;
    for (;;) {
      int action;
      if (marker < 0xC0) {
        action = 2;
      } else if (marker < 0xD0 || marker > 0xD7) {
        action = 3;
      } else if (marker == 0xD0 + ((desired + 1) & 7) ||
                 marker == 0xD0 + ((desired + 2) & 7)) {
        action = 3;
      } else if (marker == 0xD0 + ((desired - 1) & 7) ||
                 marker == 0xD0 + ((desired - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {
        *reader_marker = 0;
        return;
      }
      if (action == 3) {
        *reader_marker = marker;
        return;
      }
      pos = *reader_pos;
      marker = next_marker();
      *reader_pos = pos;
      *reader_marker = marker;
    }
  }

  // jdmarker.c read_restart_marker, for an entropy reader's marker and
  // position; advances *next_rst.
  void read_restart_marker(int* reader_marker, size_t* reader_pos,
                           int* next_rst) {
    if (*reader_marker == 0) {
      pos = *reader_pos;
      *reader_marker = next_marker();
      *reader_pos = pos;
    }
    if (*reader_marker == 0xD0 + *next_rst)
      *reader_marker = 0;
    else
      resync_to_restart(reader_marker, reader_pos, *next_rst);
    *next_rst = (*next_rst + 1) & 7;
  }

  void process_restart(BitReader& br, int* next_rst, int* last_dc,
                       int ncomp, unsigned* eobrun) {
    br.bits = 0;
    read_restart_marker(&br.marker, &br.pos, next_rst);
    for (int i = 0; i < ncomp; i++) last_dc[i] = 0;
    *eobrun = 0;
    if (br.marker == 0) br.insufficient = false;
  }

  // One progressive scan (jdphuff.c): DC first / refine over the MCUs of
  // the scan's components, AC first / refine over one component's own
  // blocks (width_in_blocks x height_in_blocks, not the MCU-padded grid).
  template <class Restart>
  void decode_progressive(BitReader& br, const std::vector<int>& sc,
                          const Derived* dct, const Derived* act, int Ss,
                          int Se, int Ah, int Al, int* last_dc,
                          unsigned* eobrun, Restart& restart) {
    const int ns = int(sc.size());
    const int p1 = 1 << Al, m1 = -p1;
    auto dc_first = [&](int i, int16_t* blk) {
      int s = br.decode(dct[i]);
      if (s) s = extend(br.get(s), s);
      int64_t v = int64_t(last_dc[i]) + s;
      if (v > INT32_MAX || v < INT32_MIN) throw Invalid{"bad DC coefficient"};
      last_dc[i] = int(v);
      blk[0] = int16_t(unsigned(last_dc[i]) << Al);
    };
    auto dc_refine = [&](int16_t* blk) {
      if (br.get(1)) blk[0] = int16_t(blk[0] | p1);
    };
    auto ac_first = [&](int16_t* blk) {
      if (*eobrun > 0) {
        (*eobrun)--;
        return;
      }
      for (int k = Ss; k <= Se; k++) {
        int rs = br.decode(act[0]);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = int16_t(unsigned(extend(br.get(s), s)) << Al);
        } else if (r == 15) {
          k += 15;
        } else {
          *eobrun = 1u << r;
          if (r) *eobrun += unsigned(br.get(r));
          (*eobrun)--;
          break;
        }
      }
    };
    auto correct = [&](int16_t* coef) {  // a correction bit of a nonzero
      if (br.get(1) && (*coef & p1) == 0)
        *coef = int16_t(*coef + (*coef >= 0 ? p1 : m1));
    };
    auto ac_refine = [&](int16_t* blk) {
      int k = Ss;
      if (*eobrun == 0) {
        for (; k <= Se; k++) {
          int rs = br.decode(act[0]);
          int r = rs >> 4, s = rs & 15;
          if (s) {  // a size other than 1 is only a warning
            s = br.get(1) ? p1 : m1;
          } else if (r != 15) {
            *eobrun = 1u << r;
            if (r) *eobrun += unsigned(br.get(r));
            break;
          }
          do {
            int16_t* coef = blk + kNatural[k];
            if (*coef != 0) {
              correct(coef);
            } else if (--r < 0) {
              break;
            }
            k++;
          } while (k <= Se);
          if (s) blk[kNatural[k]] = int16_t(s);
        }
      }
      if (*eobrun > 0) {
        for (; k <= Se; k++)
          if (blk[kNatural[k]] != 0) correct(blk + kNatural[k]);
        (*eobrun)--;
      }
    };
    auto at = [](Component& c, int by, int bx) {
      return &c.coef[(size_t(by) * c.bw + bx) * 64];
    };
    if (Ss != 0) {  // AC: one component, its own block grid
      Component& c = comps[size_t(sc[0])];
      for (int by = 0; by < c.hib; by++)
        for (int bx = 0; bx < c.wib; bx++) {
          if (!br.insufficient) last_good_imcu_row = by / c.v;
          restart();
          if (br.insufficient) continue;
          if (Ah == 0)
            ac_first(at(c, by, bx));
          else
            ac_refine(at(c, by, bx));
        }
      return;
    }
    auto dc_block = [&](int i, Component& c, int by, int bx) {
      if (Ah == 0)
        dc_first(i, at(c, by, bx));
      else
        dc_refine(at(c, by, bx));
    };
    if (ns == 1) {
      Component& c = comps[size_t(sc[0])];
      for (int by = 0; by < c.hib; by++)
        for (int bx = 0; bx < c.wib; bx++) {
          if (!br.insufficient) last_good_imcu_row = by / c.v;
          restart();
          if (Ah == 0 && br.insufficient) continue;
          dc_block(0, c, by, bx);
        }
      return;
    }
    for (int my = 0; my < mcus_y; my++)
      for (int mx = 0; mx < mcus_x; mx++) {
        if (!br.insufficient) last_good_imcu_row = my;
        restart();
        if (Ah == 0 && br.insufficient) continue;
        for (int i = 0; i < ns; i++) {
          Component& c = comps[size_t(sc[size_t(i)])];
          for (int y = 0; y < c.v; y++)
            for (int x = 0; x < c.h; x++)
              dc_block(i, c, my * c.v + y, mx * c.h + x);
        }
      }
  }

  // One arithmetic-coded scan (jdarith.c): sequential, or one of the four
  // progressive scan types, into the whole-image coefficient buffer over
  // the block grids that the Huffman scans use. A bad code (a magnitude or
  // run past its range) stops the scan's output until the next restart,
  // as libjpeg's "Corrupt JPEG data: bad arithmetic code" does.
  void decode_arith(ArithReader& ar, const std::vector<int>& sc,
                    const int* td, const int* ta, int Ss, int Se, int Ah,
                    int Al) {
    const int ns = int(sc.size());
    uint8_t dc_stats[16][64], ac_stats[16][256];
    uint8_t fixed_bin[4] = {kFixedBin, 0, 0, 0};
    int last_dc[4] = {0, 0, 0, 0}, dc_context[4] = {0, 0, 0, 0};
    const bool dc_scan = !progressive || (Ss == 0 && Ah == 0);
    const bool ac_scan = !progressive || Ss != 0;
    auto reset_stats = [&]() {  // start_pass, and process_restart
      for (int i = 0; i < ns; i++) {
        if (dc_scan) {
          std::memset(dc_stats[td[i]], 0, 64);
          last_dc[i] = 0;
          dc_context[i] = 0;
        }
        if (ac_scan) std::memset(ac_stats[ta[i]], 0, 256);
      }
    };
    reset_stats();
    int next_rst = 0, to_go = restart_interval;
    auto restart = [&]() {
      if (restart_interval) {
        if (to_go == 0) {
          read_restart_marker(&ar.marker, &ar.pos, &next_rst);
          reset_stats();
          ar.reset();
          to_go = restart_interval;
        }
        to_go--;
      }
    };
    // F.1.4.4.1 / F.2.4.1: a DC difference into last_dc[i] (mod 2^16);
    // false on a bad code
    auto dc_diff = [&](int i, int tbl) {
      uint8_t* st = dc_stats[tbl] + dc_context[i];
      if (ar.decode(st) == 0) {
        dc_context[i] = 0;
        return true;
      }
      const int sign = ar.decode(st + 1);
      st += 2 + sign;
      int m = ar.decode(st);
      if (m != 0) {
        st = dc_stats[tbl] + 20;  // X1
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;  // magnitude overflow
            return false;
          }
          st++;
        }
      }
      if (m < ((1 << arith_dc_L[tbl]) >> 1))
        dc_context[i] = 0;
      else if (m > ((1 << arith_dc_U[tbl]) >> 1))
        dc_context[i] = 12 + sign * 4;
      else
        dc_context[i] = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      last_dc[i] = (last_dc[i] + v) & 0xFFFF;
      return true;
    };
    // F.1.4.4.2: an AC magnitude after its nonzero decision at bin st;
    // 0 on a bad code
    auto ac_value = [&](uint8_t* st, int k, int tbl) {
      const int sign = ar.decode(fixed_bin);
      st += 2;
      int m = ar.decode(st);
      if (m != 0 && ar.decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= arith_ac_K[tbl] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;  // magnitude overflow
            return 0;
          }
          st++;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      return sign ? -v : v;
    };
    // sequential decode_mcu's body for one block; false on a bad code
    auto seq_block = [&](int i, int16_t* blk) {
      if (!dc_diff(i, td[i])) return false;
      blk[0] = int16_t(last_dc[i]);
      const int tbl = ta[i];
      int k = 0;
      do {
        uint8_t* st = ac_stats[tbl] + 3 * k;
        if (ar.decode(st)) break;  // EOB
        for (;;) {
          k++;
          if (ar.decode(st + 1)) break;
          st += 3;
          if (k >= 63) {
            ar.ct = -1;  // spectral overflow
            return false;
          }
        }
        const int v = ac_value(st, k, tbl);
        if (v == 0) return false;
        blk[kNatural[k]] = int16_t(v);
      } while (k < 63);
      return true;
    };
    const int p1 = 1 << Al, m1 = int(unsigned(-1) << Al);
    auto ac_first = [&](int16_t* blk) {
      const int tbl = ta[0];
      for (int k = Ss; k <= Se; k++) {
        uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
        if (ar.decode(st)) break;  // EOB
        while (ar.decode(st + 1) == 0) {
          st += 3;
          if (++k > Se) {
            ar.ct = -1;  // spectral overflow
            return;
          }
        }
        const int v = ac_value(st, k, tbl);
        if (v == 0) return;
        blk[kNatural[k]] = int16_t(unsigned(v) << Al);
      }
    };
    auto ac_refine = [&](int16_t* blk) {
      const int tbl = ta[0];
      int kex = Se;  // the previous stage's end of block
      for (; kex > 0; kex--)
        if (blk[kNatural[kex]]) break;
      for (int k = Ss; k <= Se; k++) {
        uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
        if (k > kex && ar.decode(st)) break;  // EOB
        for (;;) {
          int16_t* coef = blk + kNatural[k];
          if (*coef) {  // previously nonzero: a correction bit
            if (ar.decode(st + 2))
              *coef = int16_t(*coef + (*coef < 0 ? m1 : p1));
            break;
          }
          if (ar.decode(st + 1)) {  // newly nonzero
            *coef = int16_t(ar.decode(fixed_bin) ? m1 : p1);
            break;
          }
          st += 3;
          if (++k > Se) {
            ar.ct = -1;  // spectral overflow
            return;
          }
        }
      }
    };
    auto at = [](Component& c, int by, int bx) {
      return &c.coef[(size_t(by) * c.bw + bx) * 64];
    };
    // one MCU's blocks, in the order of the scan's components
    auto mcu_blocks = [&](int my, int mx, auto&& fn) {
      for (int i = 0; i < ns; i++) {
        Component& c = comps[size_t(sc[size_t(i)])];
        for (int y = 0; y < c.v; y++)
          for (int x = 0; x < c.h; x++)
            if (!fn(i, at(c, my * c.v + y, mx * c.h + x))) return;
      }
    };
    if (!progressive) {
      if (ns == 1) {
        Component& c = comps[size_t(sc[0])];
        for (int by = 0; by < c.hib; by++)
          for (int bx = 0; bx < c.wib; bx++) {
            restart();
            if (ar.ct != -1) seq_block(0, at(c, by, bx));
          }
        return;
      }
      for (int my = 0; my < mcus_y; my++)
        for (int mx = 0; mx < mcus_x; mx++) {
          restart();
          if (ar.ct != -1) mcu_blocks(my, mx, seq_block);
        }
      return;
    }
    // progressive: arith's insufficient_data is never set, so every MCU
    // counts as good data for block smoothing
    if (Ss != 0) {  // AC: one component, its own block grid
      Component& c = comps[size_t(sc[0])];
      for (int by = 0; by < c.hib; by++)
        for (int bx = 0; bx < c.wib; bx++) {
          last_good_imcu_row = by / c.v;
          restart();
          if (ar.ct == -1) continue;
          if (Ah == 0)
            ac_first(at(c, by, bx));
          else
            ac_refine(at(c, by, bx));
        }
      return;
    }
    auto dc_block = [&](int i, int16_t* blk) {
      if (Ah != 0) {  // DC refine: the next bit, no error check
        if (ar.decode(fixed_bin)) blk[0] = int16_t(blk[0] | p1);
        return true;
      }
      if (!dc_diff(i, td[i])) return false;
      blk[0] = int16_t(uint16_t(unsigned(last_dc[i]) << Al));
      return true;
    };
    if (ns == 1) {
      Component& c = comps[size_t(sc[0])];
      for (int by = 0; by < c.hib; by++)
        for (int bx = 0; bx < c.wib; bx++) {
          last_good_imcu_row = by / c.v;
          restart();
          if (Ah == 0 && ar.ct == -1) continue;
          dc_block(0, at(c, by, bx));
        }
      return;
    }
    for (int my = 0; my < mcus_y; my++)
      for (int mx = 0; mx < mcus_x; mx++) {
        last_good_imcu_row = my;
        restart();
        if (Ah == 0 && ar.ct == -1) continue;
        mcu_blocks(my, mx, dc_block);
      }
  }

  // One lossless scan (jdlhuff.c, jddiffct.c, jdlossls.c): Huffman-coded
  // sample differences an MCU row at a time, undifferenced and scaled by
  // the point transform Al an iMCU row at a time with predictor psv (the
  // first row after the scan's start, a restart or the end of the data
  // with the 1-D predictor from 2^(P - Al - 1)), into each component's
  // samples. Restarts come every restart_interval / MCUs_per_row MCU rows.
  void decode_lossless(BitReader& br, const std::vector<int>& sc,
                       const Derived* dct, int psv, int Al) {
    const int ns = int(sc.size());
    const int mcus_per_row = ns == 1 ? comps[size_t(sc[0])].wib : mcus_x;
    if (restart_interval % mcus_per_row != 0)
      throw Invalid{"lossless restart interval not a whole MCU row"};
    const int rows_per_rst = restart_interval / mcus_per_row;
    const int init = 1 << (precision - Al - 1);
    int next_rst = 0, to_go = rows_per_rst;
    bool first_row = true;  // start_pass_lossless: every component
    // each component's differences for an iMCU row: v rows of its
    // MCU-padded width
    std::vector<std::vector<int>> diff(static_cast<size_t>(ns));
    std::vector<int> width(static_cast<size_t>(ns));
    for (int i = 0; i < ns; i++) {
      const Component& c = comps[size_t(sc[size_t(i)])];
      width[size_t(i)] = ns == 1 ? c.wib : mcus_x * c.h;
      diff[size_t(i)].assign(size_t(width[size_t(i)]) * c.v, 0);
    }
    auto sample = [&](int i) {  // one difference (H.2.2)
      int s = br.decode(dct[i]);
      if (s == 16) return 32768;
      if (s) s = extend(br.get(s), s);
      return s;
    };
    std::vector<uint16_t> row16;
    for (int r = 0; r < mcus_y; r++) {
      const Component& c0 = comps[size_t(sc[0])];
      const int mcu_rows =
          ns > 1 ? 1 : (r < mcus_y - 1 ? c0.v : c0.last_row_height());
      for (int yoff = 0; yoff < mcu_rows; yoff++) {
        if (restart_interval) {
          if (to_go == 0) {
            br.bits = 0;
            read_restart_marker(&br.marker, &br.pos, &next_rst);
            if (br.marker == 0) br.insufficient = false;
            first_row = true;
            to_go = rows_per_rst;
          }
        }
        if (br.insufficient) {  // out of data: zeros, predictor reset
          for (int i = 0; i < ns; i++) {
            const Component& c = comps[size_t(sc[size_t(i)])];
            const int w = width[size_t(i)];
            if (ns == 1)
              std::fill_n(&diff[0][size_t(yoff) * w], w, 0);
            else
              std::fill_n(diff[size_t(i)].begin(), size_t(w) * c.v, 0);
          }
          first_row = true;
        } else if (ns == 1) {
          int* d = &diff[0][size_t(yoff) * width[0]];
          for (int x = 0; x < mcus_per_row; x++) d[x] = sample(0);
        } else {
          for (int mx = 0; mx < mcus_x; mx++)
            for (int i = 0; i < ns; i++) {
              const Component& c = comps[size_t(sc[size_t(i)])];
              for (int y = 0; y < c.v; y++)
                for (int x = 0; x < c.h; x++)
                  diff[size_t(i)][size_t(y) * width[size_t(i)] + mx * c.h +
                                  x] = sample(i);
            }
        }
        if (restart_interval) to_go--;
      }
      for (int i = 0; i < ns; i++) {
        Component& c = comps[size_t(sc[size_t(i)])];
        const int rows = r < mcus_y - 1 ? c.v : c.last_row_height();
        const int w = c.wib;
        row16.resize(size_t(w));
        for (int y = 0; y < rows; y++) {
          const int* d = &diff[size_t(i)][size_t(y) * width[size_t(i)]];
          const uint16_t* prev = c.last_row.data();
          uint16_t* out = row16.data();
          const bool first = first_row && y == 0;
          if (first || psv == 1) {  // jpeg_undifference_first_row, 1
            int ra = (d[0] + (first ? init : prev[0])) & 0xFFFF;
            out[0] = uint16_t(ra);
            for (int x = 1; x < w; x++) {
              ra = (d[x] + ra) & 0xFFFF;
              out[x] = uint16_t(ra);
            }
          } else {
            int64_t rb = prev[0], ra = (d[0] + rb) & 0xFFFF, rc;
            out[0] = uint16_t(ra);
            for (int x = 1; x < w; x++) {
              rc = rb;
              rb = prev[x];
              int64_t p;
              switch (psv) {
                case 2: p = rb; break;
                case 3: p = rc; break;
                case 4: p = ra + rb - rc; break;
                case 5: p = ra + ((rb - rc) >> 1); break;
                case 6: p = rb + ((ra - rc) >> 1); break;
                default: p = (ra + rb) >> 1; break;
              }
              ra = (d[x] + p) & 0xFFFF;
              out[x] = uint16_t(ra);
            }
          }
          std::memcpy(c.last_row.data(), out, size_t(w) * 2);
          uint8_t* o = &c.samples[size_t(r * c.v + y) * w];
          for (int x = 0; x < w; x++) o[x] = uint8_t(unsigned(out[x]) << Al);
        }
      }
      first_row = false;
    }
  }

  // Decodes one scan; returns true when it was a sequential scan that held
  // every component (the image is then complete).
  bool decode_scan() {
    int len = word();
    int ns = byte();
    if (len != ns * 2 + 6 || ns < 1 || ns > 4) throw Invalid{"bad SOS"};
    std::vector<int> sc(static_cast<size_t>(ns));
    int td[4], ta[4];
    for (int i = 0; i < ns; i++) {
      int cid = byte(), t = byte();
      int ci = -1;
      for (size_t k = 0; k < comps.size(); k++)
        if (comps[k].id == cid) ci = int(k);
      if (ci < 0) throw Invalid{"bad component id in SOS"};
      for (int j = 0; j < i; j++)
        if (sc[size_t(j)] == ci) throw Invalid{"bad component id in SOS"};
      sc[size_t(i)] = ci;
      td[i] = t >> 4;
      ta[i] = t & 15;
    }
    const int Ss = byte(), Se = byte(), AhAl = byte();
    const int Ah = AhAl >> 4, Al = AhAl & 15;
    if (lossless) {  // jdlossls.c start_pass_lossless, jdlhuff.c
      if (Ss < 1 || Ss > 7 || Se != 0 || Ah != 0 || Al >= precision)
        throw Invalid{"bad lossless scan parameters"};
      Derived dct[4];
      for (int i = 0; i < ns; i++) {
        if (td[i] > 3) throw Invalid{"bad Huffman table index"};
        // jdlhuff.c installs no standard tables (jdhuff.c's Motion-JPEG
        // fallback): a table the file does not define is an error
        const HuffSpec& spec = dc_spec[td[i]];
        if (!spec.defined) throw Invalid{"missing Huffman table"};
        derive(spec, true, &dct[i], 16);
      }
      BitReader br{d, n, pos};
      br.file = file;
      decode_lossless(br, sc, dct, Ss, Al);
      pos = br.pos;
      unread_marker = br.marker;
      lossless_scanned.resize(comps.size());
      for (int i = 0; i < ns; i++)
        lossless_scanned[size_t(sc[size_t(i)])] = true;
      return ns == int(comps.size());
    }
    if (progressive) {  // jdphuff.c / jdarith.c start_pass
      bool bad = Ss == 0 ? Se != 0 : (Ss > Se || Se > 63 || ns != 1);
      if ((Ah != 0 && Al != Ah - 1) || Al > 13) bad = true;
      if (bad) throw Invalid{"bad progression parameters"};
      scans++;
      for (int i = 0; i < ns; i++) {  // inconsistent scans are only warnings
        auto& cur = coef_bits[size_t(sc[size_t(i)])];
        auto& prev = prev_coef_bits[size_t(sc[size_t(i)])];
        for (int k = std::min(Ss, 1); k <= std::max(Se, 9); k++)
          prev[size_t(k)] = scans > 1 ? cur[size_t(k)] : 0;
        for (int k = Ss; k <= Se; k++) cur[size_t(k)] = Al;
      }
    }
    Derived dct[4], act[4];
    for (int i = 0; i < ns; i++) {
      for (int k = 0; k < 2 && !arith; k++) {
        // a progressive DC scan reads no AC table, a DC refinement none
        // (jdphuff.c checks only the tables a scan reads)
        if (progressive && (k ? Ss == 0 : (Ss != 0 || Ah != 0))) continue;
        int no = k ? ta[i] : td[i];
        if (no > 3) throw Invalid{"bad Huffman table index"};
        HuffSpec spec = k ? ac_spec[no] : dc_spec[no];
        // jdhuff.c's std_huff_tables (Motion-JPEG): sequential files only,
        // jdphuff.c installs none
        if (!spec.defined) {
          if (no > 1 || progressive) throw Invalid{"missing Huffman table"};
          if (k)
            std_spec(&spec, no ? kStdAcChroma : kStdAcLuma, 178);
          else
            std_spec(&spec, no ? kStdDcChroma : kStdDcLuma, 28);
        }
        derive(spec, k == 0, k ? &act[i] : &dct[i]);
      }
      Component& c = comps[size_t(sc[size_t(i)])];
      if (!c.latched) {  // jdinput.c latch_quant_tables
        if (c.tq > 3 || !qt_defined[c.tq]) throw Invalid{"missing DQT"};
        std::memcpy(c.quant, qt[c.tq], sizeof(c.quant));
        c.latched = true;
      }
    }
    if (arith) {
      ArithReader ar{d, n, pos};
      ar.file = file;
      decode_arith(ar, sc, td, ta, Ss, Se, Ah, Al);
      pos = ar.pos;
      unread_marker = ar.marker;
      return !progressive && ns == int(comps.size());
    }
    BitReader br{d, n, pos};
    br.file = file;
    int last_dc[4] = {0, 0, 0, 0};
    unsigned eobrun = 0;
    int next_rst = 0, to_go = restart_interval;
    auto restart = [&]() {
      if (restart_interval) {
        if (to_go == 0) {
          process_restart(br, &next_rst, last_dc, ns, &eobrun);
          to_go = restart_interval;
        }
        to_go--;
      }
    };
    if (progressive) {
      decode_progressive(br, sc, dct, act, Ss, Se, Ah, Al, last_dc, &eobrun,
                         restart);
      pos = br.pos;
      unread_marker = br.marker;
      return false;
    }
    auto block = [&](int i, Component& c, int by, int bx) {
      int16_t* blk = &c.coef[(size_t(by) * c.bw + bx) * 64];
      int s = br.decode(dct[i]);
      if (s) s = extend(br.get(s), s);
      last_dc[i] = int(unsigned(s) + unsigned(last_dc[i]));
      blk[0] = int16_t(last_dc[i]);
      for (int k = 1; k < 64; k++) {
        int rs = br.decode(act[i]);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = int16_t(extend(br.get(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    };
    if (ns == 1) {  // non-interleaved: one block per MCU, over the real ones
      Component& c = comps[size_t(sc[0])];
      for (int by = 0; by < c.hib; by++)
        for (int bx = 0; bx < c.wib; bx++) {
          restart();
          if (!br.insufficient) block(0, c, by, bx);
        }
    } else {
      for (int my = 0; my < mcus_y; my++)
        for (int mx = 0; mx < mcus_x; mx++) {
          restart();
          if (br.insufficient) continue;
          for (int i = 0; i < ns; i++) {
            Component& c = comps[size_t(sc[size_t(i)])];
            for (int y = 0; y < c.v; y++)
              for (int x = 0; x < c.h; x++)
                block(i, c, my * c.v + y, mx * c.h + x);
          }
        }
    }
    pos = br.pos;
    unread_marker = br.marker;
    return ns == int(comps.size());
  }

  // jdcoefct.c smoothing_ok: libjpeg-turbo block-smooths a progressive
  // image whose first nine AC coefficients are not all known to full
  // precision (a file cut short). Latches coef_bits[0..9] of each component
  // (rows 0..9) and those from before its latest scan (rows 10..19).
  bool smoothing_ok(std::vector<std::array<int, 20>>* latch) const {
    if (!progressive) return false;
    bool useful = false;
    latch->assign(comps.size(), {});
    for (size_t ci = 0; ci < comps.size(); ci++) {
      const Component& c = comps[ci];
      if (!c.latched) return false;
      for (int k : kSmoothPos)
        if (c.quant[k] == 0) return false;
      if (coef_bits[ci][0] < 0) return false;
      (*latch)[ci][0] = coef_bits[ci][0];
      for (int k = 1; k < 10; k++) {
        (*latch)[ci][size_t(10 + k)] =
            scans > 1 ? prev_coef_bits[ci][size_t(k)] : -1;
        (*latch)[ci][size_t(k)] = coef_bits[ci][size_t(k)];
        if (coef_bits[ci][size_t(k)] != 0) useful = true;
      }
    }
    return useful;
  }
};

inline int16_t wrap16(int64_t x) { return int16_t(uint16_t(x)); }
inline int16_t sat16(int64_t x) {
  return int16_t(x < -32768 ? -32768 : x > 32767 ? 32767 : x);
}

// One 1-D stage of libjpeg-turbo's SIMD islow IDCT (jidctint-sse2 / -avx2,
// the code OpenCV's libjpeg-turbo runs on x86-64): jidctint.c's
// arithmetic, except that in0 +- in4, in7 + in3 and in5 + in1 are 16-bit
// sums (they wrap) and the products go through pmaddwd pairs; 8 outputs
// scaled by 2^13 (32-bit, as the SIMD keeps them).
void idct_1d(const int16_t* in, int64_t* out) {
  const int64_t in0 = in[0], in1 = in[1], in2 = in[2], in3 = in[3],
                in4 = in[4], in5 = in[5], in6 = in[6], in7 = in[7];
  const int64_t tmp0 = int64_t(wrap16(in0 + in4)) * (1 << kConstBits);
  const int64_t tmp1 = int64_t(wrap16(in0 - in4)) * (1 << kConstBits);
  const int64_t tmp3 = in2 * (F0_541 + F0_765) + in6 * F0_541;
  const int64_t tmp2 = in2 * F0_541 + in6 * (F0_541 - F1_847);
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const int64_t z3 = wrap16(in7 + in3), z4 = wrap16(in5 + in1);
  const int64_t z3s = z3 * (F1_175 - F1_961) + z4 * F1_175;
  const int64_t z4s = z3 * F1_175 + z4 * (F1_175 - F0_390);
  const int64_t o0 = in7 * (F0_298 - F0_899) + in1 * -F0_899 + z3s;
  const int64_t o1 = in5 * (F2_053 - F2_562) + in3 * -F2_562 + z4s;
  const int64_t o2 = in5 * -F2_562 + in3 * (F3_072 - F2_562) + z3s;
  const int64_t o3 = in7 * -F0_899 + in1 * (F1_501 - F0_899) + z4s;
  out[0] = tmp10 + o3;
  out[7] = tmp10 - o3;
  out[1] = tmp11 + o2;
  out[6] = tmp11 - o2;
  out[2] = tmp12 + o1;
  out[5] = tmp12 - o1;
  out[3] = tmp13 + o0;
  out[4] = tmp13 - o0;
}

// libjpeg-turbo's SIMD islow IDCT of one block into 8 rows of `stride`
// samples: 16-bit dequantisation (pmullw), columns, a saturating pack to
// 16 bits, rows, saturating packs to 16 and 8 bits, plus 128. A block whose
// rows 1-7 are all zero takes the DC-only shortcut (each column's
// dequantised row-0 value shifted left by 2 in 16 bits). For the values a
// real image gives this is jidctint.c's result; it differs only where a
// damaged stream's coefficients overflow 16 bits.
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int16_t deq[64], ws[64];
  bool ac = false;
  for (int i = 0; i < 64; i++) {
    deq[i] = wrap16(int64_t(in[i]) * int16_t(q[i]));
    if (i >= 8 && in[i]) ac = true;
  }
  int64_t res[8];
  if (!ac) {
    for (int c = 0; c < 8; c++) {
      const int16_t v = wrap16(int64_t(deq[c]) * (1 << kPass1Bits));
      for (int r = 0; r < 8; r++) ws[8 * r + c] = v;
    }
  } else {
    int16_t col[8];
    for (int c = 0; c < 8; c++) {
      for (int r = 0; r < 8; r++) col[r] = deq[8 * r + c];
      idct_1d(col, res);
      for (int r = 0; r < 8; r++)
        ws[8 * r + c] = sat16(descale(res[r], kConstBits - kPass1Bits));
    }
  }
  for (int r = 0; r < 8; r++) {
    idct_1d(ws + 8 * r, res);
    uint8_t* o = out + size_t(r) * stride;
    for (int c = 0; c < 8; c++) {
      int64_t x = sat16(descale(res[c], kConstBits + kPass1Bits + 3));
      o[c] = uint8_t((x < -128 ? -128 : x > 127 ? 127 : x) + 128);
    }
  }
}

// A component's samples after the IDCT: bh*8 rows of bw*8.
struct Plane {
  int w = 0, h = 0;
  std::vector<uint8_t> px;
};

Plane idct_plane(const Component& c) {
  Plane p;
  p.w = c.bw * 8;
  p.h = c.bh * 8;
  p.px.assign(size_t(p.w) * p.h, 0);
  for (int by = 0; by < c.bh; by++)
    for (int bx = 0; bx < c.bw; bx++)
      idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], c.quant,
                 &p.px[size_t(by) * 8 * p.w + size_t(bx) * 8], p.w);
  return p;
}

// jdcoefct.c decompress_smooth_data: a component's samples with its blocks'
// missing low-frequency coefficients estimated from the DC values of the 5x5
// blocks around each (libjpeg-turbo 2.1 and later). `latch` is the
// component's row of Decoder::smoothing_ok; iMCU rows after
// `last_good_row` use the bits from before the latest scan.
Plane idct_plane_smoothed(const Component& c, const std::array<int, 20>& latch,
                          int imcu_rows, int last_good_row) {
  Plane p;
  p.w = c.bw * 8;
  p.h = c.bh * 8;
  p.px.assign(size_t(p.w) * p.h, 0);
  const uint16_t* q = c.quant;
  const int64_t Q00 = q[0], Q01 = q[1], Q10 = q[8], Q20 = q[16], Q11 = q[9],
                Q02 = q[2], Q03 = q[3], Q12 = q[10], Q21 = q[17], Q30 = q[24];
  auto dc = [&](int by, int bx) {
    return int64_t(c.coef[(size_t(by) * c.bw + bx) * 64]);
  };
  // One estimate: the coefficient in quantiser units, its magnitude held
  // under 2^Al when Al > 0.
  auto estimate = [](int64_t qk, int64_t num, int Al) {
    int64_t pred = ((qk << 7) + (num >= 0 ? num : -num)) / (qk << 8);
    if (Al > 0 && pred >= (int64_t(1) << Al)) pred = (int64_t(1) << Al) - 1;
    return int16_t(num >= 0 ? pred : -pred);
  };
  const int last_col = c.wib - 1;
  for (int r = 0; r < imcu_rows; r++) {
    int block_rows = c.v;
    if (r == imcu_rows - 1) {
      block_rows = c.hib % c.v;
      if (block_rows == 0) block_rows = c.v;
    }
    const int* bits = r > last_good_row ? &latch[10] : &latch[0];
    bool change_dc = true;
    for (int k = 1; k < 10; k++) change_dc = change_dc && bits[k] == -1;
    const int image_rows = block_rows * imcu_rows;
    for (int k = 0; k < block_rows; k++) {
      const int row = r * c.v + k, image_row = r * block_rows + k;
      const int prev = image_row > 0 ? row - 1 : row;
      const int prev2 = image_row > 1 ? row - 2 : prev;
      const int next = image_row < image_rows - 1 ? row + 1 : row;
      const int next2 = image_row < image_rows - 2 ? row + 2 : next;
      const int rows5[5] = {prev2, prev, row, next, next2};
      int64_t D[5][5];  // D[i][j]: DC01..DC25, row i, column j
      for (int i = 0; i < 5; i++) {
        D[i][0] = D[i][1] = D[i][2] = D[i][3] = D[i][4] = dc(rows5[i], 0);
      }
      for (int bx = 0; bx <= last_col; bx++) {
        if (bx == 0 && bx < last_col)
          for (int i = 0; i < 5; i++) D[i][3] = D[i][4] = dc(rows5[i], 1);
        if (bx + 1 < last_col)
          for (int i = 0; i < 5; i++) D[i][4] = dc(rows5[i], bx + 2);
        int16_t ws[64];
        std::memcpy(ws, &c.coef[(size_t(row) * c.bw + bx) * 64], sizeof(ws));
#define DC(n) D[((n) - 1) / 5][((n) - 1) % 5]
        int Al;
        if ((Al = bits[1]) != 0 && ws[1] == 0) {  // AC01
          int64_t num = Q00 * (change_dc
              ? (-DC(1) - DC(2) + DC(4) + DC(5) - 3 * DC(6) + 13 * DC(7) -
                 13 * DC(9) + 3 * DC(10) - 3 * DC(11) + 38 * DC(12) -
                 38 * DC(14) + 3 * DC(15) - 3 * DC(16) + 13 * DC(17) -
                 13 * DC(19) + 3 * DC(20) - DC(21) - DC(22) + DC(24) +
                 DC(25))
              : (-7 * DC(11) + 50 * DC(12) - 50 * DC(14) + 7 * DC(15)));
          ws[1] = estimate(Q01, num, Al);
        }
        if ((Al = bits[2]) != 0 && ws[8] == 0) {  // AC10
          int64_t num = Q00 * (change_dc
              ? (-DC(1) - 3 * DC(2) - 3 * DC(3) - 3 * DC(4) - DC(5) - DC(6) +
                 13 * DC(7) + 38 * DC(8) + 13 * DC(9) - DC(10) + DC(16) -
                 13 * DC(17) - 38 * DC(18) - 13 * DC(19) + DC(20) + DC(21) +
                 3 * DC(22) + 3 * DC(23) + 3 * DC(24) + DC(25))
              : (-7 * DC(3) + 50 * DC(8) - 50 * DC(18) + 7 * DC(23)));
          ws[8] = estimate(Q10, num, Al);
        }
        if ((Al = bits[3]) != 0 && ws[16] == 0) {  // AC20
          int64_t num = Q00 * (change_dc
              ? (DC(3) + 2 * DC(7) + 7 * DC(8) + 2 * DC(9) - 5 * DC(12) -
                 14 * DC(13) - 5 * DC(14) + 2 * DC(17) + 7 * DC(18) +
                 2 * DC(19) + DC(23))
              : (-DC(3) + 13 * DC(8) - 24 * DC(13) + 13 * DC(18) - DC(23)));
          ws[16] = estimate(Q20, num, Al);
        }
        if ((Al = bits[4]) != 0 && ws[9] == 0) {  // AC11
          int64_t num = Q00 * (change_dc
              ? (-DC(1) + DC(5) + 9 * DC(7) - 9 * DC(9) - 9 * DC(17) +
                 9 * DC(19) + DC(21) - DC(25))
              : (DC(10) + DC(16) - 10 * DC(17) + 10 * DC(19) - DC(2) -
                 DC(20) + DC(22) - DC(24) + DC(4) - DC(6) + 10 * DC(7) -
                 10 * DC(9)));
          ws[9] = estimate(Q11, num, Al);
        }
        if ((Al = bits[5]) != 0 && ws[2] == 0) {  // AC02
          int64_t num = Q00 * (change_dc
              ? (2 * DC(7) - 5 * DC(8) + 2 * DC(9) + DC(11) + 7 * DC(12) -
                 14 * DC(13) + 7 * DC(14) + DC(15) + 2 * DC(17) - 5 * DC(18) +
                 2 * DC(19))
              : (-DC(11) + 13 * DC(12) - 24 * DC(13) + 13 * DC(14) - DC(15)));
          ws[2] = estimate(Q02, num, Al);
        }
        if (change_dc) {
          if ((Al = bits[6]) != 0 && ws[3] == 0)  // AC03
            ws[3] = estimate(Q03, Q00 * (DC(7) - DC(9) + 2 * DC(12) -
                                         2 * DC(14) + DC(17) - DC(19)), Al);
          if ((Al = bits[7]) != 0 && ws[10] == 0)  // AC12
            ws[10] = estimate(Q12, Q00 * (DC(7) - 3 * DC(8) + DC(9) - DC(17) +
                                          3 * DC(18) - DC(19)), Al);
          if ((Al = bits[8]) != 0 && ws[17] == 0)  // AC21
            ws[17] = estimate(Q21, Q00 * (DC(7) - DC(9) - 3 * DC(12) +
                                          3 * DC(14) + DC(17) - DC(19)), Al);
          if ((Al = bits[9]) != 0 && ws[24] == 0)  // AC30
            ws[24] = estimate(Q30, Q00 * (DC(7) + 2 * DC(8) + DC(9) - DC(17) -
                                          2 * DC(18) - DC(19)), Al);
          ws[0] = estimate(Q00, Q00 * (
              -2 * DC(1) - 6 * DC(2) - 8 * DC(3) - 6 * DC(4) - 2 * DC(5) -
              6 * DC(6) + 6 * DC(7) + 42 * DC(8) + 6 * DC(9) - 6 * DC(10) -
              8 * DC(11) + 42 * DC(12) + 152 * DC(13) + 42 * DC(14) -
              8 * DC(15) - 6 * DC(16) + 6 * DC(17) + 42 * DC(18) +
              6 * DC(19) - 6 * DC(20) - 2 * DC(21) - 6 * DC(22) -
              8 * DC(23) - 6 * DC(24) - 2 * DC(25)), 0);
        }
#undef DC
        idct_islow(ws, q, &p.px[size_t(row) * 8 * p.w + size_t(bx) * 8], p.w);
        for (int i = 0; i < 5; i++)
          for (int j = 0; j < 4; j++) D[i][j] = D[i][j + 1];
      }
    }
  }
  return p;
}

// jdsample.c: a component's plane upsampled to width x height; without
// `fancy` (lossless: a data unit of one sample) by replication only.
std::vector<uint8_t> upsample(const Component& c, const Plane& p, int max_h,
                              int max_v, int width, int height, bool fancy) {
  std::vector<uint8_t> out(size_t(width) * height);
  const int dw = c.dw, dh = c.dh;
  auto row = [&](int y) {  // jdmainct.c context rows: the real ones repeat
    y = y < 0 ? 0 : y >= dh ? dh - 1 : y;
    return &p.px[size_t(y) * p.w];
  };
  if (c.h == max_h && c.v == max_v) {
    for (int y = 0; y < height; y++)
      std::memcpy(&out[size_t(y) * width], &p.px[size_t(y) * p.w],
                  size_t(width));
  } else if (fancy && 2 * c.h == max_h && c.v == max_v && dw > 2) {  // h2v1
    std::vector<uint8_t> line(static_cast<size_t>(2 * dw));
    for (int y = 0; y < height; y++) {
      const uint8_t* in = &p.px[size_t(y) * p.w];
      uint8_t* o = line.data();
      o[0] = in[0];
      o[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; i++) {
        int v = in[i] * 3;
        o[2 * i] = uint8_t((v + in[i - 1] + 1) >> 2);
        o[2 * i + 1] = uint8_t((v + in[i + 1] + 2) >> 2);
      }
      o[2 * dw - 2] = uint8_t((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
      o[2 * dw - 1] = in[dw - 1];
      std::memcpy(&out[size_t(y) * width], o, size_t(width));
    }
  } else if (fancy && c.h == max_h && 2 * c.v == max_v) {  // h1v2 fancy
    for (int y = 0; y < height; y++) {
      int k = y >> 1;
      const uint8_t* in0 = row(k);
      const uint8_t* in1 = row(y & 1 ? k + 1 : k - 1);
      int bias = y & 1 ? 2 : 1;
      uint8_t* o = &out[size_t(y) * width];
      for (int x = 0; x < width; x++)
        o[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
    }
  } else if (fancy && 2 * c.h == max_h && 2 * c.v == max_v && dw > 2) {
    std::vector<int> sum(static_cast<size_t>(dw));
    std::vector<uint8_t> line(static_cast<size_t>(2 * dw));
    for (int y = 0; y < height; y++) {
      int k = y >> 1;
      const uint8_t* in0 = row(k);
      const uint8_t* in1 = row(y & 1 ? k + 1 : k - 1);
      for (int i = 0; i < dw; i++) sum[size_t(i)] = in0[i] * 3 + in1[i];
      uint8_t* o = line.data();
      o[0] = uint8_t((sum[0] * 4 + 8) >> 4);
      o[1] = uint8_t((sum[0] * 3 + sum[1] + 7) >> 4);
      for (int i = 1; i < dw - 1; i++) {
        o[2 * i] = uint8_t((sum[size_t(i)] * 3 + sum[size_t(i - 1)] + 8) >> 4);
        o[2 * i + 1] =
            uint8_t((sum[size_t(i)] * 3 + sum[size_t(i + 1)] + 7) >> 4);
      }
      o[2 * dw - 2] =
          uint8_t((sum[size_t(dw - 1)] * 3 + sum[size_t(dw - 2)] + 8) >> 4);
      o[2 * dw - 1] = uint8_t((sum[size_t(dw - 1)] * 4 + 7) >> 4);
      std::memcpy(&out[size_t(y) * width], o, size_t(width));
    }
  } else if (max_h % c.h == 0 && max_v % c.v == 0) {  // box (int_upsample)
    int hx = max_h / c.h, vx = max_v / c.v;
    for (int y = 0; y < height; y++) {
      const uint8_t* in = &p.px[size_t(y / vx) * p.w];
      uint8_t* o = &out[size_t(y) * width];
      for (int x = 0; x < width; x++) o[x] = in[x / hx];
    }
  } else {
    throw Invalid{"fractional sampling ratio"};
  }
  return out;
}

inline uint8_t clamp255(int x) {
  return uint8_t(x < 0 ? 0 : x > 255 ? 255 : x);
}

// mode: 0 = as the file is (grey 1 channel, colour BGR), 1 = grey (libjpeg
// JCS_GRAYSCALE; OpenCV's own conversion for CMYK), 2 = BGR, 3 = the
// components as they are, upsampled (libtiff's JCS_UNKNOWN), 4 = BGR from
// YCbCr whatever the markers say (libtiff's JPEGCOLORMODE_RGB). `file`: the
// bytes are a file read as cv2.imread reads it (past_end). *exif_off and
// *exif_len locate the TIFF body of the file's Exif APP1 (length 0: none).
std::vector<uint8_t> decode(const uint8_t* data, size_t size, int mode,
                            bool file, int* out_h, int* out_w, int* out_c,
                            size_t* exif_off, size_t* exif_len) {
  Decoder dec;
  dec.d = data;
  dec.n = size;
  dec.file = file;
  if (size < 2 || data[0] != 0xFF || data[1] != 0xD8)
    throw Invalid{"not a JPEG (no SOI)"};
  dec.pos = 2;
  if (!dec.read_markers()) throw Invalid{"JPEG without an image"};
  // jpeg_read_header has read the frame: OpenCV's size check comes next
  if (dec.width > (1 << 20) || dec.height > (1 << 20) ||
      int64_t(dec.width) * dec.height > (int64_t(1) << 30))
    throw TooLarge{dec.height, dec.width};
  // Several scans (progressive, or sequential ones that each hold some of
  // the components): read them all, up to EOI.
  if (!dec.decode_scan()) {
    while (dec.read_markers()) dec.decode_scan();
    for (bool held : dec.lossless_scanned)  // EOI before a component's scan
      if (!held) throw Invalid{"Bogus virtual array access"};
  }
  *exif_off = dec.exif_off;
  *exif_len = dec.exif_len;
  const int nc = int(dec.comps.size());
  // jdapimin.c default_decompress_parms: the colour space of 3 components
  // (a JFIF marker, then an Adobe marker, then the component ids decide);
  // 4 components are YCCK only under an Adobe marker whose transform is not
  // 0, else CMYK.
  bool rgb = false;
  if (nc == 3 && !dec.saw_jfif && mode != 4) {
    if (dec.saw_adobe)
      rgb = dec.adobe_transform == 0;
    else
      rgb = dec.comps[0].id == 82 && dec.comps[1].id == 71 &&
            dec.comps[2].id == 66;  // 'R', 'G', 'B'
  }
  const bool ycck = nc == 4 && dec.saw_adobe && dec.adobe_transform != 0;
  const int W = dec.width, H = dec.height;
  if (mode == 4 && nc != 3) throw Invalid{"YCbCr JPEG without 3 components"};
  if (dec.lossless) {
    // jdcolor.c: libjpeg does no lossy colour conversion of a lossless
    // image, only grey, RGB (to BGR) and CMYK as they are
    const bool ok = mode == 3 || (mode != 4 && (
        (nc == 1 && mode != 2) || (nc == 3 && rgb && mode != 1) ||
        (nc == 4 && !ycck)));
    if (!ok) throw Invalid{"lossless JPEG needs a colour conversion"};
  }
  if (mode == 3) rgb = nc == 3;  // the planes as they are
  int channels = mode == 1 ? 1 : (mode == 2 || mode == 4) ? 3
               : mode == 3 ? nc : (nc == 1 ? 1 : 3);
  const bool gray_only = nc == 1 || (channels == 1 && nc == 3 && !rgb);
  std::vector<std::array<int, 20>> latch;
  const bool smooth = dec.smoothing_ok(&latch);
  std::vector<uint8_t> out(size_t(W) * H * channels);
  *out_h = H;
  *out_w = W;
  *out_c = channels;
  std::vector<std::vector<uint8_t>> planes(static_cast<size_t>(nc));
  for (int i = 0; i < (gray_only ? 1 : nc); i++) {
    const Component& c = dec.comps[size_t(i)];
    Plane p;
    if (dec.lossless) {
      p.w = c.wib;
      p.h = c.hib;
      p.px = c.samples;
    } else {
      p = smooth ? idct_plane_smoothed(c, latch[size_t(i)], dec.mcus_y,
                                       dec.last_good_imcu_row)
                 : idct_plane(c);
    }
    planes[size_t(i)] = upsample(c, p, dec.max_h, dec.max_v, W, H,
                                 !dec.lossless);
  }
  const size_t npx = size_t(W) * H;
  if (gray_only) {
    const uint8_t* y = planes[0].data();
    if (channels == 1) {
      std::memcpy(out.data(), y, npx);
    } else {
      for (size_t i = 0; i < npx; i++)
        out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
    }
    return out;
  }
  if (mode == 3) {  // interleaved in the file's order
    for (size_t i = 0; i < npx; i++)
      for (int k = 0; k < nc; k++)
        out[size_t(nc) * i + size_t(k)] = planes[size_t(k)][i];
    return out;
  }
  const uint8_t *p0 = planes[0].data(), *p1 = planes[1].data(),
                *p2 = planes[2].data();
  constexpr int kScale = 16;
  constexpr int64_t kHalf = int64_t(1) << (kScale - 1);
  auto fix = [](double x) { return int64_t(x * (1 << kScale) + 0.5); };
  if (rgb) {
    if (channels == 1) {  // jdcolor.c rgb_gray_convert
      const int64_t ry = fix(0.29900), gy = fix(0.58700), by = fix(0.11400);
      for (size_t i = 0; i < npx; i++)
        out[i] = uint8_t((ry * p0[i] + gy * p1[i] + by * p2[i] + kHalf) >>
                         kScale);
    } else {
      for (size_t i = 0; i < npx; i++) {
        out[3 * i] = p2[i];
        out[3 * i + 1] = p1[i];
        out[3 * i + 2] = p0[i];
      }
    }
    return out;
  }
  // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0, x = -128; i < 256; i++, x++) {
    cr_r[i] = int((fix(1.40200) * x + kHalf) >> kScale);
    cb_b[i] = int((fix(1.77200) * x + kHalf) >> kScale);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + kHalf;
  }
  if (nc == 4) {
    // libjpeg's JCS_CMYK output (jdcolor.c ycck_cmyk_convert for YCCK, the
    // planes as they are for CMYK), then OpenCV's icvCvt_CMYK2BGR_8u_C4C3R
    // or icvCvt_CMYK2Gray_8u_C4C1R (utils.cpp), not libjpeg's conversion.
    const uint8_t* p3 = planes[3].data();
    constexpr int kGrayShift = 14;
    const int gr = int(0.299 * (1 << kGrayShift) + 0.5),
              gg = int(0.587 * (1 << kGrayShift) + 0.5),
              gb = int(0.114 * (1 << kGrayShift) + 0.5);
    for (size_t i = 0; i < npx; i++) {
      int c = p0[i], m = p1[i], y = p2[i], k = p3[i];
      if (ycck) {
        const int yy = p0[i], cb = p1[i], cr = p2[i];
        c = clamp255(255 - (yy + cr_r[cr]));
        m = clamp255(255 - (yy + int((cb_g[cb] + cr_g[cr]) >> kScale)));
        y = clamp255(255 - (yy + cb_b[cb]));
      }
      c = k - ((255 - c) * k >> 8);
      m = k - ((255 - m) * k >> 8);
      y = k - ((255 - y) * k >> 8);
      if (channels == 1) {
        out[i] = uint8_t((y * gb + m * gg + c * gr + (1 << (kGrayShift - 1)))
                         >> kGrayShift);
      } else {
        out[3 * i] = uint8_t(y);
        out[3 * i + 1] = uint8_t(m);
        out[3 * i + 2] = uint8_t(c);
      }
    }
    return out;
  }
  for (size_t i = 0; i < npx; i++) {
    int y = p0[i], cb = p1[i], cr = p2[i];
    out[3 * i + 2] = clamp255(y + cr_r[cr]);
    out[3 * i + 1] = clamp255(y + int((cb_g[cb] + cr_g[cr]) >> kScale));
    out[3 * i] = clamp255(y + cb_b[cb]);
  }
  return out;
}

// ------------------------------------------------------------------------
// Encoder

// jcdctmgr.c compute_reciprocal for the islow divisor (quantval << 3).
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(int divisor) {
  int b = 31 - __builtin_clz(unsigned(divisor));
  int r = 16 + b;
  uint64_t fq = (uint64_t(1) << r) / unsigned(divisor);
  uint64_t fr = (uint64_t(1) << r) % unsigned(divisor);
  uint32_t c = unsigned(divisor) / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= unsigned(divisor) / 2) {
    c++;
  } else {
    fq++;
  }
  return Divisor{uint32_t(fq), c, r};
}

// jfdctint.c's 1-D stage on 8 samples: outputs 0 and 4 unscaled, the
// rest scaled by 2^13.
void fdct_1d(const int64_t* in, int64_t* out) {
  int64_t tmp0 = in[0] + in[7], tmp7 = in[0] - in[7];
  int64_t tmp1 = in[1] + in[6], tmp6 = in[1] - in[6];
  int64_t tmp2 = in[2] + in[5], tmp5 = in[2] - in[5];
  int64_t tmp3 = in[3] + in[4], tmp4 = in[3] - in[4];
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  out[0] = tmp10 + tmp11;
  out[4] = tmp10 - tmp11;
  int64_t z1 = (tmp12 + tmp13) * F0_541;
  out[2] = z1 + tmp13 * F0_765;
  out[6] = z1 + tmp12 * -F1_847;
  z1 = tmp4 + tmp7;
  int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
  const int64_t z5 = (z3 + z4) * F1_175;
  tmp4 *= F0_298;
  tmp5 *= F2_053;
  tmp6 *= F3_072;
  tmp7 *= F1_501;
  z1 *= -F0_899;
  z2 *= -F2_562;
  z3 = z3 * -F1_961 + z5;
  z4 = z4 * -F0_390 + z5;
  out[7] = tmp4 + z1 + z3;
  out[5] = tmp5 + z2 + z4;
  out[3] = tmp6 + z2 + z3;
  out[1] = tmp7 + z1 + z4;
}

// jfdctint.c islow FDCT, in place: rows, then columns; output scaled up
// by 8.
void fdct_islow(int* d) {
  int64_t v[8], res[8];
  for (int r = 0; r < 8; r++) {
    for (int c = 0; c < 8; c++) v[c] = d[8 * r + c];
    fdct_1d(v, res);
    for (int c = 0; c < 8; c++)
      d[8 * r + c] = int(c % 4 == 0 ? res[c] * (1 << kPass1Bits)
                                    : descale(res[c], kConstBits - kPass1Bits));
  }
  for (int c = 0; c < 8; c++) {
    for (int r = 0; r < 8; r++) v[r] = d[8 * r + c];
    fdct_1d(v, res);
    for (int r = 0; r < 8; r++)
      d[8 * r + c] = int(descale(
          res[r], r % 4 == 0 ? kPass1Bits : kConstBits + kPass1Bits));
  }
}

struct EncTable {  // jchuff.c c_derived_tbl
  uint32_t code[256] = {};
  uint8_t size[256] = {};
};

EncTable enc_table(const uint8_t* spec) {
  EncTable t;
  uint32_t code = 0;
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < spec[l - 1]; i++, p++) {
      int sym = spec[16 + p];
      t.code[sym] = code++;
      t.size[sym] = uint8_t(l);
    }
    code <<= 1;
  }
  return t;
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t buf = 0;
  int bits = 0;
  void put(uint32_t code, int size) {
    buf = (buf << size) | code;
    bits += size;
    while (bits >= 8) {
      bits -= 8;
      uint8_t b = uint8_t(buf >> bits);
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
    }
  }
  void flush() {  // fill the partial byte with ones
    if (bits) put((1u << (8 - bits)) - 1, 8 - bits);
  }
};

inline int nbits(int v) { return v ? 32 - __builtin_clz(unsigned(v)) : 0; }

void encode_block(BitWriter& bw, const int* coef, int* last_dc,
                  const EncTable& dc, const EncTable& ac) {
  int temp = coef[0] - *last_dc;
  *last_dc = coef[0];
  int mag = temp < 0 ? -temp : temp;
  int nb = nbits(mag);
  bw.put(dc.code[nb], dc.size[nb]);
  if (nb) bw.put(uint32_t(temp < 0 ? temp - 1 : temp) & ((1u << nb) - 1), nb);
  int run = 0;
  for (int k = 1; k < 64; k++) {
    int v = coef[kNatural[k]];
    if (v == 0) {
      run++;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    mag = v < 0 ? -v : v;
    nb = nbits(mag);
    int sym = (run << 4) + nb;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(uint32_t(v < 0 ? v - 1 : v) & ((1u << nb) - 1), nb);
    run = 0;
  }
  if (run > 0) bw.put(ac.code[0], ac.size[0]);
}

// Forward DCT and quantisation of the 8x8 block at (by, bx) of a padded
// plane (jcdctmgr.c forward_DCT with libjpeg-turbo's quantize()).
void fdct_quant(const std::vector<uint8_t>& plane, int pw, int by, int bx,
                const Divisor* div, int* coef) {
  int ws[64];
  for (int r = 0; r < 8; r++)
    for (int c = 0; c < 8; c++)
      ws[8 * r + c] =
          int(plane[size_t(by * 8 + r) * pw + size_t(bx * 8 + c)]) - 128;
  fdct_islow(ws);
  for (int i = 0; i < 64; i++) {
    int t = ws[i];
    uint64_t a = uint64_t(t < 0 ? -t : t);
    int q = int(((a + div[i].corr) * div[i].recip) >> div[i].shift);
    coef[i] = t < 0 ? -q : q;
  }
}

// Edge replication: `src` (h x w) into a (ph x pw) plane.
std::vector<uint8_t> pad(const uint8_t* src, int h, int w, int ph, int pw) {
  std::vector<uint8_t> out(size_t(ph) * pw);
  for (int y = 0; y < ph; y++) {
    const uint8_t* in = src + size_t(std::min(y, h - 1)) * w;
    uint8_t* o = &out[size_t(y) * pw];
    std::memcpy(o, in, size_t(w));
    std::memset(o + w, in[w - 1], size_t(pw - w));
  }
  return out;
}

void put_marker(std::vector<uint8_t>& out, int m) {
  out.push_back(0xFF);
  out.push_back(uint8_t(m));
}
void put_word(std::vector<uint8_t>& out, int v) {
  out.push_back(uint8_t(v >> 8));
  out.push_back(uint8_t(v & 0xFF));
}

std::vector<uint8_t> encode(const uint8_t* px, int H, int W, int C,
                            int quality) {
  if (H < 1 || W < 1 || H > 65500 || W > 65500)
    throw Invalid{"image size out of JPEG's range"};
  if (C != 1 && C != 3) throw Invalid{"encode takes 1 or 3 channels"};
  // jcparam.c jpeg_quality_scaling + jpeg_add_quant_table (force_baseline)
  quality = std::min(std::max(quality, 1), 100);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  int qt[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) {
      long v = (long((t ? kStdChromaQuant : kStdLumaQuant)[i]) * scale + 50) /
               100;
      qt[t][i] = int(std::min(std::max(v, 1L), 255L));
    }
  Divisor div[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) div[t][i] = reciprocal(qt[t][i] << 3);

  std::vector<uint8_t> out;
  out.reserve(size_t(H) * W * C / 4 + 1024);
  put_marker(out, 0xD8);
  const uint8_t jfif[16] = {0x00, 0x10, 'J', 'F', 'I', 'F', 0x00, 0x01,
                            0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  put_marker(out, 0xE0);
  out.insert(out.end(), jfif, jfif + 16);
  const int ntab = C == 1 ? 1 : 2;
  for (int t = 0; t < ntab; t++) {
    put_marker(out, 0xDB);
    put_word(out, 67);
    out.push_back(uint8_t(t));
    for (int i = 0; i < 64; i++) out.push_back(uint8_t(qt[t][kNatural[i]]));
  }
  put_marker(out, 0xC0);
  put_word(out, 8 + 3 * C);
  out.push_back(8);
  put_word(out, H);
  put_word(out, W);
  out.push_back(uint8_t(C));
  for (int c = 0; c < C; c++) {
    out.push_back(uint8_t(c + 1));
    out.push_back(C == 1 ? 0x11 : c == 0 ? 0x22 : 0x11);
    out.push_back(c == 0 ? 0 : 1);
  }
  const uint8_t* specs[4] = {kStdDcLuma, kStdAcLuma, kStdDcChroma,
                             kStdAcChroma};
  const int spec_len[4] = {28, 178, 28, 178};
  for (int t = 0; t < 2 * ntab; t++) {
    put_marker(out, 0xC4);
    put_word(out, 2 + 1 + spec_len[t]);
    out.push_back(uint8_t((t & 1 ? 0x10 : 0) | (t >> 1)));
    out.insert(out.end(), specs[t], specs[t] + spec_len[t]);
  }
  put_marker(out, 0xDA);
  put_word(out, 6 + 2 * C);
  out.push_back(uint8_t(C));
  for (int c = 0; c < C; c++) {
    out.push_back(uint8_t(c + 1));
    out.push_back(c == 0 ? 0x00 : 0x11);
  }
  out.push_back(0);
  out.push_back(63);
  out.push_back(0);

  EncTable dc[2] = {enc_table(kStdDcLuma), enc_table(kStdDcChroma)};
  EncTable ac[2] = {enc_table(kStdAcLuma), enc_table(kStdAcChroma)};
  BitWriter bw{out};
  int coef[64];
  const int wib = (W + 7) / 8, hib = (H + 7) / 8;
  if (C == 1) {
    std::vector<uint8_t> plane = pad(px, H, W, hib * 8, wib * 8);
    int last = 0;
    for (int by = 0; by < hib; by++)
      for (int bx = 0; bx < wib; bx++) {
        fdct_quant(plane, wib * 8, by, bx, div[0], coef);
        encode_block(bw, coef, &last, dc[0], ac[0]);
      }
  } else {
    // jccolor.c rgb_ycc_convert from BGR
    const size_t npx = size_t(H) * W;
    std::vector<uint8_t> Y(npx), Cb(npx), Cr(npx);
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t(1) << (kScale - 1);
    auto fix = [](double x) { return int64_t(x * (1 << kScale) + 0.5); };
    const int64_t kOff = int64_t(128) << kScale;
    for (size_t i = 0; i < npx; i++) {
      int64_t b = px[3 * i], g = px[3 * i + 1], r = px[3 * i + 2];
      Y[i] = uint8_t((fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b +
                      kHalf) >> kScale);
      Cb[i] = uint8_t((-fix(0.16874) * r - fix(0.33126) * g +
                       fix(0.50000) * b + kOff + kHalf - 1) >> kScale);
      Cr[i] = uint8_t((fix(0.50000) * r - fix(0.41869) * g -
                       fix(0.08131) * b + kOff + kHalf - 1) >> kScale);
    }
    const int mx = (W + 15) / 16, my = (H + 15) / 16;
    std::vector<uint8_t> yp = pad(Y.data(), H, W, hib * 8, wib * 8);
    // jcsample.c h2v2_downsample over the edge-replicated full-size rows,
    // then the last chroma row repeated to the iMCU height.
    const int cw = mx * 8, ch_real = (H + 1) / 2, ch = my * 8;
    std::vector<uint8_t> cplane[2];
    const std::vector<uint8_t>* full[2] = {&Cb, &Cr};
    for (int k = 0; k < 2; k++) {
      std::vector<uint8_t> f = pad(full[k]->data(), H, W, 2 * ch_real, 2 * cw);
      std::vector<uint8_t> ds(size_t(ch_real) * cw);
      for (int y = 0; y < ch_real; y++) {
        const uint8_t* r0 = &f[size_t(2 * y) * 2 * cw];
        const uint8_t* r1 = r0 + 2 * cw;
        int bias = 1;
        for (int x = 0; x < cw; x++) {
          ds[size_t(y) * cw + x] = uint8_t(
              (r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >>
              2);
          bias ^= 3;
        }
      }
      cplane[k] = pad(ds.data(), ch_real, cw, ch, cw);
    }
    int last[3] = {0, 0, 0};
    int mcu[4][64];
    for (int my_i = 0; my_i < my; my_i++)
      for (int mx_i = 0; mx_i < mx; mx_i++) {
        // jccoefct.c compress_data: blocks past the image are dummies, all
        // zero but the DC of the block before them.
        for (int yi = 0; yi < 2; yi++)
          for (int xi = 0; xi < 2; xi++) {
            int by = 2 * my_i + yi, bx = 2 * mx_i + xi;
            int* blk = mcu[2 * yi + xi];
            if (by < hib && bx < wib) {
              fdct_quant(yp, wib * 8, by, bx, div[0], blk);
            } else {
              std::memset(blk, 0, sizeof(mcu[0]));
              blk[0] = by < hib ? mcu[2 * yi + xi - 1][0] : mcu[1][0];
            }
          }
        for (int b = 0; b < 4; b++) encode_block(bw, mcu[b], &last[0], dc[0], ac[0]);
        for (int k = 0; k < 2; k++) {
          fdct_quant(cplane[k], cw, my_i, mx_i, div[1], coef);
          encode_block(bw, coef, &last[1 + k], dc[1], ac[1]);
        }
      }
  }
  bw.flush();
  put_marker(out, 0xD9);
  return out;
}

void set_msg(char* msg, int len, const std::string& s) {
  if (msg && len > 0) {
    std::strncpy(msg, s.c_str(), size_t(len - 1));
    msg[len - 1] = 0;
  }
}

uint8_t* to_malloc(const std::vector<uint8_t>& v) {
  uint8_t* p = static_cast<uint8_t*>(std::malloc(v.size() ? v.size() : 1));
  if (p && !v.empty()) std::memcpy(p, v.data(), v.size());
  return p;
}

}  // namespace

extern "C" {

// Decodes a JPEG, as cv2.imdecode (file 0) or cv2.imread (file 1) does.
// Returns a malloc'd (h, w, c) uint8 buffer (free it with gjpeg_free), or
// NULL with *status 1 (bytes cv2 gives None for), 2 (a variant the codec
// does not read; msg names it) or 3 (a header over cv2's size limits, its
// rows and columns in *h and *w). exif[0] and exif[1] get the offset and
// length of the Exif APP1's TIFF body (length 0 when there is none).
uint8_t* gjpeg_decode(const uint8_t* data, uint64_t size, int mode, int file,
                      int* h, int* w, int* c, uint64_t* exif, int* status,
                      char* msg, int msglen) {
  *status = 0;
  try {
    size_t off = 0, len = 0;
    uint8_t* out = to_malloc(decode(data, size_t(size), mode, file != 0, h,
                                    w, c, &off, &len));
    exif[0] = off;
    exif[1] = len;
    return out;
  } catch (const Invalid& e) {
    *status = 1;
    set_msg(msg, msglen, e.msg);
  } catch (const Unsupported& e) {
    *status = 2;
    set_msg(msg, msglen, e.msg);
  } catch (const TooLarge& e) {
    *status = 3;
    *h = e.h;
    *w = e.w;
  } catch (const std::bad_alloc&) {
    *status = 1;
    set_msg(msg, msglen, "out of memory");
  }
  return nullptr;
}

// Encodes an (h, w) grey or (h, w, 3) BGR uint8 image as cv2.imencode(".jpg")
// does at `quality`. Returns a malloc'd buffer of *size bytes, or NULL.
uint8_t* gjpeg_encode(const uint8_t* px, int h, int w, int c, int quality,
                      uint64_t* size, char* msg, int msglen) {
  try {
    std::vector<uint8_t> out = encode(px, h, w, c, quality);
    *size = out.size();
    return to_malloc(out);
  } catch (const Invalid& e) {
    set_msg(msg, msglen, e.msg);
  } catch (const std::bad_alloc&) {
    set_msg(msg, msglen, "out of memory");
  }
  return nullptr;
}

void gjpeg_free(void* p) { std::free(p); }

}  // extern "C"
