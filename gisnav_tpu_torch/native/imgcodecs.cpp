// Byte coders of the image formats OpenCV reads beside PNG and JPEG, for
// gis/tiff.py, gis/gif.py, gis/bmp.py and gis/hdr.py (bound
// with ctypes in gis/coders.py). Each follows the library OpenCV reads the
// format with: libtiff 4.7 for TIFF's LZW, PackBits and predictors, and
// OpenCV's own decoders for the rest (grfmt_gif.cpp, grfmt_bmp.cpp,
// rgbe.cpp). Decoders write into a caller's buffer and
// return the bytes written, or a negative status on a stream they cannot
// decode:
//   -1  the stream is corrupt (a code not yet in the table, a run past the
//       end of its row or buffer, a short RLE scanline; TIFF's LZW and
//       PackBits: any strip libtiff's decoder fails, the buffer left as
//       that decoder leaves it);
//   -2  the stream ended before the buffer was full (what was decoded
//       stands in the buffer).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kCorrupt = -1;
constexpr int64_t kShort = -2;

// ---- TIFF LZW (tif_lzw.c) ------------------------------------------------
// libtiff 4.7's two decoders, damage included. LZWDecode (new-style
// streams): codes MSB first, 9-12 bits, one more bit once the next free
// entry reaches 2^n - 1 ("early change"); it fills the buffer's rest with
// zeros on an error. LZWDecodeCompat (old-style streams, LZW_COMPAT): codes
// LSB first, one more bit at 2^n; it leaves the buffer's rest as it was.
// Both need a clear code first, refuse a code past the next free entry,
// and take the data's end as the end code; the end code before the buffer
// is full is an error. Which decoder a strip gets is the caller's: libtiff
// picks it on the first strip it decodes and keeps it for the file.
constexpr int kClear = 256, kEoi = 257, kFirst = 258, kMaxCodes = 4096;
constexpr int kCsize = 4095 + 1024;  // libtiff's CSIZE: entries it holds

struct Entry {
  int32_t prefix;  // -1 for a root
  int32_t length;
  uint8_t first, last;
};

int64_t tiff_lzw(const uint8_t* src, uint64_t n, uint8_t* dst, uint64_t cap,
                 bool compat) {
  std::vector<Entry> table(kCsize + 1);
  for (int i = 0; i < 256; ++i) table[i] = {-1, 1, uint8_t(i), uint8_t(i)};
  int width = 9, next = -1, old = -1;  // next -1: no clear code yet
  uint64_t pos = 0, out = 0, acc = 0;
  int nacc = 0;
  auto read = [&](int w) -> int {
    while (nacc < w) {
      if (pos >= n) return kEoi;  // "not terminated with EOI code"
      if (compat)
        acc |= uint64_t(src[pos++]) << nacc;
      else
        acc = (acc << 8) | src[pos++];
      nacc += 8;
    }
    nacc -= w;
    if (compat) {
      const int v = int(acc & ((1u << w) - 1));
      acc >>= w;
      return v;
    }
    const int v = int((acc >> nacc) & ((1u << w) - 1));
    acc &= (uint64_t(1) << nacc) - 1;
    return v;
  };
  auto fail = [&]() -> int64_t {
    if (!compat) std::memset(dst + out, 0, size_t(cap - out));
    return kCorrupt;
  };
  // the first `len` bytes of `code`'s string at dst + out (at most cap)
  auto emit = [&](int code) {
    const int len = table[size_t(code)].length;
    int c = code;
    for (int k = len - 1; k >= 0; --k) {
      if (out + uint64_t(k) < cap)
        dst[out + uint64_t(k)] = table[size_t(c)].last;
      c = table[size_t(c)].prefix;
    }
    out = std::min(cap, out + uint64_t(len));
  };
  const int bump = compat ? 0 : 1;
  while (out < cap) {
    int code = read(width);
    if (code == kEoi) break;
    if (code == kClear) {
      width = 9;
      next = kFirst;
      do {
        code = read(width);
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return fail();
      dst[out++] = uint8_t(code);
      old = code;
      continue;
    }
    if (next < 0 || next >= kCsize) return fail();  // no table yet, or full
    if (code > next) return fail();  // "Using code not yet in table"
    const Entry& o = table[size_t(old)];
    const uint8_t first = code < next ? table[size_t(code)].first : o.first;
    table[size_t(next)] = {old, o.length + 1, o.first, first};
    ++next;
    if (width < 12 && next >= (1 << width) - bump) ++width;
    emit(code);
    old = code;
  }
  if (out < cap) return fail();  // "Not enough data at scanline"
  return int64_t(out);
}

// ---- PackBits (tif_packbits.c) -------------------------------------------
// libtiff 4.7's PackBitsDecode: a literal run the data cannot finish, or a
// replicate code with no byte after it, ends the strip; a short strip is
// an error with the buffer's rest zeroed.
int64_t packbits(const uint8_t* src, uint64_t n, uint8_t* dst, uint64_t cap) {
  uint64_t i = 0, out = 0;
  while (i < n && out < cap) {
    const int8_t b = int8_t(src[i++]);
    if (b < 0) {
      if (b == -128) continue;  // no-op
      uint64_t len = uint64_t(1 - int(b));
      if (out + len > cap) len = cap - out;
      if (i >= n) break;
      std::memset(dst + out, src[i++], size_t(len));
      out += len;
    } else {
      uint64_t len = uint64_t(b) + 1;
      if (out + len > cap) len = cap - out;
      if (n - i < len) break;
      std::memcpy(dst + out, src + i, size_t(len));
      i += len;
      out += len;
    }
  }
  if (out < cap) {
    std::memset(dst + out, 0, size_t(cap - out));
    return kCorrupt;
  }
  return int64_t(out);
}

// ---- ThunderScan (tif_thunder.c) -----------------------------------------
// libtiff 4.7's ThunderDecodeRow: 4-bit pixels, each row its own codes
// (a byte's top 2 bits): a run of the last pixel (6-bit count), three 2-bit
// or two 3-bit deltas from it (2 and 4 skip), or a raw pixel. A row that
// ends short or long has its rest zeroed and fails the strip, which keeps
// the rows before it. libtiff's quirks stand: a run that passes the row's
// end writes nothing; one starting on an odd pixel repeats the byte it
// completed.
int64_t thunder(const uint8_t* src, uint64_t n, uint8_t* dst, uint64_t rows,
                uint64_t width) {
  static const int two[4] = {0, 1, 0, -1};
  static const int three[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  const uint64_t scanline = (width + 1) / 2;
  uint64_t pos = 0;
  for (uint64_t r = 0; r < rows; ++r) {
    uint8_t* const op0 = dst + r * scanline;
    uint8_t* op = op0;
    unsigned lastpixel = 0;
    int64_t npixels = 0;
    const int64_t maxpixels = int64_t(width);
    auto set = [&](unsigned v) {
      lastpixel = v & 0xf;
      if (npixels < maxpixels) {
        if (npixels++ & 1)
          *op++ |= uint8_t(lastpixel);
        else
          op[0] = uint8_t(lastpixel << 4);
      }
    };
    while (pos < n && npixels < maxpixels) {
      int c = src[pos++];
      int delta;
      switch (c & 0xc0) {
        case 0x00: {  // run
          int64_t k = c & 0x3f;
          if (npixels & 1) {
            op[0] |= uint8_t(lastpixel);
            lastpixel = *op++;
            npixels++;
            k--;
          } else {
            lastpixel |= lastpixel << 4;
          }
          npixels += k;
          if (npixels <= maxpixels)
            for (; k > 0; k -= 2) *op++ = uint8_t(lastpixel);
          if (k == -1) *--op &= 0xf0;
          lastpixel &= 0xf;
          break;
        }
        case 0x40:  // 2-bit deltas
          if ((delta = (c >> 4) & 3) != 2) set(unsigned(int(lastpixel) +
                                                        two[delta]));
          if ((delta = (c >> 2) & 3) != 2) set(unsigned(int(lastpixel) +
                                                        two[delta]));
          if ((delta = c & 3) != 2) set(unsigned(int(lastpixel) +
                                                 two[delta]));
          break;
        case 0x80:  // 3-bit deltas
          if ((delta = (c >> 3) & 7) != 4) set(unsigned(int(lastpixel) +
                                                        three[delta]));
          if ((delta = c & 7) != 4) set(unsigned(int(lastpixel) +
                                                three[delta]));
          break;
        default:  // raw
          set(unsigned(c));
          break;
      }
    }
    if (npixels != maxpixels) {
      uint8_t* const end = op0 + (maxpixels + 1) / 2;
      if (op < end) std::memset(op, 0, size_t(end - op));
      return kCorrupt;
    }
  }
  return int64_t(rows * scanline);
}

// ---- GIF LZW (grfmt_gif.cpp) ----------------------------------------------
// Codes LSB first over the concatenated data sub-blocks; min_code_size + 1
// bits at first, 12 at most; a full table takes no new entries until a
// clear code. Codes are read to the end code (or the data's end): one that
// would write past the image is corrupt, as OpenCV refuses it.
int64_t gif_lzw(const uint8_t* src, uint64_t n, int min_code_size,
                uint8_t* dst, uint64_t cap) {
  if (min_code_size < 1 || min_code_size > 11) return kCorrupt;
  const int clear = 1 << min_code_size, eoi = clear + 1;
  std::vector<Entry> table(kMaxCodes);
  for (int i = 0; i < clear; ++i) table[size_t(i)] = {-1, 1, uint8_t(i),
                                                      uint8_t(i)};
  int width = min_code_size + 1, next = eoi + 1, old = -1;
  uint64_t pos = 0, out = 0, acc = 0;
  int nacc = 0;
  for (;;) {
    while (nacc < width && pos < n) {
      acc |= uint64_t(src[pos++]) << nacc;
      nacc += 8;
    }
    if (nacc < width) break;
    const int code = int(acc & ((1u << width) - 1));
    acc >>= width;
    nacc -= width;
    if (code == clear) {
      width = min_code_size + 1;
      next = eoi + 1;
      old = -1;
      continue;
    }
    if (code == eoi) break;
    if (code > next || (old < 0 && code >= clear)) return kCorrupt;
    if (old >= 0 && next < kMaxCodes) {
      const Entry& o = table[size_t(old)];
      const uint8_t first =
          code < next ? table[size_t(code)].first : o.first;
      table[size_t(next)] = {old, o.length + 1, o.first, first};
      ++next;
      if (next == (1 << width) && width < 12) ++width;
    } else if (code == next) {
      return kCorrupt;
    }
    const int len = table[size_t(code)].length;
    if (out + uint64_t(len) > cap) return kCorrupt;
    int c = code;
    for (int k = len - 1; k >= 0; --k) {
      dst[out + uint64_t(k)] = table[size_t(c)].last;
      c = table[size_t(c)].prefix;
    }
    out += uint64_t(len);
    old = code;
  }
  return out < cap ? kShort : int64_t(out);
}

// ---- BMP RLE4 / RLE8 (grfmt_bmp.cpp) --------------------------------------
// Palette indices into idx (height x width, rows in decoding order: the
// file's first row first). OpenCV's rules: an encoded run of RLE8 wraps to
// the next row, one of RLE4 may not pass the row's end; a delta (0 2 dx dy)
// moves dx + dy * width pixels on, filling them with index 0, as an
// end-of-line fills the row's rest and an end-of-bitmap every pixel left;
// RLE8's end-of-line right after a run that filled its row is a no-op;
// RLE4's end-of-bitmap ends only its row and its delta moves dx pixels,
// whatever dy says. A run or literal past the row's
// end, or a stream that ends before the last row does, gives None in
// OpenCV: -1 / -2.
struct Cursor {
  uint8_t* idx;
  int width, height;
  int64_t x = 0;
  int y = 0;
  // FillUniColor: count pixels of value v from the cursor, wrapping rows
  void fill(int64_t count, uint8_t v) {
    do {
      int64_t end = x + count;
      if (end > width) end = width;
      count -= end - x;
      for (; x < end; ++x) idx[int64_t(y) * width + x] = v;
      if (x >= width) {
        x = 0;
        if (++y >= height) break;
      }
    } while (count > 0);
  }
};

int64_t bmp_rle(const uint8_t* src, uint64_t n, int rle4, int width,
                int height, uint8_t* idx) {
  Cursor cur{idx, width, height};
  uint64_t i = 0;
  int line_end_flag = 0;
  for (;;) {
    if (i + 2 > n) return kShort;
    const int len = src[i], code = src[i + 1];
    i += 2;
    if (len != 0) {  // encoded
      if (cur.x + len > width) return kCorrupt;
      if (rle4) {
        for (int k = 0; k < len; ++k)
          idx[int64_t(cur.y) * width + cur.x++] =
              uint8_t(k & 1 ? code & 15 : code >> 4);
      } else {
        const int prev_y = cur.y;
        cur.fill(len, uint8_t(code));
        line_end_flag = cur.y - prev_y;
        if (cur.y >= height) break;
      }
    } else if (code > 2) {  // absolute
      if (cur.x + code > width) return kCorrupt;
      const uint64_t size = rle4 ? uint64_t((((code + 1) >> 1) + 1) & ~1)
                                 : uint64_t((code + 1) & ~1);
      if (i + size > n) return kShort;
      for (int k = 0; k < code; ++k) {
        const uint8_t b = rle4 ? uint8_t(k & 1 ? src[i + uint64_t(k >> 1)] & 15
                                               : src[i + uint64_t(k >> 1)] >> 4)
                               : src[i + uint64_t(k)];
        idx[int64_t(cur.y) * width + cur.x++] = b;
      }
      i += size;
      if (!rle4) line_end_flag = 0;
    } else {  // 0 end of line, 1 end of bitmap, 2 delta
      int64_t x_shift = width - cur.x;
      int64_t y_shift = height - cur.y;
      if (rle4 || code || !line_end_flag || x_shift < width) {
        if (code == 2) {
          if (i + 2 > n) return kShort;
          x_shift = src[i];
          y_shift = src[i + 1];
          i += 2;
        }
        // RLE4 never moves down a row here: its end-of-bitmap ends only
        // the row and its delta moves dx (OpenCV 5.0 reads on)
        const int64_t count =
            x_shift + (code == 0 || rle4 ? 0 : y_shift * width);
        if (!rle4 && cur.y >= height) break;
        cur.fill(count, 0);
        if (cur.y >= height) break;
      }
      if (!rle4) {
        line_end_flag = 0;
        if (cur.y >= height) break;
      }
    }
  }
  return int64_t(width) * height;
}

// ---- Radiance RGBE (rgbe.cpp's RGBE_ReadPixels_RLE) -----------------------
// rgbe (height x width x 4) from the pixel data: a scanline that starts
// 2 2 w_hi w_lo (w_hi < 128) holds four run-length coded channel planes; a
// width under 8 or over 32767 is flat; the first scanline that does not
// start so ends the RLE, and its four bytes and everything after them are
// read flat. Returns the bytes of src used.
int64_t hdr_rle(const uint8_t* src, uint64_t n, int width, int height,
                uint8_t* rgbe) {
  const uint64_t total = uint64_t(width) * uint64_t(height) * 4;
  uint64_t i = 0;
  if (width < 8 || width > 0x7fff) {
    if (n < total) return kShort;
    std::memcpy(rgbe, src, size_t(total));
    return int64_t(total);
  }
  std::vector<uint8_t> line(static_cast<size_t>(width) * 4);
  for (int y = 0; y < height; ++y) {
    uint8_t* row = rgbe + uint64_t(y) * uint64_t(width) * 4;
    if (i + 4 > n) return kShort;
    if (src[i] != 2 || src[i + 1] != 2 || (src[i + 2] & 0x80)) {
      const uint64_t rest = total - uint64_t(y) * uint64_t(width) * 4;
      if (i + rest > n) return kShort;
      std::memcpy(row, src + i, size_t(rest));
      return int64_t(i + rest);
    }
    if (((src[i + 2] << 8) | src[i + 3]) != width) return kCorrupt;
    i += 4;
    for (int c = 0; c < 4; ++c) {
      uint8_t* p = line.data() + size_t(c) * size_t(width);
      uint8_t* end = p + width;
      while (p < end) {
        if (i + 2 > n) return kShort;
        int count = src[i];
        if (count > 128) {
          count -= 128;
          if (count > end - p) return kCorrupt;
          std::memset(p, src[i + 1], size_t(count));
          p += count;
          i += 2;
        } else {
          if (count == 0 || count > end - p) return kCorrupt;
          if (i + 1 + uint64_t(count) > n) return kShort;
          std::memcpy(p, src + i + 1, size_t(count));
          p += count;
          i += 1 + uint64_t(count);
        }
      }
    }
    for (int x = 0; x < width; ++x)
      for (int c = 0; c < 4; ++c)
        row[4 * x + c] = line[size_t(c) * size_t(width) + size_t(x)];
  }
  return int64_t(i);
}

// ---- TIFF predictors (tif_predict.c) -------------------------------------
// Horizontal differencing undone in place on rows of native-order samples
// of 1, 2, 4 or 8 bytes, stride samples apart (samples per pixel).
template <typename T>
void hor_acc(T* p, uint64_t rows, uint64_t row_samples, int stride) {
  for (uint64_t r = 0; r < rows; ++r, p += row_samples)
    for (uint64_t k = uint64_t(stride); k < row_samples; ++k)
      p[k] = T(p[k] + p[k - uint64_t(stride)]);
}

}  // namespace

extern "C" {

int64_t gic_tiff_lzw(const uint8_t* src, uint64_t n, uint8_t* dst,
                     uint64_t cap, int compat) {
  return tiff_lzw(src, n, dst, cap, compat != 0);
}

int64_t gic_packbits(const uint8_t* src, uint64_t n, uint8_t* dst,
                     uint64_t cap) {
  return packbits(src, n, dst, cap);
}

int64_t gic_thunder(const uint8_t* src, uint64_t n, uint8_t* dst,
                    uint64_t rows, uint64_t width) {
  return thunder(src, n, dst, rows, width);
}

int64_t gic_gif_lzw(const uint8_t* src, uint64_t n, int min_code_size,
                    uint8_t* dst, uint64_t cap) {
  return gif_lzw(src, n, min_code_size, dst, cap);
}

int64_t gic_bmp_rle(const uint8_t* src, uint64_t n, int rle4, int width,
                    int height, uint8_t* idx) {
  return bmp_rle(src, n, rle4, width, height, idx);
}

int64_t gic_hdr_rle(const uint8_t* src, uint64_t n, int width, int height,
                    uint8_t* rgbe) {
  return hdr_rle(src, n, width, height, rgbe);
}

// Predictor 2 on native-order samples of `size` bytes.
int gic_predictor2(uint8_t* data, uint64_t rows, uint64_t row_samples,
                   int stride, int size) {
  switch (size) {
    case 1: hor_acc(data, rows, row_samples, stride); return 0;
    case 2: hor_acc(reinterpret_cast<uint16_t*>(data), rows, row_samples,
                    stride); return 0;
    case 4: hor_acc(reinterpret_cast<uint32_t*>(data), rows, row_samples,
                    stride); return 0;
    case 8: hor_acc(reinterpret_cast<uint64_t*>(data), rows, row_samples,
                    stride); return 0;
    default: return -1;
  }
}

// Predictor 3 (fpAcc): each row is its samples' bytes as planes, the most
// significant first, differenced byte by byte stride bytes apart; undone
// into little-endian samples of `size` bytes.
int gic_predictor3(uint8_t* data, uint64_t rows, uint64_t row_bytes,
                   int stride, int size) {
  if (size <= 0 || row_bytes % uint64_t(size * stride)) return -1;
  const uint64_t wc = row_bytes / uint64_t(size);
  std::vector<uint8_t> tmp(static_cast<size_t>(row_bytes));
  for (uint64_t r = 0; r < rows; ++r) {
    uint8_t* p = data + r * row_bytes;
    for (uint64_t k = uint64_t(stride); k < row_bytes; ++k)
      p[k] = uint8_t(p[k] + p[k - uint64_t(stride)]);
    std::memcpy(tmp.data(), p, size_t(row_bytes));
    for (uint64_t c = 0; c < wc; ++c)
      for (int b = 0; b < size; ++b)
        p[uint64_t(size) * c + uint64_t(b)] =
            tmp[uint64_t(size - b - 1) * wc + c];
  }
  return 0;
}

}  // extern "C"
