// CCITT bilevel decoding for gis/tiff.py (bound with ctypes in
// gis/coders.py), as libtiff 4.7's tif_fax3.c and tif_fax3.h decode it
// under cv2.imread / cv2.imdecode: Modified Huffman RLE (compression 2,
// runs byte-aligned at each row's end), RLEW (32771, word-aligned: aligned
// to the input pointer's address, as libtiff tests it), Group 3 (3) 1-D
// and 2-D with an EOL before each row, and Group 4 (6).
//
// The decoders are libtiff's state machines: the same lookup tables
// (built here as mkg3states.c builds tif_fax3sm.c: 7-bit mode codes,
// 12-bit white and 13-bit black run codes, LSB first), the same bit
// reader (a byte or two at a time; past the end of the data the reader
// pads with zero bits once, then stops), the same recovery from a bad code
// word (the row so far is closed with white or a final run, and decoding
// goes on from where the bad code was), the same run arrays (kept by the
// caller across the strips of one image, as libtiff keeps them in its
// codec state) and the same fill of each row's runs into the strip buffer
// (bits past a row's last pixel, and rows never reached, are left as they
// were). A row's runs that overflow the run array end the strip there, as
// libtiff's "Buffer overflow" does.
#include <cstdint>
#include <cstring>

namespace {

enum State : uint8_t {
  S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
  S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL
};

struct TabEnt {
  uint8_t state;
  uint8_t width;  // bits the code takes
  uint32_t param;  // run length, or the vertical offset
};

struct Proto {
  const char* code;  // the code's bits, first bit first
  uint32_t param;
};

TabEnt main_table[1 << 7];
TabEnt white_table[1 << 12];
TabEnt black_table[1 << 13];

// ITU-T T.4 tables 1-4 and T.6 table 1.
const Proto kPass[] = {{"0001", 0}};
const Proto kHoriz[] = {{"001", 0}};
const Proto kV0[] = {{"1", 0}};
const Proto kVR[] = {{"011", 1}, {"000011", 2}, {"0000011", 3}};
const Proto kVL[] = {{"010", 1}, {"000010", 2}, {"0000010", 3}};
const Proto kExt[] = {{"0000001", 0}};
const Proto kEOLV[] = {{"0000000", 0}};
const Proto kEOLH[] = {{"00000000000", 0}};
const Proto kMakeUp[] = {  // shared by both colours
    {"00000001000", 1792}, {"00000001100", 1856}, {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}};
const Proto kTermW[] = {
    {"00110101", 0}, {"000111", 1}, {"0111", 2}, {"1000", 3}, {"1011", 4},
    {"1100", 5}, {"1110", 6}, {"1111", 7}, {"10011", 8}, {"10100", 9},
    {"00111", 10}, {"01000", 11}, {"001000", 12}, {"000011", 13},
    {"110100", 14}, {"110101", 15}, {"101010", 16}, {"101011", 17},
    {"0100111", 18}, {"0001100", 19}, {"0001000", 20}, {"0010111", 21},
    {"0000011", 22}, {"0000100", 23}, {"0101000", 24}, {"0101011", 25},
    {"0010011", 26}, {"0100100", 27}, {"0011000", 28}, {"00000010", 29},
    {"00000011", 30}, {"00011010", 31}, {"00011011", 32}, {"00010010", 33},
    {"00010011", 34}, {"00010100", 35}, {"00010101", 36}, {"00010110", 37},
    {"00010111", 38}, {"00101000", 39}, {"00101001", 40}, {"00101010", 41},
    {"00101011", 42}, {"00101100", 43}, {"00101101", 44}, {"00000100", 45},
    {"00000101", 46}, {"00001010", 47}, {"00001011", 48}, {"01010010", 49},
    {"01010011", 50}, {"01010100", 51}, {"01010101", 52}, {"00100100", 53},
    {"00100101", 54}, {"01011000", 55}, {"01011001", 56}, {"01011010", 57},
    {"01011011", 58}, {"01001010", 59}, {"01001011", 60}, {"00110010", 61},
    {"00110011", 62}, {"00110100", 63}};
const Proto kMakeUpW[] = {
    {"11011", 64}, {"10010", 128}, {"010111", 192}, {"0110111", 256},
    {"00110110", 320}, {"00110111", 384}, {"01100100", 448},
    {"01100101", 512}, {"01101000", 576}, {"01100111", 640},
    {"011001100", 704}, {"011001101", 768}, {"011010010", 832},
    {"011010011", 896}, {"011010100", 960}, {"011010101", 1024},
    {"011010110", 1088}, {"011010111", 1152}, {"011011000", 1216},
    {"011011001", 1280}, {"011011010", 1344}, {"011011011", 1408},
    {"010011000", 1472}, {"010011001", 1536}, {"010011010", 1600},
    {"011000", 1664}, {"010011011", 1728}};
const Proto kTermB[] = {
    {"0000110111", 0}, {"010", 1}, {"11", 2}, {"10", 3}, {"011", 4},
    {"0011", 5}, {"0010", 6}, {"00011", 7}, {"000101", 8}, {"000100", 9},
    {"0000100", 10}, {"0000101", 11}, {"0000111", 12}, {"00000100", 13},
    {"00000111", 14}, {"000011000", 15}, {"0000010111", 16},
    {"0000011000", 17}, {"0000001000", 18}, {"00001100111", 19},
    {"00001101000", 20}, {"00001101100", 21}, {"00000110111", 22},
    {"00000101000", 23}, {"00000010111", 24}, {"00000011000", 25},
    {"000011001010", 26}, {"000011001011", 27}, {"000011001100", 28},
    {"000011001101", 29}, {"000001101000", 30}, {"000001101001", 31},
    {"000001101010", 32}, {"000001101011", 33}, {"000011010010", 34},
    {"000011010011", 35}, {"000011010100", 36}, {"000011010101", 37},
    {"000011010110", 38}, {"000011010111", 39}, {"000001101100", 40},
    {"000001101101", 41}, {"000011011010", 42}, {"000011011011", 43},
    {"000001010100", 44}, {"000001010101", 45}, {"000001010110", 46},
    {"000001010111", 47}, {"000001100100", 48}, {"000001100101", 49},
    {"000001010010", 50}, {"000001010011", 51}, {"000000100100", 52},
    {"000000110111", 53}, {"000000111000", 54}, {"000000100111", 55},
    {"000000101000", 56}, {"000001011000", 57}, {"000001011001", 58},
    {"000000101011", 59}, {"000000101100", 60}, {"000001011010", 61},
    {"000001100110", 62}, {"000001100111", 63}};
const Proto kMakeUpB[] = {
    {"0000001111", 64}, {"000011001000", 128}, {"000011001001", 192},
    {"000001011011", 256}, {"000000110011", 320}, {"000000110100", 384},
    {"000000110101", 448}, {"0000001101100", 512}, {"0000001101101", 576},
    {"0000001001010", 640}, {"0000001001011", 704}, {"0000001001100", 768},
    {"0000001001101", 832}, {"0000001110010", 896}, {"0000001110011", 960},
    {"0000001110100", 1024}, {"0000001110101", 1088},
    {"0000001110110", 1152}, {"0000001110111", 1216},
    {"0000001010010", 1280}, {"0000001010011", 1344},
    {"0000001010100", 1408}, {"0000001010101", 1472},
    {"0000001011010", 1536}, {"0000001011011", 1600},
    {"0000001100100", 1664}, {"0000001100101", 1728}};

// mkg3states.c's FillTable: every index whose low bits are the code (read
// LSB first) decodes to it.
template <size_t N>
void fill_table(TabEnt* t, int size, const Proto (&protos)[N], State state) {
  for (const Proto& p : protos) {
    const int width = int(std::strlen(p.code));
    uint32_t code = 0;
    for (int i = 0; i < width; ++i)
      if (p.code[i] == '1') code |= 1u << i;
    for (uint32_t c = code; c < (1u << size); c += 1u << width)
      t[c] = {state, uint8_t(width), p.param};
  }
}

struct Tables {
  Tables() {
    fill_table(main_table, 7, kPass, S_Pass);
    fill_table(main_table, 7, kHoriz, S_Horiz);
    fill_table(main_table, 7, kV0, S_V0);
    fill_table(main_table, 7, kVR, S_VR);
    fill_table(main_table, 7, kVL, S_VL);
    fill_table(main_table, 7, kExt, S_Ext);
    fill_table(main_table, 7, kEOLV, S_EOL);
    fill_table(white_table, 12, kMakeUpW, S_MakeUpW);
    fill_table(white_table, 12, kMakeUp, S_MakeUp);
    fill_table(white_table, 12, kTermW, S_TermW);
    fill_table(white_table, 12, kEOLH, S_EOL);
    fill_table(black_table, 13, kMakeUpB, S_MakeUpB);
    fill_table(black_table, 13, kMakeUp, S_MakeUp);
    fill_table(black_table, 13, kTermB, S_TermB);
    fill_table(black_table, 13, kEOLH, S_EOL);
  }
} const tables;

uint8_t bit_reverse[256];
struct BitReverse {
  BitReverse() {
    for (int i = 0; i < 256; ++i) {
      int r = 0;
      for (int b = 0; b < 8; ++b)
        if (i & (1 << b)) r |= 0x80 >> b;
      bit_reverse[i] = uint8_t(r);
    }
  }
} const bit_reverse_init;

// _TIFFFax3fillruns: white runs clear bits, black runs set them, a run
// past the row's end is cut to it (in the run array too: the next row's
// reference line sees the cut run).
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  static const uint8_t fillmasks[] = {0x00, 0x80, 0xc0, 0xe0, 0xf0,
                                      0xf8, 0xfc, 0xfe, 0xff};
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int black = 0; black < 2; ++black) {
      uint32_t run = runs[black];
      if (x + run > lastx || run > lastx) run = runs[black] = lastx - x;
      if (!run) continue;
      uint8_t* cp = buf + (x >> 3);
      const uint32_t bx = x & 7;
      if (run > 8 - bx) {
        if (bx) {
          if (black)
            *cp++ |= uint8_t(0xff >> bx);
          else
            *cp++ &= uint8_t(0xff << (8 - bx));
          run -= 8 - bx;
        }
        const uint32_t n = run >> 3;
        if (n) {
          std::memset(cp, black ? 0xff : 0x00, n);
          cp += n;
          run &= 7;
        }
        if (run) {
          if (black)
            cp[0] = uint8_t((cp[0] | (0xff00 >> run)) & 0xff);
          else
            cp[0] &= uint8_t(0xff >> run);
        }
      } else if (black) {
        cp[0] |= uint8_t(fillmasks[run] >> bx);
      } else {
        cp[0] &= uint8_t(~(fillmasks[run] >> bx));
      }
      x += runs[black];
    }
  }
}

constexpr int kRLE = 2, kG3 = 3, kG4 = 4;

// The state one strip's decoder works on (libtiff's DECLARE_STATE and
// CACHE_STATE: the bit reader starts empty, the reference line white).
#define DECLARE_STATE                                       \
  const uint8_t* cp = raw;                                  \
  const uint8_t* const ep = raw + nraw;                     \
  const uint8_t* const bitmap = bit_reverse;                \
  uint32_t BitAcc = 0;                                      \
  int BitsAvail = 0;                                        \
  int EOLcnt = 0;                                           \
  int a0 = 0, RunLength = 0, b1 = 0;                        \
  const TabEnt* TabEnt = nullptr;                           \
  uint32_t* curruns = runs;                                 \
  uint32_t* refruns = runs + nruns;                         \
  uint32_t *pa = nullptr, *pb = nullptr, *thisrun = curruns; \
  refruns[0] = uint32_t(lastx);                             \
  refruns[1] = 0;                                           \
  (void)b1;                                                 \
  (void)pb;                                                 \
  (void)EOLcnt;                                             \
  uint32_t* const noeol = runs + 2 * nruns;                 \
  (void)noeol;                                              \
  if (occ % rowbytes) return -1; /* fractional scanlines */

#define EndOfData() (cp >= ep)
#define NeedBits8(n, eoflab)                                  \
  do {                                                        \
    if (BitsAvail < (n)) {                                    \
      if (EndOfData()) {                                      \
        if (BitsAvail == 0) goto eoflab;                      \
        BitsAvail = (n);                                      \
      } else {                                                \
        BitAcc |= uint32_t(bitmap[*cp++]) << BitsAvail;       \
        BitsAvail += 8;                                       \
      }                                                       \
    }                                                         \
  } while (0)
#define NeedBits16(n, eoflab)                                 \
  do {                                                        \
    if (BitsAvail < (n)) {                                    \
      if (EndOfData()) {                                      \
        if (BitsAvail == 0) goto eoflab;                      \
        BitsAvail = (n);                                      \
      } else {                                                \
        BitAcc |= uint32_t(bitmap[*cp++]) << BitsAvail;       \
        if ((BitsAvail += 8) < (n)) {                         \
          if (EndOfData()) {                                  \
            BitsAvail = (n);                                  \
          } else {                                            \
            BitAcc |= uint32_t(bitmap[*cp++]) << BitsAvail;   \
            BitsAvail += 8;                                   \
          }                                                   \
        }                                                     \
      }                                                       \
    }                                                         \
  } while (0)
#define GetBits(n) (BitAcc & ((1u << (n)) - 1))
#define ClrBits(n)    \
  do {                \
    BitsAvail -= (n); \
    BitAcc >>= (n);   \
  } while (0)
#define LOOKUP8(wid, tab, eoflab)   \
  do {                              \
    NeedBits8(wid, eoflab);         \
    TabEnt = tab + GetBits(wid);    \
    ClrBits(TabEnt->width);         \
  } while (0)
#define LOOKUP16(wid, tab, eoflab)  \
  do {                              \
    NeedBits16(wid, eoflab);        \
    TabEnt = tab + GetBits(wid);    \
    ClrBits(TabEnt->width);         \
  } while (0)
#define SETVALUE(x)                                 \
  do {                                              \
    if (pa >= thisrun + nruns) return -1;           \
    *pa++ = uint32_t(RunLength + int(x));           \
    a0 += int(x);                                   \
    RunLength = 0;                                  \
  } while (0)
// scan for an EOL (11 zeros and a one), skipping what precedes it; where
// the data ends first, libtiff 4.7 takes the strip for one without EOLs
// and decodes it again from its start, into the rows still to come
#define SYNC_EOL(retrylab)                          \
  do {                                              \
    if (!*noeol) {                                  \
      if (EOLcnt == 0) {                            \
        for (;;) {                                  \
          NeedBits16(11, retrylab);                 \
          if (GetBits(11) == 0) break;              \
          ClrBits(1);                               \
        }                                           \
      }                                             \
      for (;;) {                                    \
        NeedBits8(8, retrylab);                     \
        if (GetBits(8)) break;                      \
        ClrBits(8);                                 \
      }                                             \
      while (GetBits(1) == 0) ClrBits(1);           \
      ClrBits(1);                                   \
      EOLcnt = 0;                                   \
    }                                               \
  } while (0)
// close a row whose runs do not add up to its width
#define CLEANUP_RUNS()                                    \
  do {                                                    \
    if (RunLength) SETVALUE(0);                           \
    if (a0 != lastx) {                                    \
      while (a0 > lastx && pa > thisrun) a0 -= int(*--pa); \
      if (a0 < lastx) {                                   \
        if (a0 < 0) a0 = 0;                               \
        if ((pa - thisrun) & 1) SETVALUE(0);              \
        SETVALUE(lastx - a0);                             \
      } else if (a0 > lastx) {                            \
        SETVALUE(lastx);                                  \
        SETVALUE(0);                                      \
      }                                                   \
    }                                                     \
  } while (0)
#define EXPAND1D(eoflab)                                   \
  do {                                                     \
    for (;;) {                                             \
      for (;;) {                                           \
        LOOKUP16(12, white_table, eof1d);                  \
        switch (TabEnt->state) {                           \
          case S_EOL:                                      \
            EOLcnt = 1;                                    \
            goto done1d;                                   \
          case S_TermW:                                    \
            SETVALUE(TabEnt->param);                       \
            goto doneWhite1d;                              \
          case S_MakeUpW:                                  \
          case S_MakeUp:                                   \
            a0 += int(TabEnt->param);                      \
            RunLength += int(TabEnt->param);               \
            break;                                         \
          default:                                         \
            goto done1d;                                   \
        }                                                  \
      }                                                    \
    doneWhite1d:                                           \
      if (a0 >= lastx) goto done1d;                        \
      for (;;) {                                           \
        LOOKUP16(13, black_table, eof1d);                  \
        switch (TabEnt->state) {                           \
          case S_EOL:                                      \
            EOLcnt = 1;                                    \
            goto done1d;                                   \
          case S_TermB:                                    \
            SETVALUE(TabEnt->param);                       \
            goto doneBlack1d;                              \
          case S_MakeUpB:                                  \
          case S_MakeUp:                                   \
            a0 += int(TabEnt->param);                      \
            RunLength += int(TabEnt->param);               \
            break;                                         \
          default:                                         \
            goto done1d;                                   \
        }                                                  \
      }                                                    \
    doneBlack1d:                                           \
      if (a0 >= lastx) goto done1d;                        \
      if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;       \
    }                                                      \
  eof1d:                                                   \
    CLEANUP_RUNS();                                        \
    goto eoflab;                                           \
  done1d:                                                  \
    CLEANUP_RUNS();                                        \
  } while (0)
// advance b1 past a0 on the reference line
#define CHECK_b1                                           \
  do {                                                     \
    if (pa != thisrun)                                     \
      while (b1 <= a0 && b1 < lastx) {                     \
        if (pb + 1 >= refruns + nruns) return -1;          \
        b1 += int(pb[0] + pb[1]);                          \
        pb += 2;                                           \
      }                                                    \
  } while (0)
#define EXPAND2D(eoflab)                                   \
  do {                                                     \
    while (a0 < lastx) {                                   \
      if (pa >= thisrun + nruns) return -1;                \
      LOOKUP8(7, main_table, eof2d);                       \
      switch (TabEnt->state) {                             \
        case S_Pass:                                       \
          CHECK_b1;                                        \
          if (pb + 1 >= refruns + nruns) return -1;        \
          b1 += int(*pb++);                                \
          RunLength += b1 - a0;                            \
          a0 = b1;                                         \
          b1 += int(*pb++);                                \
          break;                                           \
        case S_Horiz:                                      \
          if ((pa - thisrun) & 1) {                        \
            for (;;) {                                     \
              LOOKUP16(13, black_table, eof2d);            \
              switch (TabEnt->state) {                     \
                case S_TermB:                              \
                  SETVALUE(TabEnt->param);                 \
                  goto doneWhite2da;                       \
                case S_MakeUpB:                            \
                case S_MakeUp:                             \
                  a0 += int(TabEnt->param);                \
                  RunLength += int(TabEnt->param);         \
                  break;                                   \
                default:                                   \
                  goto badBlack2d;                         \
              }                                            \
            }                                              \
          doneWhite2da:;                                   \
            for (;;) {                                     \
              LOOKUP16(12, white_table, eof2d);            \
              switch (TabEnt->state) {                     \
                case S_TermW:                              \
                  SETVALUE(TabEnt->param);                 \
                  goto doneBlack2da;                       \
                case S_MakeUpW:                            \
                case S_MakeUp:                             \
                  a0 += int(TabEnt->param);                \
                  RunLength += int(TabEnt->param);         \
                  break;                                   \
                default:                                   \
                  goto badWhite2d;                         \
              }                                            \
            }                                              \
          doneBlack2da:;                                   \
          } else {                                         \
            for (;;) {                                     \
              LOOKUP16(12, white_table, eof2d);            \
              switch (TabEnt->state) {                     \
                case S_TermW:                              \
                  SETVALUE(TabEnt->param);                 \
                  goto doneWhite2db;                       \
                case S_MakeUpW:                            \
                case S_MakeUp:                             \
                  a0 += int(TabEnt->param);                \
                  RunLength += int(TabEnt->param);         \
                  break;                                   \
                default:                                   \
                  goto badWhite2d;                         \
              }                                            \
            }                                              \
          doneWhite2db:;                                   \
            for (;;) {                                     \
              LOOKUP16(13, black_table, eof2d);            \
              switch (TabEnt->state) {                     \
                case S_TermB:                              \
                  SETVALUE(TabEnt->param);                 \
                  goto doneBlack2db;                       \
                case S_MakeUpB:                            \
                case S_MakeUp:                             \
                  a0 += int(TabEnt->param);                \
                  RunLength += int(TabEnt->param);         \
                  break;                                   \
                default:                                   \
                  goto badBlack2d;                         \
              }                                            \
            }                                              \
          doneBlack2db:;                                   \
          }                                                \
          CHECK_b1;                                        \
          break;                                           \
        case S_V0:                                         \
          CHECK_b1;                                        \
          SETVALUE(b1 - a0);                               \
          if (pb >= refruns + nruns) return -1;            \
          b1 += int(*pb++);                                \
          break;                                           \
        case S_VR:                                         \
          CHECK_b1;                                        \
          SETVALUE(b1 - a0 + int(TabEnt->param));          \
          if (pb >= refruns + nruns) return -1;            \
          b1 += int(*pb++);                                \
          break;                                           \
        case S_VL:                                         \
          CHECK_b1;                                        \
          if (b1 < int(a0 + TabEnt->param)) goto eol2d;    \
          SETVALUE(b1 - a0 - int(TabEnt->param));          \
          b1 -= int(*--pb);                                \
          break;                                           \
        case S_Ext:                                        \
          *pa++ = uint32_t(lastx - a0);                    \
          goto eol2d;                                      \
        case S_EOL:                                        \
          *pa++ = uint32_t(lastx - a0);                    \
          NeedBits8(4, eof2d);                             \
          ClrBits(4);                                      \
          EOLcnt = 1;                                      \
          goto eol2d;                                      \
        default:                                           \
        badMain2d:                                         \
        badBlack2d:                                        \
        badWhite2d:                                        \
          goto eol2d;                                      \
        eof2d:                                             \
          CLEANUP_RUNS();                                  \
          goto eoflab;                                     \
      }                                                    \
    }                                                      \
    if (RunLength) {                                       \
      if (RunLength + a0 < lastx) {                        \
        NeedBits8(1, eof2d);                               \
        if (!GetBits(1)) goto badMain2d;                   \
        ClrBits(1);                                        \
      }                                                    \
      SETVALUE(0);                                         \
    }                                                      \
  eol2d:                                                   \
    CLEANUP_RUNS();                                        \
  } while (0)

// Fax3DecodeRLE: RLE (byte-aligned rows) and RLEW (word-aligned rows).
int decode_rle(bool word, bool odd_start, const uint8_t* raw, uint64_t nraw,
               uint8_t* buf, int64_t occ, int64_t rowbytes, int lastx,
               uint32_t* runs, uint32_t nruns) {
  DECLARE_STATE
  while (occ > 0) {
    a0 = 0;
    RunLength = 0;
    pa = thisrun;
    EXPAND1D(EOFRLE);
    fill_runs(buf, thisrun, pa, uint32_t(lastx));
    if (!word) {  // FAXMODE_BYTEALIGN
      const int n = BitsAvail - (BitsAvail & ~7);
      ClrBits(n);
    } else {  // FAXMODE_WORDALIGN: to the input pointer's address
      const int n = BitsAvail - (BitsAvail & ~15);
      ClrBits(n);
      if (BitsAvail == 0 && ((cp - raw) & 1) != (odd_start ? 1 : 0)) ++cp;
    }
    buf += rowbytes;
    occ -= rowbytes;
    continue;
  EOFRLE:
    fill_runs(buf, thisrun, pa, uint32_t(lastx));
    return -1;
  }
  return 1;
}

// Fax3Decode1D: Group 3, 1-D rows after an EOL.
int decode_g3_1d(const uint8_t* raw, uint64_t nraw, uint8_t* buf, int64_t occ,
                 int64_t rowbytes, int lastx, uint32_t* runs,
                 uint32_t nruns) {
  DECLARE_STATE
DECODE:
  while (occ > 0) {
    a0 = 0;
    RunLength = 0;
    pa = thisrun;
    SYNC_EOL(RETRY);
    EXPAND1D(EOF1Da);
    fill_runs(buf, thisrun, pa, uint32_t(lastx));
    buf += rowbytes;
    occ -= rowbytes;
    continue;
  EOF1Da:
    fill_runs(buf, thisrun, pa, uint32_t(lastx));
    return -1;
  }
  return 1;
RETRY:  // from the strip's start, the bit reader empty, without EOLs
  *noeol = 1;
  cp = raw;
  BitAcc = 0;
  BitsAvail = 0;
  EOLcnt = 0;
  goto DECODE;
}

// Fax3Decode2D: Group 3, each row after an EOL and a 1-D / 2-D tag bit.
int decode_g3_2d(const uint8_t* raw, uint64_t nraw, uint8_t* buf, int64_t occ,
                 int64_t rowbytes, int lastx, uint32_t* runs,
                 uint32_t nruns) {
  DECLARE_STATE
DECODE:
  while (occ > 0) {
    a0 = 0;
    RunLength = 0;
    pa = thisrun = curruns;
    SYNC_EOL(RETRY);
    NeedBits8(1, EOF2D);
    {
      const bool is1d = GetBits(1) != 0;
      ClrBits(1);
      pb = refruns;
      b1 = int(*pb++);
      if (is1d)
        EXPAND1D(EOF2Da);
      else
        EXPAND2D(EOF2Da);
    }
    fill_runs(buf, thisrun, pa, uint32_t(lastx));
    if (pa < thisrun + nruns) SETVALUE(0);  // an imaginary change
    {
      uint32_t* t = curruns;
      curruns = refruns;
      refruns = t;
    }
    buf += rowbytes;
    occ -= rowbytes;
    continue;
  EOF2D:
    CLEANUP_RUNS();
  EOF2Da:
    fill_runs(buf, thisrun, pa, uint32_t(lastx));
    return -1;
  }
  return 1;
RETRY:  // from the strip's start, the bit reader empty, without EOLs
  *noeol = 1;
  cp = raw;
  BitAcc = 0;
  BitsAvail = 0;
  EOLcnt = 0;
  goto DECODE;
}

// Fax4Decode: Group 4, 2-D rows to an EOFB.
int decode_g4(const uint8_t* raw, uint64_t nraw, uint8_t* buf, int64_t occ,
              int64_t rowbytes, int lastx, uint32_t* runs, uint32_t nruns) {
  DECLARE_STATE
  int line = 0;
  while (occ > 0) {
    a0 = 0;
    RunLength = 0;
    pa = thisrun = curruns;
    pb = refruns;
    b1 = int(*pb++);
    EXPAND2D(EOFG4);
    if (EOLcnt) goto EOFG4;
    if (((lastx + 7) >> 3) > occ) return -1;
    fill_runs(buf, thisrun, pa, uint32_t(lastx));
    SETVALUE(0);  // an imaginary change for the reference line
    {
      uint32_t* t = curruns;
      curruns = refruns;
      refruns = t;
    }
    buf += rowbytes;
    occ -= rowbytes;
    ++line;
    continue;
  EOFG4:
    NeedBits16(13, BADG4);
  BADG4:
    ClrBits(13);
    if (((lastx + 7) >> 3) > occ) return -1;
    fill_runs(buf, thisrun, pa, uint32_t(lastx));
    return line != 0 ? 1 : -1;
  }
  return 1;
}

}  // namespace

extern "C" {

// One strip or tile of a CCITT-coded TIFF (scheme 2, 32771, 3 or 4; is2d:
// Group 3's T4Options bit 0) into `buf` (`occ` bytes of `rowbytes`-byte
// rows, `rowpixels` pixels a row), from `raw` (MSB-first bytes; odd_start:
// the data starts at an odd address, which RLEW's word alignment reads).
// `runs` (2 * nruns entries, then Group 3's no-EOL flag) is the codec's
// state kept across the strips of one image. Returns 1, or -1 where libtiff's decoder stops
// early (what it decoded stays in `buf`).
int gfax_decode(int scheme, int is2d, const uint8_t* raw, uint64_t nraw,
                int odd_start, uint8_t* buf, int64_t occ, int64_t rowbytes,
                int rowpixels, uint32_t* runs, uint32_t nruns) {
  if (scheme == kG4)
    return decode_g4(raw, nraw, buf, occ, rowbytes, rowpixels, runs, nruns);
  if (scheme == kG3)
    return is2d ? decode_g3_2d(raw, nraw, buf, occ, rowbytes, rowpixels, runs,
                               nruns)
                : decode_g3_1d(raw, nraw, buf, occ, rowbytes, rowpixels, runs,
                               nruns);
  return decode_rle(scheme != kRLE, odd_start != 0, raw, nraw, buf, occ,
                    rowbytes, rowpixels, runs, nruns);
}

}  // extern "C"
