// JPEG 2000 decoding as OpenJPEG 2.5 decodes for OpenCV.
//
// The JAX package reads WMS replies and replay files with cv2.imdecode /
// cv2.imread, which read JPEG 2000 (JP2 files and raw J2K codestreams)
// through OpenJPEG. The card machine has neither OpenCV nor OpenJPEG, so
// the port carries this decoder, built at first use with the host compiler
// and bound with ctypes (gisnav_tpu_torch/gis/jpeg2000.py). Each stage
// follows ITU-T T.800 | ISO/IEC 15444-1 as OpenJPEG's C code implements it,
// so the samples are those cv2 is handed:
//
// JP2 (Annex I; jp2.c): the signature and ftyp boxes, jp2h with ihdr, bpcc,
// colr (enumerated, ICC kept aside), pclr, cmap and cdef, other boxes
// skipped, XLBox and length-0 boxes, OpenJPEG's box-size checks; the colour
// space as OpenJPEG maps enumcs; pclr/cmap and cdef applied after decoding.
// Codestream (Annex A; j2k.c): SIZ, COD, COC, QCD, QCC, RGN, POC, TLM, PLM,
// PLT, CRG, COM, SOT, SOD and EOC in the main and tile-part headers,
// tile-parts of several tiles interleaved, OpenJPEG's strict length checks
// and its end-of-stream rules, packed packet headers (PPM, PPT); CAP and CPF
// skipped as OpenJPEG reads them, HT code-blocks (style 0x40; mixed 0x80
// fails as in OpenJPEG).
// Tier 2 (Annex B; t2.c, pi.c, tgt.c, bio.c): the five progression orders
// and POC, precincts and code-blocks clipped to them, tag trees, packet
// headers with bit stuffing, Lblock and codeword segments across layers,
// SOP and EPH.
// Tier 1 (Annexes C, D; t1.c, mqc.c): the MQ decoder and the significance,
// refinement and cleanup passes with OpenJPEG's fixed-point magnitudes
// (one extra fractional bit), and the bypass, reset, termall, vertically
// causal, predictable-termination and segmentation-symbol styles. HTJ2K
// (ITU-T T.814; ht_dec.c): the HT cleanup (MEL, VLC, MagSgn), SigProp and
// MagRef passes into the same magnitudes, with HT's segments in tier 2.
// Dequantisation (Annex E; t1.c, tcd.c): reversible halving, irreversible
// step sizes as OpenJPEG derives them (no log2 gain: the inverse 9/7 scales
// the high band by 2/K instead), the RGN maxshift.
// Inverse DWT (Annex F; dwt.c): 5/3 in integers, 9/7 in float with
// OpenJPEG's constants and lifting order, at the parity of each origin.
// Components (Annex G; mct.c, tcd.c): inverse RCT, ICT in float, the DC
// level shift with lrintf rounding (half to even) and the clamp.
//
// Floating-point expressions are written as OpenJPEG's SSE code evaluates
// them: one rounding per multiply and per add, never fused (the library is
// built with -ffp-contract=off).
#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdarg>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

struct Invalid {  // bytes cv2 gives None for
  std::string msg;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Invalid{buf};
}


// the last decode's time by stage (gj2k_timing): whole call, tier 1 (MQ
// or HT code-blocks), the inverse wavelet
using Clock = std::chrono::steady_clock;
struct Timing {
  double total = 0, tier1 = 0, wavelet = 0;
};
thread_local Timing g_timing;
inline double seconds_since(Clock::time_point t0) {
  return std::chrono::duration<double>(Clock::now() - t0).count();
}

inline uint32_t rd16(const uint8_t* p) { return uint32_t(p[0]) << 8 | p[1]; }
inline uint32_t rd32(const uint8_t* p) {
  return uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 | uint32_t(p[2]) << 8 |
         p[3];
}
inline int ceildiv(int64_t a, int64_t b) { return int((a + b - 1) / b); }
inline int ceildivpow2(int64_t a, int b) {
  return int((a + (int64_t(1) << b) - 1) >> b);
}
inline int floordivpow2(int64_t a, int b) { return int(a >> b); }

// ---------------------------------------------------------------------------
// MQ arithmetic decoder (Annex C; mqc.c): Table C.2 and OpenJPEG's software
// conventions, with two 0xFF bytes after each segment's data.

struct MQState {
  uint32_t qe;
  uint8_t nmps, nlps, sw;
};

constexpr MQState kMQ[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

// Tier-1 context numbers (t1.h): 9 zero coding, 5 sign, 3 magnitude
// refinement, run length, uniform.
constexpr int kCtxZC = 0, kCtxSC = 9, kCtxMag = 14, kCtxAgg = 17,
              kCtxUni = 18, kNumCtx = 19;

struct MQ {
  const uint8_t* bp;
  uint32_t a, c, ct;
  uint8_t state[kNumCtx], mps[kNumCtx];

  void reset_states() {
    std::memset(state, 0, sizeof state);
    std::memset(mps, 0, sizeof mps);
    state[kCtxUni] = 46;
    state[kCtxAgg] = 3;
    state[kCtxZC] = 4;
  }
  // `data` holds len bytes followed by 0xFF 0xFF (the caller's padding)
  void init(const uint8_t* data, uint32_t len) {
    bp = data;
    c = len == 0 ? 0xffu << 16 : uint32_t(*bp) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void bytein() {
    if (*bp == 0xff) {
      if (bp[1] > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        bp++;
        c += uint32_t(*bp) << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += uint32_t(*bp) << 8;
      ct = 8;
    }
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
    const MQState& s = kMQ[state[cx]];
    int d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {
      if (a < s.qe) {
        a = s.qe;
        d = mps[cx];
        state[cx] = s.nmps;
      } else {
        a = s.qe;
        d = !mps[cx];
        if (s.sw) mps[cx] = !mps[cx];
        state[cx] = s.nlps;
      }
      renorm();
    } else {
      c -= s.qe << 16;
      if ((a & 0x8000) == 0) {
        if (a < s.qe) {
          d = !mps[cx];
          if (s.sw) mps[cx] = !mps[cx];
          state[cx] = s.nlps;
        } else {
          d = mps[cx];
          state[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  // the raw (bypass) decoder shares bp / c / ct (opj_mqc_raw_decode)
  void raw_init(const uint8_t* data) {
    bp = data;
    c = 0;
    ct = 0;
  }
  int raw() {
    if (ct == 0) {
      if (c == 0xff) {
        if (*bp > 0x8f) {
          c = 0xff;
          ct = 8;
        } else {
          c = *bp++;
          ct = 7;
        }
      } else {
        c = *bp++;
        ct = 8;
      }
    }
    ct--;
    return (c >> ct) & 1;
  }
};

// ---------------------------------------------------------------------------
// Packet-header bit reader (bio.c): a byte after 0xFF gives 7 bits; past the
// end it reads zeros.

struct Bio {
  const uint8_t *start, *bp, *end;
  uint32_t buf = 0, ct = 0;
  Bio(const uint8_t* p, size_t n) : start(p), bp(p), end(p + n) {}
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
  size_t numbytes() const { return size_t(bp - start); }
};

// ---------------------------------------------------------------------------
// Tag tree (B.10.2; tgt.c)

struct TagTree {
  struct Node {
    int parent, value, low;
  };
  std::vector<Node> nodes;

  void init(int w, int h) {
    nodes.clear();
    if (w <= 0 || h <= 0) return;
    std::vector<int> lw, lh, off;
    int n;
    int total = 0;
    int cw = w, ch = h;
    do {
      lw.push_back(cw);
      lh.push_back(ch);
      off.push_back(total);
      n = cw * ch;
      total += n;
      cw = (cw + 1) / 2;
      ch = (ch + 1) / 2;
    } while (n > 1);
    nodes.assign(size_t(total), Node{-1, 999, 0});
    for (size_t l = 0; l + 1 < lw.size(); l++)
      for (int y = 0; y < lh[l]; y++)
        for (int x = 0; x < lw[l]; x++)
          nodes[size_t(off[l] + y * lw[l] + x)].parent =
              off[l + 1] + (y / 2) * lw[l + 1] + x / 2;
  }
  // opj_tgt_decode: 1 where the leaf's value is below threshold
  int decode(Bio& bio, int leaf, int threshold) {
    int stk[32];
    int sp = 0;
    int node = leaf;
    while (nodes[size_t(node)].parent >= 0) {
      stk[sp++] = node;
      node = nodes[size_t(node)].parent;
    }
    int low = 0;
    for (;;) {
      Node& nd = nodes[size_t(node)];
      if (low > nd.low)
        nd.low = low;
      else
        low = nd.low;
      while (low < threshold && low < nd.value) {
        if (bio.bit())
          nd.value = low;
        else
          ++low;
      }
      nd.low = low;
      if (sp == 0) break;
      node = stk[--sp];
    }
    return nodes[size_t(node)].value < threshold;
  }
};

// ---------------------------------------------------------------------------
// Codestream parameters (j2k.c)

constexpr int kMaxRes = 33, kMaxBands = 3 * kMaxRes - 2;
constexpr int kStyleLazy = 0x01, kStyleReset = 0x02, kStyleTermAll = 0x04,
              kStyleVsc = 0x08, kStylePterm = 0x10, kStyleSegSym = 0x20,
              kStyleHT = 0x40;
constexpr int kCstyPrt = 0x01, kCstySop = 0x02, kCstyEph = 0x04;
enum Prog { LRCP = 0, RLCP = 1, RPCL = 2, PCRL = 3, CPRL = 4 };

struct CompSiz {
  int prec = 0, sgnd = 0, dx = 1, dy = 1;
  int x0 = 0, y0 = 0, w = 0, h = 0;  // the component's grid (B.2)
};

struct TCCP {  // one component's coding style and quantisation
  int csty = 0, numres = 0, cblkw = 0, cblkh = 0, cblksty = 0, qmfbid = 0;
  int prcw[kMaxRes], prch[kMaxRes];
  int qntsty = 0, numgbits = 0, expn[kMaxBands], mant[kMaxBands];
  int roishift = 0;
  TCCP() {
    std::fill(prcw, prcw + kMaxRes, 15);
    std::fill(prch, prch + kMaxRes, 15);
    std::fill(expn, expn + kMaxBands, 0);
    std::fill(mant, mant + kMaxBands, 0);
  }
};

struct POC {
  int res0, comp0, lay1, res1, comp1, prg;
};

struct TCP {  // one tile's coding parameters and data
  int csty = 0, prg = 0, numlayers = 0, mct = 0;
  std::vector<TCCP> tccps;
  std::vector<POC> pocs;
  std::vector<uint8_t> data;  // its tile-parts' bodies in stream order
  int nb_parts = 0;           // TNsot once known
  int parts_read = 0;
  std::vector<std::pair<int, std::vector<uint8_t>>> ppt;  // (Zppt, Ippt)
};

struct Codestream {
  int x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  int tx0 = 0, ty0 = 0, tdx = 0, tdy = 0, tw = 0, th = 0;
  std::vector<CompSiz> comps;
  TCP deflt;
  std::vector<TCP> tiles;
  bool has_cod = false, has_qcd = false;
  uint32_t ihdr_w = 0, ihdr_h = 0;  // a JP2 file's ihdr size
  std::vector<std::pair<int, std::vector<uint8_t>>> ppm;  // (Zppm, data)
  bool has_ppm = false;
  std::vector<uint8_t> ppm_headers;  // every Ippm, the Nppm taken out
  size_t ppm_pos = 0;                // read across tiles in decode order
};

// PPM / PPT: a marker's index and data, each index once (opj_j2k_read_ppm,
// opj_j2k_read_ppt)
void read_packed(const uint8_t* p, size_t n,
                 std::vector<std::pair<int, std::vector<uint8_t>>>& into,
                 const char* what) {
  if (n < 2) fail("Error reading %s marker", what);
  for (const auto& m : into)
    if (m.first == p[0]) fail("Z%s %u already read", what, unsigned(p[0]));
  into.emplace_back(p[0], std::vector<uint8_t>(p + 1, p + n));
}

// opj_j2k_merge_ppm: the PPM markers' data in index order, read as Nppm
// (4 bytes) then Nppm bytes of packet headers, a run across markers
void merge_ppm(Codestream& cs) {
  std::sort(cs.ppm.begin(), cs.ppm.end(),
            [](const auto& a, const auto& b) { return a.first < b.first; });
  uint32_t remaining = 0;
  for (const auto& m : cs.ppm) {
    const uint8_t* d = m.second.data();
    size_t n = m.second.size();
    const size_t take = std::min<size_t>(remaining, n);
    cs.ppm_headers.insert(cs.ppm_headers.end(), d, d + take);
    remaining -= uint32_t(take);
    d += take;
    n -= take;
    while (n > 0) {
      if (n < 4) fail("Not enough bytes to read Nppm");
      const uint32_t nppm = rd32(d);
      d += 4;
      n -= 4;
      const size_t got = std::min<size_t>(nppm, n);
      cs.ppm_headers.insert(cs.ppm_headers.end(), d, d + got);
      d += got;
      n -= got;
      remaining = nppm - uint32_t(got);
    }
  }
  if (remaining) fail("Corrupted PPM markers");
}

// COD's / COC's SPcod: decomposition levels .. precinct sizes
size_t read_spcod(const uint8_t* p, size_t n, TCCP& t) {
  if (n < 5) fail("Error reading SPCod SPCoc element");
  t.numres = p[0] + 1;
  if (t.numres > kMaxRes)
    fail("Invalid value for numresolutions : %d, max value is set in "
         "openjpeg.h at %d", t.numres, kMaxRes);
  t.cblkw = p[1] + 2;  // the whole byte, as opj_j2k_read_SPCod_SPCoc
  t.cblkh = p[2] + 2;
  if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12)
    fail("Error reading SPCod SPCoc element, Invalid cblkw/cblkh "
         "combination");
  t.cblksty = p[3];
  if (t.cblksty & 0x80)
    fail("Error reading SPCod SPCoc element. Unsupported Mixed HT "
         "code-block style found");
  t.qmfbid = p[4];
  if (t.qmfbid > 1)
    fail("Error reading SPCod SPCoc element, Invalid transformation found");
  size_t used = 5;
  if (t.csty & kCstyPrt) {
    if (n < 5 + size_t(t.numres)) fail("Error reading SPCod SPCoc element");
    for (int i = 0; i < t.numres; i++) {
      const int v = p[5 + i];
      if (i != 0 && ((v & 0xf) == 0 || (v >> 4) == 0))
        fail("Invalid precinct size");
      t.prcw[i] = v & 0xf;
      t.prch[i] = v >> 4;
    }
    used += size_t(t.numres);
  } else {
    for (int i = 0; i < t.numres; i++) t.prcw[i] = t.prch[i] = 15;
  }
  return used;
}

// QCD's / QCC's Sqcd and SPqcd
size_t read_sqcd(const uint8_t* p, size_t n, TCCP& t) {
  if (n < 1) fail("Error reading SQcd or SQcc element");
  t.qntsty = p[0] & 0x1f;
  t.numgbits = p[0] >> 5;
  size_t nb;
  if (t.qntsty == 1)
    nb = 1;
  else
    nb = t.qntsty == 0 ? n - 1 : (n - 1) / 2;
  if (nb > size_t(kMaxBands)) nb = kMaxBands;  // OpenJPEG warns, keeps 97
  if (t.qntsty == 0) {
    for (size_t b = 0; b < nb; b++) {
      t.expn[b] = p[1 + b] >> 3;
      t.mant[b] = 0;
    }
    return 1 + nb;
  }
  if (n < 1 + 2 * nb) fail("Error reading SQcd or SQcc element");
  for (size_t b = 0; b < nb; b++) {
    const uint32_t v = rd16(p + 1 + 2 * b);
    t.expn[b] = int(v >> 11);
    t.mant[b] = int(v & 0x7ff);
  }
  if (t.qntsty == 1)  // scalar derived (E-5)
    for (int b = 1; b < kMaxBands; b++) {
      t.expn[b] = t.expn[0] - (b - 1) / 3 > 0 ? t.expn[0] - (b - 1) / 3 : 0;
      t.mant[b] = t.mant[0];
    }
  return 1 + 2 * nb;
}

int comp_index(const uint8_t*& p, const Codestream& cs) {
  int c;
  if (cs.comps.size() <= 256) {
    c = *p++;
  } else {
    c = int(rd16(p));
    p += 2;
  }
  return c;
}

void read_cod(const uint8_t* p, size_t n, TCP& tcp) {
  if (n < 5) fail("Error reading COD marker");
  tcp.csty = p[0];
  if (tcp.csty & ~(kCstyPrt | kCstySop | kCstyEph))
    fail("Unknown Scod value in COD marker");
  tcp.prg = p[1];
  if (tcp.prg > CPRL) fail("Unknown progression order in COD marker");
  tcp.numlayers = int(rd16(p + 2));
  if (tcp.numlayers == 0)
    fail("Invalid number of layers in COD marker : 0 not in range "
         "[1-65535]");
  tcp.mct = p[4];
  if (tcp.mct > 1) fail("Invalid multiple component transformation");
  TCCP t = tcp.tccps[0];
  t.csty = tcp.csty & kCstyPrt;
  const size_t used = read_spcod(p + 5, n - 5, t);
  if (5 + used != n) fail("Error reading COD marker");
  for (auto& c : tcp.tccps) {
    c.csty = t.csty;
    c.numres = t.numres;
    c.cblkw = t.cblkw;
    c.cblkh = t.cblkh;
    c.cblksty = t.cblksty;
    c.qmfbid = t.qmfbid;
    std::copy(t.prcw, t.prcw + kMaxRes, c.prcw);
    std::copy(t.prch, t.prch + kMaxRes, c.prch);
  }
}

void read_coc(const uint8_t* p, size_t n, TCP& tcp, const Codestream& cs) {
  const size_t room = cs.comps.size() <= 256 ? 1 : 2;
  if (n < room + 1) fail("Error reading COC marker");
  const uint8_t* q = p;
  const int c = comp_index(q, cs);
  if (c >= int(cs.comps.size()))
    fail("Error reading COC marker (bad number of components)");
  TCCP& t = tcp.tccps[size_t(c)];
  t.csty = *q++;
  const size_t used = read_spcod(q, n - room - 1, t);
  if (room + 1 + used != n) fail("Error reading COC marker");
}

void read_qcd(const uint8_t* p, size_t n, TCP& tcp) {
  TCCP t = tcp.tccps[0];
  if (read_sqcd(p, n, t) != n) fail("Error reading QCD marker");
  for (auto& c : tcp.tccps) {
    c.qntsty = t.qntsty;
    c.numgbits = t.numgbits;
    std::copy(t.expn, t.expn + kMaxBands, c.expn);
    std::copy(t.mant, t.mant + kMaxBands, c.mant);
  }
}

void read_qcc(const uint8_t* p, size_t n, TCP& tcp, const Codestream& cs) {
  const size_t room = cs.comps.size() <= 256 ? 1 : 2;
  if (n < room) fail("Error reading QCC marker");
  const uint8_t* q = p;
  const int c = comp_index(q, cs);
  if (c >= int(cs.comps.size()))
    fail("Invalid component number: %d, regarding the number of "
         "components %d", c, int(cs.comps.size()));
  if (read_sqcd(q, n - room, tcp.tccps[size_t(c)]) != n - room)
    fail("Error reading QCC marker");
}

void read_rgn(const uint8_t* p, size_t n, TCP& tcp, const Codestream& cs) {
  const size_t room = cs.comps.size() <= 256 ? 1 : 2;
  if (n != 2 + room) fail("Error reading RGN marker");
  const uint8_t* q = p;
  const int c = comp_index(q, cs);
  if (c >= int(cs.comps.size()))
    fail("bad component number in RGN (%d when there are only %d)", c,
         int(cs.comps.size()));
  q++;  // Srgn: OpenJPEG reads the ROI style and ignores it
  tcp.tccps[size_t(c)].roishift = *q;
}

void read_poc(const uint8_t* p, size_t n, TCP& tcp, const Codestream& cs) {
  const size_t room = cs.comps.size() <= 256 ? 1 : 2;
  const size_t chunk = 5 + 2 * room;
  if (n < chunk || n % chunk) fail("Error reading POC marker");
  if (tcp.pocs.size() + n / chunk >= 32) fail("Too many POCs");
  for (size_t i = 0; i < n / chunk; i++) {
    const uint8_t* q = p + i * chunk;
    POC poc;
    poc.res0 = *q++;
    poc.comp0 = comp_index(q, cs);
    poc.lay1 = int(rd16(q));
    q += 2;
    poc.res1 = *q++;
    poc.comp1 = comp_index(q, cs);
    poc.prg = *q;
    poc.comp1 = std::min(poc.comp1, int(cs.comps.size()));
    tcp.pocs.push_back(poc);
  }
}

void read_siz(const uint8_t* p, size_t n, Codestream& cs) {
  if (n < 36 || (n - 36) % 3) fail("Error with SIZ marker size");
  const int nc = int((n - 36) / 3);
  const uint32_t x1 = rd32(p + 2), y1 = rd32(p + 6), x0 = rd32(p + 10),
                 y0 = rd32(p + 14), tdx = rd32(p + 18), tdy = rd32(p + 22),
                 tx0 = rd32(p + 26), ty0 = rd32(p + 30);
  const uint32_t csiz = rd16(p + 34);
  if (int(csiz) != nc)
    fail("Error with SIZ marker: number of component is illegal -> %d",
         int(csiz));
  if (csiz == 0 || csiz > 16384)
    fail("Error with SIZ marker: number of component is illegal -> %d",
         int(csiz));
  if (x0 >= x1 || y0 >= y1)
    fail("Error with SIZ marker: negative or zero image size (%lld x %lld)",
         (long long)x1 - x0, (long long)y1 - y0);
  if (tdx == 0 || tdy == 0) fail("Error with SIZ marker: invalid tile size");
  if (tx0 > x0 || ty0 > y0)
    fail("Error with SIZ marker: illegal tile offset");
  if (uint64_t(tx0) + tdx <= x0 || uint64_t(ty0) + tdy <= y0)
    fail("Error with SIZ marker: illegal tile offset");
  if (x1 > 0x7fffffffu || y1 > 0x7fffffffu)
    fail("Error with SIZ marker: image area past 2^31 - 1");
  if (cs.ihdr_w && (cs.ihdr_w != x1 - x0 || cs.ihdr_h != y1 - y0))
    fail("Error with SIZ marker: IHDR w(%u) h(%u) vs. SIZ w(%u) h(%u)",
         cs.ihdr_w, cs.ihdr_h, x1 - x0, y1 - y0);
  cs.x0 = int(x0);
  cs.y0 = int(y0);
  cs.x1 = int(x1);
  cs.y1 = int(y1);
  cs.tx0 = int(tx0);
  cs.ty0 = int(ty0);
  cs.tdx = int(std::min<uint32_t>(tdx, 0x7fffffffu));
  cs.tdy = int(std::min<uint32_t>(tdy, 0x7fffffffu));
  cs.comps.resize(size_t(nc));
  for (int i = 0; i < nc; i++) {
    const uint8_t* q = p + 36 + 3 * i;
    CompSiz& c = cs.comps[size_t(i)];
    c.prec = (q[0] & 0x7f) + 1;
    c.sgnd = q[0] >> 7;
    c.dx = q[1];
    c.dy = q[2];
    if (c.dx < 1 || c.dy < 1)
      fail("Invalid values for comp = %d : dx=%u dy=%u (should be between "
           "1 and 255 according to the JPEG2000 norm)", i, c.dx, c.dy);
    if (c.prec > 31)
      fail("Invalid values for comp = %d : prec=%u (should be between 1 "
           "and 38 according to the JPEG2000 norm. OpenJpeg only supports "
           "up to 31)", i, c.prec);
    c.x0 = ceildiv(x0, c.dx);
    c.y0 = ceildiv(y0, c.dy);
    c.w = ceildiv(x1, c.dx) - c.x0;
    c.h = ceildiv(y1, c.dy) - c.y0;
  }
  cs.tw = ceildiv(int64_t(x1) - tx0, tdx);
  cs.th = ceildiv(int64_t(y1) - ty0, tdy);
  if (cs.tw <= 0 || cs.th <= 0 || int64_t(cs.tw) * cs.th > 65535)
    fail("Invalid number of tiles : %u x %u (maximum fixed by jpeg2000 "
         "norm is 65535 tiles)", cs.tw, cs.th);
  cs.deflt.tccps.assign(size_t(nc), TCCP());
}

// ---------------------------------------------------------------------------
// Tile structures (tcd.c)

struct Seg {
  uint32_t len = 0;
  int numpasses = 0, maxpasses = 0, numnewpasses = 0;
  uint32_t newlen = 0;
};

struct Cblk {
  int x0, y0, x1, y1;
  std::vector<uint8_t> data;
  std::vector<Seg> segs;
  int numsegs = 0, numbps = 0, numlenbits = 0, numnewpasses = 0;
  int mb = 0;            // the band's bit-planes (HT's zero bit-planes)
  size_t chunk_off = 0;  // where its first data lies in the tile's bytes
};

struct Prec {
  int x0, y0, x1, y1, cw, ch;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  int bandno, x0, y0, x1, y1, numbps;
  float stepsize;
  std::vector<Prec> precs;
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Res {
  int x0, y0, x1, y1, pw, ph, pdx, pdy, numbands;
  Band bands[3];
};

struct TileComp {
  int x0, y0, x1, y1, numres;
  std::vector<Res> res;
  std::vector<int32_t> idata;  // reversible samples
  std::vector<float> fdata;    // irreversible samples
  int w() const { return x1 - x0; }
  int h() const { return y1 - y0; }
};

struct Tile {
  int x0, y0, x1, y1;
  std::vector<TileComp> comps;
};

void init_seg(Cblk& cb, int index, int cblksty, bool first) {
  if (size_t(index) >= cb.segs.size()) cb.segs.resize(size_t(index) + 1);
  Seg& s = cb.segs[size_t(index)];
  s = Seg();
  if (cblksty & kStyleTermAll) {
    s.maxpasses = 1;
  } else if (cblksty & kStyleLazy) {
    if (first) {
      s.maxpasses = 10;
    } else {
      const int prev = cb.segs[size_t(index) - 1].maxpasses;
      s.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
    }
  } else {
    s.maxpasses = 109;
  }
}

void build_tile(const Codestream& cs, const TCP& tcp, int tileno, Tile& t) {
  const int p = tileno % cs.tw, q = tileno / cs.tw;
  t.x0 = int(std::max<int64_t>(int64_t(cs.tx0) + int64_t(p) * cs.tdx, cs.x0));
  t.y0 = int(std::max<int64_t>(int64_t(cs.ty0) + int64_t(q) * cs.tdy, cs.y0));
  t.x1 = int(std::min<int64_t>(int64_t(cs.tx0) + int64_t(p + 1) * cs.tdx,
                               cs.x1));
  t.y1 = int(std::min<int64_t>(int64_t(cs.ty0) + int64_t(q + 1) * cs.tdy,
                               cs.y1));
  t.comps.resize(cs.comps.size());
  for (size_t c = 0; c < cs.comps.size(); c++) {
    const CompSiz& ic = cs.comps[c];
    const TCCP& tccp = tcp.tccps[c];
    TileComp& tc = t.comps[c];
    tc.x0 = ceildiv(t.x0, ic.dx);
    tc.y0 = ceildiv(t.y0, ic.dy);
    tc.x1 = ceildiv(t.x1, ic.dx);
    tc.y1 = ceildiv(t.y1, ic.dy);
    tc.numres = tccp.numres;
    tc.res.resize(size_t(tc.numres));
    for (int r = 0; r < tc.numres; r++) {
      Res& res = tc.res[size_t(r)];
      const int lev = tc.numres - 1 - r;
      res.x0 = ceildivpow2(tc.x0, lev);
      res.y0 = ceildivpow2(tc.y0, lev);
      res.x1 = ceildivpow2(tc.x1, lev);
      res.y1 = ceildivpow2(tc.y1, lev);
      res.pdx = tccp.prcw[r];
      res.pdy = tccp.prch[r];
      const int tlpx = floordivpow2(res.x0, res.pdx) << res.pdx;
      const int tlpy = floordivpow2(res.y0, res.pdy) << res.pdy;
      const int64_t brpx = int64_t(ceildivpow2(res.x1, res.pdx)) << res.pdx;
      const int64_t brpy = int64_t(ceildivpow2(res.y1, res.pdy)) << res.pdy;
      res.pw = res.x0 == res.x1 ? 0 : int((brpx - tlpx) >> res.pdx);
      res.ph = res.y0 == res.y1 ? 0 : int((brpy - tlpy) >> res.pdy);
      if (int64_t(res.pw) * res.ph > (1 << 26))
        fail("Size of tile data exceeds system limits");
      int tlcbgx, tlcbgy, cbgw, cbgh;
      if (r == 0) {
        tlcbgx = tlpx;
        tlcbgy = tlpy;
        cbgw = res.pdx;
        cbgh = res.pdy;
        res.numbands = 1;
      } else {
        tlcbgx = ceildivpow2(tlpx, 1);
        tlcbgy = ceildivpow2(tlpy, 1);
        cbgw = res.pdx - 1;
        cbgh = res.pdy - 1;
        res.numbands = 3;
      }
      const int cbw = std::min(tccp.cblkw, cbgw);
      const int cbh = std::min(tccp.cblkh, cbgh);
      for (int b = 0; b < res.numbands; b++) {
        Band& band = res.bands[b];
        const int sidx = r == 0 ? 0 : 3 * r - 2 + b;
        if (r == 0) {
          band.bandno = 0;
          band.x0 = ceildivpow2(tc.x0, lev);
          band.y0 = ceildivpow2(tc.y0, lev);
          band.x1 = ceildivpow2(tc.x1, lev);
          band.y1 = ceildivpow2(tc.y1, lev);
        } else {
          band.bandno = b + 1;
          const int x0b = band.bandno & 1, y0b = band.bandno >> 1;
          band.x0 = ceildivpow2(int64_t(tc.x0) - (int64_t(x0b) << lev),
                                lev + 1);
          band.y0 = ceildivpow2(int64_t(tc.y0) - (int64_t(y0b) << lev),
                                lev + 1);
          band.x1 = ceildivpow2(int64_t(tc.x1) - (int64_t(x0b) << lev),
                                lev + 1);
          band.y1 = ceildivpow2(int64_t(tc.y1) - (int64_t(y0b) << lev),
                                lev + 1);
        }
        // E.1 with OpenJPEG's gain: none for 9/7 (its inverse scales the
        // high band by 2/K), the nominal gain for 5/3
        const int gain = tccp.qmfbid == 0 ? 0
                         : band.bandno == 0 ? 0
                         : band.bandno == 3 ? 2
                                            : 1;
        const int rb = ic.prec + gain;
        band.stepsize = float((1.0 + tccp.mant[sidx] / 2048.0) *
                              std::pow(2.0, double(rb - tccp.expn[sidx]))) *
                        1.0f;
        band.numbps = tccp.expn[sidx] + tccp.numgbits - 1;
        band.precs.clear();
        if (band.empty()) continue;
        band.precs.resize(size_t(res.pw) * size_t(res.ph));
        for (int pn = 0; pn < res.pw * res.ph; pn++) {
          Prec& pr = band.precs[size_t(pn)];
          const int64_t gx = tlcbgx + int64_t(pn % res.pw) * (int64_t(1) << cbgw);
          const int64_t gy = tlcbgy + int64_t(pn / res.pw) * (int64_t(1) << cbgh);
          pr.x0 = int(std::max<int64_t>(gx, band.x0));
          pr.y0 = int(std::max<int64_t>(gy, band.y0));
          pr.x1 = int(std::min<int64_t>(gx + (int64_t(1) << cbgw), band.x1));
          pr.y1 = int(std::min<int64_t>(gy + (int64_t(1) << cbgh), band.y1));
          const int tlcx = floordivpow2(pr.x0, cbw) << cbw;
          const int tlcy = floordivpow2(pr.y0, cbh) << cbh;
          const int brcx = ceildivpow2(pr.x1, cbw) << cbw;
          const int brcy = ceildivpow2(pr.y1, cbh) << cbh;
          pr.cw = std::max(0, (brcx - tlcx) >> cbw);
          pr.ch = std::max(0, (brcy - tlcy) >> cbh);
          pr.cblks.resize(size_t(pr.cw) * size_t(pr.ch));
          for (int k = 0; k < pr.cw * pr.ch; k++) {
            Cblk& cb = pr.cblks[size_t(k)];
            const int cx = tlcx + (k % pr.cw) * (1 << cbw);
            const int cy = tlcy + (k / pr.cw) * (1 << cbh);
            cb.x0 = std::max(cx, pr.x0);
            cb.y0 = std::max(cy, pr.y0);
            cb.x1 = std::min(cx + (1 << cbw), pr.x1);
            cb.y1 = std::min(cy + (1 << cbh), pr.y1);
          }
          pr.incl.init(pr.cw, pr.ch);
          pr.imsb.init(pr.cw, pr.ch);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Packet iterator (B.12; pi.c): the progression orders over a POC's ranges,
// each packet once (the include table)

struct PacketIter {
  const Codestream& cs;
  const TCP& tcp;
  const Tile& t;
  std::vector<uint8_t> include;
  int maxres = 0, maxprec = 0, nc;
  PacketIter(const Codestream& c, const TCP& p, const Tile& tl)
      : cs(c), tcp(p), t(tl), nc(int(c.comps.size())) {
    for (const auto& tc : t.comps) {
      maxres = std::max(maxres, tc.numres);
      for (const auto& r : tc.res) maxprec = std::max(maxprec, r.pw * r.ph);
    }
    include.assign(size_t(tcp.numlayers) * size_t(maxres) * size_t(nc) *
                       size_t(std::max(maxprec, 1)),
                   0);
  }
  bool take(int l, int r, int c, int p) {
    const size_t i =
        ((size_t(l) * size_t(maxres) + size_t(r)) * size_t(nc) + size_t(c)) *
            size_t(std::max(maxprec, 1)) +
        size_t(p);
    if (include[i]) return false;
    include[i] = 1;
    return true;
  }

  // the precinct of component c, resolution r at position (x, y), or -1
  int position_precinct(int c, int r, int64_t x, int64_t y) {
    const TileComp& tc = t.comps[size_t(c)];
    const Res& res = tc.res[size_t(r)];
    const int64_t dx = cs.comps[size_t(c)].dx, dy = cs.comps[size_t(c)].dy;
    const int lev = tc.numres - 1 - r;
    if (lev >= 32) return -1;
    const int64_t trx0 = ceildiv(t.x0, dx << lev), try0 = ceildiv(t.y0, dy << lev);
    const int64_t trx1 = ceildiv(t.x1, dx << lev), try1 = ceildiv(t.y1, dy << lev);
    const int rpx = res.pdx + lev, rpy = res.pdy + lev;
    if (rpx >= 31 || rpy >= 31) return -1;
    if (!((y % (dy << rpy)) == 0 ||
          (y == t.y0 && ((try0 << lev) % (int64_t(1) << rpy)))))
      return -1;
    if (!((x % (dx << rpx)) == 0 ||
          (x == t.x0 && ((trx0 << lev) % (int64_t(1) << rpx)))))
      return -1;
    if (res.pw == 0 || res.ph == 0) return -1;
    if (trx0 == trx1 || try0 == try1) return -1;
    const int64_t prci = (ceildiv(x, dx << lev) >> res.pdx) - (trx0 >> res.pdx);
    const int64_t prcj = (ceildiv(y, dy << lev) >> res.pdy) - (try0 >> res.pdy);
    return int(prci + prcj * res.pw);
  }

  // the smallest precinct step over components [c0, c1) on the grid
  void steps(int c0, int c1, int64_t& sx, int64_t& sy) {
    sx = sy = 0;
    for (int c = c0; c < c1; c++) {
      const TileComp& tc = t.comps[size_t(c)];
      for (int r = 0; r < tc.numres; r++) {
        const Res& res = tc.res[size_t(r)];
        const int ex = res.pdx + tc.numres - 1 - r;
        const int ey = res.pdy + tc.numres - 1 - r;
        if (ex < 32) {
          const int64_t d = int64_t(cs.comps[size_t(c)].dx) << ex;
          sx = sx == 0 ? d : std::min(sx, d);
        }
        if (ey < 32) {
          const int64_t d = int64_t(cs.comps[size_t(c)].dy) << ey;
          sy = sy == 0 ? d : std::min(sy, d);
        }
      }
    }
  }

  template <class F>
  void run(F&& packet) {
    std::vector<POC> pocs = tcp.pocs;
    if (pocs.empty())
      pocs.push_back(POC{0, 0, tcp.numlayers, maxres, nc, tcp.prg});
    for (const POC& poc : pocs) {
      const int l1 = std::min(poc.lay1, tcp.numlayers);
      const int r0 = poc.res0, r1 = poc.res1, c0 = poc.comp0,
                c1 = std::min(poc.comp1, nc);
      auto nprec = [&](int c, int r) {
        const Res& res = t.comps[size_t(c)].res[size_t(r)];
        return res.pw * res.ph;
      };
      auto has = [&](int c, int r) { return r < t.comps[size_t(c)].numres; };
      switch (poc.prg) {
        case LRCP:
          for (int l = 0; l < l1; l++)
            for (int r = r0; r < r1; r++)
              for (int c = c0; c < c1; c++) {
                if (!has(c, r)) continue;
                for (int p = 0; p < nprec(c, r); p++)
                  if (take(l, r, c, p)) packet(l, r, c, p);
              }
          break;
        case RLCP:
          for (int r = r0; r < r1; r++)
            for (int l = 0; l < l1; l++)
              for (int c = c0; c < c1; c++) {
                if (!has(c, r)) continue;
                for (int p = 0; p < nprec(c, r); p++)
                  if (take(l, r, c, p)) packet(l, r, c, p);
              }
          break;
        case RPCL: {
          int64_t sx, sy;
          steps(0, nc, sx, sy);
          if (sx == 0 || sy == 0) break;
          for (int r = r0; r < r1; r++)
            for (int64_t y = t.y0; y < t.y1; y += sy - (y % sy))
              for (int64_t x = t.x0; x < t.x1; x += sx - (x % sx))
                for (int c = c0; c < c1; c++) {
                  if (!has(c, r)) continue;
                  const int p = position_precinct(c, r, x, y);
                  if (p < 0) continue;
                  for (int l = 0; l < l1; l++)
                    if (take(l, r, c, p)) packet(l, r, c, p);
                }
          break;
        }
        case PCRL: {
          int64_t sx, sy;
          steps(0, nc, sx, sy);
          if (sx == 0 || sy == 0) break;
          for (int64_t y = t.y0; y < t.y1; y += sy - (y % sy))
            for (int64_t x = t.x0; x < t.x1; x += sx - (x % sx))
              for (int c = c0; c < c1; c++)
                for (int r = r0; r < std::min(r1, t.comps[size_t(c)].numres);
                     r++) {
                  const int p = position_precinct(c, r, x, y);
                  if (p < 0) continue;
                  for (int l = 0; l < l1; l++)
                    if (take(l, r, c, p)) packet(l, r, c, p);
                }
          break;
        }
        case CPRL:
          for (int c = c0; c < c1; c++) {
            int64_t sx, sy;
            steps(c, c + 1, sx, sy);
            if (sx == 0 || sy == 0) continue;
            for (int64_t y = t.y0; y < t.y1; y += sy - (y % sy))
              for (int64_t x = t.x0; x < t.x1; x += sx - (x % sx))
                for (int r = r0; r < std::min(r1, t.comps[size_t(c)].numres);
                     r++) {
                  const int p = position_precinct(c, r, x, y);
                  if (p < 0) continue;
                  for (int l = 0; l < l1; l++)
                    if (take(l, r, c, p)) packet(l, r, c, p);
                }
          }
          break;
        default:
          fail("Unknown progression order %d", poc.prg);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Tier 2 (t2.c): one packet's header and body from the tile's data

int getnumpasses(Bio& bio) {
  if (!bio.read(1)) return 1;
  if (!bio.read(1)) return 2;
  int n = int(bio.read(2));
  if (n != 3) return 3 + n;
  n = int(bio.read(5));
  if (n != 31) return 6 + n;
  return 37 + int(bio.read(7));
}

int floorlog2(uint32_t v) {
  int l = 0;
  while (v > 1) {
    v >>= 1;
    l++;
  }
  return l;
}

// Where a packet's header is read: the packet's own bytes, or the packed
// headers of PPM / PPT, read on from `pos`
struct Headers {
  const uint8_t* p;
  size_t len, *pos;
};

// reads the packet at data[0..len) (its header there too, or from packed
// headers); returns the bytes it took of data
size_t decode_packet(const TCP& tcp, Tile& t, int layno, int resno,
                     int compno, int precno, const uint8_t* data,
                     size_t len, size_t at, const Headers* packed) {
  const TCCP& tccp = tcp.tccps[size_t(compno)];
  Res& res = t.comps[size_t(compno)].res[size_t(resno)];
  size_t sop = 0;
  if (tcp.csty & kCstySop) {
    // a missing SOP is only warned about
    if (len >= 6 && data[0] == 0xff && data[1] == 0x91) sop = 6;
  }
  // the header's bytes: hp[hstart..hlen)
  const uint8_t* hp = packed ? packed->p : data;
  const size_t hlen = packed ? packed->len : len;
  const size_t hstart = packed ? *packed->pos : sop;
  Bio bio(hp + hstart, hlen - hstart);
  const int present = int(bio.read(1));
  auto eph = [&](size_t at) -> size_t {
    if (!(tcp.csty & kCstyEph)) return at;
    if (hlen - at < 2) fail("Not enough space for required EPH marker");
    if (hp[at] != 0xff || hp[at + 1] != 0x92) fail("Expected EPH marker");
    return at + 2;
  };
  // the header's end in its stream; where the body starts in data
  auto header_done = [&]() -> size_t {
    bio.inalign();
    const size_t end = eph(hstart + bio.numbytes());
    if (!packed) return end;
    *packed->pos = end;
    return sop;
  };
  if (!present) return header_done();
  for (int b = 0; b < res.numbands; b++) {
    Band& band = res.bands[b];
    if (band.empty()) continue;
    Prec& pr = band.precs[size_t(precno)];
    for (int k = 0; k < pr.cw * pr.ch; k++) {
      Cblk& cb = pr.cblks[size_t(k)];
      int included;
      if (!cb.numsegs)
        included = pr.incl.decode(bio, k, layno + 1);
      else
        included = int(bio.read(1));
      if (!included) {
        cb.numnewpasses = 0;
        continue;
      }
      if (!cb.numsegs) {
        int i = 0;
        while (!pr.imsb.decode(bio, k, i)) {
          ++i;
          if (i > 74) fail("opj_t2_read_packet_header: too many zero "
                           "bit-planes");
        }
        cb.numbps = band.numbps + 1 - i;
        cb.mb = band.numbps;
        cb.numlenbits = 3;
      }
      cb.numnewpasses = getnumpasses(bio);
      int inc = 0;
      while (bio.read(1)) inc++;
      cb.numlenbits += inc;
      int segno;
      if (!cb.numsegs) {
        segno = 0;
        init_seg(cb, 0, tccp.cblksty, true);
      } else {
        segno = cb.numsegs - 1;
        if (cb.segs[size_t(segno)].numpasses ==
            cb.segs[size_t(segno)].maxpasses) {
          ++segno;
          init_seg(cb, segno, tccp.cblksty, false);
        }
      }
      int n = cb.numnewpasses;
      const bool ht = (tccp.cblksty & kStyleHT) != 0;
      do {
        Seg& s = cb.segs[size_t(segno)];
        // HT (opj_t2_read_packet_header): the first segment one pass, a
        // later one the rest, whatever the style's segment sizes; a later
        // layer's passes so land in the cleanup's segment unless termall
        // closed it (its data then read as the cleanup's, as cv2 does)
        s.numnewpasses = ht ? (segno == 0 ? 1 : n)
                            : std::min(s.maxpasses - s.numpasses, n);
        const int bits = cb.numlenbits + floorlog2(uint32_t(s.numnewpasses));
        if (bits > 32)
          fail("read: signaled numlenbits=%d and numnewpasses=%d",
               cb.numlenbits, s.numnewpasses);
        s.newlen = bio.read(bits);
        n -= s.numnewpasses;
        if (n > 0) {
          ++segno;
          init_seg(cb, segno, tccp.cblksty, false);
        }
      } while (n > 0);
    }
  }
  size_t pos = header_done();
  // the body: each included code-block's new segments
  for (int b = 0; b < res.numbands; b++) {
    Band& band = res.bands[b];
    if (band.empty()) continue;
    Prec& pr = band.precs[size_t(precno)];
    for (auto& cb : pr.cblks) {
      if (!cb.numnewpasses) continue;
      int si;
      if (!cb.numsegs) {
        si = 0;
        cb.numsegs = 1;
      } else {
        si = cb.numsegs - 1;
        if (cb.segs[size_t(si)].numpasses == cb.segs[size_t(si)].maxpasses) {
          ++si;
          ++cb.numsegs;
        }
      }
      do {
        Seg& s = cb.segs[size_t(si)];
        if (uint64_t(pos) + s.newlen > len)
          fail("read: segment too long (%u) with max (%u) for codeblock",
               s.newlen, unsigned(len - pos));
        if (cb.data.empty()) cb.chunk_off = at + pos;
        cb.data.insert(cb.data.end(), data + pos, data + pos + s.newlen);
        pos += s.newlen;
        s.len += s.newlen;
        s.numpasses += s.numnewpasses;
        cb.numnewpasses -= s.numnewpasses;
        if (cb.numnewpasses > 0) {
          ++si;
          ++cb.numsegs;
        }
      } while (cb.numnewpasses > 0);
    }
  }
  return pos;
}

// ---------------------------------------------------------------------------
// Tier 1 (t1.c): one code-block's passes into OpenJPEG's fixed-point
// magnitudes (bit-plane p carries 2^(p+1), so a newly significant sample is
// 1.5 units of its plane and a refinement moves half a unit)

// A sample's flags: its own state, and the significance (and, for the
// four direct neighbours, the sign) of its eight neighbours, set when a
// neighbour becomes significant (t1.c keeps the same, packed by column).
// Under the vertically causal style a sample in a stripe's first row does
// not tell the row above it.
constexpr uint16_t kSig = 0x1, kVisit = 0x2, kRef = 0x4, kNeg = 0x8;
constexpr uint16_t kN = 0x10, kS = 0x20, kW = 0x40, kE = 0x80, kNW = 0x100,
                   kNE = 0x200, kSW = 0x400, kSE = 0x800;
constexpr uint16_t kNNeg = 0x1000, kSNeg = 0x2000, kWNeg = 0x4000,
                   kENeg = 0x8000;
constexpr uint16_t kNeighbours = 0xff0;

// Zero-coding contexts (Table D.1) by band and neighbour bits (flags >> 4),
// sign contexts and XOR bits (Table D.3) by the direct neighbours'
// significance and sign ((flags >> 4) & 0xf | (flags >> 8) & 0xf0)
struct T1Tables {
  uint8_t zc[4][256];
  uint8_t sc[256], spb[256];
  T1Tables() {
    for (int o = 0; o < 4; o++)
      for (int f = 0; f < 256; f++) {
        const int n = f & 1, s = (f >> 1) & 1, w = (f >> 2) & 1,
                  e = (f >> 3) & 1;
        int hh = w + e, vv = n + s;
        const int dd = ((f >> 4) & 1) + ((f >> 5) & 1) + ((f >> 6) & 1) +
                       ((f >> 7) & 1);
        int ctx;
        if (o == 3) {
          const int hv = hh + vv;
          if (!dd) ctx = hv == 0 ? 0 : hv == 1 ? 1 : 2;
          else if (dd == 1) ctx = hv == 0 ? 3 : hv == 1 ? 4 : 5;
          else if (dd == 2) ctx = hv == 0 ? 6 : 7;
          else ctx = 8;
        } else {
          if (o == 1) std::swap(hh, vv);
          if (!hh) {
            if (!vv) ctx = dd == 0 ? 0 : dd == 1 ? 1 : 2;
            else ctx = vv == 1 ? 3 : 4;
          } else if (hh == 1) {
            ctx = vv ? 7 : dd ? 6 : 5;
          } else {
            ctx = 8;
          }
        }
        zc[o][f] = uint8_t(ctx);
      }
    for (int f = 0; f < 256; f++) {
      auto c = [&](int sig, int neg) { return (f >> sig & 1) ? ((f >> neg & 1) ? -1 : 1) : 0; };
      const int nv = c(0, 4), sv = c(1, 5), wv = c(2, 6), ev = c(3, 7);
      auto sgn = [](int a, int b) {
        return std::min(int(a > 0) + int(b > 0), 1) -
               std::min(int(a < 0) + int(b < 0), 1);
      };
      int hc = sgn(ev, wv), vc = sgn(nv, sv);
      spb[f] = uint8_t((!hc && !vc) ? 0 : !(hc > 0 || (!hc && vc > 0)));
      if (hc < 0) {
        hc = -hc;
        vc = -vc;
      }
      const int n = !hc ? (vc == 0 ? 0 : 1) : (vc == -1 ? 2 : vc == 0 ? 3 : 4);
      sc[f] = uint8_t(kCtxSC + n);
    }
  }
};
const T1Tables kT1;

struct T1 {
  int w = 0, h = 0, fs = 0;  // fs: the padded flag stride
  bool vsc = false;
  int orient = 0;
  std::vector<uint16_t> f;   // (h + 2) x (w + 2) flags, a zero border
  std::vector<int32_t> d;    // h x w magnitudes with sign
  MQ mq;

  uint16_t* fl(int x, int y) { return &f[size_t(y + 1) * size_t(fs) + size_t(x + 1)]; }

  int zc_ctx(uint16_t v) const { return kT1.zc[orient][(v >> 4) & 0xff]; }
  void set_sig(int x, int y, int neg, int32_t val) {
    uint16_t* p = fl(x, y);
    *p |= uint16_t(kSig | (neg ? kNeg : 0));
    p[-1] |= uint16_t(kE | (neg ? kENeg : 0));
    p[1] |= uint16_t(kW | (neg ? kWNeg : 0));
    if (!(vsc && (y & 3) == 0)) {
      uint16_t* n = p - fs;
      n[0] |= uint16_t(kS | (neg ? kSNeg : 0));
      n[-1] |= kSE;
      n[1] |= kSW;
    }
    uint16_t* s = p + fs;
    s[0] |= uint16_t(kN | (neg ? kNNeg : 0));
    s[-1] |= kNE;
    s[1] |= kNW;
    d[size_t(y) * size_t(w) + size_t(x)] = neg ? -val : val;
  }
  void decode_sign(int x, int y, int32_t oneplushalf) {
    const uint16_t v = *fl(x, y);
    const int k = ((v >> 4) & 0xf) | ((v >> 8) & 0xf0);
    const int bit = mq.decode(kT1.sc[k]) ^ kT1.spb[k];
    set_sig(x, y, bit, oneplushalf);
  }

  template <class Visit>
  void stripes(Visit&& visit) {
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; x++)
        for (int y = k; y < std::min(k + 4, h); y++) visit(x, y);
  }

  void sigpass(int bpno, bool raw) {
    const int32_t one = int32_t(1) << bpno, oneplushalf = one | (one >> 1);
    stripes([&](int x, int y) {
      uint16_t* p = fl(x, y);
      const uint16_t v = *p;
      if ((v & (kSig | kVisit)) || !(v & kNeighbours)) return;
      if (raw) {
        if (mq.raw()) set_sig(x, y, mq.raw(), oneplushalf);
      } else if (mq.decode(kCtxZC + zc_ctx(v))) {
        decode_sign(x, y, oneplushalf);
      }
      *p |= kVisit;
    });
  }

  void refpass(int bpno, bool raw) {
    const int32_t poshalf = (int32_t(1) << bpno) >> 1;
    stripes([&](int x, int y) {
      uint16_t* p = fl(x, y);
      const uint16_t v = *p;
      if ((v & (kSig | kVisit)) != kSig) return;
      int bit;
      if (raw) {
        bit = mq.raw();
      } else {
        const int ctx = (v & kRef) ? kCtxMag + 2
                        : (v & kNeighbours) ? kCtxMag + 1
                                            : kCtxMag;
        bit = mq.decode(ctx);
      }
      int32_t& dv = d[size_t(y) * size_t(w) + size_t(x)];
      dv += (bit ^ (dv < 0)) ? poshalf : -poshalf;
      *p |= kRef;
    });
  }

  void clnpass(int bpno, bool segsym) {
    const int32_t one = int32_t(1) << bpno, oneplushalf = one | (one >> 1);
    auto step = [&](int x, int y, bool check, bool partial) {
      const uint16_t v = *fl(x, y);
      if (check && (v & (kSig | kVisit))) return;
      if (!partial && !mq.decode(kCtxZC + zc_ctx(v))) return;
      decode_sign(x, y, oneplushalf);
    };
    for (int k = 0; k < h; k += 4) {
      for (int x = 0; x < w; x++) {
        if (k + 3 < h) {
          const uint16_t any = *fl(x, k) | *fl(x, k + 1) | *fl(x, k + 2) |
                               *fl(x, k + 3);
          if (!(any & (kSig | kVisit | kNeighbours))) {
            if (!mq.decode(kCtxAgg)) continue;
            int runlen = mq.decode(kCtxUni);
            runlen = (runlen << 1) | mq.decode(kCtxUni);
            step(x, k + runlen, false, true);
            for (int y = k + runlen + 1; y < k + 4; y++) step(x, y, false, false);
          } else {
            for (int y = k; y < k + 4; y++) step(x, y, true, false);
          }
        } else {
          for (int y = k; y < h; y++) step(x, y, true, false);
        }
        for (int y = k; y < std::min(k + 4, h); y++)
          *fl(x, y) &= uint16_t(~kVisit);
      }
    }
    if (segsym)
      for (int i = 0; i < 4; i++) mq.decode(kCtxUni);
  }

  // opj_t1_decode_cblk
  void decode(const Cblk& cb, int orient_, int roishift, int cblksty) {
    w = cb.x1 - cb.x0;
    h = cb.y1 - cb.y0;
    fs = w + 2;
    orient = orient_;
    vsc = (cblksty & kStyleVsc) != 0;
    f.assign(size_t(h + 2) * size_t(fs), 0);
    d.assign(size_t(w) * size_t(h), 0);
    mq.reset_states();
    int bpno_plus_one = roishift + cb.numbps;
    if (bpno_plus_one >= 31)
      fail("opj_t1_decode_cblk(): unsupported bpno_plus_one = %d >= 31",
           bpno_plus_one);
    int passtype = 2;
    std::vector<uint8_t> buf;
    size_t off = 0;
    for (int si = 0; si < cb.numsegs; si++) {
      const Seg& s = cb.segs[size_t(si)];
      buf.assign(cb.data.begin() + long(off),
                 cb.data.begin() + long(off + s.len));
      buf.push_back(0xff);
      buf.push_back(0xff);
      off += s.len;
      const bool raw = bpno_plus_one <= cb.numbps - 4 && passtype < 2 &&
                       (cblksty & kStyleLazy);
      if (raw)
        mq.raw_init(buf.data());
      else
        mq.init(buf.data(), s.len);
      for (int pn = 0; pn < s.numpasses && bpno_plus_one >= 1; pn++) {
        switch (passtype) {
          case 0:
            sigpass(bpno_plus_one, raw);
            break;
          case 1:
            refpass(bpno_plus_one, raw);
            break;
          default:
            clnpass(bpno_plus_one, (cblksty & kStyleSegSym) != 0);
        }
        if ((cblksty & kStyleReset) && !raw) mq.reset_states();
        if (++passtype == 3) {
          passtype = 0;
          bpno_plus_one--;
        }
      }
    }
    if (roishift) {
      if (roishift >= 31) {
        std::fill(d.begin(), d.end(), 0);
      } else {
        const int32_t thresh = int32_t(1) << roishift;
        for (auto& v : d) {
          int32_t mag = v < 0 ? -v : v;
          if (mag >= thresh) {
            mag >>= roishift;
            v = v < 0 ? -mag : mag;
          }
        }
      }
    }
  }
};

// ---------------------------------------------------------------------------
// HT block decoding (ITU-T T.814 | ISO/IEC 15444-15; ht_dec.c
// opj_t1_ht_decode_cblk): the cleanup pass's MEL, backward VLC and forward
// MagSgn streams, then SigProp and MagRef, into the same fixed-point
// magnitudes as tier 1 (a cleanup at bit-plane p - 1 carries (2 mu + 1)
// << (p - 1)). Each reader takes its bytes one at a time as OpenJPEG's
// take them four at a time: the same bits, the same fill past the end
// (MEL and MagSgn 0xFF, VLC, SigProp and MagRef 0), the same unstuffing
// (a byte after 0xFF gives 7 bits forward; backward, a byte after one over
// 0x8F gives 7 bits when those are all ones), its dropped bit OR'ed into
// the next as OpenJPEG's shifts do.

// The CxtVLC codewords of T.814 Annex C, 7 hex digits each: c_q (3 bits),
// rho (4), u_off (1), e_k (4), e_1 (4), the codeword (7 bits, the first
// read lowest) and its length (3); for the quads of the first row pair,
// then for the later ones. OpenJPEG tabulates the same codewords as
// vlc_tbl0 / vlc_tbl1 (t1_ht_luts.h), by context and the next 7 bits.
constexpr const char* kHtVlcFirst =
    "008003400c45ff01000030148bff018008d01c8aff01cc4ff0200013025109e0280075"
    "02d111e02d447f030001e034037f038017f03c806e03c8a7f040002304621ee04800ee"
    "04c016e050000d05621ae0568bbf05801bf05c404e05c46bf06000f506710ae067212e"
    "06730bf068033f06c453f06d523f06f603f07003df0748a5f076a02e07791df07802df"
    "07e64df07eeb5f07f88ce07f9b9f07fc59f07fd14e07fd45f07fe1ce07ff15f0800002"
    "088007408c44ff090003409489de09800de09c01ee0a000540a5115e0a8005e0ad119e"
    "0ad47ff0b0009e0b4011e0b801ff0bc801e0bc8aff0c000140c620ee0c8016e0cc006e"
    "0d001ae0d620ae0d68b7f0d8017f0dc408e0dc467f0e0000d0e6212e0e7102e0e8007f"
    "0ec44bf0ed51ce0ef63bf0f001bf0f48abf0f6a0ce0f7933f0f8003f0fe213f0fe884e"
    "0fee14e0ff918e0ffc63f1000002108007410c44de110003411489ff118015e11c459e"
    "11ccbff1200054125105e128000d12d449e12d511e12d557f130001e13402ff13800ff"
    "13c8b7f13cc48e13dd1bf1400014146227f14801ee14c00ee150016e154006e158007f"
    "15c81ae15c8bbf16000ae165112e16722bf16800bf16e202e16f11ce16f473f170013f"
    "17480ce1748bdf178023f17c444e17cc83f17dd18e17fc54e17fe1df18000031880024"
    "18c45ee19000651948a7f19800ee19c442e19ccbff1a000b51a5116e1a800351ad446e"
    "1ad51ae1ad54d51b001ff1b512ff1b588ff1b8037f1bd90ae1bd997f1bdc52e1bdc87f"
    "1bdcfbf1c000551c6203f1c801ce1cc45bf1ce62bf1d000ce1d6214e1d688bf1d8033f"
    "1dc463f1dcc84e1dec53f1dee3df1e0018e1e5108e1e721df1e802df1ee64df1ef450e"
    "1ef500e1ef555f1ef625f1ef735f1f0005f1f5109f1f721f61f7899f1f7939f1f8029f"
    "1fea8761fee71f1ff991f1ffc4e51ffc9761ffce1f1ffd0151ffd4f61ffe0951fff01f"
    "2000002208007420c45ff210003421488de218015e21c89ee21cc7ff220005422512ff"
    "228005e22c019e230009e234011e23800ff23d001e23d137f240001424620ee248008e"
    "24c03bf250000d256896e256a06e256a97f258027f25c01ae25ec87f26000ae266212e"
    "26711bf26802bf26c402e26c443f27000bf27511ce27720ce2778b3f278013f27dc84e"
    "27ddbdf27e454e27e663f27ee18e27fd1df280000328800d528c47ff290005529488ee"
    "298016e29cc5ff29cc9ce29cceff2a000952a510ff2a8006e2ad11ae2ad477f2b000ae"
    "2b4892e2b5917f2b8027f2bd902e2bd9abf2bdc5bf2bdcbbf2bdcc7f2c000152c620ce"
    "2c801362ce20bf2ce473f2d000e52d6884e2d6a18e2d6a94e2d8013f2de608e2de643f"
    "2dec7df2dec90e2dece3f2e0000e2e621f62e711df2e802df2ee60f62ee675f2ef455f"
    "2ef51762ef54df2f0025f2f5985f2f788762f7929f2f7a1b62f7a99f2f7b39f2f8009f"
    "2fdd71f2fdd8b62fdde1f2ff641f2ffc4362ffc8252ffcfef2ffd0652ffe0a52ffe9ef"
    "2fff11f3000003308002430c441e3100065314886e31800d531cc4ee31cc96e31ccdee"
    "320005532511ff32801ae32c44ae32d53ff330012e3348aff33590ff338037f33d902e"
    "33d9a7f33dc5b633dcbbf33dcd7f3400095346207f34801ce34c45bf34e62bf35000ce"
    "354894e356a0bf358033f35e444e35e663f35ec98e35ee3df35ee93f360008e36711df"
    "367210e367303f36802df36d500e36d559f36f20df36f475f370015f374885f3778a5f"
    "377929f377a1f6377b39f378009f37d98f637ee71f37fa97637fc4e537fc81537fcc76"
    "37fd13637fd51f37fe03637ff0b63800095388002e38c47ff39001ce39489ff39802ff"
    "39cc57f39ccb7f39cccff3a0027f3a5107f3a802bf3ac44ce3ad53bf3b001bf3b4014e"
    "3b800bf3bd9b3f3bdc44e3bdca3f3bdcd3f3bdd03f3bdd4df3c003df3c621df3c802df"
    "3cc018e3d0029f3d4888e3d6a35f3d8015f3de665f3dec79f3dec90e3decc5f3dee09f"
    "3dee99f3e0031f3e6211f3e7121f3e8001f3ee67ef3ef440e3ef51f63ef56ef3ef60ef"
    "3ef71ef3f0036f3f5996f3f788f63f793af3f7a0763f7a86f3f7b26f3f800af3ffc404"
    "3ffc8643ffcc553ffd0443ffd4d53ffd9b63ffdeaf3ffe0243ffe5763ffe8153ffed2f"
    "3fff0b63fff5af3fffb2f3fffc35";
constexpr const char* kHtVlcLater =
    "008000300c453e010003301488be018006d01c01de0200013025103e02800ad02c015e"
    "030000d03403ff03800ff03c00de0400023046202d04800cd04c009e050004d056205e"
    "05689ff05802ff05c019e060008d066211e067137f068007f06c001e070017f07501ee"
    "075127f07803bf07c40ee07c45bf0800001088002c08c47ff090004c09488ff09800ed"
    "09c45ff09ccaff0a0006d0a511bf0a8001e0ac037f0b0017f0b4027f0b8007f0bc03bf"
    "0c0000c0c620bf0c8005e0cc02bf0d0019e0d4033f0d8013f0dc015f0e0009e0e4023f"
    "0e8003f0ec03df0f001df0f402df0f800df0fd011e0fd135f1000001108004c10c47ff"
    "110000c114891e11801ee11c89ff11cc4ff12000ad12512ff128001e12c037f130017f"
    "134027f138007f13c00bf140002d14623bf14801bf14c02bf15000ee156896e156a33f"
    "156abdf158013f15c003f15eca3f160006e16401df16802df16c00df170035f175025f"
    "175115f178005f17d139f17d459f17dca9f17fe09f1800002188005418c445e1900014"
    "194891e198007519cc49e19cc99e19ccfff1a000b51a511ff1a8001e1ac45ee1ad50ff"
    "1b000ee1b402ff1b8016e1bd117f1bd44f61bdcb7f1c000351c6227f1c8006e1cc01ae"
    "1d000ae1d4892e1d6a07f1d8002e1de21ce1dec7bf1dec8ce1deccbf1e0014e1e4004e"
    "1e801bf1ed018e1ed12bf1f0033f1f5113f1f7223f1f78b5f1f8008e1fd983f1fdcfdf"
    "1fea2df1ffc5f61ffc90e1ffd15f1ffd4df1ffe00e1ffe9df2000001208006d20c47ff"
    "21000ad21489ff21802ff21c037f220004c225111e228019e22c00ff230009e234017f"
    "238027f23c02bf240000c246207f24803bf24c01bf25000ee25400bf258033f25c035f"
    "260002d267103f267223f267313f26803df26c01df27002df274801e27488df278015f"
    "27c465f27cc1ee27cc85f280000228800f528c45de290005529489ff29800de29c005e"
    "2a000142a5115e2a800752ad119e2ad47ff2b0009e2b4037f2b8011e2bc80ae2bc8aff"
    "2c000b52c6201e2c801ee2cc00ff2d000ee2d4016e2d8006e2dc41ae2dc467f2e00035"
    "2e5112e2e7217f2e8002e2ec47bf2ed51ce2ef607f2f000ce2f48abf2f6a00e2f791bf"
    "2f800d52fdd93f2fe64bf2ff573f2ffc54e2ffc90e2ffcc3f2ffd18e2ffe08e2ffea3f"
    "2fff04e3000003308001430c441e310006431489ee31800ee31c886e31cc7ff3200024"
    "325116e328005532d11ae32d457f33000ae33489ff33592ff338012e33c894e33cc4ff"
    "33dd37f34000b5346202e34801ce34c00ce3500035356884e356a27f356a87f3580076"
    "35c89bf35ea2bf35ec63f35ecbbf36000d5367113f367233f36730bf368018e36d13df"
    "36f21df36f455f36f503f370008e37510df377899f37792df377a10e377ab5f378000e"
    "37cce5f37dd85f37ee69f37fc51f37fc9f637fd17637fd49f37fe0f637feb9f37ff31f"
    "3800024388019e38c449e390011e3948bff398001e39c45ff39ccb7f3a0016e3a512ff"
    "3a800b53ac45ee3ad50ff3b000ee3b403bf3b800353bd127f3bdc46e3bdcabf3bdcc7f"
    "3bdd17f3c001ae3c621bf3c800ae3cc013f3d0012e3d4014e3d800d53dc473f3dcc82e"
    "3dec4bf3dee3df3e001ce3e400ce3e800653ec443f3ed504e3ef463f3ef60df3f0018e"
    "3f48adf3f6a1f63f789df3f7905f3f800033fdd90e3fee4f63ffc4153ffc8553ffcc8e"
    "3ffd0e53ffd5763ffdd5f3ffe0953ffe80e3ffee5f3fff0763ffff5f";

struct HtTables {
  // (c_q << 7 | next 7 bits) -> e_k << 12 | e_1 << 8 | rho << 4 |
  // u_off << 3 | codeword length, as vlc_tbl0 / vlc_tbl1
  uint16_t vlc[2][1024];
  HtTables() {
    for (int t = 0; t < 2; t++) {
      std::memset(vlc[t], 0, sizeof vlc[t]);
      const char* s = t == 0 ? kHtVlcFirst : kHtVlcLater;
      for (size_t i = 0; s[i]; i += 7) {
        char hex[8] = {0};
        std::memcpy(hex, s + i, 7);
        const uint32_t v = uint32_t(std::strtoul(hex, nullptr, 16));
        const uint32_t cq = v >> 23, rho = (v >> 19) & 15, uoff = (v >> 18) & 1,
                       ek = (v >> 14) & 15, e1 = (v >> 10) & 15,
                       cwd = (v >> 3) & 127, len = v & 7;
        for (uint32_t k = 0; k < 128; k++)
          if ((k & ((1u << len) - 1)) == cwd)
            vlc[t][cq << 7 | k] =
                uint16_t(ek << 12 | e1 << 8 | rho << 4 | uoff << 3 | len);
      }
    }
  }
};
const HtTables kHt;

// MEL (T.814 7.3.3): bits from the highest, runs of 0 events as OpenJPEG
// stores them (2 x zeros, + 1 where a 1 event ends the run)
struct HtMel {
  const uint8_t* p;
  int size;  // bytes left of MEL + VLC - 1 (the last one's low nibble set)
  uint64_t tmp = 0;
  int bits = 0, k = 0;
  bool unstuff = false;

  void add(uint32_t d) {
    const int nb = 8 - int(unstuff);
    tmp |= uint64_t(d & 0xff) << (64 - bits - nb);
    bits += nb;
    unstuff = (d & 0xff) == 0xff;
  }
  uint32_t next_byte() {
    uint32_t d = 0xff;
    if (size > 0) {
      d = *p++;
      if (size == 1) d |= 0xf;
    }
    size--;
    return d;
  }
  // mel_init: OpenJPEG reads up to the next 4-byte address one byte at a
  // time and fails where a byte after 0xFF is over 0x8F among those
  bool init(const uint8_t* data, int lcup, int scup, int first_bytes) {
    p = data + lcup - scup;
    size = scup - 1;
    for (int i = 0; i < first_bytes; i++) {
      if (unstuff && *p > 0x8f) return false;
      add(next_byte());
    }
    return true;
  }
  void fill() {
    while (bits <= 56) add(next_byte());
  }
  int get_run() {
    static const int kExp[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};
    if (bits < 6) fill();
    const int e = kExp[k];
    if (tmp >> 63) {
      tmp <<= 1;
      bits -= 1;
      k = std::min(k + 1, 12);
      return ((1 << e) - 1) << 1;
    }
    const int run = e ? int((tmp >> (63 - e)) & ((1u << e) - 1)) : 0;
    tmp <<= e + 1;
    bits -= e + 1;
    k = std::max(k - 1, 0);
    return (run << 1) + 1;
  }
};

// a backward stream (VLC: from the byte before Scup's last, its high
// nibble first; MagRef: from the refinement segment's last byte)
struct HtRev {
  const uint8_t* p;
  int size;
  uint64_t tmp = 0;
  int bits = 0;
  bool unstuff = false;

  void add(uint32_t d) {
    const int nb = 8 - int(unstuff && (d & 0x7f) == 0x7f);
    tmp |= uint64_t(d) << bits;
    bits += nb;
    unstuff = d > 0x8f;
  }
  void init_vlc(const uint8_t* data, int lcup, int scup) {
    p = data + lcup - 2;
    size = scup - 2;
    const uint32_t d = *p--;
    tmp = d >> 4;
    bits = 4 - int((tmp & 7) == 7);
    unstuff = (d | 0xf) > 0x8f;
  }
  void init_mrp(const uint8_t* data, int lcup, int len2) {
    p = data + lcup + len2 - 1;
    size = len2;
    unstuff = true;
  }
  uint32_t fetch() {
    while (bits <= 56) {
      uint32_t d = 0;
      if (size > 0) d = *p--;
      size--;
      add(d);
    }
    return uint32_t(tmp);
  }
  uint32_t advance(int n) {
    tmp >>= n;
    bits -= n;
    return uint32_t(tmp);
  }
};

// a forward stream (MagSgn with 0xFF past its end, SigProp with 0)
struct HtFwd {
  const uint8_t* p;
  int size;
  uint32_t fill;
  uint64_t tmp = 0;
  int bits = 0;
  bool unstuff = false;

  void init(const uint8_t* data, int n, uint32_t x) {
    p = data;
    size = n;
    fill = x;
  }
  uint32_t fetch() {
    while (bits <= 56) {
      uint32_t d = fill;
      if (size > 0) d = *p++;
      size--;
      tmp |= uint64_t(d) << bits;
      bits += 8 - int(unstuff);
      unstuff = d == 0xff;
    }
    return uint32_t(tmp);
  }
  void advance(int n) {
    tmp >>= n;
    bits -= n;
  }
};

// decode_init_uvlc / decode_noninit_uvlc: u of a quad pair from the VLC
// bits (prefixes "1", "01", "001" with a 1-bit suffix, "000" with 5
// bits), by the pair's mode (u_off of each quad; 4: both, MEL event 1 in
// the first row pair). Returns the bits used; u[] holds u + kappa 1.
int ht_uvlc(uint32_t vlc, int mode, bool first, uint32_t* u) {
  static const uint8_t dec[8] = {
      3 | (5 << 2) | (5 << 5), 1 | (0 << 2) | (1 << 5),
      2 | (0 << 2) | (2 << 5), 1 | (0 << 2) | (1 << 5),
      3 | (1 << 2) | (3 << 5), 1 | (0 << 2) | (1 << 5),
      2 | (0 << 2) | (2 << 5), 1 | (0 << 2) | (1 << 5)};
  int used = 0;
  if (mode == 0) {
    u[0] = u[1] = 1;
  } else if (mode <= 2) {
    uint32_t d = dec[vlc & 7];
    vlc >>= d & 3;
    used += int(d & 3);
    const uint32_t sl = (d >> 2) & 7;
    used += int(sl);
    d = (d >> 5) + (vlc & ((1u << sl) - 1));
    u[0] = mode == 1 ? d + 1 : 1;
    u[1] = mode == 1 ? 1 : d + 1;
  } else if (mode == 3 && first) {
    uint32_t d1 = dec[vlc & 7];
    vlc >>= d1 & 3;
    used += int(d1 & 3);
    if ((d1 & 3) > 2) {  // u_0 over 2: u_1 is 1 + one bit
      u[1] = (vlc & 1) + 1 + 1;
      ++used;
      vlc >>= 1;
      const uint32_t sl = (d1 >> 2) & 7;
      used += int(sl);
      d1 = (d1 >> 5) + (vlc & ((1u << sl) - 1));
      u[0] = d1 + 1;
    } else {
      uint32_t d2 = dec[vlc & 7];
      vlc >>= d2 & 3;
      used += int(d2 & 3);
      uint32_t sl = (d1 >> 2) & 7;
      used += int(sl);
      d1 = (d1 >> 5) + (vlc & ((1u << sl) - 1));
      u[0] = d1 + 1;
      vlc >>= sl;
      sl = (d2 >> 2) & 7;
      used += int(sl);
      d2 = (d2 >> 5) + (vlc & ((1u << sl) - 1));
      u[1] = d2 + 1;
    }
  } else {  // both u_off set: mode 3 after the first row pair, or mode 4
    uint32_t d1 = dec[vlc & 7];
    vlc >>= d1 & 3;
    used += int(d1 & 3);
    uint32_t d2 = dec[vlc & 7];
    vlc >>= d2 & 3;
    used += int(d2 & 3);
    uint32_t sl = (d1 >> 2) & 7;
    used += int(sl);
    d1 = (d1 >> 5) + (vlc & ((1u << sl) - 1));
    vlc >>= sl;
    sl = (d2 >> 2) & 7;
    used += int(sl);
    d2 = (d2 >> 5) + (vlc & ((1u << sl) - 1));
    const uint32_t add = mode == 4 ? 3 : 1;  // mode 4: u - 2 coded
    u[0] = d1 + add;
    u[1] = d2 + add;
  }
  return used;
}

// opj_t1_ht_decode_cblk on one code-block's segments: 0 passes leave it
// zero, OpenJPEG's errors fail the decode (cv2: None), its warnings cut
// the passes. d gets h x w samples in tier 1's layout; chunk_off is the
// block's data offset in its tile's buffer (where OpenJPEG's MEL reader
// starts byte by byte).
void ht_decode(const Cblk& cb, int roishift, int cblksty, size_t chunk_off,
               std::vector<int32_t>& d) {
  const int w = cb.x1 - cb.x0, h = cb.y1 - cb.y0;
  d.assign(size_t(w) * size_t(h), 0);
  if (roishift != 0) fail("We do not support ROI in decoding HT codeblocks");
  if (cb.data.empty()) return;
  const uint32_t zero_bplanes = uint32_t(cb.mb + 1 - cb.numbps);
  int num_passes = cb.numsegs > 0 ? cb.segs[0].numpasses : 0;
  num_passes += cb.numsegs > 1 ? cb.segs[1].numpasses : 0;
  const int lengths1 = num_passes > 0 ? int(cb.segs[0].len) : 0;
  const int lengths2 = num_passes > 1 ? int(cb.segs[1].len) : 0;
  if (num_passes > 1 && lengths2 == 0) num_passes = 1;  // a warning
  if (num_passes > 3)
    fail("We do not support more than 3 coding passes in an HT codeblock; "
         "This codeblocks has %d passes.", num_passes);
  if (cb.mb > 30)
    fail("32 bits are not enough to decode this codeblock, since the "
         "number of bitplane, %d, is larger than 30.", cb.mb);
  if (zero_bplanes > uint32_t(cb.mb))
    fail("Malformed HT codeblock. Decoding this codeblock is stopped. "
         "There are %u zero bitplanes in %d bitplanes.", zero_bplanes, cb.mb);
  if (zero_bplanes == uint32_t(cb.mb) && num_passes > 1) num_passes = 1;
  const uint32_t p = uint32_t(cb.numbps);
  const uint32_t mmsbp2 = zero_bplanes + 1;
  const uint8_t* data = cb.data.data();
  const size_t cblk_len = cb.data.size();
  if (lengths1 < 2 || size_t(lengths1) > cblk_len ||
      size_t(lengths1) + size_t(lengths2) > cblk_len)
    fail("Malformed HT codeblock. Invalid codeblock length values.");
  const int lcup = lengths1;
  const int scup = (int(data[lcup - 1]) << 4) + (data[lcup - 2] & 0xf);
  if (scup < 2 || scup > lcup || scup > 4079)
    fail("Malformed HT codeblock. One of the following condition is not "
         "met: 2 <= Scup <= min(Lcup, 4079)");
  HtMel mel;
  if (!mel.init(data, lcup, scup,
                4 - int((chunk_off + size_t(lcup - scup)) & 3)))
    fail("Malformed HT codeblock. Incorrect MEL segment sequence.");
  HtRev vlc;
  vlc.init_vlc(data, lcup, scup);
  HtFwd ms;
  ms.init(data, lcup - scup, 0xff);

  // sign-magnitude samples as OpenJPEG decodes them, two's complement at
  // the end; sig: the cleanup's significance
  std::vector<uint32_t> v(size_t(w) * size_t(h), 0);
  std::vector<uint8_t> sig(size_t(w) * size_t(h), 0);
  // line state a quad column (two sample columns, 2q - 1 and 2q, of the
  // row above): bit 7 significance, bits 0-6 the largest exponent
  std::vector<uint8_t> ls(size_t(w) / 2 + 4, 0);
  int run = mel.get_run();
  for (int y = 0; y < h; y += 2) {
    const bool first = y == 0;
    const uint16_t* tbl = kHt.vlc[first ? 0 : 1];
    uint32_t c_q = 0;
    uint8_t ls0 = ls[0];
    ls[0] = 0;
    for (int x = 0; x < w; x += 4) {
      const size_t q = size_t(x) / 2;  // the pair's first quad column
      uint32_t qinf[2] = {0, 0};
      uint32_t vlc_val = vlc.fetch();
      if (!first) {
        c_q |= ls0 >> 7;
        c_q |= (ls[q + 1] >> 5) & 4;
      }
      qinf[0] = tbl[(c_q << 7) | (vlc_val & 0x7f)];
      if (c_q == 0) {
        run -= 2;
        qinf[0] = run == -1 ? qinf[0] : 0;
        if (run < 0) run = mel.get_run();
      }
      if (first)
        c_q = ((qinf[0] & 0x10) >> 4) | ((qinf[0] & 0xe0) >> 5);
      else
        c_q = ((qinf[0] & 0x40) >> 5) | ((qinf[0] & 0x80) >> 6);
      vlc_val = vlc.advance(int(qinf[0] & 7));
      if (x + 2 < w) {
        if (!first) {
          c_q |= ls[q + 1] >> 7;
          c_q |= (ls[q + 2] >> 5) & 4;
        }
        qinf[1] = tbl[(c_q << 7) | (vlc_val & 0x7f)];
        if (c_q == 0) {
          run -= 2;
          qinf[1] = run == -1 ? qinf[1] : 0;
          if (run < 0) run = mel.get_run();
        }
        if (first)
          c_q = ((qinf[1] & 0x10) >> 4) | ((qinf[1] & 0xe0) >> 5);
        else
          c_q = ((qinf[1] & 0x40) >> 5) | ((qinf[1] & 0x80) >> 6);
        vlc_val = vlc.advance(int(qinf[1] & 7));
      }
      int mode = int((qinf[0] & 8) >> 3) | int((qinf[1] & 8) >> 2);
      if (first && mode == 3) {
        run -= 2;
        mode += run == -1 ? 1 : 0;
        if (run < 0) run = mel.get_run();
      }
      uint32_t u_q[2];
      vlc_val = vlc.advance(ht_uvlc(vlc_val, mode, first, u_q));
      if (!first) {  // kappa from the row above (eqns 5, 6 of T.814)
        for (int k = 0; k < 2; k++) {
          const uint32_t r = qinf[k] & 0xf0;
          if (r & (r - 1)) {
            const uint32_t e = std::max<uint32_t>(
                k == 0 ? ls0 & 0x7f : ls[q + 1] & 0x7f,
                ls[q + 1 + size_t(k)] & 0x7f);
            u_q[k] += e > 2 ? e - 2 : 0;
          }
        }
        ls0 = ls[q + 2];
        ls[q + 1] = ls[q + 2] = 0;
      }
      if (u_q[0] > mmsbp2 || u_q[1] > mmsbp2)
        fail("Malformed HT codeblock. Decoding this codeblock is stopped. "
             "U_q is larger than zero bitplanes + 1");
      uint32_t locs = 0xff;
      if (x + 4 > w) locs >>= (x + 4 - w) << 1;
      if (y + 2 > h) locs &= 0x55;
      if ((((qinf[0] & 0xf0) >> 4) | (qinf[1] & 0xf0)) & ~locs)
        fail("Malformed HT codeblock. VLC code produces significant "
             "samples outside the codeblock area.");
      for (int k = 0; k < 2; k++) {
        for (int n = 0; n < 4; n++) {
          const int sx = x + 2 * k + (n >> 1), sy = y + (n & 1);
          if (!((qinf[k] >> (4 + n)) & 1)) continue;
          const uint32_t ms_val = ms.fetch();
          const uint32_t m_n = u_q[k] - ((qinf[k] >> (12 + n)) & 1);
          ms.advance(int(m_n));
          const uint32_t sgn = ms_val << 31;
          uint32_t v_n = ms_val & ((1u << (m_n & 31)) - 1);
          v_n |= ((qinf[k] >> (8 + n)) & 1) << (m_n & 31);
          v_n |= 1;
          const size_t at = size_t(sy) * size_t(w) + size_t(sx);
          v[at] = sgn | ((v_n + 2) << (p - 1));
          sig[at] = 1;
          if (n & 1) {  // the pair's bottom row feeds the next row pair
            const uint32_t e = 32 - uint32_t(__builtin_clz(v_n));
            uint8_t& l = ls[q + size_t(k) + (n >> 1)];
            l = uint8_t(0x80 | std::max<uint32_t>(l & 0x7f, e));
          }
        }
      }
    }
  }
  if (num_passes > 1) {
    // SigProp (T.814 7.4): stripes of 4 rows, groups of 4 columns, column
    // by column; a member is insignificant with a significant neighbour
    // (the stripe above and earlier samples as significance stands after
    // SigProp, the stripe below as the cleanup left it, not at all under
    // the vertically causal style); a group's signs after its bits
    const bool causal = (cblksty & kStyleVsc) != 0;
    std::vector<uint8_t> now(sig);
    HtFwd sp;
    sp.init(data + lengths1, lengths2, 0);
    auto known = [&](int xx, int yy, int stripe_end) -> bool {
      if (xx < 0 || xx >= w || yy < 0 || yy >= h) return false;
      if (yy >= stripe_end) return !causal && sig[size_t(yy) * size_t(w) + size_t(xx)];
      return now[size_t(yy) * size_t(w) + size_t(xx)] != 0;
    };
    const uint32_t val = 3u << (p - 2);
    for (int y0 = 0; y0 < h; y0 += 4) {
      const int y1 = std::min(y0 + 4, h);
      for (int gx = 0; gx < w; gx += 4) {
        uint32_t cwd = sp.fetch();
        int cnt = 0;
        int newly[16], nnew = 0;
        for (int xx = gx; xx < std::min(gx + 4, w); xx++)
          for (int yy = y0; yy < y1; yy++) {
            const size_t at = size_t(yy) * size_t(w) + size_t(xx);
            if (sig[at]) continue;
            bool member = false;
            for (int dy = -1; dy <= 1 && !member; dy++)
              for (int dx = -1; dx <= 1 && !member; dx++)
                if ((dx || dy) && known(xx + dx, yy + dy, y0 + 4))
                  member = true;
            if (!member) continue;
            const uint32_t b = cwd & 1;
            cwd >>= 1;
            ++cnt;
            if (b) {
              now[at] = 1;
              newly[nnew++] = int(at);
            }
          }
        for (int i = 0; i < nnew; i++) {
          v[size_t(newly[i])] = (cwd << 31) | val;
          cwd >>= 1;
          ++cnt;
        }
        sp.advance(cnt);
      }
    }
  }
  if (num_passes > 2) {
    // MagRef (T.814 7.5): a bit for each sample the cleanup made
    // significant, in SigProp's order, read backward
    HtRev mr;
    mr.init_mrp(data, lengths1, lengths2);
    const uint32_t half = 1u << (p - 2);
    for (int y0 = 0; y0 < h; y0 += 4) {
      const int y1 = std::min(y0 + 4, h);
      for (int gx = 0; gx < w; gx += 4) {
        uint32_t cwd = mr.fetch();
        int cnt = 0;
        for (int xx = gx; xx < std::min(gx + 4, w); xx++)
          for (int yy = y0; yy < y1; yy++) {
            const size_t at = size_t(yy) * size_t(w) + size_t(xx);
            if (!sig[at]) continue;
            const uint32_t sym = cwd & 1;
            v[at] ^= (1 - sym) << (p - 1);
            v[at] |= half;
            cwd >>= 1;
            ++cnt;
          }
        mr.advance(cnt);
      }
    }
  }
  for (size_t i = 0; i < v.size(); i++) {
    const int32_t mag = int32_t(v[i] & 0x7fffffff);
    d[i] = (v[i] & 0x80000000u) ? -mag : mag;
  }
}

// ---------------------------------------------------------------------------
// Inverse DWT (Annex F; dwt.c) on the tile-component's Mallat layout:
// lows in [0, sn), highs in [sn, n); cas is the parity of the origin

// One lifting step over the samples of one parity, each a run of `run`
// values (a row of the vertical pass, one value of the horizontal): sample
// p from its neighbours p - 1 and p + 1, mirrored at both ends (F.3.7).
template <class T, class Step>
void lift(T* x, int n, size_t run, int start, Step step) {
  for (int p = start; p < n; p += 2) {
    const int l = p > 0 ? p - 1 : p + 1;
    const int r = p + 1 < n ? p + 1 : p - 1;
    step(x + size_t(p) * run, x + size_t(l) * run, x + size_t(r) * run, run);
  }
}

// interleaves n lines of `run` values from `a` (line i at a + i * stride:
// lows [0, sn), highs [sn, n)) into x by parity cas, and back
template <class T>
void interleave(const T* a, size_t stride, int n, int sn, int cas,
                size_t run, T* x) {
  if (run == 1) {
    for (int i = 0; i < sn; i++) x[cas + 2 * i] = a[size_t(i) * stride];
    for (int i = sn; i < n; i++)
      x[1 - cas + 2 * (i - sn)] = a[size_t(i) * stride];
    return;
  }
  for (int i = 0; i < n; i++) {
    const int p = i < sn ? cas + 2 * i : 1 - cas + 2 * (i - sn);
    std::memcpy(x + size_t(p) * run, a + size_t(i) * stride, run * sizeof(T));
  }
}
template <class T>
void put_back(const T* x, int n, size_t run, T* a, size_t stride) {
  if (run == 1) {
    for (int i = 0; i < n; i++) a[size_t(i) * stride] = x[i];
    return;
  }
  for (int i = 0; i < n; i++)
    std::memcpy(a + size_t(i) * stride, x + size_t(i) * run, run * sizeof(T));
}

// the inverse 5/3 (F.3.8, opj_idwt53_h / _v) of n lines of `run` samples
void idwt53(int32_t* a, size_t stride, int n, int sn, int cas, size_t run,
            std::vector<int32_t>& x) {
  const int dn = n - sn;
  if (!cas) {
    if (!(dn > 0 || sn > 1)) return;
  } else if (!sn && dn == 1) {  // one high sample: halved
    for (size_t k = 0; k < run; k++) a[k] /= 2;
    return;
  }
  x.resize(size_t(n) * run);
  interleave(a, stride, n, sn, cas, run, x.data());
  lift(x.data(), n, run, cas,
       [](int32_t* d, const int32_t* l, const int32_t* r, size_t m) {
         for (size_t k = 0; k < m; k++) d[k] -= (l[k] + r[k] + 2) >> 2;
       });
  lift(x.data(), n, run, 1 - cas,
       [](int32_t* d, const int32_t* l, const int32_t* r, size_t m) {
         for (size_t k = 0; k < m; k++) d[k] += (l[k] + r[k]) >> 1;
       });
  put_back(x.data(), n, run, a, stride);
}

// opj_v8dwt_decode: scale lows by K and highs by 2/K, then the four lifting
// steps, each x += (left + right) * c
constexpr float kDwtAlpha = -1.586134342f, kDwtBeta = -0.052980118f,
                kDwtGamma = 0.882911075f, kDwtDelta = 0.443506852f,
                kDwtK = 1.230174105f, kDwtTwoInvK = 1.625732422f;

void idwt97(float* a, size_t stride, int n, int sn, int cas, size_t run,
            std::vector<float>& x) {
  const int dn = n - sn;
  if (!cas) {
    if (!(dn > 0 || sn > 1)) return;
  } else if (!(sn > 0 || dn > 1)) {  // one high sample: left as it is
    return;
  }
  x.resize(size_t(n) * run);
  interleave(a, stride, n, sn, cas, run, x.data());
  for (int p = 0; p < n; p++) {
    const float c = (p & 1) == cas ? kDwtK : kDwtTwoInvK;
    float* d = x.data() + size_t(p) * run;
    for (size_t k = 0; k < run; k++) d[k] *= c;
  }
  const float cs[4] = {-kDwtDelta, -kDwtGamma, -kDwtBeta, -kDwtAlpha};
  for (int s = 0; s < 4; s++) {
    const float c = cs[s];
    lift(x.data(), n, run, s % 2 == 0 ? cas : 1 - cas,
         [c](float* d, const float* l, const float* r, size_t m) {
           for (size_t k = 0; k < m; k++) {
             const float sum = l[k] + r[k];
             const float prod = sum * c;
             d[k] = d[k] + prod;
           }
         });
  }
  put_back(x.data(), n, run, a, stride);
}

// the horizontal pass over rw x rh samples, eight rows at a time: the rows
// are transposed into g (sample i of row k at g[i * 8 + k]) so that each
// lifting step runs over eight values at once, as OpenJPEG's v8 code does
template <class T, class F>
void rows_by_eight(T* a, size_t w, int rw, int rh, int sn, int cas,
                   std::vector<T>& g, std::vector<T>& x, F transform) {
  if (rw <= 0) return;
  g.assign(size_t(rw) * 8, T(0));
  for (int j = 0; j < rh; j += 8) {
    const int m = std::min(8, rh - j);
    for (int k = 0; k < m; k++) {
      const T* row = a + size_t(j + k) * w;
      for (int i = 0; i < rw; i++) g[size_t(i) * 8 + size_t(k)] = row[i];
    }
    transform(g.data(), 8, rw, sn, cas, 8, x);
    for (int k = 0; k < m; k++) {
      T* row = a + size_t(j + k) * w;
      for (int i = 0; i < rw; i++) row[i] = g[size_t(i) * 8 + size_t(k)];
    }
  }
}

// the levels from the lowest resolution up: each row, then the columns in
// strips of kStrip (a strip's rows run along memory and stay in cache)
constexpr int kStrip = 64;
void idwt_tile(TileComp& tc, bool reversible) {
  const size_t w = size_t(tc.w());
  std::vector<int32_t> xi, gi;
  std::vector<float> xf, gf;
  for (int r = 1; r < tc.numres; r++) {
    const Res& lo = tc.res[size_t(r - 1)];
    const Res& res = tc.res[size_t(r)];
    const int rw = res.x1 - res.x0, rh = res.y1 - res.y0;
    const int snh = lo.x1 - lo.x0, snv = lo.y1 - lo.y0;
    const int cash = res.x0 % 2, casv = res.y0 % 2;
    if (reversible) {
      int32_t* a = tc.idata.data();
      rows_by_eight(a, w, rw, rh, snh, cash, gi, xi, idwt53);
      for (int i = 0; i < rw; i += kStrip)
        idwt53(a + i, w, rh, snv, casv, size_t(std::min(kStrip, rw - i)), xi);
    } else {
      float* a = tc.fdata.data();
      rows_by_eight(a, w, rw, rh, snh, cash, gf, xf, idwt97);
      for (int i = 0; i < rw; i += kStrip)
        idwt97(a + i, w, rh, snv, casv, size_t(std::min(kStrip, rw - i)), xf);
    }
  }
}

// ---------------------------------------------------------------------------
// The decoded image: components as opj_image_t holds them

struct ImageComp {
  int w = 0, h = 0, x0 = 0, y0 = 0, dx = 1, dy = 1, prec = 0, sgnd = 0,
      alpha = 0;
  std::vector<int32_t> data;
};

// decodes one tile's packets, code-blocks, wavelet and components into img.
// resno_decoded holds each image component's highest resolution any packet
// decoded so far came from (opj_image_comp resno_decoded, kept across
// tiles): the wavelet, colour transform and level shift stop there, as in
// OpenJPEG, which shows only where a POC leaves the top resolutions out.
// whole: the image is this one tile (OpenJPEG then hands the tile buffer
// over as it stands, samples past the decoded resolution included).
void decode_tile(Codestream& cs, const TCP& tcp, int tileno,
                 std::vector<ImageComp>& img, std::vector<int>& resno_decoded,
                 bool whole) {
  Tile t;
  build_tile(cs, tcp, tileno, t);
  {  // tier 2
    PacketIter pi(cs, tcp, t);
    const uint8_t* data = tcp.data.data();
    const size_t len = tcp.data.size();
    size_t pos = 0;
    // packed headers: PPM's, read on across tiles, or this tile's PPT
    // markers in index order (opj_j2k_merge_ppt)
    std::vector<uint8_t> ppt;
    size_t ppt_pos = 0;
    Headers packed{nullptr, 0, nullptr};
    if (cs.has_ppm) {
      packed = {cs.ppm_headers.data(), cs.ppm_headers.size(), &cs.ppm_pos};
    } else if (!tcp.ppt.empty()) {
      auto markers = tcp.ppt;
      std::sort(markers.begin(), markers.end(), [](const auto& a,
                                                   const auto& b) {
        return a.first < b.first;
      });
      for (const auto& m : markers)
        ppt.insert(ppt.end(), m.second.begin(), m.second.end());
      packed = {ppt.data(), ppt.size(), &ppt_pos};
    }
    pi.run([&](int l, int r, int c, int p) {
      pos += decode_packet(tcp, t, l, r, c, p, data + pos, len - pos, pos,
                           packed.pos ? &packed : nullptr);
      resno_decoded[size_t(c)] = std::max(resno_decoded[size_t(c)], r);
    });
  }
  T1 t1;
  for (size_t c = 0; c < t.comps.size(); c++) {
    TileComp& tc = t.comps[c];
    const TCCP& tccp = tcp.tccps[c];
    const bool rev = tccp.qmfbid == 1;
    const size_t n = size_t(tc.w()) * size_t(tc.h());
    if (rev)
      tc.idata.assign(n, 0);
    else
      tc.fdata.assign(n, 0.0f);
    for (int r = 0; r < tc.numres; r++) {
      Res& res = tc.res[size_t(r)];
      for (int b = 0; b < res.numbands; b++) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        const float step = 0.5f * band.stepsize;
        for (auto& pr : band.precs)
          for (auto& cb : pr.cblks) {
            if (cb.x1 <= cb.x0 || cb.y1 <= cb.y0) continue;
            {
              const Clock::time_point t0 = Clock::now();
              if (tccp.cblksty & kStyleHT)
                ht_decode(cb, tccp.roishift, tccp.cblksty, cb.chunk_off,
                          t1.d);
              else
                t1.decode(cb, band.bandno, tccp.roishift, tccp.cblksty);
              g_timing.tier1 += seconds_since(t0);
            }
            int x = cb.x0 - band.x0, y = cb.y0 - band.y0;
            if (band.bandno & 1) x += tc.res[size_t(r - 1)].x1 - tc.res[size_t(r - 1)].x0;
            if (band.bandno & 2) y += tc.res[size_t(r - 1)].y1 - tc.res[size_t(r - 1)].y0;
            const int cw = cb.x1 - cb.x0, ch = cb.y1 - cb.y0;
            for (int j = 0; j < ch; j++) {
              const int32_t* src = t1.d.data() + size_t(j) * size_t(cw);
              const size_t o = size_t(y + j) * size_t(tc.w()) + size_t(x);
              if (rev) {
                for (int i = 0; i < cw; i++) tc.idata[o + size_t(i)] = src[i] / 2;
              } else {
                for (int i = 0; i < cw; i++)
                  tc.fdata[o + size_t(i)] = float(src[i]) * step;
              }
            }
          }
      }
    }
    tc.numres = std::min(tc.numres, resno_decoded[c] + 1);
    const Clock::time_point t0 = Clock::now();
    idwt_tile(tc, rev);
    g_timing.wavelet += seconds_since(t0);
  }
  // multiple component transform (G.2, G.3; mct.c), on as many samples as
  // component 0's decoded resolution holds, taken from the buffers' start
  if (tcp.mct) {
    if (t.comps.size() >= 3) {
      const TileComp &c0 = t.comps[0], &c1 = t.comps[1], &c2 = t.comps[2];
      if (c0.w() != c1.w() || c0.w() != c2.w() || c0.h() != c1.h() ||
          c0.h() != c2.h())
        fail("Tiles don't all have the same dimension. Skip the MCT step.");
      const bool rev = tcp.tccps[0].qmfbid == 1;
      const Res& r0 = c0.res[size_t(c0.numres - 1)];
      const size_t n = size_t(r0.x1 - r0.x0) * size_t(r0.y1 - r0.y0);
      if (tcp.tccps[1].qmfbid != tcp.tccps[0].qmfbid ||
          tcp.tccps[2].qmfbid != tcp.tccps[0].qmfbid) {
        // components of both wavelets: OpenJPEG keeps every component in
        // one 32-bit buffer (integers after 5/3, floats after 9/7) and
        // runs component 0's transform over the three as they stand
        std::vector<uint32_t> w[3];
        for (int k = 0; k < 3; k++) {
          TileComp& tc = t.comps[size_t(k)];
          w[k].resize(n);
          if (tcp.tccps[size_t(k)].qmfbid == 1)
            std::memcpy(w[k].data(), tc.idata.data(), n * 4);
          else
            std::memcpy(w[k].data(), tc.fdata.data(), n * 4);
        }
        for (size_t i = 0; i < n; i++) {
          if (rev) {  // opj_mct_decode, int32 arithmetic wrapping
            const uint32_t y = w[0][i], u = w[1][i], v = w[2][i];
            const uint32_t g =
                y - uint32_t(int32_t(u + v) >> 2);
            w[0][i] = v + g;
            w[1][i] = g;
            w[2][i] = u + g;
          } else {  // opj_mct_decode_real
            float yy, uu, vv;
            std::memcpy(&yy, &w[0][i], 4);
            std::memcpy(&uu, &w[1][i], 4);
            std::memcpy(&vv, &w[2][i], 4);
            const float r = yy + vv * 1.402f;
            float g = yy - uu * 0.34413f;
            g = g - vv * 0.71414f;
            const float b = yy + uu * 1.772f;
            std::memcpy(&w[0][i], &r, 4);
            std::memcpy(&w[1][i], &g, 4);
            std::memcpy(&w[2][i], &b, 4);
          }
        }
        for (int k = 0; k < 3; k++) {
          TileComp& tc = t.comps[size_t(k)];
          if (tcp.tccps[size_t(k)].qmfbid == 1)
            std::memcpy(tc.idata.data(), w[k].data(), n * 4);
          else
            std::memcpy(tc.fdata.data(), w[k].data(), n * 4);
        }
      } else if (rev) {
        int32_t *y = t.comps[0].idata.data(), *u = t.comps[1].idata.data(),
                *v = t.comps[2].idata.data();
        for (size_t i = 0; i < n; i++) {
          const int32_t g = y[i] - ((u[i] + v[i]) >> 2);
          const int32_t r = v[i] + g, b = u[i] + g;
          y[i] = r;
          u[i] = g;
          v[i] = b;
        }
      } else {
        float *y = t.comps[0].fdata.data(), *u = t.comps[1].fdata.data(),
              *v = t.comps[2].fdata.data();
        for (size_t i = 0; i < n; i++) {
          const float yy = y[i], uu = u[i], vv = v[i];
          const float r = yy + vv * 1.402f;
          float g = yy - uu * 0.34413f;
          g = g - vv * 0.71414f;
          const float b = yy + uu * 1.772f;
          y[i] = r;
          u[i] = g;
          v[i] = b;
        }
      }
    }
  }
  // DC level shift and clamp (G.1; tcd.c) over the decoded resolution, then
  // into the image: the whole buffer where the image is this one tile, else
  // that resolution's area at its own coordinates (opj_j2k_update_image_data)
  for (size_t c = 0; c < t.comps.size(); c++) {
    TileComp& tc = t.comps[c];
    ImageComp& ic = img[c];
    if (ic.data.empty())  // allocated once a tile decodes, not before
      ic.data.assign(size_t(ic.w) * size_t(ic.h), 0);
    const CompSiz& sz = cs.comps[c];
    const int32_t lo = sz.sgnd ? -(int32_t(1) << (sz.prec - 1)) : 0;
    const int32_t hi = sz.sgnd ? (int32_t(1) << (sz.prec - 1)) - 1
                               : int32_t((int64_t(1) << sz.prec) - 1);
    const int32_t shift = sz.sgnd ? 0 : int32_t(1) << (sz.prec - 1);
    const bool rev = tcp.tccps[c].qmfbid == 1;
    const Res& res = tc.res[size_t(tc.numres - 1)];
    const int rw = res.x1 - res.x0, rh = res.y1 - res.y0;
    const size_t stride = size_t(tc.w());
    auto level = [&](size_t o) -> int32_t {
      int64_t v;
      if (rev) {  // OpenJPEG adds in 32 bits
        v = int32_t(uint32_t(tc.idata[o]) + uint32_t(shift));
      } else {
        const float fv = tc.fdata[o];
        if (fv > float(INT32_MAX))
          v = hi;
        else if (fv < float(INT32_MIN))
          v = lo;
        else
          v = int64_t(std::lrintf(fv)) + shift;
      }
      return int32_t(std::min<int64_t>(std::max<int64_t>(v, lo), hi));
    };
    if (rw == tc.w() && rh == tc.h()) {  // every resolution decoded
      for (int j = 0; j < rh; j++) {
        int32_t* dst = ic.data.data() +
                       size_t(tc.y0 - ic.y0 + j) * size_t(ic.w) +
                       size_t(tc.x0 - ic.x0);
        const size_t o = size_t(j) * stride;
        for (int i = 0; i < rw; i++) dst[i] = level(o + size_t(i));
      }
      continue;
    }
    std::vector<int32_t> out(stride * size_t(tc.h()));
    if (rev)
      std::copy(tc.idata.begin(), tc.idata.end(), out.begin());
    else
      std::memcpy(out.data(), tc.fdata.data(), out.size() * 4);
    for (int j = 0; j < rh; j++)
      for (int i = 0; i < rw; i++) {
        const size_t o = size_t(j) * stride + size_t(i);
        out[o] = level(o);
      }
    if (whole) {
      std::memcpy(ic.data.data(), out.data(),
                  std::min(ic.data.size(), out.size()) * 4);
      continue;
    }
    // the decoded resolution's area clipped to the component, at its
    // coordinates in the full-size component
    const int64_t dx0 = ic.x0, dx1 = int64_t(ic.x0) + ic.w;
    const int64_t dy0 = ic.y0, dy1 = int64_t(ic.y0) + ic.h;
    const int64_t x0 = std::max<int64_t>(res.x0, dx0);
    const int64_t x1 = std::min<int64_t>(res.x1, dx1);
    const int64_t y0 = std::max<int64_t>(res.y0, dy0);
    const int64_t y1 = std::min<int64_t>(res.y1, dy1);
    for (int64_t y = y0; y < y1; y++)
      for (int64_t x = x0; x < x1; x++)
        ic.data[size_t(y - dy0) * size_t(ic.w) + size_t(x - dx0)] =
            out[size_t(y - res.y0) * stride + size_t(x - res.x0)];
  }
}

// ---------------------------------------------------------------------------
// The codestream walk (j2k.c): main header, then tile-parts, decoding each
// tile when its last tile-part is in, with OpenJPEG's end-of-stream rules

enum Marker : uint32_t {
  SOC = 0xff4f, CAP = 0xff50, SIZ = 0xff51, COD = 0xff52, COC = 0xff53,
  TLM = 0xff55, PLM = 0xff57, PLT = 0xff58, QCD = 0xff5c, QCC = 0xff5d,
  RGN = 0xff5e, POCm = 0xff5f, PPM = 0xff60, PPT = 0xff61, CRG = 0xff63,
  COM = 0xff64, SOT = 0xff90, SOP = 0xff91, EPH = 0xff92, SOD = 0xff93,
  EOC = 0xffd9
};

bool known_marker(uint32_t m) {
  switch (m) {
    case SOT: case COD: case COC: case RGN: case QCD: case QCC: case POCm:
    case SIZ: case TLM: case PLM: case PLT: case PPM: case PPT: case SOP:
    case EPH: case SOD: case EOC: case CRG: case COM: case CAP:
    case 0xff74: case 0xff75: case 0xff77: case 0xff76: case 0xff78:
    case 0xff59:
      return true;
    default:
      return false;
  }
}

struct Walker {
  const uint8_t* p;
  size_t n, pos = 0;
  int correction = 0;  // added to TNsot after a TPsot == TNsot find
  Codestream& cs;
  Walker(const uint8_t* d, size_t len, Codestream& c) : p(d), n(len), cs(c) {}

  uint32_t marker() {
    if (pos + 2 > n) fail("Stream too short");
    const uint32_t m = rd16(p + pos);
    pos += 2;
    return m;
  }
  // a marker segment's body; pos moves past it
  const uint8_t* segment(size_t& len) {
    if (pos + 2 > n) fail("Stream too short");
    const uint32_t l = rd16(p + pos);
    if (l < 2) fail("Invalid marker size");
    if (pos + l > n) fail("Stream too short");
    len = l - 2;
    const uint8_t* body = p + pos + 2;
    pos += l;
    return body;
  }
  // opj_j2k_read_unk: skip to the next marker OpenJPEG knows
  uint32_t skip_unknown() {
    for (;;) {
      const uint32_t m = marker();
      if (known_marker(m)) return m;
    }
  }

  void main_header() {
    if (marker() != SOC) fail("Expected a SOC marker");
    uint32_t m = marker();
    if (m != SIZ) fail("Marker is not compliant with its position");
    bool first = true;
    for (;;) {
      if (!first) m = marker();
      if (m < 0xff00) fail("A marker ID was expected (0xff--) instead of %.8x", m);
      if (!known_marker(m)) m = skip_unknown();
      if (m == SOT) break;
      size_t len;
      const uint8_t* b;
      switch (m) {
        case SIZ:
          if (!first) fail("Marker is not compliant with its position");
          b = segment(len);
          read_siz(b, len, cs);
          break;
        case COD:
          b = segment(len);
          read_cod(b, len, cs.deflt);
          cs.has_cod = true;
          break;
        case COC:
          b = segment(len);
          read_coc(b, len, cs.deflt, cs);
          break;
        case QCD:
          b = segment(len);
          read_qcd(b, len, cs.deflt);
          cs.has_qcd = true;
          break;
        case QCC:
          b = segment(len);
          read_qcc(b, len, cs.deflt, cs);
          break;
        case RGN:
          b = segment(len);
          read_rgn(b, len, cs.deflt, cs);
          break;
        case POCm:
          b = segment(len);
          read_poc(b, len, cs.deflt, cs);
          break;
        case PPM:
          b = segment(len);
          read_packed(b, len, cs.ppm, "ppm");
          cs.has_ppm = true;
          break;
        case TLM: case PLM: case CRG: case COM: case CAP: case 0xff59:
          segment(len);  // opj_j2k_read_cap / _cpf read nothing
          break;
        default:
          fail("Marker is not compliant with its position");
      }
      first = false;
    }
    if (!cs.has_cod) fail("required COD marker not found in main header");
    if (!cs.has_qcd) fail("required QCD marker not found in main header");
    if (cs.has_ppm) merge_ppm(cs);
    cs.tiles.assign(size_t(cs.tw) * size_t(cs.th), TCP());
  }

  // The tile-parts after the main header (pos just past the first SOT), as
  // opj_j2k_decode_tiles walks them: opj_j2k_read_tile_header gathers
  // tile-parts until one completes its tile (TNsot known) or the stream
  // ends, opj_j2k_decode_tile decodes and reads the next marker. A tile
  // whose tile-part count is unknown is decoded at EOC or where the stream
  // ends, from the last tile read onwards ("tiles with a single tile-part
  // and TNsot == 0"). cv2 holds every rule here: a stream that ends right
  // after a tile it could decode is "too short", a tile-part's header or
  // body cut short fails, two bytes after a decoded tile (EOC, SOT or
  // anything at the very end) let the tiles read so far stand.
  void tile_parts(std::vector<ImageComp>& img, bool& any) {
    enum State { kTphSot, kNeoc, kEoc } state = kTphSot;
    const int nt = int(cs.tiles.size());
    int current = 0, ndecoded = 0;
    bool corrected = false;
    std::vector<int> resno_decoded(cs.comps.size(), 0);
    // OpenJPEG's "whole single tile" case: the tile buffer is the image's
    const bool whole = nt == 1 && cs.tx0 == 0 && cs.ty0 == 0 && cs.x0 == 0 &&
                       cs.y0 == 0 && cs.x1 == cs.tdx && cs.y1 == cs.tdy;
    std::vector<char> has_data(size_t(nt), 0);
    for (;;) {
      // opj_j2k_read_tile_header
      uint32_t marker = state == kEoc ? uint32_t(EOC) : uint32_t(SOT);
      bool can_decode = false;
      while (!can_decode && marker != EOC) {
        bool tph = false, last_part = false;
        int64_t sot_length = 0;
        int tileno = -1;
        while (marker != SOD) {
          if (pos == n) {
            state = kNeoc;
            break;
          }
          if (n - pos < 2) fail("Stream too short");
          const uint32_t l = rd16(p + pos);
          pos += 2;
          if (l < 2) fail("Inconsistent marker size");
          if (tph && sot_length != 0) {
            if (sot_length < int64_t(l) + 2)
              fail("Sot length is less than marker size + marker ID");
            sot_length -= int64_t(l) + 2;
          }
          if ((marker == SOT) == tph)
            fail("Marker is not compliant with its position");
          if (n - pos < l - 2) fail("Stream too short");
          const uint8_t* b = p + pos;
          const size_t len = l - 2;
          pos += len;
          if (marker == SOT) {
            read_sot(b, len, tileno, sot_length, last_part, can_decode);
            current = tileno;
            tph = true;
          } else {
            TCP& tcp = cs.tiles[size_t(tileno)];
            switch (marker) {
              case COD: read_cod(b, len, tcp); break;
              case COC: read_coc(b, len, tcp, cs); break;
              case QCD: read_qcd(b, len, tcp); break;
              case QCC: read_qcc(b, len, tcp, cs); break;
              case RGN: read_rgn(b, len, tcp, cs); break;
              case POCm: read_poc(b, len, tcp, cs); break;
              case PPT:
                if (cs.has_ppm)
                  fail("Error reading PPT marker: packet header have been "
                       "previously found in the main header (PPM marker).");
                read_packed(b, len, tcp.ppt, "ppt");
                break;
              case PLT: case COM: break;
              default:
                fail("Marker is not compliant with its position");
            }
          }
          if (n - pos < 2) fail("Stream too short");
          marker = rd16(p + pos);
          pos += 2;
        }
        if (pos == n && state == kNeoc) break;
        // opj_j2k_read_sod
        size_t body;
        if (last_part) {
          if (n - pos < 2)
            fail("Tile part length size inconsistent with stream length");
          body = n - pos - 2;
        } else {
          body = sot_length >= 2 ? size_t(sot_length - 2) : 0;
          if (body > n - pos)
            fail("Tile part length size inconsistent with stream length");
        }
        TCP& tcp = cs.tiles[size_t(tileno)];
        if (body) {
          tcp.data.insert(tcp.data.end(), p + pos, p + pos + body);
          has_data[size_t(tileno)] = 1;
        }
        pos += body;
        state = kTphSot;
        if (can_decode && !corrected && tcp.nb_parts > 1) {
          corrected = true;
          if (needs_correction(tileno)) {
            // "Non conformant codestream TPsot==TNsot": one more part each
            can_decode = false;
            correction = 1;
            for (auto& t : cs.tiles)
              if (t.nb_parts) t.nb_parts += 1;
          }
        }
        if (!can_decode) {
          if (n - pos < 2) {
            // the last tile's first tile-part, their count unknown, may end
            // the stream: read as EOC, the tiles read in one tile-part
            // each decoded and those read in several dropped (cv2 holds it)
            if (tcp.nb_parts == 0 && tcp.parts_read == 1 &&
                tileno == nt - 1) {
              for (int t = 0; t < nt; t++)
                if (cs.tiles[size_t(t)].parts_read > 1) has_data[size_t(t)] = 0;
              pos = n;
              marker = EOC;
              break;
            }
            fail("Stream too short");
          }
          marker = rd16(p + pos);
          pos += 2;
        }
      }
      if (marker == EOC && state != kEoc) {
        current = 0;
        state = kEoc;
      }
      if (!can_decode) {
        while (current < nt && !has_data[size_t(current)]) ++current;
        if (current == nt) return;
      }
      // opj_j2k_decode_tile
      TCP& tcp = cs.tiles[size_t(current)];
      if (!has_data[size_t(current)]) fail("Failed to decode tile");
      decode_tile(cs, tcp, current, img, resno_decoded, whole);
      any = true;
      has_data[size_t(current)] = 0;
      tcp.data.clear();
      tcp.data.shrink_to_fit();
      if (!(pos == n && state == kNeoc) && state != kEoc) {
        if (n - pos < 2) fail("Stream too short");
        const uint32_t m = rd16(p + pos);
        pos += 2;
        if (m == EOC) {
          current = 0;
          state = kEoc;
        } else if (m != SOT) {
          if (pos != n) fail("Stream too short");
          state = kNeoc;  // "Stream does not end with EOC"
        }
      }
      if (pos == n && state == kNeoc) return;
      if (++ndecoded == nt) return;
    }
  }

  // opj_j2k_need_nb_tile_parts_correction, run once at the first tile
  // completed from several tile-parts: looks ahead for another tile-part
  // of that tile whose TPsot equals its TNsot
  bool needs_correction(int tileno) {
    size_t q = pos;
    for (;;) {
      if (n - q < 2 || rd16(p + q) != SOT) return false;
      q += 2;
      if (n - q < 2) fail("Stream too short");
      if (rd16(p + q) != 10) fail("Inconsistent marker size");
      q += 2;
      if (n - q < 8) fail("Stream too short");
      const uint32_t isot = rd16(p + q), psot = rd32(p + q + 2);
      const int tpsot = p[q + 6], tnsot = p[q + 7];
      q += 8;
      if (int(isot) == tileno) return tpsot == tnsot;
      if (psot < 14) return false;
      if (n - q < psot - 12) return false;
      q += psot - 12;
    }
  }

  // opj_j2k_read_sot
  void read_sot(const uint8_t* b, size_t len, int& tileno,
                int64_t& sot_length, bool& last_part, bool& can_decode) {
    if (len != 8) fail("Error reading SOT marker");
    const uint32_t isot = rd16(b), psot = rd32(b + 2);
    const int tpsot = b[6];
    const int tnsot = b[7] ? b[7] + correction : 0;
    if (isot >= uint32_t(cs.tiles.size()))
      fail("Tile index provided by SOT marker %u is not compatible with "
           "the tile number", isot);
    TCP& tcp = cs.tiles[isot];
    if (psot != 0 && psot < 14 && psot != 12)
      fail("Psot value (%u) is not correct regards to the JPEG2000 norm!",
           psot);
    if (tpsot != tcp.parts_read)
      fail("Invalid tile part index for tile number %u. Got %d, expected "
           "%d", isot, tpsot, tcp.parts_read);
    if (tnsot != 0) {
      if (tcp.nb_parts && tpsot >= tcp.nb_parts)
        fail("In SOT marker, TPSot (%d) is not valid regards to the "
             "current number of tile-part (%d), giving up", tpsot,
             tcp.nb_parts);
      if (tpsot >= tnsot)
        fail("In SOT marker, TPSot (%d) is not valid regards to the "
             "current number of tile-part (header) (%d), giving up",
             tpsot, tnsot);
      tcp.nb_parts = tnsot;
    }
    if (tcp.parts_read == 0) {
      tcp.csty = cs.deflt.csty;
      tcp.prg = cs.deflt.prg;
      tcp.numlayers = cs.deflt.numlayers;
      tcp.mct = cs.deflt.mct;
      tcp.tccps = cs.deflt.tccps;
      tcp.pocs = cs.deflt.pocs;
    }
    tcp.parts_read++;
    can_decode = tcp.nb_parts && tcp.nb_parts == tpsot + 1;
    last_part = psot == 0;
    sot_length = last_part ? 0 : int64_t(psot) - 12;
    tileno = int(isot);
  }
};

// ---------------------------------------------------------------------------
// JP2 boxes (Annex I; jp2.c)

struct Pclr {
  std::vector<uint32_t> entries;
  std::vector<int> size, sign;
  int nr_entries = 0, nr_channels = 0;
  struct Map {
    int cmp, mtyp, pcol;
  };
  std::vector<Map> cmap;
  bool has_cmap = false;
};
struct Cdef {
  int cn, typ, asoc;
};

struct JP2 {
  bool sig = false, ftyp = false, header = false, has_ihdr = false,
       has_colr = false;
  int numcomps = 0;
  uint32_t w = 0, h = 0;
  uint32_t enumcs = 0;
  bool has_pclr = false, has_cdef = false;
  Pclr pclr;
  std::vector<Cdef> cdef;
};

void read_ihdr(const uint8_t* b, size_t n, JP2& j) {
  if (j.has_ihdr) return;  // a second ihdr is ignored
  if (n != 14) fail("Bad image header box (bad size)");
  const uint32_t h = rd32(b), w = rd32(b + 4), nc = rd16(b + 8);
  if (h < 1 || w < 1 || nc < 1)
    fail("Wrong values for: w(%u) h(%u) numcomps(%u) (ihdr)", w, h, nc);
  if (nc - 1 >= 16384) fail("Invalid number of components (ihdr)");
  j.numcomps = int(nc);
  j.w = w;
  j.h = h;
  j.has_ihdr = true;
}

void read_colr(const uint8_t* b, size_t n, JP2& j) {
  if (n < 3) fail("Bad COLR header box (bad size)");
  if (j.has_colr) return;  // only the first counts
  const int meth = b[0];
  if (meth == 1) {
    if (n < 7) fail("Bad COLR header box (bad size: %d)", int(n));
    j.enumcs = rd32(b + 3);
    j.has_colr = true;
  } else if (meth == 2) {
    j.has_colr = true;  // the ICC profile: kept by OpenJPEG, unused by cv2
  }
}

void read_pclr(const uint8_t* b, size_t n, JP2& j) {
  if (j.has_pclr) fail("pclr: a second box");
  if (n < 3) fail("pclr: short box");
  const int ne = int(rd16(b)), nch = b[2];
  if (ne == 0 || ne > 1024) fail("Invalid PCLR box. Reports %d entries", ne);
  if (nch == 0) fail("Invalid PCLR box. Reports 0 palette columns");
  if (n < 3 + size_t(nch)) fail("pclr: short box");
  Pclr& pc = j.pclr;
  pc.nr_entries = ne;
  pc.nr_channels = nch;
  for (int i = 0; i < nch; i++) {
    pc.size.push_back((b[3 + i] & 0x7f) + 1);
    pc.sign.push_back(b[3 + i] & 0x80 ? 1 : 0);
  }
  size_t at = 3 + size_t(nch);
  for (int e = 0; e < ne; e++)
    for (int i = 0; i < nch; i++) {
      size_t k = size_t((pc.size[size_t(i)] + 7) >> 3);
      if (k > 4) k = 4;
      if (n < at + k) fail("pclr: short box");
      uint32_t v = 0;
      for (size_t q = 0; q < k; q++) v = (v << 8) | b[at + q];
      pc.entries.push_back(v);
      at += k;
    }
  j.has_pclr = true;
}

void read_cmap(const uint8_t* b, size_t n, JP2& j) {
  if (!j.has_pclr) fail("Need to read a PCLR box before the CMAP box.");
  if (j.pclr.has_cmap) fail("Only one CMAP box is allowed.");
  const int nch = j.pclr.nr_channels;
  if (n < size_t(nch) * 4) fail("Insufficient data for CMAP box.");
  for (int i = 0; i < nch; i++)
    j.pclr.cmap.push_back({int(rd16(b + 4 * i)), b[4 * i + 2], b[4 * i + 3]});
  j.pclr.has_cmap = true;
}

void read_cdef(const uint8_t* b, size_t n, JP2& j) {
  if (j.has_cdef) fail("cdef: a second box");
  if (n < 2) fail("Insufficient data for CDEF box.");
  const int k = int(rd16(b));
  if (k == 0) fail("Number of channel description is equal to zero in CDEF box.");
  if (n < 2 + size_t(k) * 6) fail("Insufficient data for CDEF box.");
  for (int i = 0; i < k; i++) {
    const uint8_t* q = b + 2 + 6 * i;
    j.cdef.push_back({int(rd16(q)), int(rd16(q + 2)), int(rd16(q + 4))});
  }
  j.has_cdef = true;
}

constexpr uint32_t box(const char* s) {
  return uint32_t(uint8_t(s[0])) << 24 | uint32_t(uint8_t(s[1])) << 16 |
         uint32_t(uint8_t(s[2])) << 8 | uint8_t(s[3]);
}

void read_jp2h(const uint8_t* b, size_t n, JP2& j) {
  if (!j.ftyp) fail("The  box must be the first box in the file.");
  bool ihdr = false;
  while (n > 0) {
    if (n < 8) fail("Cannot handle box of less than 8 bytes");
    uint64_t len = rd32(b);
    const uint32_t type = rd32(b + 4);
    size_t hdr = 8;
    if (len == 1) {
      if (n < 16) fail("Cannot handle XL box of less than 16 bytes");
      if (rd32(b + 8) != 0) fail("Cannot handle box sizes higher than 2^32");
      len = rd32(b + 12);
      hdr = 16;
    }
    if (len == 0) fail("Cannot handle box of undefined sizes");
    if (len < hdr) fail("Box length is inconsistent.");
    if (len > n)
      fail("Stream error while reading JP2 Header box: box length is "
           "inconsistent.");
    const uint8_t* body = b + hdr;
    const size_t blen = size_t(len) - hdr;
    switch (type) {
      case box("ihdr"): read_ihdr(body, blen, j); ihdr = true; break;
      case box("colr"): read_colr(body, blen, j); break;
      case box("bpcc"):
        if (blen != size_t(j.numcomps)) fail("Bad BPCC header box (bad size)");
        break;
      case box("pclr"): read_pclr(body, blen, j); break;
      case box("cmap"): read_cmap(body, blen, j); break;
      case box("cdef"): read_cdef(body, blen, j); break;
      default: break;
    }
    b += len;
    n -= size_t(len);
  }
  if (!ihdr) fail("Stream error while reading JP2 Header box: no 'ihdr' box.");
  j.header = true;
}

// the codestream's offset in a JP2 file (opj_jp2_read_header_procedure)
size_t read_boxes(const uint8_t* p, size_t n, JP2& j) {
  size_t pos = 0;
  for (;;) {
    if (n - pos < 8) fail("Stream error while reading JP2 boxes");
    uint64_t len = rd32(p + pos);
    const uint32_t type = rd32(p + pos + 4);
    size_t hdr = 8;
    if (len == 0) {
      len = n - pos;
    } else if (len == 1) {
      if (n - pos < 16) fail("Stream error while reading JP2 boxes");
      if (rd32(p + pos + 8) != 0) fail("Cannot handle box sizes higher than 2^32");
      len = rd32(p + pos + 12);
      hdr = 16;
    }
    if (type == box("jp2c")) {
      if (!j.header) fail("bad placed jpeg codestream");
      return pos + hdr;
    }
    if (len < hdr) fail("invalid box size %u", unsigned(len));
    const size_t blen = size_t(len) - hdr;
    const bool handled = type == box("jP  ") || type == box("ftyp") ||
                         type == box("jp2h");
    const bool img = type == box("ihdr") || type == box("colr") ||
                     type == box("bpcc") || type == box("pclr") ||
                     type == box("cmap") || type == box("cdef");
    if (!handled && !img) {
      if (!j.sig)
        fail("Malformed JP2 file format: first box must be JPEG 2000 "
             "signature box");
      if (!j.ftyp)
        fail("Malformed JP2 file format: second box must be file type box");
      if (blen > n - pos - hdr) fail("Problem with skipping JPEG2000 box, stream error");
      pos += size_t(len);
      continue;
    }
    if (img && !j.header) {  // misplaced before jp2h: skipped
      if (blen > n - pos - hdr) fail("Problem with skipping JPEG2000 box, stream error");
      pos += size_t(len);
      continue;
    }
    if (blen > n - pos - hdr)
      fail("Invalid box size %u for box '%c%c%c%c'. Need %u bytes, %u bytes "
           "remaining ", unsigned(len), char(type >> 24), char(type >> 16),
           char(type >> 8), char(type), unsigned(blen),
           unsigned(n - pos - hdr));
    const uint8_t* body = p + pos + hdr;
    if (type == box("jP  ")) {
      if (j.sig || j.ftyp || j.header)
        fail("The signature box must be the first box in the file.");
      if (blen != 4) fail("Error with JP signature Box size");
      if (rd32(body) != 0x0d0a870a) fail("Error with JP Signature : bad magic number");
      j.sig = true;
    } else if (type == box("ftyp")) {
      if (!j.sig || j.ftyp || j.header)
        fail("The ftyp box must be the second box in the file.");
      if (blen < 8 || blen % 4) fail("Error with FTYP signature Box size");
      j.ftyp = true;
    } else if (type == box("jp2h")) {
      read_jp2h(body, blen, j);
    } else {  // an image box after jp2h: read as if inside it
      if (type == box("ihdr")) read_ihdr(body, blen, j);
      else if (type == box("colr")) read_colr(body, blen, j);
      else if (type == box("pclr")) read_pclr(body, blen, j);
      else if (type == box("cmap")) read_cmap(body, blen, j);
      else if (type == box("cdef")) read_cdef(body, blen, j);
    }
    pos += size_t(len);
  }
}

// OpenJPEG's opj_image color_space values
enum ColourSpace { kUnknown = -1, kSRGB = 1, kGray = 2,
                   kSYCC = 3, kEYCC = 4, kCMYK = 5 };

int colour_space(const JP2* j) {
  if (!j) return kUnknown;
  switch (j->enumcs) {
    case 16: return kSRGB;
    case 17: return kGray;
    case 18: return kSYCC;
    case 24: return kEYCC;
    case 12: return kCMYK;
    default: return kUnknown;
  }
}

// opj_jp2_check_color, opj_jp2_apply_pclr, opj_jp2_apply_cdef
void apply_colour(JP2& j, std::vector<ImageComp>& img) {
  const bool cmap = j.has_pclr && j.pclr.has_cmap;
  if (j.has_cdef) {
    int nch = int(img.size());
    if (cmap) nch = j.pclr.nr_channels;
    for (const auto& c : j.cdef) {
      if (c.cn >= nch) fail("Invalid component index %d (>= %d).", c.cn, nch);
      if (c.asoc == 65535) continue;
      if (c.asoc > 0 && c.asoc - 1 >= nch)
        fail("Invalid component index %d (>= %d).", c.asoc - 1, nch);
    }
    for (int k = nch; k > 0; k--) {
      bool found = false;
      for (const auto& c : j.cdef) found |= c.cn == k - 1;
      if (!found) fail("Incomplete channel definitions.");
    }
  }
  if (cmap) {
    Pclr& pc = j.pclr;
    const int nch = pc.nr_channels;
    bool sane = true;
    for (int i = 0; i < nch; i++)
      if (pc.cmap[size_t(i)].cmp >= int(img.size())) sane = false;
    std::vector<char> used(size_t(nch), 0);
    for (int i = 0; i < nch; i++) {
      const int mtyp = pc.cmap[size_t(i)].mtyp, pcol = pc.cmap[size_t(i)].pcol;
      if (mtyp != 0 && mtyp != 1) sane = false;
      else if (pcol >= nch) sane = false;
      else if (used[size_t(pcol)] && mtyp == 1) sane = false;
      else if (mtyp == 0 && pcol != 0) sane = false;
      else if (mtyp == 1 && pcol != i) sane = false;
      else used[size_t(pcol)] = 1;
    }
    for (int i = 0; i < nch; i++)
      if (!used[size_t(i)] && pc.cmap[size_t(i)].mtyp != 0) sane = false;
    if (sane && img.size() == 1) {  // "Component mapping seems wrong"
      bool fix = false;
      for (int i = 0; i < nch; i++) fix |= !used[size_t(i)];
      if (fix)
        for (int i = 0; i < nch; i++) pc.cmap[size_t(i)] = {pc.cmap[size_t(i)].cmp, 1, i};
    }
    if (!sane) fail("JP2 cmap is not sane");
  }
  if (j.has_pclr) {
    if (!j.pclr.has_cmap) {
      j.has_pclr = false;  // both or none (I.5.3.4)
    } else {
      Pclr& pc = j.pclr;
      const int nch = pc.nr_channels;
      std::vector<ImageComp> out;
      out.resize(size_t(nch));
      for (int i = 0; i < nch; i++) {
        const auto& m = pc.cmap[size_t(i)];
        const ImageComp& src = img[size_t(m.cmp)];
        ImageComp& dst = out[size_t(m.mtyp == 0 ? i : m.pcol)];
        dst.w = src.w; dst.h = src.h; dst.x0 = src.x0; dst.y0 = src.y0;
        dst.dx = src.dx; dst.dy = src.dy; dst.alpha = src.alpha;
      }
      for (int i = 0; i < nch; i++) {
        out[size_t(i)].prec = pc.size[size_t(i)];
        out[size_t(i)].sgnd = pc.sign[size_t(i)];
        out[size_t(i)].data.assign(size_t(img[size_t(pc.cmap[size_t(i)].cmp)].w) *
                                   size_t(img[size_t(pc.cmap[size_t(i)].cmp)].h), 0);
      }
      const int top = pc.nr_entries - 1;
      for (int i = 0; i < nch; i++) {
        const auto& m = pc.cmap[size_t(i)];
        const std::vector<int32_t>& src = img[size_t(m.cmp)].data;
        std::vector<int32_t>& dst = out[size_t(m.mtyp == 0 ? i : m.pcol)].data;
        const size_t mx = std::min(dst.size(), src.size());
        for (size_t q = 0; q < mx; q++) {
          if (m.mtyp == 0) {
            dst[q] = src[q];
          } else {
            int k = src[q];
            k = k < 0 ? 0 : k > top ? top : k;
            dst[q] = int32_t(pc.entries[size_t(k) * size_t(nch) + size_t(m.pcol)]);
          }
        }
      }
      img.swap(out);
    }
  }
  if (j.has_cdef) {
    std::vector<Cdef> info = j.cdef;
    for (size_t i = 0; i < info.size(); i++) {
      const int asoc = info[i].asoc, cn = info[i].cn;
      if (cn >= int(img.size())) continue;
      if (asoc == 0 || asoc == 65535) {
        img[size_t(cn)].alpha = info[i].typ;
        continue;
      }
      const int acn = asoc - 1;
      if (acn >= int(img.size())) continue;
      if (cn != acn && info[i].typ == 0) {
        std::swap(img[size_t(cn)], img[size_t(acn)]);
        for (size_t k = i + 1; k < info.size(); k++) {
          if (info[k].cn == cn) info[k].cn = acn;
          else if (info[k].cn == acn) info[k].cn = cn;
        }
      }
      img[size_t(cn)].alpha = info[i].typ;
    }
  }
}

bool is_jp2(const uint8_t* p, size_t n) {
  static const uint8_t sig[12] = {0, 0, 0, 0x0c, 'j', 'P', ' ', ' ',
                                  0x0d, 0x0a, 0x87, 0x0a};
  return n >= 12 && std::memcmp(p, sig, 12) == 0;
}

// the header as opj_read_header leaves it: codestream components and the
// JP2 colour space; returns the codestream's offset
size_t read_header(const uint8_t* p, size_t n, JP2& j, bool& jp2,
                   Codestream& cs, Walker*& w) {
  jp2 = is_jp2(p, n);
  size_t off = 0;
  if (jp2) {
    off = read_boxes(p, n, j);
    if (!j.has_ihdr) fail("IHDR box missing. Required.");
    cs.ihdr_w = j.w;
    cs.ihdr_h = j.h;
  }
  w = new Walker(p + off, n - off, cs);
  w->main_header();
  return off;
}

void put_msg(char* msg, int msglen, const std::string& s) {
  if (msglen <= 0) return;
  std::snprintf(msg, size_t(msglen), "%s", s.c_str());
}

}  // namespace

extern "C" {

// opj_read_header as OpenCV's readHeader calls it. Returns 0 (info =
// {numcomps, colour space, x0, y0, x1, y1, then prec, sgnd, dx, dy per
// component, at most (cap - 6) / 4 of them}), 1 (bytes cv2 gives None
// for); msg says why.
int gj2k_header(const uint8_t* data, uint64_t size, int* info, int cap,
                char* msg, int msglen) {
  Walker* w = nullptr;
  try {
    JP2 j;
    Codestream cs;
    bool jp2;
    read_header(data, size_t(size), j, jp2, cs, w);
    delete w;
    w = nullptr;
    info[0] = int(cs.comps.size());
    info[1] = colour_space(jp2 ? &j : nullptr);
    info[2] = cs.x0;
    info[3] = cs.y0;
    info[4] = cs.x1;
    info[5] = cs.y1;
    for (size_t c = 0; c < cs.comps.size() && 6 + 4 * int(c) + 3 < cap; c++) {
      info[6 + 4 * c] = cs.comps[c].prec;
      info[7 + 4 * c] = cs.comps[c].sgnd;
      info[8 + 4 * c] = cs.comps[c].dx;
      info[9 + 4 * c] = cs.comps[c].dy;
    }
    return 0;
  } catch (const Invalid& e) {
    delete w;
    put_msg(msg, msglen, e.msg);
    return 1;
  } catch (const std::bad_alloc&) {
    delete w;
    put_msg(msg, msglen, "out of memory");
    return 1;
  }
}

// opj_decode as OpenCV's readData calls it. Returns a malloc'd buffer of the
// components' int32 samples one after another (free it with gj2k_free), or
// NULL with *status 1 (None). info gets
// {numcomps, colour space, then w, h, x0, y0, dx, dy, prec, sgnd, alpha per
// component, at most (cap - 2) / 9 of them}.
int32_t* gj2k_decode(const uint8_t* data, uint64_t size, int* info, int cap,
                     int* status, char* msg, int msglen) {
  *status = 0;
  g_timing = Timing();
  const Clock::time_point start = Clock::now();
  struct Total {
    Clock::time_point t0;
    ~Total() { g_timing.total = seconds_since(t0); }
  } total{start};
  Walker* w = nullptr;
  try {
    JP2 j;
    Codestream cs;
    bool jp2;
    read_header(data, size_t(size), j, jp2, cs, w);
    std::vector<ImageComp> img(cs.comps.size());
    for (size_t c = 0; c < img.size(); c++) {
      const CompSiz& s = cs.comps[c];
      ImageComp& ic = img[c];
      ic.w = s.w; ic.h = s.h; ic.x0 = s.x0; ic.y0 = s.y0;
      ic.dx = s.dx; ic.dy = s.dy; ic.prec = s.prec; ic.sgnd = s.sgnd;
    }
    bool any = false;
    w->tile_parts(img, any);
    delete w;
    w = nullptr;
    for (auto& ic : img)  // a component no decoded tile wrote
      if (ic.data.empty()) ic.data.assign(size_t(ic.w) * size_t(ic.h), 0);
    if (!any) fail("Failed to decode tile 1/1");
    if (jp2) apply_colour(j, img);
    info[0] = int(img.size());
    info[1] = colour_space(jp2 ? &j : nullptr);
    size_t total = 0;
    for (size_t c = 0; c < img.size(); c++) {
      const ImageComp& ic = img[c];
      if (2 + 9 * int(c) + 8 < cap) {
        int* q = info + 2 + 9 * c;
        q[0] = ic.w; q[1] = ic.h; q[2] = ic.x0; q[3] = ic.y0; q[4] = ic.dx;
        q[5] = ic.dy; q[6] = ic.prec; q[7] = ic.sgnd; q[8] = ic.alpha;
      }
      total += ic.data.size();
    }
    int32_t* out = static_cast<int32_t*>(std::malloc(std::max<size_t>(total, 1) * 4));
    if (!out) throw std::bad_alloc();
    size_t at = 0;
    for (const auto& ic : img) {
      std::memcpy(out + at, ic.data.data(), ic.data.size() * 4);
      at += ic.data.size();
    }
    return out;
  } catch (const Invalid& e) {
    delete w;
    put_msg(msg, msglen, e.msg);
    *status = 1;
  } catch (const std::bad_alloc&) {
    delete w;
    put_msg(msg, msglen, "out of memory");
    *status = 1;
  }
  return nullptr;
}

void gj2k_free(void* p) { std::free(p); }

// the calling thread's last gj2k_decode in seconds: out = {whole call,
// tier 1 (MQ or HT code-blocks), inverse wavelet}
void gj2k_timing(double* out) {
  out[0] = g_timing.total;
  out[1] = g_timing.tier1;
  out[2] = g_timing.wavelet;
}

}  // extern "C"
