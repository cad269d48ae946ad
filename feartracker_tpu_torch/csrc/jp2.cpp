// A JPEG 2000 Part 1 codestream decoder (ITU-T T.800), with a plain C
// interface for ctypes (feartracker_tpu_torch/data/jp2.py builds and binds it
// and reads the JP2 boxes around the codestream).
//
// It gives the component samples OpenJPEG 2.5 gives (the library behind
// OpenCV 5.0's cv2.imread), in OpenJPEG's arithmetic:
//
// * markers: SIZ, COD/COC, QCD/QCC, RGN, POC, PPM/PPT, SOT/SOD with tiles and
//   tile-parts; TLM, PLM, PLT, CRG, COM and unknown markers are skipped;
// * tier-2: tag trees, the five progressions (position-driven ones as
//   OpenJPEG's packet iterator steps them), precincts, quality layers,
//   SOP/EPH, packet headers in PPM/PPT;
// * tier-1: the MQ decoder and the three coding passes with every code-block
//   style (bypass, reset, termall, vertically causal, predictable
//   termination, segmentation symbols); coefficients kept at twice their
//   value, a newly significant one at 1.5 times its bit (OpenJPEG's "one plus
//   half" reconstruction);
// * ROI max-shift; reversible coefficients halved (C division), irreversible
//   ones times 0.5 * step in float, where the step is (1 + mant/2048) *
//   2^(prec - expn) for every band (OpenJPEG's decoder leaves out the band
//   gain and scales the 9/7 high-pass by 2/K instead of 1/K);
// * the 5/3 integer and 9/7 float inverse DWT, horizontal then vertical at
//   each level, lifting with whole-sample symmetric extension; RCT/ICT; DC
//   level shift with lrintf and the clamp to the component's range.
//
// HTJ2K code-blocks, Part 2 transforms and multiple-component transforms
// raise. Every function returns 0 on success, else writes a message to err.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& m) { throw Error(m); }

inline int ceildiv(int64_t a, int64_t b) { return (int)((a + b - 1) / b); }
inline int ceildivpow2(int64_t a, int b) { return (int)((a + ((int64_t)1 << b) - 1) >> b); }
inline int floordivpow2(int a, int b) { return a >> b; }

// -- byte and bit readers ------------------------------------------------------

struct Reader {
  const uint8_t* p;
  size_t n, pos = 0;
  Reader(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  void need(size_t k) const {
    if (pos + k > n) fail("codestream ends inside a marker segment");
  }
  uint32_t u8() { need(1); return p[pos++]; }
  uint32_t u16() { need(2); uint32_t v = (uint32_t)p[pos] << 8 | p[pos + 1]; pos += 2; return v; }
  uint32_t u32() { uint32_t v = u16() << 16; return v | u16(); }
};

// OpenJPEG's opj_bio: packet-header bits, MSB first, a 0 bit stuffed after 0xFF
struct Bio {
  const uint8_t* start;
  const uint8_t* bp;
  const uint8_t* end;
  uint32_t buf = 0;
  int ct = 0;
  Bio(const uint8_t* b, const uint8_t* e) : start(b), bp(b), end(e) {}
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
  uint32_t bits(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) v = v << 1 | bit();
    return v;
  }
  void inalign() {
    if ((buf & 0xff) == 0xff) bytein();
    ct = 0;
  }
  size_t used() const { return (size_t)(bp - start); }
};

// -- the MQ decoder (T.800 Annex C) --------------------------------------------

struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

const MqState MQ_TABLE[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},
    {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0},
    {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0}, {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0}, {0x1C01, 25, 22, 0},
    {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0},
    {0x02A1, 36, 33, 0}, {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

// context labels: 0-8 significance, 9-13 sign, 14-16 refinement, 17 run, 18 uniform
enum { CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NUM_CTX = 19 };

struct Mq {
  // one segment's bytes followed by 0xFF 0xFF, as OpenJPEG terminates them
  std::vector<uint8_t> buf;
  const uint8_t* bp = nullptr;
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t state[NUM_CTX], mps[NUM_CTX];

  void reset_states() {
    memset(state, 0, sizeof state);
    memset(mps, 0, sizeof mps);
    state[CTX_UNI] = 46;
    state[CTX_AGG] = 3;
    state[0] = 4;
  }
  void load(const uint8_t* data, size_t len) {
    buf.assign(data, data + len);
    buf.push_back(0xFF);
    buf.push_back(0xFF);
    bp = buf.data();
  }
  void bytein() {
    if (bp[0] == 0xFF) {
      if (bp[1] > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        bp++;
        c += (uint32_t)bp[0] << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += (uint32_t)bp[0] << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* data, size_t len) {
    load(data, len);
    c = (uint32_t)bp[0] << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
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
    const MqState& s = MQ_TABLE[state[cx]];
    int d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {  // LPS exchange
      if (a < s.qe) {
        d = mps[cx];
        state[cx] = s.nmps;
      } else {
        d = 1 - mps[cx];
        if (s.sw) mps[cx] = (uint8_t)(1 - mps[cx]);
        state[cx] = s.nlps;
      }
      a = s.qe;
      renorm();
    } else {
      c -= (uint32_t)s.qe << 16;
      if ((a & 0x8000) == 0) {  // MPS exchange
        if (a < s.qe) {
          d = 1 - mps[cx];
          if (s.sw) mps[cx] = (uint8_t)(1 - mps[cx]);
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
  // raw (bypass) segments: opj_mqc_raw_init_dec / opj_mqc_raw_decode
  void raw_init(const uint8_t* data, size_t len) {
    load(data, len);
    c = 0;
    ct = 0;
  }
  int raw() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (bp[0] > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = bp[0];
          bp++;
          ct = 7;
        }
      } else {
        c = bp[0];
        bp++;
        ct = 8;
      }
    }
    ct--;
    return (int)((c >> ct) & 1);
  }
};

// -- tag trees -----------------------------------------------------------------

struct TagTree {
  struct Node {
    int parent, value, low;
  };
  std::vector<Node> nodes;

  void build(int w, int h) {
    std::vector<int> lw, lh;
    int nw = w, nh = h, total = 0;
    do {
      lw.push_back(nw);
      lh.push_back(nh);
      total += nw * nh;
      nw = (nw + 1) / 2;
      nh = (nh + 1) / 2;
    } while (lw.back() * lh.back() > 1);
    nodes.assign((size_t)total, Node{-1, 999, 0});
    int base = 0;
    for (size_t l = 0; l + 1 < lw.size(); ++l) {
      int up = base + lw[l] * lh[l];
      for (int j = 0; j < lh[l]; ++j)
        for (int i = 0; i < lw[l]; ++i) nodes[(size_t)(base + j * lw[l] + i)].parent = up + (j / 2) * lw[l + 1] + i / 2;
      base = up;
    }
  }
  void reset() {
    for (Node& n : nodes) {
      n.value = 999;
      n.low = 0;
    }
  }
  // opj_tgt_decode: is the leaf's value below threshold?
  bool decode(Bio& bio, int leaf, int threshold) {
    int stk[64], sp = 0, n = leaf;
    while (nodes[(size_t)n].parent >= 0) {
      stk[sp++] = n;
      n = nodes[(size_t)n].parent;
    }
    int low = 0;
    for (;;) {
      Node& nd = nodes[(size_t)n];
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
      n = stk[--sp];
    }
    return nodes[(size_t)n].value < threshold;
  }
};

// -- coding parameters ---------------------------------------------------------

struct Step {
  int expn = 0, mant = 0;
};

struct CompParams {
  int numres = 6, cblkw = 6, cblkh = 6, cblksty = 0, qmfbid = 1;
  int prcw[33], prch[33];
  int qntsty = 0, numgbits = 2;
  Step steps[3 * 32 + 1];
  int roishift = 0;
  CompParams() {
    for (int i = 0; i < 33; ++i) prcw[i] = prch[i] = 15;
  }
};

struct Poc {
  int resno0, compno0, layno1, resno1, compno1, prg;
};

struct CompInfo {
  int prec, sgnd, dx, dy;
};

struct Siz {
  int x0, y0, x1, y1, tx0, ty0, tdx, tdy, numcomps;
  std::vector<CompInfo> comps;
  int tw, th;
};

struct TileParams {
  int csty = 0, prg = 0, numlayers = 1, mct = 0;
  std::vector<CompParams> comps;
  std::vector<Poc> pocs;
  std::vector<std::pair<int, std::vector<uint8_t>>> ppt;
  std::vector<uint8_t> headers;  // packet headers from PPM, tile-part by tile-part
  std::vector<uint8_t> data;     // the tile-parts' bodies
  bool present = false;
};

void read_spcod(Reader& r, CompParams& cp, bool precincts) {
  int nl = (int)r.u8();
  if (nl > 32) fail("COD/COC: more than 32 decomposition levels");
  cp.numres = nl + 1;
  cp.cblkw = (int)r.u8() + 2;
  cp.cblkh = (int)r.u8() + 2;
  if (cp.cblkw > 10 || cp.cblkh > 10 || cp.cblkw + cp.cblkh > 12) fail("COD/COC: code-block size out of range");
  cp.cblksty = (int)r.u8();
  if (cp.cblksty & 0x40) fail("HTJ2K (high-throughput) code-blocks are not read");
  cp.qmfbid = (int)r.u8();
  if (cp.qmfbid > 1) fail("COD/COC: a Part 2 wavelet transform is not read");
  for (int i = 0; i < cp.numres; ++i) {
    if (precincts) {
      int b = (int)r.u8();
      cp.prcw[i] = b & 15;
      cp.prch[i] = b >> 4;
      if (i > 0 && (cp.prcw[i] == 0 || cp.prch[i] == 0)) fail("COD/COC: a precinct of size 1 above resolution 0");
    } else {
      cp.prcw[i] = cp.prch[i] = 15;
    }
  }
}

void read_sqcd(Reader& r, size_t end, CompParams& cp) {
  int s = (int)r.u8();
  cp.qntsty = s & 31;
  cp.numgbits = s >> 5;
  if (cp.qntsty > 2) fail("QCD/QCC: unknown quantization style");
  size_t left = end - r.pos;
  int nb = cp.qntsty == 1 ? 1 : (int)(cp.qntsty == 0 ? left : left / 2);
  for (int b = 0; b < nb; ++b) {
    Step st;
    if (cp.qntsty == 0) {
      st.expn = (int)r.u8() >> 3;
    } else {
      int v = (int)r.u16();
      st.expn = v >> 11;
      st.mant = v & 0x7FF;
    }
    if (b < 97) cp.steps[b] = st;
  }
  if (cp.qntsty == 1) {
    for (int b = 1; b < 97; ++b) {
      cp.steps[b].expn = std::max(cp.steps[0].expn - (b - 1) / 3, 0);
      cp.steps[b].mant = cp.steps[0].mant;
    }
  }
}

// -- the tile's structure (OpenJPEG's opj_tcd_init_tile) -----------------------

struct Seg {
  int len = 0, numpasses = 0, maxpasses = 0, newlen = 0, numnewpasses = 0;
};

struct Cblk {
  int x0, y0, x1, y1;
  int numbps = 0, numlenbits = 0, numnewpasses = 0;
  std::vector<Seg> segs;  // segs.size() = OpenJPEG's numsegs
  std::vector<uint8_t> data;
};

struct Prec {
  int cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  int x0, y0, x1, y1, bandno, numbps;
  float stepsize;
  std::vector<Prec> precs;
  bool empty() const { return x0 == x1 || y0 == y1; }
};

struct Res {
  int x0, y0, x1, y1, pw, ph, pdx, pdy, numbands;
  Band bands[3];
};

struct TileComp {
  int x0, y0, x1, y1, numres;
  std::vector<Res> res;
  std::vector<int32_t> idata;
  std::vector<float> fdata;
  int w() const { return x1 - x0; }
  int h() const { return y1 - y0; }
};

void init_tilecomp(TileComp& tc, const CompParams& cp, const CompInfo& ci, int tx0, int ty0, int tx1, int ty1) {
  tc.x0 = ceildiv(tx0, ci.dx);
  tc.y0 = ceildiv(ty0, ci.dy);
  tc.x1 = ceildiv(tx1, ci.dx);
  tc.y1 = ceildiv(ty1, ci.dy);
  tc.numres = cp.numres;
  tc.res.resize((size_t)cp.numres);
  for (int resno = 0; resno < cp.numres; ++resno) {
    Res& res = tc.res[(size_t)resno];
    int levelno = cp.numres - 1 - resno;
    res.x0 = ceildivpow2(tc.x0, levelno);
    res.y0 = ceildivpow2(tc.y0, levelno);
    res.x1 = ceildivpow2(tc.x1, levelno);
    res.y1 = ceildivpow2(tc.y1, levelno);
    res.pdx = cp.prcw[resno];
    res.pdy = cp.prch[resno];
    int tlpx = floordivpow2(res.x0, res.pdx) << res.pdx, tlpy = floordivpow2(res.y0, res.pdy) << res.pdy;
    int brpx = ceildivpow2(res.x1, res.pdx) << res.pdx, brpy = ceildivpow2(res.y1, res.pdy) << res.pdy;
    res.pw = res.x0 == res.x1 ? 0 : (brpx - tlpx) >> res.pdx;
    res.ph = res.y0 == res.y1 ? 0 : (brpy - tlpy) >> res.pdy;
    int tlcbgx, tlcbgy, cbgw, cbgh;
    if (resno == 0) {
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
    int cblkw = std::min(cp.cblkw, cbgw), cblkh = std::min(cp.cblkh, cbgh);
    for (int b = 0; b < res.numbands; ++b) {
      Band& band = res.bands[b];
      if (resno == 0) {
        band.bandno = 0;
        band.x0 = res.x0;
        band.y0 = res.y0;
        band.x1 = res.x1;
        band.y1 = res.y1;
      } else {
        band.bandno = b + 1;
        int xob = band.bandno & 1, yob = band.bandno >> 1;
        band.x0 = ceildivpow2(tc.x0 - ((int64_t)xob << levelno), levelno + 1);
        band.y0 = ceildivpow2(tc.y0 - ((int64_t)yob << levelno), levelno + 1);
        band.x1 = ceildivpow2(tc.x1 - ((int64_t)xob << levelno), levelno + 1);
        band.y1 = ceildivpow2(tc.y1 - ((int64_t)yob << levelno), levelno + 1);
      }
      const Step& st = cp.steps[resno == 0 ? 0 : 3 * (resno - 1) + b + 1];
      int gain = cp.qmfbid == 0 ? 0 : band.bandno == 0 ? 0 : band.bandno == 3 ? 2 : 1;
      int rb = ci.prec + gain;
      band.stepsize = (float)((1.0 + st.mant / 2048.0) * pow(2.0, (double)(rb - st.expn)));
      band.numbps = st.expn + cp.numgbits - 1;
      band.precs.assign((size_t)res.pw * (size_t)res.ph, Prec());
      for (int p = 0; p < res.pw * res.ph; ++p) {
        Prec& prc = band.precs[(size_t)p];
        int cx0 = tlcbgx + (p % res.pw) * (1 << cbgw), cy0 = tlcbgy + (p / res.pw) * (1 << cbgh);
        int px0 = std::max(cx0, band.x0), py0 = std::max(cy0, band.y0);
        int px1 = std::min(cx0 + (1 << cbgw), band.x1), py1 = std::min(cy0 + (1 << cbgh), band.y1);
        if (px1 <= px0 || py1 <= py0) {
          prc.cw = prc.ch = 0;
        } else {
          int tlbx = floordivpow2(px0, cblkw) << cblkw, tlby = floordivpow2(py0, cblkh) << cblkh;
          int brbx = ceildivpow2(px1, cblkw) << cblkw, brby = ceildivpow2(py1, cblkh) << cblkh;
          prc.cw = (brbx - tlbx) >> cblkw;
          prc.ch = (brby - tlby) >> cblkh;
          prc.cblks.resize((size_t)prc.cw * (size_t)prc.ch);
          for (int k = 0; k < prc.cw * prc.ch; ++k) {
            Cblk& cb = prc.cblks[(size_t)k];
            int bx = tlbx + (k % prc.cw) * (1 << cblkw), by = tlby + (k / prc.cw) * (1 << cblkh);
            cb.x0 = std::max(bx, px0);
            cb.y0 = std::max(by, py0);
            cb.x1 = std::min(bx + (1 << cblkw), px1);
            cb.y1 = std::min(by + (1 << cblkh), py1);
          }
        }
        prc.incl.build(prc.cw, prc.ch);
        prc.imsb.build(prc.cw, prc.ch);
      }
    }
  }
}

// -- tier-2: the packet order (OpenJPEG's opj_pi_next_*) ------------------------

struct Packet {
  int layno, resno, compno, precno;
};

struct PacketOrder {
  const Siz& siz;
  const std::vector<TileComp>& tcs;
  int tx0, ty0, tx1, ty1, maxres, maxprec;
  std::vector<uint8_t> include;
  std::vector<Packet> out;

  PacketOrder(const Siz& s, const std::vector<TileComp>& t, int x0, int y0, int x1, int y1)
      : siz(s), tcs(t), tx0(x0), ty0(y0), tx1(x1), ty1(y1) {
    maxres = 0;
    maxprec = 0;
    for (const TileComp& tc : tcs) {
      maxres = std::max(maxres, tc.numres);
      for (const Res& r : tc.res) maxprec = std::max(maxprec, r.pw * r.ph);
    }
  }
  void add(int l, int r, int c, int p) {
    size_t idx = (((size_t)l * (size_t)maxres + (size_t)r) * (size_t)siz.numcomps + (size_t)c) * (size_t)maxprec + (size_t)p;
    if (idx >= include.size()) include.resize(idx + 1, 0);
    if (!include[idx]) {
      include[idx] = 1;
      out.push_back(Packet{l, r, c, p});
    }
  }
  // the precinct at position (x, y) of resolution r of component c, or -1
  int precinct_at(int c, int r, int x, int y) const {
    const TileComp& tc = tcs[(size_t)c];
    const CompInfo& ci = siz.comps[(size_t)c];
    const Res& res = tc.res[(size_t)r];
    int levelno = tc.numres - 1 - r;
    int64_t cdx = (int64_t)ci.dx << levelno, cdy = (int64_t)ci.dy << levelno;
    int trx0 = (int)((tx0 + cdx - 1) / cdx), try0 = (int)((ty0 + cdy - 1) / cdy);
    int trx1 = (int)((tx1 + cdx - 1) / cdx), try1 = (int)((ty1 + cdy - 1) / cdy);
    int rpx = res.pdx + levelno, rpy = res.pdy + levelno;
    if (rpx >= 31 || rpy >= 31) return -1;
    if (!((uint64_t)y % ((uint64_t)ci.dy << rpy) == 0 ||
          (y == ty0 && (((uint64_t)try0 << levelno) % ((uint64_t)1 << rpy)))))
      return -1;
    if (!((uint64_t)x % ((uint64_t)ci.dx << rpx) == 0 ||
          (x == tx0 && (((uint64_t)trx0 << levelno) % ((uint64_t)1 << rpx)))))
      return -1;
    if (res.pw == 0 || res.ph == 0) return -1;
    if (trx0 == trx1 || try0 == try1) return -1;
    int prci = floordivpow2((int)((x + cdx - 1) / cdx), res.pdx) - floordivpow2(trx0, res.pdx);
    int prcj = floordivpow2((int)((y + cdy - 1) / cdy), res.pdy) - floordivpow2(try0, res.pdy);
    return prci + prcj * res.pw;
  }
  void steps(int c0, int c1, int& dx, int& dy) const {
    dx = dy = 0;
    for (int c = c0; c < c1; ++c) {
      const TileComp& tc = tcs[(size_t)c];
      for (int r = 0; r < tc.numres; ++r) {
        int sh = tc.res[(size_t)r].pdx + tc.numres - 1 - r, shy = tc.res[(size_t)r].pdy + tc.numres - 1 - r;
        if (sh < 32) {
          int64_t d = (int64_t)siz.comps[(size_t)c].dx << sh;
          if (d <= 0x7FFFFFFF) dx = dx ? (int)std::min<int64_t>(dx, d) : (int)d;
        }
        if (shy < 32) {
          int64_t d = (int64_t)siz.comps[(size_t)c].dy << shy;
          if (d <= 0x7FFFFFFF) dy = dy ? (int)std::min<int64_t>(dy, d) : (int)d;
        }
      }
    }
  }
  void progression(int prg, int r0, int c0, int l1, int r1, int c1) {
    c1 = std::min(c1, siz.numcomps);
    if (prg == 0 || prg == 1) {  // LRCP, RLCP
      int outer = prg == 0 ? l1 : r1, inner = prg == 0 ? r1 : l1;
      for (int a = prg == 0 ? 0 : r0; a < outer; ++a)
        for (int b = prg == 0 ? r0 : 0; b < inner; ++b) {
          int l = prg == 0 ? a : b, r = prg == 0 ? b : a;
          for (int c = c0; c < c1; ++c) {
            const TileComp& tc = tcs[(size_t)c];
            if (r >= tc.numres) continue;
            const Res& res = tc.res[(size_t)r];
            for (int p = 0; p < res.pw * res.ph; ++p) add(l, r, c, p);
          }
        }
      return;
    }
    int dx, dy;
    if (prg == 2 || prg == 3) {  // RPCL, PCRL: steps over every component
      steps(0, siz.numcomps, dx, dy);
      if (dx == 0 || dy == 0) return;
      if (prg == 2) {
        for (int r = r0; r < r1; ++r)
          for (int y = ty0; y < ty1; y += dy - y % dy)
            for (int x = tx0; x < tx1; x += dx - x % dx)
              for (int c = c0; c < c1; ++c) {
                if (r >= tcs[(size_t)c].numres) continue;
                int p = precinct_at(c, r, x, y);
                if (p >= 0)
                  for (int l = 0; l < l1; ++l) add(l, r, c, p);
              }
      } else {
        for (int y = ty0; y < ty1; y += dy - y % dy)
          for (int x = tx0; x < tx1; x += dx - x % dx)
            for (int c = c0; c < c1; ++c)
              for (int r = r0; r < std::min(r1, tcs[(size_t)c].numres); ++r) {
                int p = precinct_at(c, r, x, y);
                if (p >= 0)
                  for (int l = 0; l < l1; ++l) add(l, r, c, p);
              }
      }
      return;
    }
    for (int c = c0; c < c1; ++c) {  // CPRL: steps per component
      steps(c, c + 1, dx, dy);
      if (dx == 0 || dy == 0) return;
      for (int y = ty0; y < ty1; y += dy - y % dy)
        for (int x = tx0; x < tx1; x += dx - x % dx)
          for (int r = r0; r < std::min(r1, tcs[(size_t)c].numres); ++r) {
            int p = precinct_at(c, r, x, y);
            if (p >= 0)
              for (int l = 0; l < l1; ++l) add(l, r, c, p);
          }
    }
  }
};

// -- tier-2: one packet (opj_t2_read_packet_header / _data) --------------------

int init_seg(Cblk& cb, int cblksty, bool first) {
  Seg s;
  if (cblksty & 0x04)  // TERMALL
    s.maxpasses = 1;
  else if (cblksty & 0x01)  // BYPASS
    s.maxpasses = first ? 10 : (cb.segs.back().maxpasses == 1 || cb.segs.back().maxpasses == 10) ? 2 : 1;
  else
    s.maxpasses = 109;
  cb.segs.push_back(s);
  return (int)cb.segs.size() - 1;
}

int numpasses(Bio& bio) {
  if (!bio.bit()) return 1;
  if (!bio.bit()) return 2;
  uint32_t n = bio.bits(2);
  if (n != 3) return 3 + (int)n;
  n = bio.bits(5);
  if (n != 31) return 6 + (int)n;
  return 37 + (int)bio.bits(7);
}

int floorlog2(int v) {
  int l = 0;
  while (v > 1) {
    v >>= 1;
    ++l;
  }
  return l;
}

struct Span {
  const uint8_t* p;
  const uint8_t* end;
};

void read_packet(TileComp& tc, const CompParams& cp, int csty, const Packet& pk, Span& body, Span* hdr) {
  Res& res = tc.res[(size_t)pk.resno];
  if (pk.layno == 0) {
    for (int b = 0; b < res.numbands; ++b) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      Prec& prc = band.precs[(size_t)pk.precno];
      prc.incl.reset();
      prc.imsb.reset();
      for (Cblk& cb : prc.cblks) cb.segs.clear();
    }
  }
  if ((csty & 0x02) && body.end - body.p >= 6 && body.p[0] == 0xFF && body.p[1] == 0x91) body.p += 6;  // SOP
  Span& hs = hdr ? *hdr : body;
  Bio bio(hs.p, hs.end);
  bool present = bio.bit();
  if (present) {
    for (int b = 0; b < res.numbands; ++b) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      Prec& prc = band.precs[(size_t)pk.precno];
      for (int k = 0; k < prc.cw * prc.ch; ++k) {
        Cblk& cb = prc.cblks[(size_t)k];
        bool included;
        if (cb.segs.empty())
          included = prc.incl.decode(bio, k, pk.layno + 1);
        else
          included = bio.bit();
        if (!included) {
          cb.numnewpasses = 0;
          continue;
        }
        if (cb.segs.empty()) {
          int i = 0;
          while (!prc.imsb.decode(bio, k, i)) {
            if (++i > 999) fail("bad zero bit-plane tag tree");
          }
          cb.numbps = band.numbps + 1 - i;
          cb.numlenbits = 3;
        }
        cb.numnewpasses = numpasses(bio);
        while (bio.bit()) ++cb.numlenbits;
        int segno;
        if (cb.segs.empty()) {
          segno = init_seg(cb, cp.cblksty, true);
        } else {
          segno = (int)cb.segs.size() - 1;
          if (cb.segs[(size_t)segno].numpasses == cb.segs[(size_t)segno].maxpasses) segno = init_seg(cb, cp.cblksty, false);
        }
        int n = cb.numnewpasses;
        for (;;) {
          Seg& s = cb.segs[(size_t)segno];
          s.numnewpasses = std::min(s.maxpasses - s.numpasses, n);
          int nbits = cb.numlenbits + floorlog2(s.numnewpasses);
          if (nbits > 32) fail("packet header: a code-word length of more than 32 bits");
          uint32_t len = bio.bits(nbits);
          if (len > 0x7FFFFFFF) fail("packet header: a code-word segment longer than 2 GB");
          s.newlen = (int)len;
          n -= s.numnewpasses;
          if (n <= 0) break;
          segno = init_seg(cb, cp.cblksty, false);
        }
      }
    }
  }
  bio.inalign();
  hs.p += bio.used();
  if (hs.p > hs.end) fail("packet header runs past the end of the tile");
  if ((csty & 0x04) && hs.end - hs.p >= 2 && hs.p[0] == 0xFF && hs.p[1] == 0x92) hs.p += 2;  // EPH
  if (!present) return;
  for (int b = 0; b < res.numbands; ++b) {
    Band& band = res.bands[b];
    if (band.empty()) continue;
    Prec& prc = band.precs[(size_t)pk.precno];
    for (Cblk& cb : prc.cblks) {
      if (!cb.numnewpasses) continue;
      int n = cb.numnewpasses;
      for (size_t si = 0; si < cb.segs.size() && n > 0; ++si) {
        Seg& s = cb.segs[si];
        if (s.numpasses == s.maxpasses) continue;
        if (s.newlen > body.end - body.p) fail("truncated tile data: a code-block segment runs past the end");
        cb.data.insert(cb.data.end(), body.p, body.p + s.newlen);
        body.p += s.newlen;
        s.len += s.newlen;
        s.numpasses += s.numnewpasses;
        n -= s.numnewpasses;
        s.newlen = 0;
        s.numnewpasses = 0;
      }
    }
  }
}

// -- tier-1: one code-block (opj_t1_decode_cblk) --------------------------------

// Table D.1 by band (0 LL, 1 HL, 2 LH, 3 HH), h/v/d the counts of
// significant horizontal, vertical and diagonal neighbours
int zc_context(int bandno, int h, int v, int d) {
  if (bandno == 1) std::swap(h, v);
  if (bandno == 3) {
    int hv = h + v;
    if (d >= 3) return 8;
    if (d == 2) return hv >= 1 ? 7 : 6;
    if (d == 1) return hv >= 2 ? 5 : hv == 1 ? 4 : 3;
    return hv >= 2 ? 2 : hv;
  }
  if (h == 2) return 8;
  if (h == 1) return v >= 1 ? 7 : d >= 1 ? 6 : 5;
  if (v == 2) return 4;
  if (v == 1) return 3;
  return d >= 2 ? 2 : d;
}

// a sample's significant neighbours packed in one byte: h + 4 v + 16 d
enum { NB_H = 1, NB_V = 4, NB_D = 16 };
enum { F_SIG = 1, F_NEG = 2, F_VISITED = 4, F_REFINED = 8 };

struct ZcTable {
  uint8_t ctx[4][128];
  ZcTable() {
    for (int b = 0; b < 4; ++b)
      for (int nb = 0; nb < 128; ++nb) ctx[b][nb] = (uint8_t)zc_context(b, nb & 3, (nb >> 2) & 3, nb >> 4);
  }
};
const ZcTable ZC;

// one code-block's coefficients (at twice their value) and per-sample state,
// reused from block to block; the state arrays have a border of one sample
struct T1 {
  int w = 0, h = 0, stride = 0;
  bool vsc = false;
  const uint8_t* zc = nullptr;
  std::vector<int32_t> data;
  std::vector<uint8_t> flags, nb;
  Mq mq;

  void reset(int w_, int h_, int bandno, bool vsc_) {
    w = w_;
    h = h_;
    stride = w + 2;
    vsc = vsc_;
    zc = ZC.ctx[bandno];
    data.assign((size_t)w * (size_t)h, 0);
    flags.assign((size_t)stride * (size_t)(h + 2), 0);
    nb.assign((size_t)stride * (size_t)(h + 2), 0);
  }
  int at(int y, int x) const { return (y + 1) * stride + x + 1; }
  // Table D.3 from the four direct neighbours' signs; the one below a
  // stripe's last row is hidden in vertically causal mode
  int sign_context(int y, int i, int& xorbit) const {
    auto contrib = [&](int j) { return (flags[(size_t)j] & F_SIG) ? ((flags[(size_t)j] & F_NEG) ? -1 : 1) : 0; };
    int hc = contrib(i - 1) + contrib(i + 1);
    int vc = contrib(i - stride) + ((vsc && (y & 3) == 3) ? 0 : contrib(i + stride));
    hc = std::max(-1, std::min(1, hc));
    vc = std::max(-1, std::min(1, vc));
    if (hc < 0 || (hc == 0 && vc < 0)) {
      hc = -hc;
      vc = -vc;
      xorbit = 1;
    } else {
      xorbit = 0;
    }
    if (hc == 0) return CTX_SC + (vc == 0 ? 0 : 1);
    return CTX_SC + 3 + vc;  // (1, 1) -> 13, (1, 0) -> 12, (1, -1) -> 11
  }
  // a sample turns significant: its neighbours count it, except that in
  // vertically causal mode a stripe's last row does not see the row below
  void set_significant(int y, int x, int i, int s, int32_t value) {
    flags[(size_t)i] |= (uint8_t)(F_SIG | (s ? F_NEG : 0));
    data[(size_t)y * (size_t)w + (size_t)x] = s ? -value : value;
    nb[(size_t)i - 1] += NB_H;
    nb[(size_t)i + 1] += NB_H;
    nb[(size_t)(i + stride)] += NB_V;
    nb[(size_t)(i + stride - 1)] += NB_D;
    nb[(size_t)(i + stride + 1)] += NB_D;
    if (!(vsc && (y & 3) == 0)) {
      nb[(size_t)(i - stride)] += NB_V;
      nb[(size_t)(i - stride - 1)] += NB_D;
      nb[(size_t)(i - stride + 1)] += NB_D;
    }
  }
  int decode_sign_mq(int y, int i) {
    int xb;
    int cx = sign_context(y, i, xb);
    return mq.decode(cx) ^ xb;
  }

  void sigpass(int bp, bool raw) {
    int32_t one = 1 << bp, oneplushalf = one | (one >> 1);
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < std::min(k + 4, h); ++y) {
          int i = at(y, x);
          if ((flags[(size_t)i] & (F_SIG | F_VISITED)) || nb[(size_t)i] == 0) continue;
          if (raw) {
            if (mq.raw()) set_significant(y, x, i, mq.raw(), oneplushalf);
          } else if (mq.decode(zc[nb[(size_t)i]])) {
            set_significant(y, x, i, decode_sign_mq(y, i), oneplushalf);
          }
          flags[(size_t)i] |= F_VISITED;
        }
  }

  void refpass(int bp, bool raw) {
    int32_t poshalf = (1 << bp) >> 1;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < std::min(k + 4, h); ++y) {
          int i = at(y, x);
          uint8_t f = flags[(size_t)i];
          if ((f & (F_SIG | F_VISITED)) != F_SIG) continue;
          int v;
          if (raw)
            v = mq.raw();
          else
            v = mq.decode((f & F_REFINED) ? CTX_MAG + 2 : nb[(size_t)i] ? CTX_MAG + 1 : CTX_MAG);
          int32_t& d = data[(size_t)y * (size_t)w + (size_t)x];
          d += (v ^ (d < 0)) ? poshalf : -poshalf;
          flags[(size_t)i] |= F_REFINED;
        }
  }

  void clnpass(int bp, bool segsym) {
    int32_t one = 1 << bp, oneplushalf = one | (one >> 1);
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x) {
        int y = k, yend = std::min(k + 4, h);
        if (yend - k == 4) {  // run mode where the column's four samples and their neighbours are all insignificant
          bool run = true;
          for (int j = k; j < yend && run; ++j) {
            int i = at(j, x);
            run = !(flags[(size_t)i] & (F_SIG | F_VISITED)) && nb[(size_t)i] == 0;
          }
          if (run) {
            if (!mq.decode(CTX_AGG)) {
              y = yend;
            } else {
              int r = mq.decode(CTX_UNI);
              r = r << 1 | mq.decode(CTX_UNI);
              y = k + r;
              int i = at(y, x);
              set_significant(y, x, i, decode_sign_mq(y, i), oneplushalf);
              ++y;
            }
          }
        }
        for (; y < yend; ++y) {
          int i = at(y, x);
          if (flags[(size_t)i] & (F_SIG | F_VISITED)) continue;
          if (mq.decode(zc[nb[(size_t)i]])) set_significant(y, x, i, decode_sign_mq(y, i), oneplushalf);
        }
        for (int j = k; j < yend; ++j) flags[(size_t)at(j, x)] &= (uint8_t)~F_VISITED;
      }
    if (segsym) {
      for (int i = 0; i < 4; ++i) mq.decode(CTX_UNI);  // 0xA; a wrong symbol is only warned about
    }
  }
};

void decode_cblk(const Cblk& cb, int roishift, int cblksty, T1& t1) {
  t1.mq.reset_states();
  int bpno = roishift + cb.numbps;
  if (bpno >= 31) fail("code-block of more than 30 bit-planes");
  int passtype = 2;
  size_t at = 0;
  for (const Seg& s : cb.segs) {
    bool raw = bpno <= cb.numbps - 4 && passtype < 2 && (cblksty & 0x01);
    if (raw)
      t1.mq.raw_init(cb.data.data() + at, (size_t)s.len);
    else
      t1.mq.init(cb.data.data() + at, (size_t)s.len);
    at += (size_t)s.len;
    for (int p = 0; p < s.numpasses && bpno >= 1; ++p) {
      if (passtype == 0)
        t1.sigpass(bpno, raw);
      else if (passtype == 1)
        t1.refpass(bpno, raw);
      else
        t1.clnpass(bpno, (cblksty & 0x20) != 0);
      if ((cblksty & 0x02) && !raw) t1.mq.reset_states();  // RESET
      if (++passtype == 3) {
        passtype = 0;
        bpno--;
      }
    }
  }
  if (roishift) {
    if (roishift >= 31) {
      std::fill(t1.data.begin(), t1.data.end(), 0);
    } else {
      int32_t thresh = 1 << roishift;
      for (int32_t& v : t1.data) {
        int32_t mag = v < 0 ? -v : v;
        if (mag >= thresh) {
          mag >>= roishift;
          v = v < 0 ? -mag : mag;
        }
      }
    }
  }
}

// -- inverse DWT ---------------------------------------------------------------

// One lifting step of one level, on n >= 2 lines of `width` samples each:
// line k (k = 0..n-1) starts at base + k * step, and the lines are samples of
// one signal. The step updates every line of one parity (first, first + 2,
// ...) from its two neighbours, with whole-sample symmetric extension at
// both ends; a pass over rows (step = row stride, width = row length) and a
// pass over single samples (step = 1, width = 1) do the same arithmetic on
// every sample.

template <typename T, typename Op>
void lift(T* base, size_t step, int n, int first, int width, Op op) {
  if (width == 1) {  // one signal: step is 1
    for (int k = first; k < n; k += 2) base[k] = op(base[k], base[k > 0 ? k - 1 : 1], base[k + 1 < n ? k + 1 : k - 1]);
    return;
  }
  for (int k = first; k < n; k += 2) {
    T* x = base + (size_t)k * step;
    const T* l = base + (size_t)(k > 0 ? k - 1 : 1) * step;
    const T* r = base + (size_t)(k + 1 < n ? k + 1 : k - 1) * step;
    for (int j = 0; j < width; ++j) x[j] = op(x[j], l[j], r[j]);
  }
}

// deinterleave: n lines in the band layout (sn low-pass lines, then the
// high-pass ones) → interleaved in tmp, in signal order
template <typename T>
void interleave(const T* src, size_t step, int n, int sn, int cas, int width, T* tmp) {
  for (int k = 0; k < n; ++k) {
    int from = ((k + cas) & 1) ? sn + (k - (1 - cas)) / 2 : (k + cas) / 2 - cas;
    memcpy(tmp + (size_t)k * (size_t)width, src + (size_t)from * step, (size_t)width * sizeof(T));
  }
}

// OpenJPEG's opj_dwt_decode_tile (5/3) on n lines: a single sample at an odd
// position is halved (C division), else predict then update
void idwt53(int32_t* t, int n, int /*sn*/, int cas, int width) {
  if (n == 1) {
    if (cas)
      for (int j = 0; j < width; ++j) t[j] /= 2;
    return;
  }
  size_t w = (size_t)width;
  lift(t, w, n, cas, width, [](int32_t x, int32_t l, int32_t r) { return x - ((l + r + 2) >> 2); });
  lift(t, w, n, 1 - cas, width, [](int32_t x, int32_t l, int32_t r) { return x + ((l + r) >> 1); });
}

const float DWT_ALPHA = -1.586134342f, DWT_BETA = -0.052980118f, DWT_GAMMA = 0.882911075f,
            DWT_DELTA = 0.443506852f, DWT_K = 1.230174105f, DWT_TWO_INVK = 1.625732422f;

// OpenJPEG's opj_v8dwt_decode on n lines: nothing for a single sample; the
// low-pass lines times K and the high-pass ones times 2/K (OpenJPEG's
// historic 1.625732422), then x += (left + right) * c for c = -delta,
// -gamma, -beta, -alpha, in float without contraction
void idwt97(float* t, int n, int sn, int cas, int width) {
  int dn = n - sn;
  if (cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1)) return;
  size_t w = (size_t)width;
  for (int k = 0; k < n; ++k) {
    float c = ((k + cas) & 1) ? DWT_TWO_INVK : DWT_K;
    float* x = t + (size_t)k * w;
    for (int j = 0; j < width; ++j) x[j] = x[j] * c;
  }
  const float c[4] = {-DWT_DELTA, -DWT_GAMMA, -DWT_BETA, -DWT_ALPHA};
  for (int s = 0; s < 4; ++s) {
    const float cs = c[s];
    lift(t, w, n, (s & 1) ? 1 - cas : cas, width, [cs](float x, float l, float r) {
      float sum = l + r;
      float prod = sum * cs;
      return x + prod;
    });
  }
}

// every level of a tile-component, horizontal then vertical: rows one at a
// time, then all columns of the level together, row by row
template <typename T, typename F>
void idwt_2d(TileComp& tc, std::vector<T>& buf, F levels) {
  size_t stride = (size_t)tc.w();
  std::vector<T> tmp;
  for (int r = 1; r < tc.numres; ++r) {
    const Res& lo = tc.res[(size_t)r - 1];
    const Res& res = tc.res[(size_t)r];
    int rw = res.x1 - res.x0, rh = res.y1 - res.y0;
    int snh = lo.x1 - lo.x0, snv = lo.y1 - lo.y0;
    if (rw == 0 || rh == 0) continue;
    tmp.resize((size_t)rw * (size_t)rh);
    for (int j = 0; j < rh; ++j) {
      T* row = buf.data() + (size_t)j * stride;
      interleave(row, 1, rw, snh, res.x0 & 1, 1, tmp.data());
      levels(tmp.data(), rw, snh, res.x0 & 1, 1);
      memcpy(row, tmp.data(), (size_t)rw * sizeof(T));
    }
    interleave(buf.data(), stride, rh, snv, res.y0 & 1, rw, tmp.data());
    levels(tmp.data(), rh, snv, res.y0 & 1, rw);
    for (int j = 0; j < rh; ++j)
      memcpy(buf.data() + (size_t)j * stride, tmp.data() + (size_t)j * (size_t)rw, (size_t)rw * sizeof(T));
  }
}

// -- the codestream ------------------------------------------------------------

struct Decoder {
  const uint8_t* cs;
  size_t n;
  Siz siz{};
  TileParams defaults;
  std::vector<TileParams> tiles;
  std::vector<std::pair<int, std::vector<uint8_t>>> ppm;
  bool has_ppm = false;

  Decoder(const uint8_t* c, size_t len) : cs(c), n(len) {}

  int comp_index(Reader& r) { return (int)(siz.numcomps < 257 ? r.u8() : r.u16()); }

  void read_siz(Reader& r) {
    r.u16();  // Rsiz
    siz.x1 = (int)r.u32();
    siz.y1 = (int)r.u32();
    siz.x0 = (int)r.u32();
    siz.y0 = (int)r.u32();
    siz.tdx = (int)r.u32();
    siz.tdy = (int)r.u32();
    siz.tx0 = (int)r.u32();
    siz.ty0 = (int)r.u32();
    siz.numcomps = (int)r.u16();
    if (siz.x1 <= siz.x0 || siz.y1 <= siz.y0 || siz.x1 < 0 || siz.y1 < 0 || siz.x0 < 0 || siz.y0 < 0)
      fail("SIZ: empty or too large image area");
    if (siz.tdx <= 0 || siz.tdy <= 0 || siz.tx0 < 0 || siz.ty0 < 0 || siz.tx0 > siz.x0 || siz.ty0 > siz.y0 ||
        (int64_t)siz.tx0 + siz.tdx <= siz.x0 || (int64_t)siz.ty0 + siz.tdy <= siz.y0)
      fail("SIZ: bad tile grid");
    if (siz.numcomps < 1 || siz.numcomps > 16384) fail("SIZ: bad number of components");
    for (int c = 0; c < siz.numcomps; ++c) {
      int s = (int)r.u8();
      CompInfo ci{(s & 0x7F) + 1, s >> 7, (int)r.u8(), (int)r.u8()};
      if (ci.dx == 0 || ci.dy == 0) fail("SIZ: a component sub-sampling of 0");
      if (ci.prec > 31) fail("SIZ: a component precision above 31 bits");
      siz.comps.push_back(ci);
    }
    siz.tw = ceildiv((int64_t)siz.x1 - siz.tx0, siz.tdx);
    siz.th = ceildiv((int64_t)siz.y1 - siz.ty0, siz.tdy);
    if ((int64_t)siz.tw * siz.th > 65535) fail("SIZ: more than 65535 tiles");
    defaults.comps.assign((size_t)siz.numcomps, CompParams());
  }

  // one marker segment of the main header (tp = the defaults) or of a tile-part header
  void read_marker(int marker, Reader& r, size_t end, TileParams& tp, bool main) {
    switch (marker) {
      case 0xFF52: {  // COD
        tp.csty = (int)r.u8();
        tp.prg = (int)r.u8();
        if (tp.prg > 4) fail("COD: unknown progression order");
        tp.numlayers = (int)r.u16();
        if (tp.numlayers == 0) fail("COD: no quality layer");
        tp.mct = (int)r.u8();
        if (tp.mct > 1) fail("COD: a Part 2 multiple-component transform is not read");
        CompParams cp = tp.comps[0];
        read_spcod(r, cp, tp.csty & 1);
        for (CompParams& c : tp.comps) {
          c.numres = cp.numres;
          c.cblkw = cp.cblkw;
          c.cblkh = cp.cblkh;
          c.cblksty = cp.cblksty;
          c.qmfbid = cp.qmfbid;
          memcpy(c.prcw, cp.prcw, sizeof c.prcw);
          memcpy(c.prch, cp.prch, sizeof c.prch);
        }
        break;
      }
      case 0xFF53: {  // COC
        int c = comp_index(r);
        if (c >= siz.numcomps) fail("COC: bad component index");
        read_spcod(r, tp.comps[(size_t)c], r.u8() & 1);
        break;
      }
      case 0xFF5C: {  // QCD
        CompParams cp;
        read_sqcd(r, end, cp);
        for (CompParams& c : tp.comps) {
          c.qntsty = cp.qntsty;
          c.numgbits = cp.numgbits;
          memcpy(c.steps, cp.steps, sizeof c.steps);
        }
        break;
      }
      case 0xFF5D: {  // QCC
        int c = comp_index(r);
        if (c >= siz.numcomps) fail("QCC: bad component index");
        read_sqcd(r, end, tp.comps[(size_t)c]);
        break;
      }
      case 0xFF5E: {  // RGN
        int c = comp_index(r);
        if (c >= siz.numcomps) fail("RGN: bad component index");
        if (r.u8() != 0) fail("RGN: unknown region-of-interest style");
        tp.comps[(size_t)c].roishift = (int)r.u8();
        break;
      }
      case 0xFF5F: {  // POC
        std::vector<Poc> pocs;
        while (r.pos < end) {
          Poc p;
          p.resno0 = (int)r.u8();
          p.compno0 = comp_index(r);
          p.layno1 = (int)r.u16();
          p.resno1 = (int)r.u8();
          p.compno1 = comp_index(r);
          p.prg = (int)r.u8();
          if (p.prg > 4) fail("POC: unknown progression order");
          pocs.push_back(p);
        }
        tp.pocs.insert(tp.pocs.end(), pocs.begin(), pocs.end());
        break;
      }
      case 0xFF60: {  // PPM
        if (!main) fail("PPM in a tile-part header");
        int z = (int)r.u8();
        ppm.emplace_back(z, std::vector<uint8_t>(cs + r.pos, cs + end));
        has_ppm = true;
        break;
      }
      case 0xFF61: {  // PPT
        if (main) fail("PPT in the main header");
        int z = (int)r.u8();
        tp.ppt.emplace_back(z, std::vector<uint8_t>(cs + r.pos, cs + end));
        break;
      }
      default:  // TLM, PLM, PLT, CRG, COM, CAP, unknown: skipped
        break;
    }
  }

  void parse() {
    Reader r(cs, n);
    if (r.u16() != 0xFF4F) fail("no SOC marker: not a JPEG 2000 codestream");
    if (r.u16() != 0xFF51) fail("SIZ must follow SOC");
    size_t len = r.u16();
    if (len < 41) fail("SIZ segment too short");
    size_t end = r.pos + len - 2;
    read_siz(r);
    r.pos = end;
    bool seen_cod = false, seen_qcd = false;
    for (;;) {  // main header
      uint32_t m = r.u16();
      if (m == 0xFF90) break;
      if (m == 0xFFD9) fail("codestream ends before its first tile");
      if ((m >> 8) != 0xFF) fail("main header: a byte that is not a marker");
      size_t l = r.u16();
      if (l < 2) fail("main header: bad marker segment length");
      size_t e = r.pos + l - 2;
      if (e > n) fail("main header: a marker segment runs past the end");
      if (m == 0xFF52) seen_cod = true;
      if (m == 0xFF5C) seen_qcd = true;
      read_marker((int)m, r, e, defaults, true);
      r.pos = e;
    }
    if (!seen_cod) fail("main header without COD");
    if (!seen_qcd) fail("main header without QCD");
    std::sort(ppm.begin(), ppm.end(), [](const auto& a, const auto& b) { return a.first < b.first; });
    std::vector<uint8_t> ppm_all;
    for (auto& z : ppm) ppm_all.insert(ppm_all.end(), z.second.begin(), z.second.end());
    size_t ppm_at = 0;
    tiles.assign((size_t)siz.tw * (size_t)siz.th, TileParams());
    r.pos -= 2;
    while (r.pos + 2 <= n) {  // tile-parts
      uint32_t m = r.u16();
      if (m == 0xFFD9) break;
      if (m != 0xFF90) fail("expected SOT");
      size_t sot_at = r.pos - 2;
      size_t l = r.u16();
      if (l != 10) fail("SOT: bad length");
      int isot = (int)r.u16();
      uint32_t psot = r.u32();
      r.u8();  // TPsot
      r.u8();  // TNsot
      if (isot >= siz.tw * siz.th) fail("SOT: tile index out of range");
      size_t part_end = psot ? sot_at + psot : n;
      if (psot == 0) {  // up to EOC
        if (n >= 2 && cs[n - 2] == 0xFF && cs[n - 1] == 0xD9) part_end = n - 2;
      }
      if (part_end > n) fail("truncated codestream: a tile-part runs past the end");
      TileParams& tp = tiles[(size_t)isot];
      if (!tp.present) {
        tp = defaults;
        tp.present = true;
      }
      for (;;) {  // tile-part header
        uint32_t mk = r.u16();
        if (mk == 0xFF93) break;
        if ((mk >> 8) != 0xFF) fail("tile-part header: a byte that is not a marker");
        size_t ml = r.u16();
        if (ml < 2) fail("tile-part header: bad marker segment length");
        size_t e = r.pos + ml - 2;
        if (e > part_end) fail("tile-part header: a marker segment runs past the tile-part");
        read_marker((int)mk, r, e, tp, false);
        r.pos = e;
      }
      if (has_ppm) {
        if (ppm_at + 4 > ppm_all.size()) fail("PPM: fewer packet headers than tile-parts");
        size_t nppm = (size_t)ppm_all[ppm_at] << 24 | (size_t)ppm_all[ppm_at + 1] << 16 |
                      (size_t)ppm_all[ppm_at + 2] << 8 | ppm_all[ppm_at + 3];
        ppm_at += 4;
        if (ppm_at + nppm > ppm_all.size()) fail("PPM: packet headers run past the marker data");
        tp.headers.insert(tp.headers.end(), ppm_all.begin() + (long)ppm_at, ppm_all.begin() + (long)(ppm_at + nppm));
        ppm_at += nppm;
      }
      tp.data.insert(tp.data.end(), cs + r.pos, cs + part_end);
      r.pos = part_end;
    }
  }

  void decode_tile(int tileno, std::vector<std::vector<int32_t>>& out) {
    TileParams& tp = tiles[(size_t)tileno];
    if (!tp.present) return;
    int p = tileno % siz.tw, q = tileno / siz.tw;
    int tx0 = std::max(siz.tx0 + p * siz.tdx, siz.x0), ty0 = std::max(siz.ty0 + q * siz.tdy, siz.y0);
    int tx1 = (int)std::min<int64_t>((int64_t)siz.tx0 + (int64_t)(p + 1) * siz.tdx, siz.x1);
    int ty1 = (int)std::min<int64_t>((int64_t)siz.ty0 + (int64_t)(q + 1) * siz.tdy, siz.y1);
    int nc = siz.numcomps;
    std::vector<TileComp> tcs((size_t)nc);
    for (int c = 0; c < nc; ++c)
      init_tilecomp(tcs[(size_t)c], tp.comps[(size_t)c], siz.comps[(size_t)c], tx0, ty0, tx1, ty1);

    PacketOrder order(siz, tcs, tx0, ty0, tx1, ty1);
    if (!tp.pocs.empty()) {
      for (const Poc& pc : tp.pocs)
        order.progression(pc.prg, pc.resno0, pc.compno0, std::min(pc.layno1, tp.numlayers), pc.resno1, pc.compno1);
    } else {
      order.progression(tp.prg, 0, 0, tp.numlayers, order.maxres, nc);
    }
    std::vector<uint8_t> hdrs;
    if (!tp.ppt.empty()) {
      std::sort(tp.ppt.begin(), tp.ppt.end(), [](const auto& a, const auto& b) { return a.first < b.first; });
      for (auto& z : tp.ppt) hdrs.insert(hdrs.end(), z.second.begin(), z.second.end());
    } else if (has_ppm) {
      hdrs = tp.headers;
    }
    bool sep = !tp.ppt.empty() || has_ppm;
    Span body{tp.data.data(), tp.data.data() + tp.data.size()};
    Span hs{hdrs.data(), hdrs.data() + hdrs.size()};
    for (const Packet& pk : order.out) {
      if (!sep && body.p >= body.end) break;  // the tile's data ends: the remaining packets are absent
      read_packet(tcs[(size_t)pk.compno], tp.comps[(size_t)pk.compno], tp.csty, pk, body, sep ? &hs : nullptr);
    }

    T1 t1;
    for (int c = 0; c < nc; ++c) {
      TileComp& tc = tcs[(size_t)c];
      const CompParams& cp = tp.comps[(size_t)c];
      size_t area = (size_t)tc.w() * (size_t)tc.h();
      bool rev = cp.qmfbid == 1;
      if (rev)
        tc.idata.assign(area, 0);
      else
        tc.fdata.assign(area, 0.0f);
      for (int r = 0; r < tc.numres; ++r) {
        Res& res = tc.res[(size_t)r];
        for (int b = 0; b < res.numbands; ++b) {
          Band& band = res.bands[b];
          if (band.empty()) continue;
          for (Prec& prc : band.precs)
            for (Cblk& cb : prc.cblks) {
              int cw = cb.x1 - cb.x0, ch = cb.y1 - cb.y0;
              if (cw <= 0 || ch <= 0 || cb.segs.empty()) continue;
              t1.reset(cw, ch, band.bandno, (cp.cblksty & 0x08) != 0);
              decode_cblk(cb, cp.roishift, cp.cblksty, t1);
              int x = cb.x0 - band.x0, y = cb.y0 - band.y0;
              if (band.bandno & 1) x += tc.res[(size_t)r - 1].x1 - tc.res[(size_t)r - 1].x0;
              if (band.bandno & 2) y += tc.res[(size_t)r - 1].y1 - tc.res[(size_t)r - 1].y0;
              float step = 0.5f * band.stepsize;
              for (int j = 0; j < ch; ++j)
                for (int i = 0; i < cw; ++i) {
                  int32_t v = t1.data[(size_t)j * (size_t)cw + (size_t)i];
                  size_t o = (size_t)(y + j) * (size_t)tc.w() + (size_t)(x + i);
                  if (rev)
                    tc.idata[o] = v / 2;
                  else
                    tc.fdata[o] = (float)v * step;
                }
            }
        }
      }
      if (rev)
        idwt_2d(tc, tc.idata, idwt53);
      else
        idwt_2d(tc, tc.fdata, idwt97);
    }

    if (tp.mct == 1 && nc >= 3) {
      bool same = true;
      for (int c = 1; c < 3; ++c)
        same = same && tcs[(size_t)c].w() == tcs[0].w() && tcs[(size_t)c].h() == tcs[0].h();
      if (!same) fail("MCT on components of different sizes");
      size_t area = (size_t)tcs[0].w() * (size_t)tcs[0].h();
      if (tp.comps[0].qmfbid == 1) {
        if (tcs[1].idata.empty() || tcs[2].idata.empty()) fail("RCT on irreversible components");
        int32_t *c0 = tcs[0].idata.data(), *c1 = tcs[1].idata.data(), *c2 = tcs[2].idata.data();
        for (size_t i = 0; i < area; ++i) {
          int32_t y = c0[i], u = c1[i], v = c2[i];
          int32_t g = y - ((u + v) >> 2);
          c0[i] = v + g;
          c1[i] = g;
          c2[i] = u + g;
        }
      } else {
        if (tcs[1].fdata.empty() || tcs[2].fdata.empty()) fail("ICT on reversible components");
        float *c0 = tcs[0].fdata.data(), *c1 = tcs[1].fdata.data(), *c2 = tcs[2].fdata.data();
        for (size_t i = 0; i < area; ++i) {
          float y = c0[i], u = c1[i], v = c2[i];
          float r = y + v * 1.402f;
          float g = y - u * 0.34413f - v * 0.71414f;
          float b = y + u * 1.772f;
          c0[i] = r;
          c1[i] = g;
          c2[i] = b;
        }
      }
    }

    for (int c = 0; c < nc; ++c) {  // DC level shift, clamp, into the image
      TileComp& tc = tcs[(size_t)c];
      const CompInfo& ci = siz.comps[(size_t)c];
      int64_t lo = ci.sgnd ? -((int64_t)1 << (ci.prec - 1)) : 0;
      int64_t hi = ci.sgnd ? ((int64_t)1 << (ci.prec - 1)) - 1 : ((int64_t)1 << ci.prec) - 1;
      int64_t shift = ci.sgnd ? 0 : (int64_t)1 << (ci.prec - 1);
      int cx0 = ceildiv(siz.x0, ci.dx), cy0 = ceildiv(siz.y0, ci.dy);
      int cw = ceildiv(siz.x1, ci.dx) - cx0;
      std::vector<int32_t>& img = out[(size_t)c];
      for (int j = 0; j < tc.h(); ++j)
        for (int i = 0; i < tc.w(); ++i) {
          size_t k = (size_t)j * (size_t)tc.w() + (size_t)i;
          int64_t v;
          if (!tc.idata.empty()) {
            v = tc.idata[k] + shift;
          } else {
            float f = tc.fdata[k];
            if (f > (float)INT32_MAX)
              v = hi - shift;
            else if (f < (float)INT32_MIN)
              v = lo - shift;
            else
              v = (int64_t)lrintf(f);
            v += shift;
          }
          v = std::max(lo, std::min(hi, v));
          img[(size_t)(tc.y0 - cy0 + j) * (size_t)cw + (size_t)(tc.x0 - cx0 + i)] = (int32_t)v;
        }
    }
  }
};

void set_err(char* err, int errlen, const char* m) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", m);
}

}  // namespace

extern "C" {

// a codestream (SOC to EOC) → each component's samples, one int32 plane after
// another in out: component c is (ceil(y1/dy) - ceil(y0/dy)) rows of
// (ceil(x1/dx) - ceil(x0/dx)) samples; out_len counts the int32s of all of them
int j2k_decode(const uint8_t* cs, size_t n, int32_t* out, size_t out_len, char* err, int errlen) {
  try {
    Decoder d(cs, n);
    d.parse();
    std::vector<std::vector<int32_t>> planes((size_t)d.siz.numcomps);
    size_t total = 0;
    for (int c = 0; c < d.siz.numcomps; ++c) {
      const CompInfo& ci = d.siz.comps[(size_t)c];
      size_t w = (size_t)(ceildiv(d.siz.x1, ci.dx) - ceildiv(d.siz.x0, ci.dx));
      size_t h = (size_t)(ceildiv(d.siz.y1, ci.dy) - ceildiv(d.siz.y0, ci.dy));
      planes[(size_t)c].assign(w * h, 0);
      total += w * h;
    }
    if (total != out_len) fail("output buffer of the wrong size");
    for (int t = 0; t < d.siz.tw * d.siz.th; ++t) d.decode_tile(t, planes);
    for (auto& pl : planes) {
      memcpy(out, pl.data(), pl.size() * sizeof(int32_t));
      out += pl.size();
    }
    return 0;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return 1;
  }
}

}  // extern "C"
