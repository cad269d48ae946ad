// JPEG codec for the host, byte-equal to libjpeg-turbo 3.1 as OpenCV 5.0
// drives it (cv2.imdecode / cv2.imencode), with a plain C interface for
// ctypes (feartracker_tpu_torch/data/jpeg.py builds and binds it).
//
// Decode: baseline, extended and progressive Huffman, 8-bit; 1 or 3
// components at sampling factors 1-2; restart intervals; APPn/COM skipped.
// The output follows libjpeg's defaults: JDCT_ISLOW (jidctint.c), fancy
// (triangular) upsampling (jdsample.c) and the fixed-point YCbCr->RGB
// tables (jdcolor.c); a gray file comes out as three equal channels. The
// EXIF orientation is returned, not applied: the binding applies it.
//
// Encode: what cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, q]) writes:
// JFIF APP0, DQT per table (jpeg_set_quality), SOF0, the four standard DHTs,
// SOS; 4:2:0 by jcsample.c's h2v2 box (bias 1, 2 alternating), the islow
// FDCT (jfdctint.c) and the reciprocal quantizer (jcdctmgr.c), standard
// Huffman tables; gray input gives one component.
//
// Every codec function returns 0 on success, else writes a message to err.
// The library also holds cv2's colour maps (cvh_*, at the end), where numpy
// would pace the training loader.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <string>
#include <vector>

namespace {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& m) { throw Error{m}; }

// ---------------------------------------------------------------- decoder

struct HuffTable {
  bool present = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valoffset[18];
  int16_t look_sym[256];  // 8-bit lookahead: symbol or -1
  uint8_t look_len[256];

  void build() {
    uint16_t huffcode[257];
    int p = 0, code = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < bits[l]; i++) huffcode[p++] = (uint16_t)code++;
      if (code > (1 << l)) fail("bad Huffman table");
      code <<= 1;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoffset[l] = p - (int)huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7FFFFFFF;
    for (int i = 0; i < 256; i++) { look_sym[i] = -1; look_len[i] = 0; }
    p = 0;
    for (int l = 1; l <= 8; l++) {
      for (int i = 0; i < bits[l]; i++, p++) {
        int lookbits = huffcode[p] << (8 - l);
        for (int ctr = 1 << (8 - l); ctr > 0; ctr--, lookbits++) {
          look_sym[lookbits] = vals[p];
          look_len[lookbits] = (uint8_t)l;
        }
      }
    }
  }
};

// the standard table for a scan that names one it never defined (jdhuff.c)
void std_table(HuffTable& t, int id, bool ac);

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;          // blocks that hold image data
  int bw_pad = 0, bh_pad = 0;  // blocks allocated (whole MCUs)
  int dw = 0, dh = 0;          // downsampled size in samples
  std::vector<int16_t> coef;   // bh_pad * bw_pad * 64, natural order
  uint16_t qt[64];             // latched at the component's first scan
  bool latched = false;
  int coef_bits[64];
  int dc_pred = 0;
  int td = 0, ta = 0;
  int16_t* block(int by, int bx) { return &coef[((size_t)by * bw_pad + bx) * 64]; }
};

struct BitReader {
  const uint8_t* data;
  size_t n, pos;
  uint64_t acc = 0;
  int nbits = 0;
  bool hit_marker = false;

  void fill() {
    while (nbits <= 56) {
      int byte = 0;
      if (!hit_marker && pos < n) {
        byte = data[pos];
        if (byte == 0xFF) {
          size_t q = pos + 1;
          while (q < n && data[q] == 0xFF) q++;  // fill bytes
          if (q < n && data[q] == 0x00) {
            pos = q + 1;
          } else {
            hit_marker = true;
            byte = 0;
            pos = q - 1;  // rest on the marker's last 0xFF
          }
        } else {
          pos++;
        }
      }
      acc |= (uint64_t)byte << (56 - nbits);
      nbits += 8;
    }
  }
  inline int peek(int k) {
    if (nbits < k) fill();
    return (int)(acc >> (64 - k));
  }
  inline void skip(int k) { acc <<= k; nbits -= k; }
  inline int get(int k) {
    if (k == 0) return 0;
    int v = peek(k);
    skip(k);
    return v;
  }
  void reset() { acc = 0; nbits = 0; hit_marker = false; }
};

inline int extend(int x, int s) { return x < (1 << (s - 1)) ? x + (int)(((unsigned)-1) << s) + 1 : x; }

int decode_huff(BitReader& br, const HuffTable& t) {
  int look = br.peek(8);
  if (t.look_sym[look] >= 0) {
    br.skip(t.look_len[look]);
    return t.look_sym[look];
  }
  int code = br.peek(16);
  for (int l = 9; l <= 16; l++) {
    int c = code >> (16 - l);
    if (c <= t.maxcode[l]) {
      br.skip(l);
      return t.vals[(c + t.valoffset[l]) & 0xFF];
    }
  }
  // libjpeg warns and returns 0 for a code that is in no table
  br.skip(16);
  return 0;
}

struct Decoder {
  const uint8_t* d;
  size_t n, pos = 0;
  int W = 0, H = 0, ncomp = 0, precision = 8;
  bool progressive = false, have_frame = false;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int orientation = 0;
  int restart_interval = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  std::vector<Component> comps;
  int eobrun = 0;

  Decoder(const uint8_t* data, size_t len) : d(data), n(len) {}

  int u8() {
    if (pos >= n) fail("truncated JPEG");
    return d[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  void parse_exif(const uint8_t* p, size_t len) {
    if (len < 14 || memcmp(p, "Exif\0\0", 6) != 0) return;
    const uint8_t* t = p + 6;
    size_t tl = len - 6;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto r16 = [&](size_t o) -> int {
      if (o + 2 > tl) return -1;
      return le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
    };
    auto r32 = [&](size_t o) -> long {
      if (o + 4 > tl) return -1;
      return le ? (long)((uint32_t)t[o] | ((uint32_t)t[o + 1] << 8) | ((uint32_t)t[o + 2] << 16) | ((uint32_t)t[o + 3] << 24))
                : (long)(((uint32_t)t[o] << 24) | ((uint32_t)t[o + 1] << 16) | ((uint32_t)t[o + 2] << 8) | (uint32_t)t[o + 3]);
    };
    if (r16(2) != 42) return;
    long ifd = r32(4);
    if (ifd < 8 || (size_t)ifd + 2 > tl) return;
    int count = r16((size_t)ifd);
    for (int i = 0; i < count; i++) {
      size_t e = (size_t)ifd + 2 + (size_t)i * 12;
      if (e + 12 > tl) return;
      if (r16(e) == 0x0112) {
        int type = r16(e + 2);
        if (type == 3) {
          int v = r16(e + 8);
          if (v >= 1 && v <= 8) orientation = v;
        }
        return;
      }
    }
  }

  void read_sof(int marker) {
    if (have_frame) fail("a second frame header (hierarchical JPEG) is not supported");
    int len = u16();
    precision = u8();
    H = u16();
    W = u16();
    ncomp = u8();
    if (len != 8 + 3 * ncomp) fail("bad SOF length");
    if (precision != 8) fail(std::to_string(precision) + "-bit JPEG is not supported (8-bit only)");
    if (H == 0) fail("a height set by a DNL marker is not supported");
    if (W == 0) fail("JPEG of zero width");
    if (ncomp == 4) fail("4-component (CMYK/YCCK) JPEG is not supported");
    if (ncomp != 1 && ncomp != 3) fail(std::to_string(ncomp) + "-component JPEG is not supported");
    comps.resize(ncomp);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comps[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.v < 1 || c.h > 4 || c.v > 4) fail("bad sampling factor");
      if (c.h > 2 || c.v > 2) fail("sampling factor above 2 is not supported");
      if (c.tq > 3) fail("bad quantization table index");
    }
    progressive = marker == 0xC2;
    have_frame = true;
    hmax = vmax = 1;
    for (auto& c : comps) {
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    for (auto& c : comps) {
      if (hmax % c.h || vmax % c.v) fail("non-integral sampling ratio is not supported");
    }
    mcux = (W + 8 * hmax - 1) / (8 * hmax);
    mcuy = (H + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      c.dw = (int)(((long)W * c.h + hmax - 1) / hmax);
      c.dh = (int)(((long)H * c.v + vmax - 1) / vmax);
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.bw_pad = ncomp == 1 ? c.bw : mcux * c.h;
      c.bh_pad = ncomp == 1 ? c.bh : mcuy * c.v;
      c.coef.assign((size_t)c.bw_pad * c.bh_pad * 64, 0);
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
  }

  void read_dqt() {
    int len = u16() - 2;
    while (len > 0) {
      int pq = u8();
      int tq = pq & 15, p = pq >> 4;
      if (tq > 3 || p > 1) fail("bad DQT");
      for (int k = 0; k < 64; k++) qt[tq][kNatural[k]] = (uint16_t)(p ? u16() : u8());
      qt_present[tq] = true;
      len -= 1 + 64 * (p + 1);
    }
  }

  void read_dht() {
    int len = u16() - 2;
    while (len > 0) {
      int tc = u8();
      int cls = tc >> 4, id = tc & 15;
      if (cls > 1 || id > 3) fail("bad DHT");
      HuffTable& t = cls ? ac[id] : dc[id];
      int total = 0;
      t.bits[0] = 0;
      for (int l = 1; l <= 16; l++) { t.bits[l] = (uint8_t)u8(); total += t.bits[l]; }
      if (total > 256) fail("bad DHT");
      memset(t.vals, 0, sizeof(t.vals));
      for (int i = 0; i < total; i++) t.vals[i] = (uint8_t)u8();
      t.build();
      t.present = true;
      len -= 17 + total;
    }
  }

  // the scan: returns with pos at the marker that ends it
  void read_sos() {
    if (!have_frame) fail("SOS before SOF");
    int len = u16();
    int ns = u8();
    if (len != 6 + 2 * ns || ns < 1 || ns > 4) fail("bad SOS");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; i++) {
      int id = u8(), t = u8();
      Component* c = nullptr;
      for (auto& cc : comps) if (cc.id == id) c = &cc;
      if (!c) fail("SOS names an unknown component");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3) fail("bad Huffman table index");
      sc.push_back(c);
    }
    int Ss = u8(), Se = u8(), A = u8();
    int Ah = A >> 4, Al = A & 15;
    if (!progressive) {
      Ss = 0; Se = 63; Ah = 0; Al = 0;
    } else {
      if (Ss > Se || Se > 63 || (Ss == 0 && Se != 0) || (Ss > 0 && ns != 1) || Al > 13)
        fail("bad progression parameters");
    }
    for (auto* c : sc) {
      if (!c->latched) {
        if (!qt_present[c->tq]) fail("quantization table missing");
        memcpy(c->qt, qt[c->tq], sizeof(c->qt));
        c->latched = true;
      }
      if (progressive) {
        for (int k = Ss; k <= Se; k++) c->coef_bits[k] = Al;
      }
      bool need_dc = !progressive || (Ss == 0 && Ah == 0);
      bool need_ac = !progressive || Ss > 0;
      if (need_dc && !dc[c->td].present) std_table(dc[c->td], c->td, false);
      if (need_ac && !ac[c->ta].present) std_table(ac[c->ta], c->ta, true);
      c->dc_pred = 0;
    }
    eobrun = 0;
    BitReader br{d, n, pos};
    long mcus;
    int mcus_x;
    if (ns == 1) {
      mcus_x = sc[0]->bw;
      mcus = (long)sc[0]->bw * sc[0]->bh;
    } else {
      mcus_x = mcux;
      mcus = (long)mcux * mcuy;
    }
    int restarts_left = restart_interval;
    for (long m = 0; m < mcus; m++) {
      if (restart_interval) {
        if (restarts_left == 0) {
          // jdhuff.c process_restart: drop the bits left, read RSTn, reset
          br.reset();
          size_t q = br.pos;
          while (q < n && d[q] != 0xFF) q++;
          while (q < n && d[q] == 0xFF) q++;
          if (q < n && d[q] >= 0xD0 && d[q] <= 0xD7) br.pos = q + 1;
          else br.pos = q > 0 ? q - 1 : q;
          for (auto* c : sc) c->dc_pred = 0;
          eobrun = 0;
          restarts_left = restart_interval;
        }
        restarts_left--;
      }
      int my = (int)(m / mcus_x), mx = (int)(m % mcus_x);
      if (ns == 1) {
        decode_block(br, *sc[0], sc[0]->block(my, mx), Ss, Se, Ah, Al);
      } else {
        for (auto* c : sc)
          for (int yy = 0; yy < c->v; yy++)
            for (int xx = 0; xx < c->h; xx++)
              decode_block(br, *c, c->block(my * c->v + yy, mx * c->h + xx), Ss, Se, Ah, Al);
      }
    }
    pos = br.pos;  // parse() walks on to the next marker
  }

  void decode_block(BitReader& br, Component& c, int16_t* blk, int Ss, int Se, int Ah, int Al) {
    if (!progressive) {
      int s = decode_huff(br, dc[c.td]);
      int diff = s ? extend(br.get(s), s) : 0;
      c.dc_pred += diff;
      blk[0] = (int16_t)c.dc_pred;
      const HuffTable& t = ac[c.ta];
      for (int k = 1; k < 64; k++) {
        int rs = decode_huff(br, t);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          int v = extend(br.get(s), s);
          blk[kNatural[k]] = (int16_t)v;
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (Ss == 0) {
      if (Ah == 0) {
        int s = decode_huff(br, dc[c.td]);
        int diff = s ? extend(br.get(s), s) : 0;
        c.dc_pred += diff;
        blk[0] = (int16_t)(c.dc_pred * (1 << Al));
      } else {
        if (br.get(1)) blk[0] = (int16_t)(blk[0] | (1 << Al));
      }
      return;
    }
    const HuffTable& t = ac[c.ta];
    if (Ah == 0) {
      if (eobrun > 0) { eobrun--; return; }
      for (int k = Ss; k <= Se; k++) {
        int rs = decode_huff(br, t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          int v = extend(br.get(s), s);
          blk[kNatural[k]] = (int16_t)(v * (1 << Al));
        } else {
          if (r == 15) {
            k += 15;
          } else {
            eobrun = 1 << r;
            if (r) eobrun += br.get(r);
            eobrun--;
            break;
          }
        }
      }
      return;
    }
    // AC refinement (jdphuff.c decode_mcu_AC_refine)
    int p1 = 1 << Al, m1 = -1 * (1 << Al);
    int k = Ss;
    if (eobrun == 0) {
      for (; k <= Se; k++) {
        int rs = decode_huff(br, t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;
        } else {
          if (r != 15) {
            eobrun = 1 << r;
            if (r) eobrun += br.get(r);
            break;
          }
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.get(1)) {
              if ((*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= Se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= Se; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) {
          if (br.get(1)) {
            if ((*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
          }
        }
      }
      eobrun--;
    }
  }

  void parse() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      // find the next marker
      while (pos < n && d[pos] != 0xFF) pos++;
      while (pos < n && d[pos] == 0xFF) pos++;
      if (pos >= n) {
        if (!have_frame) fail("truncated JPEG");
        return;  // libjpeg: a premature end is a warning
      }
      int marker = d[pos++];
      if (marker == 0xD9) return;  // EOI
      if (marker == 0x00 || (marker >= 0xD0 && marker <= 0xD7)) continue;
      switch (marker) {
        case 0xC0: case 0xC1: case 0xC2:
          read_sof(marker);
          break;
        case 0xC3: fail("lossless JPEG (SOF3) is not supported");
        case 0xC5: case 0xC6: case 0xC7: fail("hierarchical JPEG is not supported");
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          fail("arithmetic-coded JPEG is not supported");
        case 0xCC: fail("arithmetic-coded JPEG (DAC) is not supported");
        case 0xC4: read_dht(); break;
        case 0xDB: read_dqt(); break;
        case 0xDD: {
          int len = u16();
          if (len != 4) fail("bad DRI");
          restart_interval = u16();
          break;
        }
        case 0xDA: read_sos(); break;
        case 0xDC: fail("a DNL marker is not supported");
        default: {
          int len = u16();
          if (len < 2 || pos + len - 2 > n) fail("truncated marker segment");
          const uint8_t* p = d + pos;
          size_t pl = (size_t)len - 2;
          if (marker == 0xE0 && pl >= 5 && memcmp(p, "JFIF\0", 5) == 0) jfif = true;
          if (marker == 0xE1 && orientation == 0) parse_exif(p, pl);
          if (marker == 0xEE && pl >= 12 && memcmp(p, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = p[11];
          }
          pos += pl;
        }
      }
    }
  }
};

// jdmaster.c prepare_range_limit_table: the post-IDCT part
struct RangeLimit {
  uint8_t simple[5 * 256 + 128];
  const uint8_t* idct;  // index (x & 1023) for x centred on 0
  const uint8_t* clamp; // index -256..511
  RangeLimit() {
    uint8_t* table = simple + 256;
    memset(table - 256, 0, 256);
    for (int i = 0; i < 256; i++) table[i] = (uint8_t)i;
    uint8_t* post = table + 128;
    for (int i = 128; i < 512; i++) post[i] = 255;
    memset(post + 512, 0, 512 - 128);
    memcpy(post + 1024 - 128, table, 128);
    idct = post;
    clamp = table;
  }
};

const RangeLimit kRange;

const int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// jidctint.c jpeg_idct_islow
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  const uint8_t* rl = kRange.idct;
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int dcval = (ip[0] * qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) wp[r * 8] = dcval;
      continue;
    }
    int32_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int32_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int32_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    wp[0] = descale(tmp10 + tmp3, sh);
    wp[56] = descale(tmp10 - tmp3, sh);
    wp[8] = descale(tmp11 + tmp2, sh);
    wp[48] = descale(tmp11 - tmp2, sh);
    wp[16] = descale(tmp12 + tmp1, sh);
    wp[40] = descale(tmp12 - tmp1, sh);
    wp[24] = descale(tmp13 + tmp0, sh);
    wp[32] = descale(tmp13 - tmp0, sh);
  }
  for (int r = 0; r < 8; r++) {
    const int* wp = ws + r * 8;
    uint8_t* op = out + (size_t)r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
      uint8_t v = rl[descale(wp[0], PASS1_BITS + 3) & 1023];
      for (int i = 0; i < 8; i++) op[i] = v;
      continue;
    }
    int32_t z2 = wp[2], z3 = wp[6];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    int32_t tmp0 = (wp[0] + wp[4]) * (1 << CONST_BITS);
    int32_t tmp1 = (wp[0] - wp[4]) * (1 << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    op[0] = rl[descale(tmp10 + tmp3, sh) & 1023];
    op[7] = rl[descale(tmp10 - tmp3, sh) & 1023];
    op[1] = rl[descale(tmp11 + tmp2, sh) & 1023];
    op[6] = rl[descale(tmp11 - tmp2, sh) & 1023];
    op[2] = rl[descale(tmp12 + tmp1, sh) & 1023];
    op[5] = rl[descale(tmp12 - tmp1, sh) & 1023];
    op[3] = rl[descale(tmp13 + tmp0, sh) & 1023];
    op[4] = rl[descale(tmp13 - tmp0, sh) & 1023];
  }
}

// jdsample.c: one component's plane (dw x dh, row stride ps) to W x H
void upsample(const uint8_t* p, int ps, int dw, int dh, int rh, int rv, int W, int H, uint8_t* out) {
  std::vector<uint8_t> row((size_t)dw * 2 + 2);
  if (rh == 1 && rv == 1) {
    for (int y = 0; y < H; y++) memcpy(out + (size_t)y * W, p + (size_t)y * ps, W);
    return;
  }
  if (rh == 2 && rv == 1) {
    for (int y = 0; y < H; y++) {
      const uint8_t* in = p + (size_t)y * ps;
      uint8_t* o = row.data();
      if (dw > 2) {  // libjpeg's fancy h2v1 needs three columns
        int v = in[0];
        *o++ = (uint8_t)v;
        *o++ = (uint8_t)((v * 3 + in[1] + 2) >> 2);
        for (int c = 1; c < dw - 1; c++) {
          v = in[c] * 3;
          *o++ = (uint8_t)((v + in[c - 1] + 1) >> 2);
          *o++ = (uint8_t)((v + in[c + 1] + 2) >> 2);
        }
        v = in[dw - 1];
        *o++ = (uint8_t)((v * 3 + in[dw - 2] + 1) >> 2);
        *o++ = (uint8_t)v;
      } else {
        for (int c = 0; c < dw; c++) { *o++ = in[c]; *o++ = in[c]; }
      }
      memcpy(out + (size_t)y * W, row.data(), W);
    }
    return;
  }
  if (rh == 1 && rv == 2) {
    for (int y = 0; y < H; y++) {
      int r = y >> 1;
      const uint8_t* in0 = p + (size_t)r * ps;
      uint8_t* o = out + (size_t)y * W;
      int r1 = (y & 1) ? (r + 1 < dh ? r + 1 : dh - 1) : (r > 0 ? r - 1 : 0);
      int bias = (y & 1) ? 2 : 1;
      const uint8_t* in1 = p + (size_t)r1 * ps;
      for (int c = 0; c < W; c++) o[c] = (uint8_t)((in0[c] * 3 + in1[c] + bias) >> 2);
    }
    return;
  }
  // 2 x 2
  std::vector<int> colsum((size_t)dw);
  for (int y = 0; y < H; y++) {
    int r = y >> 1;
    const uint8_t* in0 = p + (size_t)r * ps;
    uint8_t* o = row.data();
    if (dw <= 2) {  // libjpeg's h2v2 without fancy upsampling
      for (int c = 0; c < dw; c++) { *o++ = in0[c]; *o++ = in0[c]; }
      memcpy(out + (size_t)y * W, row.data(), W);
      continue;
    }
    int r1 = (y & 1) ? (r + 1 < dh ? r + 1 : dh - 1) : (r > 0 ? r - 1 : 0);
    const uint8_t* in1 = p + (size_t)r1 * ps;
    for (int c = 0; c < dw; c++) colsum[c] = in0[c] * 3 + in1[c];
    int this_ = colsum[0], next = colsum[1], last;
    *o++ = (uint8_t)((this_ * 4 + 8) >> 4);
    *o++ = (uint8_t)((this_ * 3 + next + 7) >> 4);
    last = this_;
    this_ = next;
    for (int c = 2; c < dw; c++) {
      next = colsum[c];
      *o++ = (uint8_t)((this_ * 3 + last + 8) >> 4);
      *o++ = (uint8_t)((this_ * 3 + next + 7) >> 4);
      last = this_;
      this_ = next;
    }
    *o++ = (uint8_t)((this_ * 3 + last + 8) >> 4);
    *o++ = (uint8_t)((this_ * 4 + 7) >> 4);
    memcpy(out + (size_t)y * W, row.data(), W);
  }
}

// jdcolor.c tables
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int SCALEBITS = 16;
    const int32_t ONE_HALF = 1 << (SCALEBITS - 1);
    auto FIX = [](double x) { return (int32_t)(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = (-FIX(0.71414)) * x;
      cb_g[i] = (-FIX(0.34414)) * x + ONE_HALF;
    }
  }
};

const YccTables kYcc;

void decode_image(const uint8_t* data, size_t len, bool blue_first, std::vector<uint8_t>& out, int& H, int& W,
                  int& orientation) {
  Decoder dec(data, len);
  dec.parse();
  if (!dec.have_frame) fail("no frame header (SOF) in JPEG");
  H = dec.H;
  W = dec.W;
  orientation = dec.orientation;
  int nc = dec.ncomp;
  if (dec.progressive) {
    // libjpeg smooths blocks whose first AC coefficients were never
    // refined to full precision (jdcoefct.c smoothing_ok)
    for (auto& c : dec.comps) {
      if (c.coef_bits[0] < 0) continue;
      for (int k = 1; k < 10; k++)
        if (c.coef_bits[k] != 0) fail("progressive JPEG with unrefined coefficients (block smoothing) is not supported");
    }
  }
  std::vector<std::vector<uint8_t>> full(nc);
  for (int ci = 0; ci < nc; ci++) {
    Component& c = dec.comps[ci];
    if (!c.latched) {
      if (!dec.qt_present[c.tq]) fail("quantization table missing");
      memcpy(c.qt, dec.qt[c.tq], sizeof(c.qt));
    }
    // only the blocks that hold the downsampled plane: the upsampler reads no further
    int ps = c.bw * 8;
    std::vector<uint8_t> plane((size_t)ps * c.bh * 8);
    for (int by = 0; by < c.bh; by++)
      for (int bx = 0; bx < c.bw; bx++)
        idct_islow(c.block(by, bx), c.qt, plane.data() + (size_t)by * 8 * ps + bx * 8, ps);
    full[ci].resize((size_t)W * H);
    int rh = dec.hmax / c.h, rv = dec.vmax / c.v;
    upsample(plane.data(), ps, c.dw, c.dh, rh, rv, W, H, full[ci].data());
  }
  out.resize((size_t)W * H * 3);
  int ir = blue_first ? 2 : 0, ib = blue_first ? 0 : 2;
  if (nc == 1) {
    const uint8_t* g = full[0].data();
    for (size_t i = 0; i < (size_t)W * H; i++) out[i * 3] = out[i * 3 + 1] = out[i * 3 + 2] = g[i];
    return;
  }
  bool rgb = false;
  if (dec.jfif) rgb = false;
  else if (dec.adobe) rgb = dec.adobe_transform == 0;
  else rgb = dec.comps[0].id == 82 && dec.comps[1].id == 71 && dec.comps[2].id == 66;
  const uint8_t* y = full[0].data();
  const uint8_t* cb = full[1].data();
  const uint8_t* cr = full[2].data();
  const uint8_t* lim = kRange.clamp;
  for (size_t i = 0; i < (size_t)W * H; i++) {
    uint8_t* o = &out[i * 3];
    if (rgb) {
      o[ir] = y[i];
      o[1] = cb[i];
      o[ib] = cr[i];
      continue;
    }
    int Y = y[i], Cb = cb[i], Cr = cr[i];
    o[ir] = lim[Y + kYcc.cr_r[Cr]];
    o[1] = lim[Y + (int)((kYcc.cb_g[Cb] + kYcc.cr_g[Cr]) >> 16)];
    o[ib] = lim[Y + kYcc.cb_b[Cb]];
  }
}

// ---------------------------------------------------------------- encoder

const uint8_t kStdLumaQ[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                               14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                               18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                               49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                                 24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                                 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                                 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcChromaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
    0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
    0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36,
    0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  uint16_t code[256];
  uint8_t size[256];
  EncTable(const uint8_t* bits, const uint8_t* vals) {
    memset(size, 0, sizeof(size));
    int p = 0, c = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < bits[l]; i++, p++) {
        code[vals[p]] = (uint16_t)c++;
        size[vals[p]] = (uint8_t)l;
      }
      c <<= 1;
    }
  }
};

struct Writer {
  std::vector<uint8_t> out;
  uint32_t acc = 0;
  int nbits = 0;
  void byte(int b) { out.push_back((uint8_t)b); }
  void word(int w) { byte(w >> 8); byte(w & 255); }
  void bits(uint32_t v, int k) {
    acc = (acc << k) | (v & ((1u << k) - 1));
    nbits += k;
    while (nbits >= 8) {
      int b = (int)((acc >> (nbits - 8)) & 0xFF);
      byte(b);
      if (b == 0xFF) byte(0);
      nbits -= 8;
    }
  }
};

// jfdctint.c jpeg_fdct_islow on centred samples
void fdct_islow(int32_t* data) {
  int32_t* p = data;
  for (int r = 0; r < 8; r++, p += 8) {
    int32_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7], tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int32_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5], tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int16_t)((tmp10 + tmp11) * (1 << PASS1_BITS));
    p[4] = (int16_t)((tmp10 - tmp11) * (1 << PASS1_BITS));
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[2] = (int16_t)descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS - PASS1_BITS);
    p[6] = (int16_t)descale(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS - PASS1_BITS);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = (int16_t)descale(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS);
    p[5] = (int16_t)descale(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS);
    p[3] = (int16_t)descale(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS);
    p[1] = (int16_t)descale(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS);
  }
  p = data;
  for (int c = 0; c < 8; c++, p++) {
    int32_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56], tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int32_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40], tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int16_t)descale(tmp10 + tmp11, PASS1_BITS);
    p[32] = (int16_t)descale(tmp10 - tmp11, PASS1_BITS);
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[16] = (int16_t)descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS + PASS1_BITS);
    p[48] = (int16_t)descale(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS + PASS1_BITS);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = (int16_t)descale(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS);
    p[40] = (int16_t)descale(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS);
    p[24] = (int16_t)descale(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS);
    p[8] = (int16_t)descale(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS);
  }
}

// jcdctmgr.c compute_reciprocal (16-bit DCTELEM) and quantize
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  Divisor dv;
  if (divisor == 1) return {1, 0, -16};
  int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (1u << r) / divisor, fr = (1u << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr > divisor / 2) {
    c++;
  } else {
    fq++;
  }
  dv.recip = fq & 0xFFFF;
  dv.corr = c & 0xFFFF;
  dv.shift = r - 16;
  return dv;
}

inline int quantize(int32_t t, const Divisor& dv) {
  uint32_t a = (uint32_t)(t < 0 ? -t : t) & 0xFFFF;
  uint32_t prod = (a + dv.corr) * dv.recip;
  prod >>= dv.shift + 16;
  int v = (int)(int16_t)(uint16_t)prod;
  return t < 0 ? -v : v;
}

void std_table(HuffTable& t, int id, bool ac) {
  if (id > 1) fail("Huffman table missing");
  const uint8_t* bits = ac ? (id ? kAcChromaBits : kAcLumaBits) : (id ? kDcChromaBits : kDcLumaBits);
  const uint8_t* vals = ac ? (id ? kAcChromaVals : kAcLumaVals) : (id ? kDcChromaVals : kDcLumaVals);
  int total = 0;
  for (int l = 1; l <= 16; l++) total += bits[l];
  memcpy(t.bits, bits, 17);
  memset(t.vals, 0, sizeof(t.vals));
  memcpy(t.vals, vals, total);
  t.build();
  t.present = true;
}

void emit_dht(Writer& w, int cls, int id, const uint8_t* bits, const uint8_t* vals) {
  int total = 0;
  for (int l = 1; l <= 16; l++) total += bits[l];
  w.word(0xFFC4);
  w.word(2 + 1 + 16 + total);
  w.byte((cls << 4) | id);
  for (int l = 1; l <= 16; l++) w.byte(bits[l]);
  for (int i = 0; i < total; i++) w.byte(vals[i]);
}

void encode_image(const uint8_t* img, int H, int W, int C, int quality, bool blue_first, std::vector<uint8_t>& out) {
  if (H < 1 || W < 1 || H > 65500 || W > 65500) fail("image size out of JPEG's range");
  if (C != 1 && C != 3) fail("encode needs 1 or 3 channels");
  if (quality < 1) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t q[2][64];
  for (int i = 0; i < 64; i++) {
    long a = ((long)kStdLumaQ[i] * scale + 50) / 100, b = ((long)kStdChromaQ[i] * scale + 50) / 100;
    a = a < 1 ? 1 : (a > 255 ? 255 : a);
    b = b < 1 ? 1 : (b > 255 ? 255 : b);
    q[0][i] = (uint16_t)a;
    q[1][i] = (uint16_t)b;
  }
  int nc = C;
  Writer w;
  w.word(0xFFD8);
  static const uint8_t jfif[18] = {0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00, 0x01,
                                   0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  for (uint8_t b : jfif) w.byte(b);
  for (int t = 0; t < (nc == 3 ? 2 : 1); t++) {
    w.word(0xFFDB);
    w.word(67);
    w.byte(t);
    for (int k = 0; k < 64; k++) w.byte(q[t][kNatural[k]]);
  }
  w.word(0xFFC0);
  w.word(8 + 3 * nc);
  w.byte(8);
  w.word(H);
  w.word(W);
  w.byte(nc);
  for (int c = 0; c < nc; c++) {
    w.byte(c + 1);
    w.byte(nc == 3 && c == 0 ? 0x22 : 0x11);
    w.byte(c == 0 ? 0 : 1);
  }
  emit_dht(w, 0, 0, kDcLumaBits, kDcLumaVals);
  emit_dht(w, 1, 0, kAcLumaBits, kAcLumaVals);
  if (nc == 3) {
    emit_dht(w, 0, 1, kDcChromaBits, kDcChromaVals);
    emit_dht(w, 1, 1, kAcChromaBits, kAcChromaVals);
  }
  w.word(0xFFDA);
  w.word(6 + 2 * nc);
  w.byte(nc);
  for (int c = 0; c < nc; c++) {
    w.byte(c + 1);
    w.byte(c == 0 ? 0x00 : 0x11);
  }
  w.byte(0);
  w.byte(63);
  w.byte(0);

  // planes: colour conversion (jccolor.c), padded as jcprepct.c/jcsample.c pad
  int hs = nc == 3 ? 2 : 1;
  int mcu = 8 * hs;
  int mcux = (W + mcu - 1) / mcu, mcuy = (H + mcu - 1) / mcu;
  std::vector<std::vector<uint8_t>> planes(nc);
  std::vector<int> pw(nc), ph(nc), bw(nc), bh(nc);
  if (nc == 1) {
    bw[0] = (W + 7) / 8;
    bh[0] = (H + 7) / 8;
    pw[0] = bw[0] * 8;
    ph[0] = bh[0] * 8;
    planes[0].resize((size_t)pw[0] * ph[0]);
    for (int y = 0; y < ph[0]; y++) {
      int sy = y < H ? y : H - 1;
      for (int x = 0; x < pw[0]; x++) planes[0][(size_t)y * pw[0] + x] = img[(size_t)sy * W + (x < W ? x : W - 1)];
    }
  } else {
    const int32_t ONE_HALF = 1 << 15, CBCR_OFFSET = 128 << 16;
    auto FIX = [](double x) { return (int32_t)(x * 65536.0 + 0.5); };
    static int32_t tab[8 * 256];
    static bool tab_ready = false;
    if (!tab_ready) {
      for (int i = 0; i < 256; i++) {
        tab[i + 0 * 256] = FIX(0.29900) * i;
        tab[i + 1 * 256] = FIX(0.58700) * i;
        tab[i + 2 * 256] = FIX(0.11400) * i + ONE_HALF;
        tab[i + 3 * 256] = (-FIX(0.16874)) * i;
        tab[i + 4 * 256] = (-FIX(0.33126)) * i;
        tab[i + 5 * 256] = FIX(0.50000) * i + CBCR_OFFSET + ONE_HALF - 1;
        tab[i + 6 * 256] = (-FIX(0.41869)) * i;
        tab[i + 7 * 256] = (-FIX(0.08131)) * i;
      }
      tab_ready = true;
    }
    // full-resolution Y, Cb, Cr with rows padded to even, columns to the chroma blocks
    int cbw = (int)(((long)W + 1) / 2 + 7) / 8;  // chroma width_in_blocks
    int cbh = (int)(((long)H + 1) / 2 + 7) / 8;
    int fw = cbw * 16;
    int fh_rows = ((H + 1) / 2) * 2;
    std::vector<uint8_t> Y((size_t)W * H), Cb((size_t)fw * fh_rows), Cr((size_t)fw * fh_rows);
    int ir = blue_first ? 2 : 0, ib = blue_first ? 0 : 2;
    for (int y = 0; y < H; y++) {
      for (int x = 0; x < W; x++) {
        const uint8_t* p = img + ((size_t)y * W + x) * 3;
        int r = p[ir], g = p[1], b = p[ib];
        Y[(size_t)y * W + x] = (uint8_t)((tab[r] + tab[g + 256] + tab[b + 512]) >> 16);
        Cb[(size_t)y * fw + x] = (uint8_t)((tab[r + 768] + tab[g + 1024] + tab[b + 1280]) >> 16);
        Cr[(size_t)y * fw + x] = (uint8_t)((tab[r + 1280] + tab[g + 1536] + tab[b + 1792]) >> 16);
      }
      for (int x = W; x < fw; x++) {
        Cb[(size_t)y * fw + x] = Cb[(size_t)y * fw + W - 1];
        Cr[(size_t)y * fw + x] = Cr[(size_t)y * fw + W - 1];
      }
    }
    for (int y = H; y < fh_rows; y++) {
      memcpy(&Cb[(size_t)y * fw], &Cb[(size_t)(H - 1) * fw], fw);
      memcpy(&Cr[(size_t)y * fw], &Cr[(size_t)(H - 1) * fw], fw);
    }
    // luma: right edge to its blocks, bottom to the iMCU row (16)
    bw[0] = (W + 7) / 8;
    bh[0] = (H + 7) / 8;
    pw[0] = bw[0] * 8;
    ph[0] = mcuy * 16;
    planes[0].resize((size_t)pw[0] * ph[0]);
    for (int y = 0; y < ph[0]; y++) {
      int sy = y < H ? y : H - 1;
      const uint8_t* src = &Y[(size_t)sy * W];
      uint8_t* dst = &planes[0][(size_t)y * pw[0]];
      memcpy(dst, src, W);
      for (int x = W; x < pw[0]; x++) dst[x] = src[W - 1];
    }
    // chroma: h2v2 box with alternating bias, bottom to the iMCU row (8)
    for (int c = 1; c < 3; c++) {
      const std::vector<uint8_t>& F = c == 1 ? Cb : Cr;
      bw[c] = cbw;
      bh[c] = cbh;
      pw[c] = cbw * 8;
      ph[c] = mcuy * 8;
      planes[c].resize((size_t)pw[c] * ph[c]);
      int rows = fh_rows / 2;
      for (int y = 0; y < rows; y++) {
        const uint8_t* r0 = &F[(size_t)(2 * y) * fw];
        const uint8_t* r1 = &F[(size_t)(2 * y + 1) * fw];
        uint8_t* dst = &planes[c][(size_t)y * pw[c]];
        int bias = 1;
        for (int x = 0; x < pw[c]; x++) {
          dst[x] = (uint8_t)((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
          bias ^= 3;
        }
      }
      for (int y = rows; y < ph[c]; y++) memcpy(&planes[c][(size_t)y * pw[c]], &planes[c][(size_t)(rows - 1) * pw[c]], pw[c]);
    }
  }

  Divisor div[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) div[t][i] = reciprocal((uint32_t)q[t][i] << 3);
  EncTable dcl(kDcLumaBits, kDcLumaVals), acl(kAcLumaBits, kAcLumaVals);
  EncTable dcc(kDcChromaBits, kDcChromaVals), acc(kAcChromaBits, kAcChromaVals);

  int pred[3] = {0, 0, 0};
  auto code_block = [&](int ci, const int16_t* blk) {
    const EncTable& td = ci == 0 ? dcl : dcc;
    const EncTable& ta = ci == 0 ? acl : acc;
    int diff = blk[0] - pred[ci];
    pred[ci] = blk[0];
    int t = diff < 0 ? -diff : diff, nb = 0;
    while (t) { nb++; t >>= 1; }
    w.bits(td.code[nb], td.size[nb]);
    if (nb) w.bits((uint32_t)(diff < 0 ? diff - 1 : diff), nb);
    int r = 0;
    for (int k = 1; k < 64; k++) {
      int v = blk[kNatural[k]];
      if (v == 0) { r++; continue; }
      while (r > 15) { w.bits(ta.code[0xF0], ta.size[0xF0]); r -= 16; }
      int a = v < 0 ? -v : v;
      nb = 0;
      while (a) { nb++; a >>= 1; }
      int sym = (r << 4) + nb;
      w.bits(ta.code[sym], ta.size[sym]);
      w.bits((uint32_t)(v < 0 ? v - 1 : v), nb);
      r = 0;
    }
    if (r > 0) w.bits(ta.code[0], ta.size[0]);
  };
  auto fdct_block = [&](int ci, int by, int bx, int16_t* blk) {
    int32_t ws[64];
    const uint8_t* p = planes[ci].data() + (size_t)by * 8 * pw[ci] + bx * 8;
    for (int r = 0; r < 8; r++)
      for (int c = 0; c < 8; c++) ws[r * 8 + c] = (int32_t)p[(size_t)r * pw[ci] + c] - 128;
    fdct_islow(ws);
    const Divisor* dv = div[ci == 0 ? 0 : 1];
    for (int i = 0; i < 64; i++) blk[i] = (int16_t)quantize((int16_t)ws[i], dv[i]);
  };
  int16_t blocks[6][64];
  if (nc == 1) {
    for (int by = 0; by < bh[0]; by++)
      for (int bx = 0; bx < bw[0]; bx++) {
        fdct_block(0, by, bx, blocks[0]);
        code_block(0, blocks[0]);
      }
  } else {
    for (int my = 0; my < mcuy; my++) {
      for (int mx = 0; mx < mcux; mx++) {
        // luma 2x2 with jccoefct.c's dummy blocks past the right and bottom edges
        for (int yy = 0; yy < 2; yy++) {
          int by = my * 2 + yy;
          for (int xx = 0; xx < 2; xx++) {
            int bx = mx * 2 + xx;
            int16_t* blk = blocks[yy * 2 + xx];
            if (by < bh[0] || my < mcuy - 1) {
              if (bx < bw[0]) {
                fdct_block(0, by, bx, blk);
              } else {
                memset(blk, 0, 128);
                blk[0] = blocks[yy * 2 + xx - 1][0];
              }
            } else {
              memset(blk, 0, 128);
              blk[0] = blocks[yy * 2 - 1][0];
            }
          }
        }
        for (int b = 0; b < 4; b++) code_block(0, blocks[b]);
        fdct_block(1, my, mx, blocks[4]);
        fdct_block(2, my, mx, blocks[5]);
        code_block(1, blocks[4]);
        code_block(2, blocks[5]);
      }
    }
  }
  // jchuff.c flush_bits: pad the last byte with ones
  if (w.nbits > 0) w.bits(0x7F, 8 - w.nbits);
  w.word(0xFFD9);
  out.swap(w.out);
}

void set_err(char* err, int errlen, const std::string& m) {
  if (err && errlen > 0) {
    snprintf(err, (size_t)errlen, "%s", m.c_str());
  }
}

}  // namespace

extern "C" {

// Decode a JPEG held in memory to interleaved 8-bit samples, RGB or BGR
// (blue_first). *out is malloc'd; free it with jpg_free.
int jpg_decode(const uint8_t* data, size_t len, int blue_first, uint8_t** out, int* h, int* w, int* orientation,
               char* err, int errlen) {
  try {
    std::vector<uint8_t> img;
    int H = 0, W = 0, o = 0;
    decode_image(data, len, blue_first != 0, img, H, W, o);
    uint8_t* buf = (uint8_t*)malloc(img.size() ? img.size() : 1);
    if (!buf) fail("out of memory");
    memcpy(buf, img.data(), img.size());
    *out = buf;
    *h = H;
    *w = W;
    *orientation = o;
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return 1;
  }
}

// Encode h x w x c (c = 1 or 3) samples; a 3-channel image is RGB, or BGR
// when blue_first. *out is malloc'd; free it with jpg_free.
int jpg_encode(const uint8_t* img, int h, int w, int c, int quality, int blue_first, uint8_t** out, size_t* len,
               char* err, int errlen) {
  try {
    std::vector<uint8_t> buf;
    encode_image(img, h, w, c, quality, blue_first != 0, buf);
    uint8_t* p = (uint8_t*)malloc(buf.size());
    if (!p) fail("out of memory");
    memcpy(p, buf.data(), buf.size());
    *out = p;
    *len = buf.size();
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return 1;
  }
}

void jpg_free(void* p) { free(p); }

// ---------------------------------------------------------------- cv2's colour maps
//
// OpenCV 5.0's cvtColor on 8-bit RGB, pixel for pixel (utils/cv_host.py
// holds the rules and builds the tables; each map is checked there over all
// 2**24 inputs). n pixels of 3 bytes; the maps whose vector body and scalar
// tail round differently take rows of `width` pixels.

void cvh_rgb2gray(const uint8_t* s, uint8_t* d, size_t n) {
  for (size_t i = 0; i < n; i++, s += 3)
    d[i] = (uint8_t)((s[0] * 9798 + s[1] * 19235 + s[2] * 3735 + (1 << 14)) >> 15);
}

void cvh_rgb2hsv(const uint8_t* s, uint8_t* d, size_t n, const int32_t* sdiv, const int32_t* hdiv) {
  for (size_t i = 0; i < n; i++, s += 3, d += 3) {
    int r = s[0], g = s[1], b = s[2];
    int v = r > g ? r : g;
    v = v > b ? v : b;
    int mn = r < g ? r : g;
    mn = mn < b ? mn : b;
    int diff = v - mn;
    int sat = (diff * sdiv[v] + (1 << 11)) >> 12;
    int h = v == r ? g - b : (v == g ? b - r + 2 * diff : r - g + 4 * diff);
    h = (h * hdiv[diff] + (1 << 11)) >> 12;
    if (h < 0) h += 180;
    d[0] = (uint8_t)h;
    d[1] = (uint8_t)sat;
    d[2] = (uint8_t)v;
  }
}

static const int kSectors[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1}, {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};

static inline uint8_t clip_u8(float x) { return (uint8_t)(x < 0.f ? 0.f : (x > 255.f ? 255.f : x)); }

void cvh_hsv2rgb(const uint8_t* s, uint8_t* d, size_t rows, size_t width) {
  size_t body = width / 32 * 32;  // cv2's vector body truncates, its scalar tail rounds
  for (size_t y = 0; y < rows; y++) {
    for (size_t x = 0; x < width; x++, s += 3, d += 3) {
      float h = (float)s[0] * (float)(6.0 / 180), sat = (float)s[1] * (float)(1 / 255.0);
      float v = (float)s[2] * (float)(1 / 255.0);
      if (h >= 6.f) h -= 6.f;
      float sector = floorf(h), f = h - sector;
      float tab[4] = {v, v * (1.f - sat), v * fmaf(-sat, f, 1.f), v * fmaf(-sat, 1.f - f, 1.f)};
      int k = (int)sector;
      k = k < 0 ? 0 : (k > 5 ? 5 : k);
      float rgb[3] = {tab[kSectors[k][2]] * 255.f, tab[kSectors[k][1]] * 255.f, tab[kSectors[k][0]] * 255.f};
      for (int c = 0; c < 3; c++) d[c] = clip_u8(x < body ? truncf(rgb[c]) : nearbyintf(rgb[c]));
    }
  }
}

void cvh_rgb2hls(const uint8_t* s, uint8_t* d, size_t rows, size_t width) {
  size_t body = width / 8 * 8;  // the vector body folds +360 into the fused add
  for (size_t y = 0; y < rows; y++) {
    for (size_t x = 0; x < width; x++, s += 3, d += 3) {
      float r = (float)s[0] * (float)(1 / 255.0), g = (float)s[1] * (float)(1 / 255.0);
      float b = (float)s[2] * (float)(1 / 255.0);
      float vmax = fmaxf(fmaxf(r, g), b), vmin = fminf(fminf(r, g), b);
      float diff = vmax - vmin, msum = vmax + vmin, lum = msum * 0.5f;
      float h = 0.f, sat = 0.f;
      if (diff > 1.1920928955078125e-07f) {
        bool dark = lum < 0.5f;
        if (x < body)
          sat = diff / (dark ? msum : 2.f - msum);
        else
          sat = dark ? diff / msum : diff / ((2.f - vmax) - vmin);
        float hp = vmax == r ? g - b : (vmax == g ? b - r : r - g);
        float add = vmax == r ? 0.f : (vmax == g ? 120.f : 240.f);
        float inv = 60.f / diff;
        h = fmaf(hp, inv, add);
        if (h < 0.f) h = x < body ? fmaf(hp, inv, add + 360.f) : h + 360.f;
      }
      h *= 0.5f;
      d[0] = clip_u8(nearbyintf(h));
      d[1] = clip_u8(nearbyintf(lum * 255.f));
      d[2] = clip_u8(nearbyintf(sat * 255.f));
    }
  }
}

void cvh_hls2rgb(const uint8_t* s, uint8_t* d, size_t n) {
  for (size_t i = 0; i < n; i++, s += 3, d += 3) {
    float h = (float)s[0] * (float)(6.0 / 180), lum = (float)s[1] * (float)(1 / 255.0);
    float sat = (float)s[2] * (float)(1 / 255.0);
    float rgb[3];
    if (sat == 0.f) {
      rgb[0] = rgb[1] = rgb[2] = lum;
    } else {
      float p2 = lum <= 0.5f ? lum * (1.f + sat) : (lum + sat) - lum * sat;
      float p1 = 2.f * lum - p2;
      if (h >= 6.f) h -= 6.f;
      float sector = floorf(h), f = h - sector, dp = p2 - p1;
      float tab[4] = {p2, p1, p1 + dp * (1.f - f), p1 + dp * f};
      int k = (int)sector;
      k = k < 0 ? 0 : (k > 5 ? 5 : k);
      rgb[0] = tab[kSectors[k][2]];
      rgb[1] = tab[kSectors[k][1]];
      rgb[2] = tab[kSectors[k][0]];
    }
    for (int c = 0; c < 3; c++) d[c] = clip_u8(nearbyintf(rgb[c] * 255.f));
  }
}

void cvh_rgb2lab(const uint8_t* s, uint8_t* d, size_t n, const int32_t* gamma, const int32_t* cbrt,
                 const int32_t* to_xyz) {
  for (size_t i = 0; i < n; i++, s += 3, d += 3) {
    int32_t lin[3] = {gamma[s[0]], gamma[s[1]], gamma[s[2]]}, f[3];
    for (int k = 0; k < 3; k++)
      f[k] = cbrt[(lin[0] * to_xyz[3 * k] + lin[1] * to_xyz[3 * k + 1] + lin[2] * to_xyz[3 * k + 2] + (1 << 11)) >> 12];
    int32_t lab[3] = {(296 * f[1] - 1336934 + (1 << 14)) >> 15,
                      (500 * (f[0] - f[1]) + (128 << 15) + (1 << 14)) >> 15,
                      (200 * (f[1] - f[2]) + (128 << 15) + (1 << 14)) >> 15};
    for (int k = 0; k < 3; k++) d[k] = (uint8_t)(lab[k] < 0 ? 0 : (lab[k] > 255 ? 255 : lab[k]));
  }
}

void cvh_lab2rgb(const uint8_t* s, uint8_t* d, size_t n, const int32_t* y_tab, const int32_t* fy_tab,
                 const int32_t* xz, const int32_t* to_rgb, const int32_t* inv_gamma) {
  const int base = 1 << 14;
  for (size_t i = 0; i < n; i++, s += 3, d += 3) {
    int adiv = ((5 * s[1] * 53687 + (1 << 7)) >> 13) - 128 * base / 500;
    int bdiv = ((s[2] * 41943 + (1 << 4)) >> 9) - 128 * base / 200 + 1;
    int32_t y = y_tab[s[0]], fy = fy_tab[s[0]];
    int64_t x = xz[fy + adiv + 8145], z = xz[fy - bdiv + 8145];
    for (int k = 0; k < 3; k++) {
      int64_t v = (to_rgb[3 * k] * x + to_rgb[3 * k + 1] * (int64_t)y + to_rgb[3 * k + 2] * z + (1 << 13)) >> 14;
      d[k] = (uint8_t)inv_gamma[v < 0 ? 0 : (v > 4095 ? 4095 : v)];
    }
  }
}

}  // extern "C"
