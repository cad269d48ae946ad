// The sequential inner loops of the host's PNG, BMP, TIFF and GIF readers,
// with a plain C interface for ctypes (feartracker_tpu_torch/data/imread.py
// builds and binds it; the rest of each reader is numpy).
//
// png_unfilter: PNG's five row filters (None, Sub, Up, Average, Paeth) undone
// in place, one pass of an image at a time: Sub, Average and Paeth depend on
// the pixel just decoded, so a row is a sequential scan.
//
// bmp_rle: OpenCV 5.0's BMP RLE4 / RLE8 decoder (grfmt_bmp.cpp) to palette
// indices, its quirks included: a skipped pixel (end of line, delta, end of
// bitmap) takes index 0; an RLE8 end of line right after a run that ended on
// the line's last pixel is not a blank line; in RLE4 a delta moves dx pixels
// along and no line down, and an end of bitmap ends only its line; a run or
// a literal that passes the line's end, or a stream that ends before the
// last line, is an error.
//
// tiff_lzw, tiff_packbits: libtiff's LZWDecode (new-style codes, MSB first,
// the width growing one code early) and PackBitsDecode, each filling one
// strip or tile of a known size; a stream that ends before it is full is an
// error.
//
// gif_lzw: GIF's LZW (LSB first, minimum code size 2-8) to palette indices.
//
// hdr_rle: Radiance scanlines as the RGBE reader OpenCV 5.0 carries (Greg
// Ward's rgbe.c) reads them, to RGBE bytes: a scanline that starts 2, 2
// holds its four channels one after another, each as runs (a count above
// 128, then the byte) and literals (a count up to 128, then the bytes); any
// other start means that pixel and every one after it are stored flat, and
// widths below 8 or above 32767 are flat throughout.
//
// tiff_fax: libtiff 4.7's CCITT decoders (tif_fax3.c) filling one strip or
// tile of 1-bit rows (MSB first, a black run as 1 bits): Modified Huffman
// rows (compression 2 byte-aligned, 32771 word-aligned), T.4 (compression 3:
// an EOL before each row; 1-D rows, or 1-D and 2-D rows told apart by the bit
// after the EOL) and T.6 (compression 4). The codes are T.4's, looked up LSB
// first in tables laid out as libtiff's mkg3states lays them out (12 bits
// white, 13 black, 7 for the 2-D modes; eleven zeros an EOL). A bad code, a
// short row or one past the width is what libtiff makes of it: the row cut,
// or filled out white, and the next row decoded from where the bits stand.
// Where the data ends early (or the run array would overflow) the rows not
// reached stay as they were, zero, as libtiff's RGBA reader leaves them when
// OpenCV reads with stop-on-error off: tiff_fax returns 1 and names it (2 for
// T.4 data, whose missing rows libtiff re-reads in its no-EOL mode).
//
// tiff_cielab: TIFFCIELabToRGBInit (display_sRGB, the file's white point) and
// TIFFCIELab16ToXYZ / TIFFXYZToRGB, in libtiff 4.7's float order, for 8-bit
// (L, then a and b as signed bytes) or 16-bit (L, then signed a and b)
// samples.
//
// Every function returns 0 on success, else writes a message to err.

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <cstring>
#include <utility>
#include <vector>

namespace {

void set_err(char* err, int errlen, const char* m) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", m);
}

// FillUniColor of OpenCV's imgcodecs/utils.cpp on an index plane: count
// pixels of index 0 from (x, y) on, wrapping to the next line at the end of
// one; stops at the last line.
void fill_zero(uint8_t* idx, int W, int H, bool bottom_up, int& x, int& y, long count) {
  do {
    long end = x + count < W ? x + count : W;
    count -= end - x;
    if (y < H) {
      uint8_t* row = idx + (size_t)(bottom_up ? H - 1 - y : y) * W;
      memset(row + x, 0, (size_t)(end - x));
    }
    x = (int)end;
    if (x >= W) {
      x = 0;
      if (++y >= H) break;
    }
  } while (count > 0);
}


// ---------------------------------------------------------------- CCITT fax

namespace fax {

enum State : uint8_t { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW, S_MakeUpB,
                       S_MakeUp, S_EOL };

struct Ent {
  uint8_t state, width;
  int32_t param;
};

// T.4's run-length codes, first bit first: terminating codes of runs 0-63,
// make-up codes of 64-1728 a colour, and the make-up codes of 1792-2560 both
// colours share
const char* const kWhiteTerm[64] = {
    "00110101", "000111",   "0111",     "1000",     "1011",     "1100",     "1110",     "1111",
    "10011",    "10100",    "00111",    "01000",    "001000",   "000011",   "110100",   "110101",
    "101010",   "101011",   "0100111",  "0001100",  "0001000",  "0010111",  "0000011",  "0000100",
    "0101000",  "0101011",  "0010011",  "0100100",  "0011000",  "00000010", "00000011", "00011010",
    "00011011", "00010010", "00010011", "00010100", "00010101", "00010110", "00010111", "00101000",
    "00101001", "00101010", "00101011", "00101100", "00101101", "00000100", "00000101", "00001010",
    "00001011", "01010010", "01010011", "01010100", "01010101", "00100100", "00100101", "01011000",
    "01011001", "01011010", "01011011", "01001010", "01001011", "00110010", "00110011", "00110100"};
const char* const kWhiteMakeUp[27] = {
    "11011",     "10010",     "010111",    "0110111",   "00110110",  "00110111",  "01100100",
    "01100101",  "01101000",  "01100111",  "011001100", "011001101", "011010010", "011010011",
    "011010100", "011010101", "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000",    "010011011"};
const char* const kBlackTerm[64] = {
    "0000110111",   "010",          "11",           "10",           "011",          "0011",
    "0010",         "00011",        "000101",       "000100",       "0000100",      "0000101",
    "0000111",      "00000100",     "00000111",     "000011000",    "0000010111",   "0000011000",
    "0000001000",   "00001100111",  "00001101000",  "00001101100",  "00000110111",  "00000101000",
    "00000010111",  "00000011000",  "000011001010", "000011001011", "000011001100", "000011001101",
    "000001101000", "000001101001", "000001101010", "000001101011", "000011010010", "000011010011",
    "000011010100", "000011010101", "000011010110", "000011010111", "000001101100", "000001101101",
    "000011011010", "000011011011", "000001010100", "000001010101", "000001010110", "000001010111",
    "000001100100", "000001100101", "000001010010", "000001010011", "000000100100", "000000110111",
    "000000111000", "000000100111", "000000101000", "000001011000", "000001011001", "000000101011",
    "000000101100", "000001011010", "000001100110", "000001100111"};
const char* const kBlackMakeUp[27] = {
    "0000001111",    "000011001000",  "000011001001",  "000001011011",  "000000110011",  "000000110100",
    "000000110101",  "0000001101100", "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100", "0000001110101", "0000001110110",
    "0000001110111", "0000001010010", "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101"};
const char* const kMakeUp[13] = {"00000001000",  "00000001100",  "00000001101",  "000000010010", "000000010011",
                                 "000000010100", "000000010101", "000000010110", "000000010111", "000000011100",
                                 "000000011101", "000000011110", "000000011111"};

// every index of a (1 << bits)-entry table whose low bits read `code` first
// bit first
void put_code(Ent* tab, int bits, const char* code, State state, int32_t param) {
  const int len = (int)strlen(code);
  uint32_t r = 0;
  for (int k = 0; k < len; k++)
    if (code[k] == '1') r |= 1u << k;
  for (uint32_t i = r; i < (1u << bits); i += 1u << len) tab[i] = {state, (uint8_t)len, param};
}

struct Tables {
  Ent white[1 << 12] = {}, black[1 << 13] = {}, main[1 << 7] = {};
  uint8_t rev[256];
  Tables() {
    for (int i = 0; i < 64; i++) {
      put_code(white, 12, kWhiteTerm[i], S_TermW, i);
      put_code(black, 13, kBlackTerm[i], S_TermB, i);
    }
    for (int i = 0; i < 27; i++) {
      put_code(white, 12, kWhiteMakeUp[i], S_MakeUpW, 64 * (i + 1));
      put_code(black, 13, kBlackMakeUp[i], S_MakeUpB, 64 * (i + 1));
    }
    for (int i = 0; i < 13; i++) {
      put_code(white, 12, kMakeUp[i], S_MakeUp, 1792 + 64 * i);
      put_code(black, 13, kMakeUp[i], S_MakeUp, 1792 + 64 * i);
    }
    put_code(white, 12, "00000000000", S_EOL, 0);
    put_code(black, 13, "00000000000", S_EOL, 0);
    put_code(main, 7, "0001", S_Pass, 0);
    put_code(main, 7, "001", S_Horiz, 0);
    put_code(main, 7, "1", S_V0, 0);
    put_code(main, 7, "011", S_VR, 1);
    put_code(main, 7, "000011", S_VR, 2);
    put_code(main, 7, "0000011", S_VR, 3);
    put_code(main, 7, "010", S_VL, 1);
    put_code(main, 7, "000010", S_VL, 2);
    put_code(main, 7, "0000010", S_VL, 3);
    put_code(main, 7, "0000001", S_Ext, 0);
    put_code(main, 7, "0000000", S_EOL, 0);
    for (int i = 0; i < 256; i++) {
      int r = 0;
      for (int k = 0; k < 8; k++) r |= ((i >> k) & 1) << (7 - k);
      rev[i] = (uint8_t)r;
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// _TIFFFax3fillruns: white runs skipped (the row is zero), black runs set,
// each run cut at the row's end in place (the cut runs are the next row's
// reference)
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, int lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  const uint32_t last = (uint32_t)lastx;
  for (; runs < erun; runs += 2) {
    uint32_t run = runs[0];
    if (x + run > last || run > last) run = runs[0] = last - x;
    x += run;
    run = runs[1];
    if (x + run > last || run > last) run = runs[1] = last - x;
    for (uint32_t k = x; k < x + run; k++) buf[k >> 3] |= (uint8_t)(0x80 >> (k & 7));
    x += run;
  }
}

// one strip or tile, libtiff's Fax3DecodeRLE / Fax3Decode1D / Fax3Decode2D /
// Fax4Decode with their macros written out; returns 1 where libtiff's
// decoder returns -1
struct Decoder {
  const uint8_t *cp, *ep;
  const uint8_t* bitmap;
  uint32_t acc = 0;
  int avail = 0;
  uint32_t* runs;
  uint32_t nruns;
  uint32_t *curruns, *refruns = nullptr, *thisrun, *pa, *pb = nullptr;
  int a0 = 0, lastx, RunLength = 0, EOLcnt = 0, b1 = 0;
  const char* msg = nullptr;

  // Fax3PreDecode: the run arrays (2 * nruns, kept from strip to strip as
  // libtiff keeps them: a pass past the reference line's end reads what an
  // earlier row left there) with the reference line reset to one white run
  Decoder(const uint8_t* in, size_t n, bool lsb_first, int width, uint32_t* run_arrays, uint32_t n_runs,
          bool reference)
      : cp(in), ep(in + n), runs(run_arrays), nruns(n_runs) {
    bitmap = lsb_first ? nullptr : tables().rev;
    lastx = width;
    curruns = runs;
    if (reference) {
      refruns = runs + nruns;
      refruns[0] = (uint32_t)width;
      refruns[1] = 0;
    }
  }
  // NeedBits8 / NeedBits16: false where no bit is left; a short tail padded with zeros
  bool need(int n) {
    if (avail < n) {
      if (cp >= ep) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= (uint32_t)(bitmap ? bitmap[*cp++] : *cp++) << avail;
        avail += 8;
        if (avail < n) {
          if (cp >= ep)
            avail = n;
          else {
            acc |= (uint32_t)(bitmap ? bitmap[*cp++] : *cp++) << avail;
            avail += 8;
          }
        }
      }
    }
    return true;
  }
  uint32_t get(int n) const { return acc & ((1u << n) - 1); }
  void clr(int n) {
    avail -= n;
    acc >>= n;
  }
  bool setvalue(int x) {  // false: the run array would overflow
    if (pa >= thisrun + nruns) {
      msg = "CCITT: run array overflow";
      return false;
    }
    *pa++ = (uint32_t)(RunLength + x);
    a0 += x;
    RunLength = 0;
    return true;
  }
  bool cleanup_runs() {
    if (RunLength && !setvalue(0)) return false;
    if (a0 != lastx) {
      while (a0 > lastx && pa > thisrun) a0 -= (int)*--pa;
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if (((pa - thisrun) & 1) && !setvalue(0)) return false;
        if (!setvalue(lastx - a0)) return false;
      } else if (a0 > lastx) {
        if (!setvalue(lastx) || !setvalue(0)) return false;
      }
    }
    return true;
  }
  // a run of one colour: make-up codes, then a terminating code.
  // 0 = terminated, 1 = EOL, 2 = bad code, 3 = end of data, 4 = overflow
  int run(bool white) {
    const Tables& t = tables();
    for (;;) {
      if (!need(white ? 12 : 13)) return 3;
      const Ent& e = white ? t.white[get(12)] : t.black[get(13)];
      clr(e.width);
      switch (e.state) {
        case S_EOL:
          return 1;
        case S_TermW:
        case S_TermB:
          if (e.state != (white ? S_TermW : S_TermB)) return 2;
          return setvalue(e.param) ? 0 : 4;
        case S_MakeUpW:
        case S_MakeUpB:
          if (e.state != (white ? S_MakeUpW : S_MakeUpB)) return 2;
          [[fallthrough]];
        case S_MakeUp:
          a0 += e.param;
          RunLength += e.param;
          break;
        default:
          return 2;
      }
    }
  }
  // EXPAND1D: 0 = done, 3 = end of data, 4 = overflow
  int expand1d() {
    for (;;) {
      int r = run(true);
      if (r == 1) EOLcnt = 1;
      if (r == 1 || r == 2 || (r == 0 && a0 >= lastx)) return cleanup_runs() ? 0 : 4;
      if (r == 3) return cleanup_runs() ? 3 : 4;
      if (r == 4) return 4;
      r = run(false);
      if (r == 1) EOLcnt = 1;
      if (r == 1 || r == 2 || (r == 0 && a0 >= lastx)) return cleanup_runs() ? 0 : 4;
      if (r == 3) return cleanup_runs() ? 3 : 4;
      if (r == 4) return 4;
      if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;
    }
  }
  bool check_b1() {
    if (pa != thisrun)
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= refruns + nruns) {
          msg = "CCITT: reference run array overflow";
          return false;
        }
        b1 += (int)(pb[0] + pb[1]);
        pb += 2;
      }
    return true;
  }
  // EXPAND2D: 0 = done, 3 = end of data, 4 = overflow
  int expand2d() {
    const Tables& t = tables();
    while (a0 < lastx) {
      if (pa >= thisrun + nruns) {
        msg = "CCITT: run array overflow";
        return 4;
      }
      if (!need(7)) goto eof2d;
      {
        const Ent& e = t.main[get(7)];
        clr(e.width);
        switch (e.state) {
          case S_Pass:
            if (!check_b1()) return 4;
            if (pb + 1 >= refruns + nruns) {
              msg = "CCITT: reference run array overflow";
              return 4;
            }
            b1 += (int)*pb++;
            RunLength += b1 - a0;
            a0 = b1;
            b1 += (int)*pb++;
            break;
          case S_Horiz: {
            const bool black_first = ((pa - thisrun) & 1) != 0;
            for (int k = 0; k < 2; k++) {
              int r = run(black_first == (k == 1));
              if (r == 3) goto eof2d;
              if (r == 4) return 4;
              if (r != 0) goto eol2d;  // libtiff: unexpected in the black or white table
            }
            if (!check_b1()) return 4;
            break;
          }
          case S_V0:
          case S_VR:
            if (!check_b1()) return 4;
            if (!setvalue(b1 - a0 + (e.state == S_VR ? e.param : 0))) return 4;
            if (pb >= refruns + nruns) {
              msg = "CCITT: reference run array overflow";
              return 4;
            }
            b1 += (int)*pb++;
            break;
          case S_VL:
            if (!check_b1()) return 4;
            if (b1 < a0 + e.param) goto eol2d;
            if (!setvalue(b1 - a0 - e.param)) return 4;
            b1 -= (int)*--pb;
            break;
          case S_Ext:  // uncompressed mode, which libtiff does not read
            *pa++ = (uint32_t)(lastx - a0);
            goto eol2d;
          case S_EOL:
            *pa++ = (uint32_t)(lastx - a0);
            if (!need(4)) goto eof2d;
            clr(4);
            EOLcnt = 1;
            goto eol2d;
          default:
            goto eol2d;
        }
      }
    }
    if (RunLength) {
      if (RunLength + a0 < lastx) {  // a final V0
        if (!need(1)) goto eof2d;
        if (!get(1)) goto eol2d;
        clr(1);
      }
      if (!setvalue(0)) return 4;
    }
  eol2d:
    return cleanup_runs() ? 0 : 4;
  eof2d:
    return cleanup_runs() ? 3 : 4;
  }
  // SYNC_EOL: false at the end of the data
  bool sync_eol() {
    if (EOLcnt == 0) {
      for (;;) {
        if (!need(11)) return false;
        if (get(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      if (!need(8)) return false;
      if (get(8)) break;
      clr(8);
    }
    while (get(1) == 0) clr(1);
    clr(1);
    EOLcnt = 0;
    return true;
  }
};

}  // namespace fax

// ---------------------------------------------------------------- CIELab

// libtiff's TIFFCIELabToRGB with display_sRGB
struct CieLab {
  float Yr2r[1501], Yg2g[1501], Yb2b[1501];
  float rstep, gstep, bstep, X0, Y0, Z0;
};

const float kLabMat[3][3] = {{3.2410F, -1.5374F, -0.4986F}, {-0.9692F, 1.8760F, 0.0416F},
                             {0.0556F, -0.2040F, 1.0570F}};
const float kLabYC = 100.0F, kLabY0 = 1.0F, kLabGamma = 2.4F;
const uint32_t kLabVrw = 255;
const int kLabRange = 1500;

void cielab_init(CieLab& c, const float* ref_white) {
  const double gamma = 1.0 / kLabGamma;
  c.rstep = c.gstep = c.bstep = (kLabYC - kLabY0) / kLabRange;
  for (int i = 0; i <= kLabRange; i++)
    c.Yr2r[i] = c.Yg2g[i] = c.Yb2b[i] = kLabVrw * ((float)pow((double)i / kLabRange, gamma));
  c.X0 = ref_white[0];
  c.Y0 = ref_white[1];
  c.Z0 = ref_white[2];
}

void cielab16_to_xyz(const CieLab& c, uint32_t l, int32_t a, int32_t b, float* X, float* Y, float* Z) {
  float L = (float)l * 100.0F / 65535.0F;
  float cby, tmp;
  if (L < 8.856F) {
    *Y = (L * c.Y0) / 903.292F;
    cby = 7.787F * (*Y / c.Y0) + 16.0F / 116.0F;
  } else {
    cby = (L + 16.0F) / 116.0F;
    *Y = c.Y0 * cby * cby * cby;
  }
  tmp = (float)a / 256.0F / 500.0F + cby;
  if (tmp < 0.2069F)
    *X = c.X0 * (tmp - 0.13793F) / 7.787F;
  else
    *X = c.X0 * tmp * tmp * tmp;
  tmp = cby - (float)b / 256.0F / 200.0F;
  if (tmp < 0.2069F)
    *Z = c.Z0 * (tmp - 0.13793F) / 7.787F;
  else
    *Z = c.Z0 * tmp * tmp * tmp;
}

uint32_t lab_rint(float R) { return (uint32_t)(R > 0 ? (R + 0.5) : (R - 0.5)); }

void xyz_to_rgb(const CieLab& c, float X, float Y, float Z, uint8_t* rgb) {
  const float* m = &kLabMat[0][0];
  float Yc[3] = {m[0] * X + m[1] * Y + m[2] * Z, m[3] * X + m[4] * Y + m[5] * Z, m[6] * X + m[7] * Y + m[8] * Z};
  const float* tab[3] = {c.Yr2r, c.Yg2g, c.Yb2b};
  const float step[3] = {c.rstep, c.gstep, c.bstep};
  for (int k = 0; k < 3; k++) {
    float v = Yc[k] > kLabY0 ? Yc[k] : kLabY0;  // TIFFmax, then TIFFmin
    v = v < kLabYC ? v : kLabYC;
    int i = (int)((v - kLabY0) / step[k]);
    i = i < kLabRange ? i : kLabRange;
    uint32_t u = lab_rint(tab[k][i]);
    rgb[k] = (uint8_t)(u < kLabVrw ? u : kLabVrw);
  }
}

}  // namespace

extern "C" {

// rows of (1 + rowbytes) bytes, each a filter type byte and the filtered
// bytes, unfiltered into out (rows * rowbytes); bpp = bytes a pixel, at least 1
int png_unfilter(const uint8_t* in, size_t rows, size_t rowbytes, int bpp, uint8_t* out, char* err, int errlen) {
  const size_t n = rowbytes, k = (size_t)bpp < n ? (size_t)bpp : n;
  std::vector<uint8_t> zeros(n, 0);
  const uint8_t* prev = zeros.data();  // the row above the first is zero
  for (size_t y = 0; y < rows; y++) {
    const uint8_t* src = in + y * (n + 1) + 1;
    uint8_t* dst = out + y * n;
    switch (src[-1]) {
      case 0:
        memcpy(dst, src, n);
        break;
      case 1:
        memcpy(dst, src, k);
        for (size_t i = k; i < n; i++) dst[i] = (uint8_t)(src[i] + dst[i - bpp]);
        break;
      case 2:
        for (size_t i = 0; i < n; i++) dst[i] = (uint8_t)(src[i] + prev[i]);
        break;
      case 3:
        for (size_t i = 0; i < k; i++) dst[i] = (uint8_t)(src[i] + (prev[i] >> 1));
        for (size_t i = k; i < n; i++) dst[i] = (uint8_t)(src[i] + ((dst[i - bpp] + prev[i]) >> 1));
        break;
      case 4:
        for (size_t i = 0; i < k; i++) dst[i] = (uint8_t)(src[i] + prev[i]);  // a = c = 0: the predictor is b
        for (size_t i = k; i < n; i++) {
          // libpng's branch-light Paeth: |p - a|, |p - b|, |p - c| with p = a + b - c
          int a = dst[i - bpp], b = prev[i], c = prev[i - bpp];
          int pa = b - c, pb = a - c, pc = pa + pb;
          pa = pa < 0 ? -pa : pa;
          pb = pb < 0 ? -pb : pb;
          pc = pc < 0 ? -pc : pc;
          int pred = a;
          if (pb < pa) { pa = pb; pred = b; }
          if (pc < pa) pred = c;
          dst[i] = (uint8_t)(src[i] + pred);
        }
        break;
      default:
        set_err(err, errlen, "bad adaptive filter value");
        return 1;
    }
    prev = dst;
  }
  return 0;
}

// an RLE4 (bits 4) or RLE8 (bits 8) stream of n bytes to W x H palette
// indices in top-down row order (idx, zero-filled by the caller)
int bmp_rle(const uint8_t* src, size_t n, int W, int H, int bits, int bottom_up, uint8_t* idx, char* err,
            int errlen) {
  size_t pos = 0;
  int x = 0, y = 0;
  bool flag = false;  // RLE8: the last run wrapped to a new line
  auto row = [&](int yy) { return idx + (size_t)(bottom_up ? H - 1 - yy : yy) * W; };
  for (;;) {
    if (pos + 2 > n) {
      set_err(err, errlen, "RLE data ends before the last line");
      return 1;
    }
    int len = src[pos], code = src[pos + 1];
    pos += 2;
    if (len != 0) {  // encoded mode: len pixels of one index (RLE4: two alternating)
      if (x + len > W) {
        set_err(err, errlen, "RLE run past the end of a line");
        return 1;
      }
      uint8_t* r = row(y);
      if (bits == 8) {
        memset(r + x, code, (size_t)len);
        x += len;
        flag = false;
        if (x >= W) {
          x = 0;
          flag = true;
          if (++y >= H) break;
        }
      } else {
        for (int i = 0; i < len; i++) r[x + i] = (uint8_t)(i & 1 ? code & 15 : code >> 4);
        x += len;
      }
    } else if (code > 2) {  // absolute mode: code literal indices, padded to 16 bits
      if (x + code > W) {
        set_err(err, errlen, "RLE literal past the end of a line");
        return 1;
      }
      size_t sz = bits == 8 ? (size_t)((code + 1) & ~1) : (size_t)((((code + 1) >> 1) + 1) & ~1);
      if (pos + sz > n) {
        set_err(err, errlen, "RLE data ends inside a literal");
        return 1;
      }
      uint8_t* r = row(y);
      for (int i = 0; i < code; i++)
        r[x + i] = bits == 8 ? src[pos + i] : (uint8_t)(i & 1 ? src[pos + i / 2] & 15 : src[pos + i / 2] >> 4);
      pos += sz;
      x += code;
      flag = false;
    } else {  // 0: end of line, 1: end of bitmap, 2: delta
      long x_shift = W - x, y_shift = H - y;
      if (code == 2) {
        if (pos + 2 > n) {
          set_err(err, errlen, "RLE data ends inside a delta");
          return 1;
        }
        x_shift = src[pos];
        y_shift = src[pos + 1];
        pos += 2;
      }
      if (bits == 4) {
        // OpenCV's RLE4 skips dx pixels on a delta and ends the line on an
        // end of bitmap: the lines below it are still read
        fill_zero(idx, W, H, bottom_up != 0, x, y, x_shift);
      } else if (code || !flag || x_shift < W) {
        if (code) x_shift += y_shift * W;
        fill_zero(idx, W, H, bottom_up != 0, x, y, x_shift);
      }
      flag = false;
      if (y >= H) break;
    }
  }
  return 0;
}

// one strip or tile of LZW data (n bytes) to exactly occ bytes
int tiff_lzw(const uint8_t* in, size_t n, uint8_t* out, size_t occ, char* err, int errlen) {
  if (n >= 2 && in[0] == 0 && (in[1] & 1)) {
    set_err(err, errlen, "old-style (LSB-first) LZW is not read");
    return 1;
  }
  static thread_local std::vector<uint16_t> prefix(4096);
  static thread_local std::vector<uint8_t> suffix(4096), first(4096);
  static thread_local std::vector<uint16_t> length(4096);
  for (int i = 0; i < 256; i++) {
    prefix[i] = 0;
    suffix[i] = first[i] = (uint8_t)i;
    length[i] = 1;
  }
  size_t pos = 0, o = 0;
  uint32_t acc = 0;
  int have = 0, nbits = 9, free_ent = 258, old = -1;
  auto next = [&](int& code) {
    while (have < nbits) {
      if (pos >= n) return false;
      acc = (acc << 8) | in[pos++];
      have += 8;
    }
    have -= nbits;
    code = (int)((acc >> have) & ((1u << nbits) - 1));
    return true;
  };
  auto put = [&](int code) {  // the string of code, cut at the end of the buffer
    int len = length[code];
    size_t skip = o + (size_t)len > occ ? o + (size_t)len - occ : 0;
    int c = code;
    for (int k = len - 1; k >= 0; k--) {
      if ((size_t)k < (size_t)len - skip) out[o + (size_t)k] = suffix[c];
      c = prefix[c];
    }
    o += (size_t)len - skip;
  };
  while (o < occ) {
    int code;
    if (!next(code)) break;
    if (code == 256) {
      free_ent = 258;
      nbits = 9;
      if (!next(code)) break;
      if (code == 257) break;
      if (code > 255) {
        set_err(err, errlen, "LZW: corrupted table after a Clear code");
        return 1;
      }
      out[o++] = (uint8_t)code;
      old = code;
      continue;
    }
    if (code == 257) break;
    if (old < 0 || code > free_ent || free_ent >= 4096) {
      set_err(err, errlen, old < 0 ? "LZW: no Clear code first" : "LZW: a code not yet in the table");
      return 1;
    }
    // the new entry: the previous string + the first byte of this one (KwKwK: of the previous)
    prefix[free_ent] = (uint16_t)old;
    length[free_ent] = (uint16_t)(length[old] + 1);
    first[free_ent] = first[old];
    suffix[free_ent] = code < free_ent ? first[code] : first[old];
    if (++free_ent > (1 << nbits) - 2) nbits = nbits < 12 ? nbits + 1 : 12;
    put(code);
    old = code;
  }
  if (o < occ) {
    set_err(err, errlen, "LZW: not enough data for the strip or tile");
    return 1;
  }
  return 0;
}

// one strip or tile of PackBits data (n bytes) to exactly occ bytes
int tiff_packbits(const uint8_t* in, size_t n, uint8_t* out, size_t occ, char* err, int errlen) {
  size_t pos = 0, o = 0;
  while (pos < n && o < occ) {
    int c = (int8_t)in[pos++];
    if (c == -128) continue;
    if (c < 0) {
      size_t k = (size_t)(1 - c);
      if (k > occ - o) k = occ - o;
      if (pos >= n) break;
      memset(out + o, in[pos++], k);
      o += k;
    } else {
      size_t k = (size_t)c + 1;
      if (k > occ - o) k = occ - o;
      if (pos + k > n) break;
      memcpy(out + o, in + pos, k);
      pos += k;
      o += k;
    }
  }
  if (o < occ) {
    set_err(err, errlen, "PackBits: not enough data for the strip or tile");
    return 1;
  }
  return 0;
}

// GIF image data: the sub-blocks from in (after the minimum code size byte)
// to npix palette indices; *used = bytes read through the terminating block
int gif_lzw(const uint8_t* in, size_t n, int min_size, uint16_t* out, size_t npix, size_t* used, char* err,
            int errlen) {
  if (min_size < 2 || min_size > 11) {
    set_err(err, errlen, "GIF LZW minimum code size outside 2-11");
    return 1;
  }
  static thread_local std::vector<uint16_t> prefix(4096), length(4096), suffix(4096), first(4096), stack(4097);
  const int clear = 1 << min_size, eoi = clear + 1;
  for (int i = 0; i < clear; i++) {
    prefix[i] = 0;
    suffix[i] = first[i] = (uint16_t)i;
    length[i] = 1;
  }
  int width = min_size + 1, next = eoi + 1, old = -1;
  uint32_t acc = 0;
  int have = 0;
  size_t pos = 0, o = 0;
  bool done = false;
  for (;;) {
    if (pos >= n) {
      set_err(err, errlen, "GIF image data has no terminating block");
      return 1;
    }
    size_t len = in[pos++];
    if (len == 0) break;
    if (pos + len > n) {
      set_err(err, errlen, "GIF image data runs past the end of the file");
      return 1;
    }
    for (size_t i = 0; i < len && !done; i++) {
      acc |= (uint32_t)in[pos + i] << have;
      have += 8;
      while (have >= width && !done) {
        int code = (int)(acc & ((1u << width) - 1));
        acc >>= width;
        have -= width;
        if (code == clear) {
          width = min_size + 1;
          next = eoi + 1;
          old = -1;
          continue;
        }
        if (code == eoi) {
          done = true;
          break;
        }
        if (old < 0) {
          if (code >= clear) {
            set_err(err, errlen, "GIF LZW: a first code that is not a colour");
            return 1;
          }
          if (o < npix) out[o++] = (uint16_t)code;
          old = code;
          continue;
        }
        if (code > next || (code == next && next >= 4096)) {
          set_err(err, errlen, "GIF LZW: a code not yet in the table");
          return 1;
        }
        if (next < 4096) {
          prefix[next] = (uint16_t)old;
          length[next] = (uint16_t)(length[old] + 1);
          first[next] = first[old];
          suffix[next] = code < next ? first[code] : first[old];
          next++;
          if (next == (1 << width) && width < 12) width++;
        }
        int c = code, k = length[code];
        for (int j = k - 1; j >= 0; j--) {
          stack[j] = suffix[c];
          c = prefix[c];
        }
        for (int j = 0; j < k && o < npix; j++) out[o++] = stack[j];
        old = code;
      }
    }
    pos += len;
    if (done) {  // skip to the terminating block
      while (pos < n && in[pos] != 0) pos += (size_t)in[pos] + 1;
      if (pos >= n) {
        set_err(err, errlen, "GIF image data has no terminating block");
        return 1;
      }
      pos++;
      break;
    }
  }
  *used = pos;
  if (o < npix) {
    set_err(err, errlen, "GIF image data ends before the last pixel");
    return 1;
  }
  return 0;
}


// height * width pixels of RGBE bytes from src into out (4 bytes a pixel)
int hdr_rle(const uint8_t* src, size_t n, int width, int height, uint8_t* out, char* err, int errlen) {
  const size_t total = (size_t)width * (size_t)height;
  size_t pos = 0;
  auto flat = [&](size_t from) {
    size_t need = (total - from) * 4;
    if (n - pos < need) {
      set_err(err, errlen, "RGBE read error: the pixels end early");
      return 1;
    }
    memcpy(out + from * 4, src + pos, need);
    return 0;
  };
  if (width < 8 || width > 0x7fff) return flat(0);
  std::vector<uint8_t> line((size_t)width * 4);
  for (int y = 0; y < height; y++) {
    if (n - pos < 4) {
      set_err(err, errlen, "RGBE read error: the scanlines end early");
      return 1;
    }
    const uint8_t* h = src + pos;
    if (h[0] != 2 || h[1] != 2 || (h[2] & 0x80)) return flat((size_t)y * (size_t)width);
    if ((h[2] << 8 | h[3]) != width) {
      set_err(err, errlen, "RGBE bad file format: wrong scanline width");
      return 1;
    }
    pos += 4;
    for (int c = 0; c < 4; c++) {
      uint8_t* ch = line.data() + (size_t)c * (size_t)width;
      int x = 0;
      while (x < width) {
        if (n - pos < 2) {
          set_err(err, errlen, "RGBE read error: a scanline ends early");
          return 1;
        }
        int b0 = src[pos], b1 = src[pos + 1];
        pos += 2;
        int count = b0 > 128 ? b0 - 128 : b0;
        if (count == 0 || count > width - x) {
          set_err(err, errlen, "RGBE bad file format: bad scanline data");
          return 1;
        }
        if (b0 > 128) {
          memset(ch + x, b1, (size_t)count);
          x += count;
        } else {
          ch[x++] = (uint8_t)b1;
          if (--count > 0) {
            if (n - pos < (size_t)count) {
              set_err(err, errlen, "RGBE read error: a scanline ends early");
              return 1;
            }
            memcpy(ch + x, src + pos, (size_t)count);
            pos += (size_t)count;
            x += count;
          }
        }
      }
    }
    uint8_t* row = out + (size_t)y * (size_t)width * 4;
    for (int x = 0; x < width; x++)
      for (int c = 0; c < 4; c++) row[x * 4 + c] = line[(size_t)c * (size_t)width + (size_t)x];
  }
  return 0;
}

// One strip or tile of CCITT data (n bytes) to rows of rowbytes bytes (out,
// zeroed by the caller). comp: 2 (Modified Huffman, byte-aligned rows), 32771
// (word-aligned rows: odd_start says the data starts at an odd file offset,
// libtiff aligning to the mapped file), 3 (T.4; two_d: T4Options bit 0) or 4
// (T.6); lsb_first: FillOrder 2; runs: the image's run arrays, zero at its
// first strip or tile, at least 4 * roundup(width + 1, 32) entries, passed
// to each of its strips or tiles in turn. Returns 0; 1 where libtiff's
// decoder fails (err names why), the rows not reached left zero, as cv2
// reads them; 2 for T.4 data that ends before the last row, whose missing
// rows cv2 decodes from a re-read of the strip in libtiff's no-EOL mode (its
// rows there are not the file's), which this reader refuses.
int tiff_fax(const uint8_t* in, size_t n, int comp, int two_d, int lsb_first, int odd_start, int width, int rows,
             uint8_t* out, size_t rowbytes, uint32_t* runs, size_t runs_len, char* err, int errlen) {
  using namespace fax;
  const bool reference = comp == 4 || (comp == 3 && two_d);
  const uint32_t nruns = (uint32_t)((width + 1 + 31) / 32 * 32) * (reference ? 2 : 1);  // Fax3SetupState's
  if (width <= 0 || rows <= 0 || rowbytes < ((size_t)width + 7) / 8 || runs_len < (size_t)nruns * 2) {
    set_err(err, errlen, "CCITT: inconsistent row size");
    return 2;
  }
  Decoder d(in, n, lsb_first != 0, width, runs, nruns, reference);
  uint8_t* buf = out;
  auto fail = [&](const char* m) {
    set_err(err, errlen, d.msg ? d.msg : m);
    return 1;
  };
  for (int line = 0; line < rows; line++, buf += rowbytes) {
    d.a0 = 0;
    d.RunLength = 0;
    d.pa = d.thisrun = d.curruns;
    int r;
    if (comp == 2 || comp == 32771) {
      r = d.expand1d();
      if (r == 4) return fail("");
      fill_runs(buf, d.thisrun, d.pa, d.lastx);
      if (r == 3) return fail("CCITT: the data ends before the last row");
      if (comp == 2) {
        d.clr(d.avail - (d.avail & ~7));
      } else {
        d.clr(d.avail - (d.avail & ~15));
        if (d.avail == 0 && (((size_t)(d.cp - in) + (size_t)odd_start) & 1)) d.cp++;
      }
      continue;
    }
    if (comp == 3) {
      bool ok = d.sync_eol();
      int is1d = 1;
      if (ok && (!two_d || (ok = d.need(1)))) {
        if (two_d) {
          is1d = (int)d.get(1);
          d.clr(1);
        }
      }
      if (!ok) {
        set_err(err, errlen, "CCITT Group 3: the data ends before the last row");
        return 2;
      }
      if (two_d) {
        d.pb = d.refruns;
        d.b1 = (int)*d.pb++;
      }
      r = is1d ? d.expand1d() : d.expand2d();
      if (r == 4) return fail("");
      if (r == 3) {
        set_err(err, errlen, "CCITT Group 3: the data ends before the last row");
        return 2;
      }
      fill_runs(buf, d.thisrun, d.pa, d.lastx);
      if (two_d) {
        if (d.pa < d.thisrun + d.nruns && !d.setvalue(0)) return fail("");
        std::swap(d.curruns, d.refruns);
      }
      continue;
    }
    // T.6
    d.pb = d.refruns;
    d.b1 = (int)*d.pb++;
    r = d.expand2d();
    if (r == 4) return fail("");
    if (r == 3 || d.EOLcnt) {  // libtiff's EOFG4: fill the row, stop
      fill_runs(buf, d.thisrun, d.pa, d.lastx);
      return fail("CCITT: the data ends before the last row");
    }
    fill_runs(buf, d.thisrun, d.pa, d.lastx);
    if (!d.setvalue(0)) return fail("");
    std::swap(d.curruns, d.refruns);
  }
  return 0;
}

// n pixels of CIELab samples (bits 8: L, a, b bytes, a and b signed; 16: the
// same as uint16/int16 words in host order) to RGB bytes. white: the
// WhitePoint tag's two floats, or null for libtiff's default (D50).
int tiff_cielab(const void* in, size_t n, int bits, const float* white, uint8_t* out, char* err, int errlen) {
  float wp[2];
  if (white) {
    wp[0] = white[0];
    wp[1] = white[1];
  } else {
    const float X0 = 96.4250F, Y0 = 100.0F, Z0 = 82.4680F;
    wp[0] = X0 / (X0 + Y0 + Z0);
    wp[1] = Y0 / (X0 + Y0 + Z0);
  }
  if (wp[1] == 0.0f) {
    set_err(err, errlen, "CIELab: invalid WhitePoint (y = 0)");
    return 1;
  }
  float ref[3];
  ref[1] = 100.0F;
  ref[0] = wp[0] / wp[1] * ref[1];
  ref[2] = (1.0F - wp[0] - wp[1]) / wp[1] * ref[1];
  static thread_local CieLab c;
  cielab_init(c, ref);
  float X, Y, Z;
  for (size_t i = 0; i < n; i++) {
    if (bits == 8) {
      const uint8_t* p = (const uint8_t*)in + i * 3;
      cielab16_to_xyz(c, (uint32_t)p[0] * 257, (int32_t)(int8_t)p[1] * 256, (int32_t)(int8_t)p[2] * 256, &X, &Y, &Z);
    } else {
      const uint16_t* p = (const uint16_t*)in + i * 3;
      cielab16_to_xyz(c, p[0], (int16_t)p[1], (int16_t)p[2], &X, &Y, &Z);
    }
    xyz_to_rgb(c, X, Y, Z, out + i * 3);
  }
  return 0;
}

}  // extern "C"
