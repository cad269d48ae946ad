// The sequential inner loops of the host's PNG and BMP readers, with a plain
// C interface for ctypes (feartracker_tpu_torch/data/imread.py builds and
// binds it; the rest of both readers is numpy).
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
// Every function returns 0 on success, else writes a message to err.

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
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

}  // extern "C"
