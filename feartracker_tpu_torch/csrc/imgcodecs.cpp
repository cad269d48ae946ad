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

}  // extern "C"
