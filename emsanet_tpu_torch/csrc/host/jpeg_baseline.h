// Baseline JPEG decoding (ITU T.81 sequential DCT, Huffman, 8-bit),
// included by emsanet_native.cpp; entry point `jpeg_decode` (plain C).
//
// It returns the pixels PIL gives for the same file: Pillow decodes with
// libjpeg-turbo at its defaults, so each step is libjpeg-turbo's:
//   - the `islow` integer IDCT (jidctint.c: 13-bit constants, 2 extra
//     bits after the column pass, the post-IDCT range-limit table);
//   - "fancy" chroma upsampling (jdsample.c): h2v1 and h2v2 triangle
//     filters with their rounding biases, h1v2, box replication where
//     a component is at most 2 samples wide or for other factors; the
//     rows above the first and below the last real row repeat it;
//   - YCbCr -> RGB by libjpeg's 16-bit fixed-point tables (jdcolor.c).
// Handled: SOF0 and SOF1 at 8-bit precision, 1 or 3 components,
// interleaved and single-component scans (several scans per frame),
// any sampling factors, 8- and 16-bit quantization tables, restart
// intervals, partial edge MCUs. The colour space of 3 components is
// libjpeg's guess: JFIF -> YCbCr, Adobe transform 0 -> RGB, else the
// component ids ('R','G','B' -> RGB). Progressive, lossless,
// arithmetic-coded, 12-bit and CMYK files are refused by the caller
// (`datasets/jpeg.py`) before they get here.

#include <cstdint>
#include <cstring>
#include <vector>

namespace jpeg {

enum Error {
  kOk = 0,
  kTruncated = 1,
  kBadMarker = 2,
  kUnsupported = 3,
  kBadHuffman = 4,
  kBadTable = 5,
  kNoFrame = 6,
  kBadScan = 7,
};

static const int kNatural[64 + 16] = {  // zigzag index -> natural index
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries: a corrupt run past 63 writes to a harmless slot
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  uint8_t values[256];
  int32_t maxcode[18];   // per length; -1 where none
  int32_t valoffset[18];
  // 9-bit lookahead: (length << 8) | value, 0 where the code is longer
  uint16_t look[1 << 9];
};

static bool build_huffman(Huffman* h, const uint8_t* counts,
                          const uint8_t* values, int n_values) {
  std::memcpy(h->values, values, n_values);
  int code = 0, k = 0;
  std::memset(h->look, 0, sizeof(h->look));
  for (int len = 1; len <= 16; ++len) {
    h->valoffset[len] = k - code;
    if (counts[len - 1]) {
      for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
        if (len <= 9) {
          const int shift = 9 - len;
          for (int j = 0; j < (1 << shift); ++j)
            h->look[(code << shift) | j] =
                (uint16_t)((len << 8) | values[k]);
        }
      }
      h->maxcode[len] = code - 1;
    } else {
      h->maxcode[len] = -1;
    }
    if (code > (1 << len)) return false;  // over-subscribed
    code <<= 1;
  }
  h->maxcode[17] = 0x7fffffff;
  h->defined = true;
  return true;
}

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;   // the scan's tables
  int dc_pred = 0;
  int bw = 0, bh = 0;   // blocks per row and column (MCU-padded)
  int dw = 0, dh = 0;   // the downsampled size (libjpeg's)
  std::vector<int16_t> coef;  // (bh, bw, 64) natural order
};

struct BitReader {
  const uint8_t* data;
  size_t size, pos;
  uint64_t acc = 0;
  int bits = 0;
  bool at_marker = false;

  void fill() {
    while (bits <= 56) {
      uint8_t byte = 0;
      if (!at_marker && pos < size) {
        byte = data[pos];
        if (byte == 0xFF) {
          // 0xFF 0x00 is a data byte; 0xFF then anything else a marker
          size_t q = pos + 1;
          while (q < size && data[q] == 0xFF) ++q;  // fill bytes
          if (q < size && data[q] == 0x00) {
            pos = q + 1;
          } else {
            at_marker = true;
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      acc |= (uint64_t)byte << (56 - bits);
      bits += 8;
    }
  }
  inline uint32_t peek(int n) {
    if (bits < n) fill();
    return (uint32_t)(acc >> (64 - n));
  }
  inline void skip(int n) {
    acc <<= n;
    bits -= n;
  }
  inline int get(int n) {  // n in 0..16
    if (n == 0) return 0;
    const int v = (int)peek(n);
    skip(n);
    return v;
  }
  // at a restart: drop the buffered bits, step over the RSTn marker
  bool restart() {
    acc = 0;
    bits = 0;
    // the marker sits at `pos` (possibly after fill bytes)
    while (pos < size && data[pos] != 0xFF) ++pos;
    while (pos < size && data[pos] == 0xFF) ++pos;
    if (pos >= size) return false;
    const uint8_t m = data[pos++];
    at_marker = false;
    return m >= 0xD0 && m <= 0xD7;
  }
};

static inline int decode_huffman(BitReader* br, const Huffman* h) {
  const uint32_t look = br->peek(9);
  const uint16_t e = h->look[look];
  if (e) {
    br->skip(e >> 8);
    return e & 0xFF;
  }
  uint32_t code = br->peek(16);
  for (int len = 10; len <= 16; ++len) {
    const int32_t c = (int32_t)(code >> (16 - len));
    if (c <= h->maxcode[len]) {
      br->skip(len);
      const int idx = c + h->valoffset[len];
      if (idx < 0 || idx > 255) return -1;
      return h->values[idx];
    }
  }
  return -1;
}

static inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

static bool decode_block(BitReader* br, const Huffman* dc, const Huffman* ac,
                         int* pred, int16_t* blk) {
  int s = decode_huffman(br, dc);
  if (s < 0 || s > 16) return false;
  int diff = s ? extend(br->get(s), s) : 0;
  *pred += diff;
  blk[0] = (int16_t)*pred;
  for (int k = 1; k < 64; ++k) {
    const int rs = decode_huffman(br, ac);
    if (rs < 0) return false;
    const int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      blk[kNatural[k]] = (int16_t)extend(br->get(s), s);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  return true;
}

// ---- the islow IDCT (libjpeg-turbo jidctint.c, jpeg_idct_islow) ----------

static inline uint8_t range_limit(int64_t v) {  // post-IDCT table
  const int i = (int)(v & 1023);
  if (i < 128) return (uint8_t)(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return (uint8_t)(i - 896);
}

#define JPEG_DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))

static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                       int stride) {
  const int CB = 13, P1 = 2;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      const int dc = (int)ip[0] * (int)qp[0] * (1 << P1);
      for (int r = 0; r < 8; ++r) wp[r * 8] = dc;
      continue;
    }
    int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137;
    int64_t tmp3 = z1 + z2 * 6270;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CB);
    int64_t tmp1 = (z2 - z3) * (1 << CB);
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    const int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 *= -16069;
    z4 *= -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    wp[0] = (int)JPEG_DESCALE(t10 + tmp3, CB - P1);
    wp[56] = (int)JPEG_DESCALE(t10 - tmp3, CB - P1);
    wp[8] = (int)JPEG_DESCALE(t11 + tmp2, CB - P1);
    wp[48] = (int)JPEG_DESCALE(t11 - tmp2, CB - P1);
    wp[16] = (int)JPEG_DESCALE(t12 + tmp1, CB - P1);
    wp[40] = (int)JPEG_DESCALE(t12 - tmp1, CB - P1);
    wp[24] = (int)JPEG_DESCALE(t13 + tmp0, CB - P1);
    wp[32] = (int)JPEG_DESCALE(t13 - tmp0, CB - P1);
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + r * 8;
    uint8_t* op = out + r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] &&
        !wp[7]) {
      const uint8_t dc = range_limit(JPEG_DESCALE((int64_t)wp[0], P1 + 3));
      for (int i = 0; i < 8; ++i) op[i] = dc;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137;
    int64_t tmp3 = z1 + z2 * 6270;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CB);
    int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CB);
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    const int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 *= -16069;
    z4 *= -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CB + P1 + 3;
    op[0] = range_limit(JPEG_DESCALE(t10 + tmp3, n));
    op[7] = range_limit(JPEG_DESCALE(t10 - tmp3, n));
    op[1] = range_limit(JPEG_DESCALE(t11 + tmp2, n));
    op[6] = range_limit(JPEG_DESCALE(t11 - tmp2, n));
    op[2] = range_limit(JPEG_DESCALE(t12 + tmp1, n));
    op[5] = range_limit(JPEG_DESCALE(t12 - tmp1, n));
    op[3] = range_limit(JPEG_DESCALE(t13 + tmp0, n));
    op[4] = range_limit(JPEG_DESCALE(t13 - tmp0, n));
  }
}

#undef JPEG_DESCALE

// ---- upsampling (libjpeg-turbo jdsample.c) --------------------------------

// plane: (ph, pw) samples of which (dh, dw) are real; out: (H, W) at
// the full resolution. hx, vx: the integer expansion factors.
static void upsample(const uint8_t* plane, int pw, int dw, int dh, int hx,
                     int vx, uint8_t* out, int W, int H) {
  auto row = [&](int y) {  // context rows repeat the first / last real row
    y = y < 0 ? 0 : (y >= dh ? dh - 1 : y);
    return plane + (size_t)y * pw;
  };
  if (hx == 1 && vx == 1) {
    for (int y = 0; y < H; ++y) std::memcpy(out + (size_t)y * W, row(y), W);
    return;
  }
  std::vector<uint8_t> line(2 * (size_t)dw + 2);
  if (hx == 2 && vx == 1 && dw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < H; ++y) {
      const uint8_t* in = row(y);
      uint8_t* o = line.data();
      int v = in[0];
      *o++ = (uint8_t)v;
      *o++ = (uint8_t)((v * 3 + in[1] + 2) >> 2);
      for (int c = 1; c < dw - 1; ++c) {
        v = in[c] * 3;
        *o++ = (uint8_t)((v + in[c - 1] + 1) >> 2);
        *o++ = (uint8_t)((v + in[c + 1] + 2) >> 2);
      }
      v = in[dw - 1];
      *o++ = (uint8_t)((v * 3 + in[dw - 2] + 1) >> 2);
      *o++ = (uint8_t)v;
      std::memcpy(out + (size_t)y * W, line.data(), W);
    }
    return;
  }
  if (hx == 1 && vx == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < H; ++y) {
      const int inrow = y >> 1;
      const bool below = y & 1;
      const uint8_t* in0 = row(inrow);
      const uint8_t* in1 = row(below ? inrow + 1 : inrow - 1);
      const int bias = below ? 2 : 1;
      uint8_t* o = out + (size_t)y * W;
      for (int c = 0; c < W; ++c)
        o[c] = (uint8_t)((in0[c] * 3 + in1[c] + bias) >> 2);
    }
    return;
  }
  if (hx == 2 && vx == 2 && dw > 2) {  // h2v2_fancy_upsample
    for (int y = 0; y < H; ++y) {
      const int inrow = y >> 1;
      const uint8_t* in0 = row(inrow);
      const uint8_t* in1 = row((y & 1) ? inrow + 1 : inrow - 1);
      uint8_t* o = line.data();
      int this_sum = in0[0] * 3 + in1[0];
      int next_sum = in0[1] * 3 + in1[1];
      *o++ = (uint8_t)((this_sum * 4 + 8) >> 4);
      *o++ = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int c = 2; c < dw; ++c) {
        next_sum = in0[c] * 3 + in1[c];
        *o++ = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
        *o++ = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      *o++ = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
      *o++ = (uint8_t)((this_sum * 4 + 7) >> 4);
      std::memcpy(out + (size_t)y * W, line.data(), W);
    }
    return;
  }
  // box replication (h2v1_upsample, h2v2_upsample, int_upsample): every
  // output row of a group copies the group's input row, also the padded
  // samples past the real ones
  for (int y = 0; y < H; ++y) {
    const uint8_t* in = plane + (size_t)(y / vx) * pw;
    uint8_t* o = out + (size_t)y * W;
    for (int c = 0; c < W; ++c) o[c] = in[c / hx];
  }
}

// ---- the decoder ----------------------------------------------------------

struct Decoder {
  const uint8_t* data;
  size_t size, pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  std::vector<Component> comps;
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;

  int u16() {
    const int v = (data[pos] << 8) | data[pos + 1];
    pos += 2;
    return v;
  }

  int frame(size_t end) {
    if (end - pos < 6) return kTruncated;
    if (data[pos] != 8) return kUnsupported;
    pos++;
    height = u16();
    width = u16();
    const int n = data[pos++];
    if (n != 1 && n != 3) return kUnsupported;
    if (width == 0 || height == 0) return kUnsupported;
    if (end - pos < (size_t)(3 * n)) return kTruncated;
    comps.resize(n);
    hmax = vmax = 1;
    for (int i = 0; i < n; ++i) {
      Component& c = comps[i];
      c.id = data[pos];
      c.h = data[pos + 1] >> 4;
      c.v = data[pos + 1] & 15;
      c.tq = data[pos + 2];
      pos += 3;
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        return kBadTable;
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (Component& c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    return kOk;
  }

  int quant(size_t end) {
    while (pos < end) {
      const int pq = data[pos] >> 4, tq = data[pos] & 15;
      pos++;
      if (tq > 3 || pq > 1) return kBadTable;
      if (end - pos < (size_t)(pq ? 128 : 64)) return kTruncated;
      for (int k = 0; k < 64; ++k)
        qt[tq][kNatural[k]] = pq ? (uint16_t)u16() : data[pos++];
      qt_defined[tq] = true;
    }
    return kOk;
  }

  int huffman(size_t end) {
    while (pos < end) {
      if (end - pos < 17) return kTruncated;
      const int tc = data[pos] >> 4, th = data[pos] & 15;
      if (tc > 1 || th > 3) return kBadTable;
      const uint8_t* counts = data + pos + 1;
      int n = 0;
      for (int i = 0; i < 16; ++i) n += counts[i];
      if (n > 256 || end - pos < (size_t)(17 + n)) return kBadTable;
      if (!build_huffman(tc ? &ac[th] : &dc[th], counts, data + pos + 17, n))
        return kBadHuffman;
      pos += 17 + n;
    }
    return kOk;
  }

  int scan(size_t end) {
    if (comps.empty()) return kNoFrame;
    const int ns = data[pos++];
    if (ns < 1 || ns > (int)comps.size() || end - pos < (size_t)(2 * ns + 3))
      return kBadScan;
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      const int id = data[pos], t = data[pos + 1];
      pos += 2;
      Component* c = nullptr;
      for (Component& x : comps)
        if (x.id == id) c = &x;
      if (!c) return kBadScan;
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined ||
          !ac[c->ta].defined || !qt_defined[c->tq])
        return kBadTable;
      sc.push_back(c);
    }
    const int ss = data[pos], se = data[pos + 1], ahl = data[pos + 2];
    pos += 3;
    if (ss != 0 || se != 63 || ahl != 0) return kUnsupported;
    for (Component* c : sc) c->dc_pred = 0;

    BitReader br{data, size, end};
    // MCUs of the scan: interleaved, or one block each for one component
    int nx, ny;
    if (ns == 1) {
      nx = (sc[0]->dw + 7) / 8;
      ny = (sc[0]->dh + 7) / 8;
    } else {
      nx = mcux;
      ny = mcuy;
    }
    const int64_t total = (int64_t)nx * ny;
    int64_t todo = restart_interval;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval) {
        if (todo == 0) {
          if (!br.restart()) return kBadMarker;
          for (Component* c : sc) c->dc_pred = 0;
          todo = restart_interval;
        }
        --todo;
      }
      const int my = (int)(m / nx), mx = (int)(m % nx);
      if (ns == 1) {
        Component* c = sc[0];
        int16_t* blk = c->coef.data() + ((size_t)my * c->bw + mx) * 64;
        if (!decode_block(&br, &dc[c->td], &ac[c->ta], &c->dc_pred, blk))
          return kBadHuffman;
      } else {
        for (Component* c : sc) {
          for (int by = 0; by < c->v; ++by)
            for (int bx = 0; bx < c->h; ++bx) {
              const size_t b = (size_t)(my * c->v + by) * c->bw
                               + (size_t)mx * c->h + bx;
              if (!decode_block(&br, &dc[c->td], &ac[c->ta], &c->dc_pred,
                                c->coef.data() + b * 64))
                return kBadHuffman;
            }
        }
      }
    }
    // step to the byte after the scan's entropy-coded data: its marker
    size_t p = br.pos;
    while (p + 1 < size &&
           !(data[p] == 0xFF && data[p + 1] != 0x00 &&
             !(data[p + 1] >= 0xD0 && data[p + 1] <= 0xD7)))
      ++p;
    pos = p;
    return kOk;
  }

  // parse every marker up to EOI; entropy-coded data follows each SOS
  int parse() {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) return kBadMarker;
    pos = 2;
    bool frame_seen = false, scan_seen = false;
    while (pos < size) {
      if (data[pos] != 0xFF) {
        ++pos;  // garbage between markers: libjpeg skips it with a warning
        continue;
      }
      while (pos < size && data[pos] == 0xFF) ++pos;
      if (pos >= size) break;
      const int m = data[pos++];
      if (m == 0xD9) break;  // EOI
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (pos + 2 > size) return kTruncated;
      const int len = u16();
      if (len < 2 || pos + len - 2 > size) return kTruncated;
      const size_t end = pos + len - 2;
      int err = kOk;
      if (m == 0xC0 || m == 0xC1) {
        if (frame_seen) return kUnsupported;
        frame_seen = true;
        err = frame(end);
      } else if ((m >= 0xC2 && m <= 0xCF) && m != 0xC4 && m != 0xC8 &&
                 m != 0xCC) {
        return kUnsupported;  // progressive, lossless, arithmetic
      } else if (m == 0xDB) {
        err = quant(end);
      } else if (m == 0xC4) {
        err = huffman(end);
      } else if (m == 0xCC) {
        return kUnsupported;  // arithmetic conditioning
      } else if (m == 0xDD) {
        if (len != 4) return kBadMarker;
        restart_interval = u16();
      } else if (m == 0xDA) {
        err = scan(end);
        scan_seen = true;
        if (err) return err;
        continue;  // `scan` left pos at the next marker
      } else if (m == 0xE0) {  // libjpeg reads 14 bytes of APP0
        if (len - 2 >= 14 && !std::memcmp(data + pos, "JFIF\0", 5))
          jfif = true;
      } else if (m == 0xEE) {  // and 12 of APP14
        if (len - 2 >= 12 && !std::memcmp(data + pos, "Adobe", 5)) {
          adobe = true;
          adobe_transform = data[pos + 11];
        }
      }
      if (err) return err;
      pos = end;
    }
    if (!frame_seen || !scan_seen) return kNoFrame;
    return kOk;
  }

  // the RGB / gray pixels (H, W, n_out), n_out = 1 or 3
  void render(uint8_t* out) {
    const int W = width, H = height;
    std::vector<std::vector<uint8_t>> full(comps.size());
    std::vector<uint8_t> plane;
    for (size_t ci = 0; ci < comps.size(); ++ci) {
      Component& c = comps[ci];
      const int pw = c.bw * 8, ph = c.bh * 8;
      plane.assign((size_t)pw * ph, 0);
      const uint16_t* q = qt[c.tq];
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(c.coef.data() + ((size_t)by * c.bw + bx) * 64, q,
                     plane.data() + (size_t)by * 8 * pw + bx * 8, pw);
      full[ci].resize((size_t)W * H);
      // libjpeg's integer expansion factors (jdsample.c)
      upsample(plane.data(), pw, c.dw, c.dh, hmax / c.h, vmax / c.v,
               full[ci].data(), W, H);
    }
    const size_t n = (size_t)W * H;
    if (comps.size() == 1) {
      std::memcpy(out, full[0].data(), n);
      return;
    }
    bool ycc;
    if (jfif) {
      ycc = true;
    } else if (adobe) {
      ycc = adobe_transform != 0;
    } else {
      ycc = !(comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B');
    }
    const uint8_t *y = full[0].data(), *cb = full[1].data(),
                  *cr = full[2].data();
    if (!ycc) {
      for (size_t i = 0; i < n; ++i) {
        out[3 * i] = y[i];
        out[3 * i + 1] = cb[i];
        out[3 * i + 2] = cr[i];
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table: SCALEBITS 16
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    const int64_t one_half = (int64_t)1 << 15;
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = (int)((91881 * x + one_half) >> 16);   // FIX(1.40200)
      cb_b[i] = (int)((116130 * x + one_half) >> 16);  // FIX(1.77200)
      cr_g[i] = -46802 * x;                            // FIX(0.71414)
      cb_g[i] = -22554 * x + one_half;                 // FIX(0.34414)
    }
    auto clamp = [](int v) {
      return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    for (size_t i = 0; i < n; ++i) {
      const int yy = y[i], b = cb[i], r = cr[i];
      out[3 * i] = clamp(yy + cr_r[r]);
      out[3 * i + 1] = clamp(yy + (int)((cb_g[b] + cr_g[r]) >> 16));
      out[3 * i + 2] = clamp(yy + cb_b[b]);
    }
  }
};

}  // namespace jpeg

extern "C" {

// Decode the baseline JPEG file `data` (`size` bytes) of `width` x
// `height` pixels and `channels` (1 or 3) output channels, as the
// caller read them from its frame header, into `out`. Returns 0 or a
// `jpeg::Error`; 8 where the frame disagrees with the caller's sizes.
int jpeg_decode(const uint8_t* data, int64_t size, int width, int height,
                int channels, uint8_t* out) {
  jpeg::Decoder d;
  d.data = data;
  d.size = (size_t)size;
  const int err = d.parse();
  if (err) return err;
  if (d.width != width || d.height != height ||
      (int)d.comps.size() != channels)
    return 8;
  d.render(out);
  return 0;
}

}  // extern "C"
