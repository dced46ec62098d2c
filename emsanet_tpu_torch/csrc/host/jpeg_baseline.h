// JPEG decoding (ITU T.81 sequential, progressive and lossless, Huffman
// and arithmetic coding, 8-bit), included by emsanet_native.cpp; entry
// point `jpeg_decode` (plain C).
//
// It returns the pixels PIL gives for the same file: Pillow decodes with
// libjpeg-turbo 3.x at its defaults, so each step is libjpeg-turbo's:
//   - progressive scans (jdphuff.c): DC first and refinement scans, AC
//     first scans with end-of-band runs, AC refinement scans with their
//     correction bits;
//   - arithmetic coding (jdarith.c, `jpeg_arith.h`): sequential and
//     progressive, DAC conditioning, restarts;
//   - lossless files (jdlhuff.c, jdlossls.c, `jpeg_lossless.h`):
//     predictors 1-7, the point transform, restarts of whole MCU rows;
//   - block smoothing (jdcoefct.c decompress_smooth_data, libjpeg-turbo
//     2.1+): where a progressive file's scans leave some of the first 9
//     AC coefficients' bits unknown, each block's zero ones among them
//     are estimated from the DC values of its 5x5 neighbourhood (and
//     the DC too, where no AC data came at all);
//   - the `islow` integer IDCT (jidctint.c: 13-bit constants, 2 extra
//     bits after the column pass, the post-IDCT range-limit table);
//   - "fancy" chroma upsampling (jdsample.c): h2v1 and h2v2 triangle
//     filters with their rounding biases, h1v2, box replication where
//     a component is at most 2 samples wide or for other factors; the
//     rows above the first and below the last real row repeat it;
//   - YCbCr -> RGB by libjpeg's 16-bit fixed-point tables (jdcolor.c),
//     and YCCK -> CMYK (ycck_cmyk_convert) by the same tables.
// Handled: SOF0-3, SOF9 and SOF10 at 8-bit precision, 1, 3 or 4
// components, interleaved and single-component scans (several scans per
// frame; a single-component scan covers the component's own blocks, not
// the MCU-padded ones), any sampling factors (a lossless file's
// subsampled components upsampled by replication, as libjpeg-turbo does
// with its 1x1 data units), 8-
// and 16-bit quantization tables, restart intervals, partial edge MCUs.
// The colour space is libjpeg's guess: of 3 components JFIF -> YCbCr,
// Adobe transform 0 -> RGB, else the component ids ('R','G','B' -> RGB;
// a lossless file -> RGB); of 4 components Adobe transform 0 or no Adobe
// marker -> CMYK, any other transform -> YCCK. Four components are
// returned as PIL's mode CMYK gives them: inverted (PIL's raw mode
// "CMYK;I"). 12-bit and hierarchical files are refused by the caller
// (`datasets/jpeg.py`), as PIL refuses them.

#include <cstdint>
#include <cstring>
#include <vector>

#include "jpeg_arith.h"
#include "jpeg_lossless.h"

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
  kSizes = 8,         // the frame differs from the caller's sizes
  kLosslessColour = 10,   // a lossless file in YCbCr or YCCK
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
  int bw = 0, bh = 0;   // data units (blocks; lossless: samples) per row
                        // and column, MCU-padded
  int dw = 0, dh = 0;   // the downsampled size (libjpeg's)
  std::vector<int16_t> coef;  // (bh, bw, 64) natural order
  // progressive: the lowest bit known of each coefficient (zigzag
  // order), -1 where no scan has coded it (libjpeg's coef_bits)
  int coef_bits[64];
  // lossless: the differences of the scan (bh, bw: MCU-padded, in
  // samples), then the samples (dh, dw)
  std::vector<int32_t> diff;
  std::vector<uint8_t> samples;
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

// ---- progressive scans (libjpeg-turbo jdphuff.c) --------------------------

static bool decode_dc_first(BitReader* br, const Huffman* dc, int* pred,
                            int16_t* blk, int al) {
  const int s = decode_huffman(br, dc);
  if (s < 0 || s > 16) return false;
  *pred += s ? extend(br->get(s), s) : 0;
  blk[0] = (int16_t)((unsigned)*pred << al);
  return true;
}

// a correction bit of an already nonzero coefficient (jdphuff.c)
static inline void refine(BitReader* br, int16_t* coef, int p1) {
  if (br->get(1) && (*coef & p1) == 0) *coef += *coef >= 0 ? p1 : -p1;
}

static bool decode_ac_first(BitReader* br, const Huffman* ac, int ss, int se,
                            int al, int* eobrun, int16_t* blk) {
  if (*eobrun > 0) {
    --*eobrun;
    return true;
  }
  for (int k = ss; k <= se; ++k) {
    const int rs = decode_huffman(br, ac);
    if (rs < 0) return false;
    const int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      blk[kNatural[k]] = (int16_t)((unsigned)extend(br->get(s), s) << al);
    } else if (r == 15) {
      k += 15;
    } else {
      *eobrun = (1 << r) + (r ? br->get(r) : 0) - 1;
      break;
    }
  }
  return true;
}

static bool decode_ac_refine(BitReader* br, const Huffman* ac, int ss,
                             int se, int al, int* eobrun, int16_t* blk) {
  const int p1 = 1 << al;
  int k = ss;
  if (*eobrun == 0) {
    for (; k <= se; ++k) {
      const int rs = decode_huffman(br, ac);
      if (rs < 0) return false;
      int r = rs >> 4, s = rs & 15;
      if (s) {  // a newly nonzero coefficient: its sign
        s = br->get(1) ? p1 : -p1;
      } else if (r != 15) {
        *eobrun = (1 << r) + (r ? br->get(r) : 0);
        break;  // the rest of the block is the end-of-band run's
      }
      // step over r zero coefficients, refining the nonzero ones
      do {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) {
          refine(br, coef, p1);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= se);
      if (s) blk[kNatural[k]] = (int16_t)s;
    }
  }
  if (*eobrun > 0) {
    for (; k <= se; ++k) {
      int16_t* coef = blk + kNatural[k];
      if (*coef != 0) refine(br, coef, p1);
    }
    --*eobrun;
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
                     int vx, uint8_t* out, int W, int H, bool fancy = true) {
  auto row = [&](int y) {  // context rows repeat the first / last real row
    y = y < 0 ? 0 : (y >= dh ? dh - 1 : y);
    return plane + (size_t)y * pw;
  };
  if (hx == 1 && vx == 1) {
    for (int y = 0; y < H; ++y) std::memcpy(out + (size_t)y * W, row(y), W);
    return;
  }
  std::vector<uint8_t> line(2 * (size_t)dw + 2);
  if (fancy && hx == 2 && vx == 1 && dw > 2) {  // h2v1_fancy_upsample
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
  if (fancy && hx == 1 && vx == 2) {  // h1v2_fancy_upsample
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
  if (fancy && hx == 2 && vx == 2 && dw > 2) {  // h2v2_fancy_upsample
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

// ---- block smoothing (libjpeg-turbo jdcoefct.c) ---------------------------

// zigzag coefficients 1..9 in natural order (Q01, Q10, Q20, Q11, Q02,
// Q03, Q12, Q21, Q30)
static const int kSmoothPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
static const int kSavedCoefs = 10;

// the estimate of one coefficient (decompress_smooth_data): rounded,
// clipped below 2^Al where Al > 0
static inline int16_t smooth_pred(int64_t q, int64_t num, int al) {
  int64_t pred;
  if (num >= 0) {
    pred = ((q << 7) + num) / (q << 8);
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = ((q << 7) - num) / (q << 8);
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  return (int16_t)pred;
}

// ---- the decoder ----------------------------------------------------------

struct Decoder {
  const uint8_t* data;
  size_t size, pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  ArithConditioning cond;
  std::vector<Component> comps;
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool progressive = false, arithmetic = false, lossless = false;
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
    if (n != 1 && n != 3 && n != 4) return kUnsupported;
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
    const int unit = lossless ? 1 : 8;  // a data unit's side in samples
    mcux = (width + unit * hmax - 1) / (unit * hmax);
    mcuy = (height + unit * vmax - 1) / (unit * vmax);
    for (Component& c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      if (lossless)  // one sample a data unit
        c.samples.assign((size_t)c.dw * c.dh, 0);
      else
        c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      for (int& b : c.coef_bits) b = -1;
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

  // DAC (jdmarker.c get_dac): Tc Tb, then L and U of a DC table or K of
  // an AC one
  int conditioning(size_t end) {
    for (; end - pos >= 2; pos += 2) {
      const int tc = data[pos] >> 4, tb = data[pos] & 15, val = data[pos + 1];
      if (tc > 1) return kBadTable;
      if (tc) {
        cond.ac_k[tb] = (uint8_t)val;
      } else {
        cond.dc_l[tb] = (uint8_t)(val & 15);
        cond.dc_u[tb] = (uint8_t)(val >> 4);
        if (cond.dc_l[tb] > cond.dc_u[tb]) return kBadTable;
      }
    }
    return pos == end ? kOk : kBadTable;
  }

  // the position after the scan's entropy-coded data: its marker
  void skip_to_marker(size_t p) {
    while (p + 1 < size &&
           !(data[p] == 0xFF && data[p + 1] != 0x00 &&
             !(data[p + 1] >= 0xD0 && data[p + 1] <= 0xD7)))
      ++p;
    pos = p;
  }

  // an arithmetic scan's restart: past the next marker, which must be RSTn
  bool arith_restart(ArithDecoder* ar) {
    size_t p = ar->pos;
    for (;;) {
      while (p < size && data[p] != 0xFF) ++p;
      size_t q = p + 1;
      while (q < size && data[q] == 0xFF) ++q;
      if (q >= size) return false;
      if (data[q] == 0x00) {  // a stuffed 0xFF data byte
        p = q + 1;
        continue;
      }
      ar->pos = q + 1;
      ar->at_marker = false;
      return data[q] >= 0xD0 && data[q] <= 0xD7;
    }
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
      // Huffman tables 0-3; arithmetic conditioning tables 0-15
      if ((!arithmetic && (c->td > 3 || c->ta > 3)) ||
          (!lossless && !qt_defined[c->tq]))
        return kBadTable;
      sc.push_back(c);
    }
    const int ss = data[pos], se = data[pos + 1];
    const int ah = data[pos + 2] >> 4, al = data[pos + 2] & 15;
    pos += 3;
    if (lossless) return lossless_scan(sc, ss, se, ah, al, end);
    // the scan's kind, its parameters as libjpeg checks them (jdinput.c,
    // jdphuff.c start_pass_phuff_decoder) and the tables it needs
    enum { kSequential, kDcFirst, kDcRefine, kAcFirst, kAcRefine } kind;
    if (!progressive) {
      if (ss != 0 || se != 63 || ah != 0 || al != 0) return kUnsupported;
      kind = kSequential;
    } else {
      if (ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1))
        return kBadScan;
      if ((ah != 0 && al != ah - 1) || al > 13) return kBadScan;
      kind = ss == 0 ? (ah ? kDcRefine : kDcFirst)
                     : (ah ? kAcRefine : kAcFirst);
      for (Component* c : sc)
        for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
    }
    for (Component* c : sc) {
      if (!arithmetic) {
        if ((kind == kSequential || kind == kDcFirst) && !dc[c->td].defined)
          return kBadTable;
        if ((kind == kSequential || kind >= kAcFirst) && !ac[c->ta].defined)
          return kBadTable;
      }
      c->dc_pred = 0;
    }
    int eobrun = 0;
    BitReader br{data, size, end};
    ArithDecoder ar;
    ar.data = data;
    ar.size = size;
    ar.pos = end;
    // jdarith.c start_pass / process_restart: the statistics of the
    // scan's tables, the DC contexts and the registers start anew
    auto arith_start = [&]() {
      for (int i = 0; i < ns; ++i) {
        if (!progressive || (ss == 0 && ah == 0)) {
          std::memset(ar.dc_stats[sc[i]->td], 0, kDcStatBins);
          ar.dc_context[i] = 0;
          sc[i]->dc_pred = 0;
        }
        if (!progressive || ss)
          std::memset(ar.ac_stats[sc[i]->ta], 0, kAcStatBins);
      }
      ar.reset_registers();
      ar.broken = false;
    };
    if (arithmetic) arith_start();

    // one block of the scan; ci: the component's place in the scan
    auto block = [&](Component* c, int ci, int16_t* blk) {
      if (arithmetic) {
        int v;
        switch (kind) {
          case kSequential:
            if (!ar.dc_diff(c->td, ci, cond, &v)) return false;
            c->dc_pred = (c->dc_pred + v) & 0xFFFF;
            blk[0] = (int16_t)c->dc_pred;
            return ar.ac_first(c->ta, 1, 63, 0, cond, blk, kNatural);
          case kDcFirst:
            if (!ar.dc_diff(c->td, ci, cond, &v)) return false;
            c->dc_pred = (c->dc_pred + v) & 0xFFFF;
            blk[0] = (int16_t)((unsigned)c->dc_pred << al);
            return true;
          case kDcRefine:
            if (ar.decode(&ar.fixed_bin)) blk[0] |= (int16_t)(1 << al);
            return true;
          case kAcFirst:
            return ar.ac_first(c->ta, ss, se, al, cond, blk, kNatural);
          default:
            return ar.ac_refine(c->ta, ss, se, al, blk, kNatural);
        }
      }
      switch (kind) {
        case kSequential:
          return decode_block(&br, &dc[c->td], &ac[c->ta], &c->dc_pred, blk);
        case kDcFirst:
          return decode_dc_first(&br, &dc[c->td], &c->dc_pred, blk, al);
        case kDcRefine:
          if (br.get(1)) blk[0] |= (int16_t)(1 << al);
          return true;
        case kAcFirst:
          return decode_ac_first(&br, &ac[c->ta], ss, se, al, &eobrun, blk);
        default:
          return decode_ac_refine(&br, &ac[c->ta], ss, se, al, &eobrun,
                                  blk);
      }
    };
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
          if (arithmetic) {
            if (!arith_restart(&ar)) return kBadMarker;
            arith_start();
          } else {
            if (!br.restart()) return kBadMarker;
            for (Component* c : sc) c->dc_pred = 0;
            eobrun = 0;
          }
          todo = restart_interval;
        }
        --todo;
      }
      // a bad arithmetic code leaves the rest of the restart interval
      // undecoded (jdarith.c: ct = -1 until the next restart)
      if (ar.broken) continue;
      const int my = (int)(m / nx), mx = (int)(m % nx);
      bool ok = true;
      if (ns == 1) {
        Component* c = sc[0];
        ok = block(c, 0, c->coef.data() + ((size_t)my * c->bw + mx) * 64);
      } else {
        for (int i = 0; i < ns && ok; ++i) {
          Component* c = sc[i];
          for (int by = 0; by < c->v && ok; ++by)
            for (int bx = 0; bx < c->h && ok; ++bx) {
              const size_t b = (size_t)(my * c->v + by) * c->bw
                               + (size_t)mx * c->h + bx;
              ok = block(c, i, c->coef.data() + b * 64);
            }
        }
      }
      if (!ok) {
        if (!arithmetic) return kBadHuffman;
        ar.broken = true;
      }
    }
    skip_to_marker(arithmetic ? ar.pos : br.pos);
    return kOk;
  }

  // a lossless scan (jdlhuff.c, jddiffct.c): one Huffman-coded
  // difference a sample (category 16: 32768); an interleaved scan's MCU
  // holds h x v samples of each component, a single-component scan's one
  // sample of its real grid; then the prediction undone per component
  // (`lossless_undifference`)
  int lossless_scan(const std::vector<Component*>& sc, int predictor, int se,
                    int ah, int pt, size_t end) {
    if (arithmetic) return kUnsupported;
    if (predictor < 1 || predictor > 7 || se != 0 || ah != 0 || pt > 7)
      return kBadScan;
    const bool single = sc.size() == 1;
    const int nx = single ? sc[0]->dw : mcux, ny = single ? sc[0]->dh : mcuy;
    if (restart_interval % nx) return kUnsupported;  // JERR_BAD_RESTART
    for (Component* c : sc) {
      if (!dc[c->td].defined) return kBadTable;
      c->diff.assign((size_t)c->bw * c->bh, 0);
    }
    BitReader br{data, size, end};
    int64_t todo = restart_interval;
    for (int my = 0; my < ny; ++my)
      for (int mx = 0; mx < nx; ++mx) {
        if (restart_interval) {
          if (todo == 0) {
            if (!br.restart()) return kBadMarker;
            todo = restart_interval;
          }
          --todo;
        }
        for (Component* c : sc) {
          const int h = single ? 1 : c->h, v = single ? 1 : c->v;
          const size_t stride = (size_t)c->bw;
          for (int y = 0; y < v; ++y)
            for (int x = 0; x < h; ++x) {
              const int s = decode_huffman(&br, &dc[c->td]);
              if (s < 0 || s > 16) return kBadHuffman;
              c->diff[(size_t)(my * v + y) * stride + mx * h + x] =
                  s == 16 ? 32768 : (s ? extend(br.get(s), s) : 0);
            }
        }
      }
    const int restart_rows = restart_interval / nx;  // MCU rows
    for (Component* c : sc) {
      const int v = single ? 1 : c->v;
      std::vector<uint8_t> first((size_t)c->dh);
      for (int y = 0; y < c->dh; ++y)
        first[y] = y == 0 || (restart_rows && y % v == 0 &&
                              (y / v) % restart_rows == 0);
      lossless_undifference(c->diff.data(), (size_t)c->bw,
                            c->samples.data(), c->dw, c->dh, predictor, pt,
                            first);
      c->diff = std::vector<int32_t>();
    }
    skip_to_marker(br.pos);
    return kOk;
  }

  // jdcoefct.c smoothing_ok: progressive, every component's DC partly
  // known and its quantizers of the DC and the first 9 AC coefficients
  // nonzero, and some bits of those AC coefficients unknown
  bool smoothing_ok() const {
    if (!progressive) return false;
    bool useful = false;
    for (const Component& c : comps) {
      for (int k = 0; k < kSavedCoefs; ++k)
        if (qt[c.tq][kSmoothPos[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < kSavedCoefs; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // decompress_smooth_data for one component: the blocks of its real
  // rows and columns, each with its zero coefficients among the first 9
  // AC ones that are not known exactly estimated from the DC values of
  // the 5x5 blocks around it, IDCT'd into `plane`. The neighbour rows
  // follow libjpeg-turbo's iMCU-row bookkeeping, the padded rows of the
  // coefficient array included.
  void smooth_component(const Component& c, uint8_t* plane, int pw) const {
    const int* bits = c.coef_bits;
    const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 &&
                           bits[4] == -1 && bits[5] == -1 && bits[6] == -1 &&
                           bits[7] == -1 && bits[8] == -1 && bits[9] == -1;
    const uint16_t* qv = qt[c.tq];
    const int64_t Q00 = qv[0], Q01 = qv[1], Q10 = qv[8], Q20 = qv[16],
                  Q11 = qv[9], Q02 = qv[2], Q03 = qv[3], Q12 = qv[10],
                  Q21 = qv[17], Q30 = qv[24];
    const int width_blocks = (c.dw + 7) / 8, height_blocks = (c.dh + 7) / 8;
    const int last_col = width_blocks - 1;
    const int total_rows = mcuy;  // iMCU rows
    int16_t ws[64];
    auto dcat = [&](int row, int col) -> int {
      return c.coef[((size_t)row * c.bw + col) * 64];
    };
    for (int imcu = 0; imcu < total_rows; ++imcu) {
      int block_rows = c.v;
      if (imcu == total_rows - 1) {
        block_rows = height_blocks % c.v;
        if (block_rows == 0) block_rows = c.v;
      }
      const int image_rows = block_rows * total_rows;
      for (int br = 0; br < block_rows; ++br) {
        const int image_row = imcu * block_rows + br;
        const int r = imcu * c.v + br;  // the block row in the array
        const int prev = image_row > 0 ? r - 1 : r;
        const int prev2 = image_row > 1 ? r - 2 : prev;
        const int next = image_row < image_rows - 1 ? r + 1 : r;
        const int next2 = image_row < image_rows - 2 ? r + 2 : next;
        const int rows[5] = {prev2, prev, r, next, next2};
        // DC[i][j]: row i of the window, column j (DC01..DC25)
        int DC[5][5];
        for (int i = 0; i < 5; ++i)
          for (int j = 0; j < 5; ++j) DC[i][j] = dcat(rows[i], 0);
        for (int col = 0; col <= last_col; ++col) {
          std::memcpy(ws, &c.coef[((size_t)r * c.bw + col) * 64], sizeof ws);
          if (col == 0 && col < last_col)
            for (int i = 0; i < 5; ++i) DC[i][3] = DC[i][4] = dcat(rows[i], 1);
          if (col + 1 < last_col)
            for (int i = 0; i < 5; ++i) DC[i][4] = dcat(rows[i], col + 2);
#define D(n) ((int64_t)DC[((n)-1) / 5][((n)-1) % 5])
          int al;
          if ((al = bits[1]) != 0 && ws[1] == 0) {
            const int64_t num = Q00 * (change_dc ?
                (-D(1) - D(2) + D(4) + D(5) - 3 * D(6) + 13 * D(7) -
                 13 * D(9) + 3 * D(10) - 3 * D(11) + 38 * D(12) -
                 38 * D(14) + 3 * D(15) - 3 * D(16) + 13 * D(17) -
                 13 * D(19) + 3 * D(20) - D(21) - D(22) + D(24) + D(25)) :
                (-7 * D(11) + 50 * D(12) - 50 * D(14) + 7 * D(15)));
            ws[1] = smooth_pred(Q01, num, al);
          }
          if ((al = bits[2]) != 0 && ws[8] == 0) {
            const int64_t num = Q00 * (change_dc ?
                (-D(1) - 3 * D(2) - 3 * D(3) - 3 * D(4) - D(5) - D(6) +
                 13 * D(7) + 38 * D(8) + 13 * D(9) - D(10) + D(16) -
                 13 * D(17) - 38 * D(18) - 13 * D(19) + D(20) + D(21) +
                 3 * D(22) + 3 * D(23) + 3 * D(24) + D(25)) :
                (-7 * D(3) + 50 * D(8) - 50 * D(18) + 7 * D(23)));
            ws[8] = smooth_pred(Q10, num, al);
          }
          if ((al = bits[3]) != 0 && ws[16] == 0) {
            const int64_t num = Q00 * (change_dc ?
                (D(3) + 2 * D(7) + 7 * D(8) + 2 * D(9) - 5 * D(12) -
                 14 * D(13) - 5 * D(14) + 2 * D(17) + 7 * D(18) +
                 2 * D(19) + D(23)) :
                (-D(3) + 13 * D(8) - 24 * D(13) + 13 * D(18) - D(23)));
            ws[16] = smooth_pred(Q20, num, al);
          }
          if ((al = bits[4]) != 0 && ws[9] == 0) {
            const int64_t num = Q00 * (change_dc ?
                (-D(1) + D(5) + 9 * D(7) - 9 * D(9) - 9 * D(17) +
                 9 * D(19) + D(21) - D(25)) :
                (D(10) + D(16) - 10 * D(17) + 10 * D(19) - D(2) - D(20) +
                 D(22) - D(24) + D(4) - D(6) + 10 * D(7) - 10 * D(9)));
            ws[9] = smooth_pred(Q11, num, al);
          }
          if ((al = bits[5]) != 0 && ws[2] == 0) {
            const int64_t num = Q00 * (change_dc ?
                (2 * D(7) - 5 * D(8) + 2 * D(9) + D(11) + 7 * D(12) -
                 14 * D(13) + 7 * D(14) + D(15) + 2 * D(17) - 5 * D(18) +
                 2 * D(19)) :
                (-D(11) + 13 * D(12) - 24 * D(13) + 13 * D(14) - D(15)));
            ws[2] = smooth_pred(Q02, num, al);
          }
          if (change_dc) {
            if ((al = bits[6]) != 0 && ws[3] == 0)
              ws[3] = smooth_pred(Q03, Q00 * (D(7) - D(9) + 2 * D(12) -
                                              2 * D(14) + D(17) - D(19)), al);
            if ((al = bits[7]) != 0 && ws[10] == 0)
              ws[10] = smooth_pred(Q12, Q00 * (D(7) - 3 * D(8) + D(9) -
                                               D(17) + 3 * D(18) - D(19)),
                                   al);
            if ((al = bits[8]) != 0 && ws[17] == 0)
              ws[17] = smooth_pred(Q21, Q00 * (D(7) - D(9) - 3 * D(12) +
                                               3 * D(14) + D(17) - D(19)),
                                   al);
            if ((al = bits[9]) != 0 && ws[24] == 0)
              ws[24] = smooth_pred(Q30, Q00 * (D(7) + 2 * D(8) + D(9) -
                                               D(17) - 2 * D(18) - D(19)),
                                   al);
            const int64_t num = Q00 *
                (-2 * D(1) - 6 * D(2) - 8 * D(3) - 6 * D(4) - 2 * D(5) -
                 6 * D(6) + 6 * D(7) + 42 * D(8) + 6 * D(9) - 6 * D(10) -
                 8 * D(11) + 42 * D(12) + 152 * D(13) + 42 * D(14) -
                 8 * D(15) - 6 * D(16) + 6 * D(17) + 42 * D(18) +
                 6 * D(19) - 6 * D(20) - 2 * D(21) - 6 * D(22) -
                 8 * D(23) - 6 * D(24) - 2 * D(25));
            ws[0] = smooth_pred(Q00, num, 0);
          }
#undef D
          idct_islow(ws, qv, plane + (size_t)r * 8 * pw + col * 8, pw);
          for (int i = 0; i < 5; ++i)
            for (int j = 0; j < 4; ++j) DC[i][j] = DC[i][j + 1];
        }
      }
    }
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
      if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || m == 0xC9 ||
          m == 0xCA) {
        if (frame_seen) return kUnsupported;
        frame_seen = true;
        progressive = m == 0xC2 || m == 0xCA;
        arithmetic = m >= 0xC9;
        lossless = m == 0xC3;
        err = frame(end);
      } else if ((m >= 0xC2 && m <= 0xCF) && m != 0xC4 && m != 0xC8 &&
                 m != 0xCC) {
        return kUnsupported;  // hierarchical, arithmetic lossless
      } else if (m == 0xDB) {
        err = quant(end);
      } else if (m == 0xC4) {
        err = huffman(end);
      } else if (m == 0xCC) {
        err = conditioning(end);
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

  // libjpeg's guess of the colour transform (jdapimin.c
  // default_decompress_parms): YCbCr of 3 components, YCCK of 4
  bool transformed() const {
    if (comps.size() == 3) {
      if (jfif) return true;
      if (adobe) return adobe_transform != 0;
      // libjpeg-turbo assumes RGB for a lossless file
      return !lossless &&
             !(comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B');
    }
    return comps.size() == 4 && adobe && adobe_transform != 0;
  }

  // the gray / RGB / CMYK pixels (H, W, n_out), n_out = 1, 3 or 4
  void render(uint8_t* out) {
    const int W = width, H = height;
    std::vector<std::vector<uint8_t>> full(comps.size());
    std::vector<uint8_t> plane;
    const bool smooth = smoothing_ok();
    for (size_t ci = 0; ci < comps.size(); ++ci) {
      Component& c = comps[ci];
      if (lossless) {  // 1x1 data units: libjpeg's box upsampling
        full[ci].resize((size_t)W * H);
        upsample(c.samples.data(), c.dw, c.dw, c.dh, hmax / c.h, vmax / c.v,
                 full[ci].data(), W, H, false);
        continue;
      }
      const int pw = c.bw * 8, ph = c.bh * 8;
      plane.assign((size_t)pw * ph, 0);
      const uint16_t* q = qt[c.tq];
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(c.coef.data() + ((size_t)by * c.bw + bx) * 64, q,
                     plane.data() + (size_t)by * 8 * pw + bx * 8, pw);
      if (smooth) smooth_component(c, plane.data(), pw);
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
    const uint8_t *y = full[0].data(), *cb = full[1].data(),
                  *cr = full[2].data();
    if (comps.size() == 4) {
      // libjpeg's CMYK (YCCK converted: C = 255 - (Y + Cr_r), ...), then
      // PIL's inversion: YCCK gives Y + Cr_r etc. clamped, and 255 - K
      const uint8_t* k = full[3].data();
      const bool ycck = transformed();
      for (size_t i = 0; i < n; ++i) {
        uint8_t* o = out + 4 * i;
        if (ycck) {
          const int yy = y[i], b = cb[i], r = cr[i];
          o[0] = clamp(yy + cr_r[r]);
          o[1] = clamp(yy + (int)((cb_g[b] + cr_g[r]) >> 16));
          o[2] = clamp(yy + cb_b[b]);
        } else {
          o[0] = (uint8_t)(255 - y[i]);
          o[1] = (uint8_t)(255 - cb[i]);
          o[2] = (uint8_t)(255 - cr[i]);
        }
        o[3] = (uint8_t)(255 - k[i]);
      }
      return;
    }
    const bool ycc = transformed();
    if (!ycc) {
      for (size_t i = 0; i < n; ++i) {
        out[3 * i] = y[i];
        out[3 * i + 1] = cb[i];
        out[3 * i + 2] = cr[i];
      }
      return;
    }
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

// Decode the JPEG file `data` (`size` bytes) of `width` x `height`
// pixels and `channels` (1, 3 or 4) output channels, as the caller read
// them from its frame header, into `out`. Returns 0 or a `jpeg::Error`.
int jpeg_decode(const uint8_t* data, int64_t size, int width, int height,
                int channels, uint8_t* out) {
  jpeg::Decoder d;
  d.data = data;
  d.size = (size_t)size;
  const int err = d.parse();
  if (err) return err;
  if (d.width != width || d.height != height ||
      (int)d.comps.size() != channels)
    return jpeg::kSizes;
  // libjpeg-turbo converts no colour of a lossless file: PIL's RGB or
  // CMYK of a YCbCr or YCCK one fails
  if (d.lossless && d.transformed()) return jpeg::kLosslessColour;
  d.render(out);
  return 0;
}

}  // extern "C"
