// Arithmetic-coded JPEG (ITU T.81 Annex D, F.1.4.4, F.2.4 and G.1.3), as
// libjpeg-turbo's jdarith.c decodes it; included by jpeg_baseline.h.
//
// `ArithDecoder` is the QM decoder: the C and A registers, the bit
// counter, the statistics bins of each conditioning table (64 for DC,
// 256 for AC) and the fixed 0.5 estimate (state 113, T.851) that codes
// signs and DC refinement bits. A marker met inside the entropy-coded
// segment is legal: from there on the decoder reads zero bytes, and the
// marker stays where it is for the caller. The four block decoders are
// jdarith.c's decode_mcu (sequential), decode_mcu_DC_first,
// decode_mcu_AC_first and decode_mcu_AC_refine; the DC refinement is one
// fixed-estimate bit a block.

#include <cstdint>
#include <cstring>

namespace jpeg {

// T.81 Table D.2 as jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 estimate
#define JPEG_ARITAB(qe, lps, mps, sw) \
  (((int32_t)(qe) << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
static const int32_t kAritab[114] = {
    JPEG_ARITAB(0x5a1d, 1, 1, 1),     JPEG_ARITAB(0x2586, 14, 2, 0),
    JPEG_ARITAB(0x1114, 16, 3, 0),    JPEG_ARITAB(0x080b, 18, 4, 0),
    JPEG_ARITAB(0x03d8, 20, 5, 0),    JPEG_ARITAB(0x01da, 23, 6, 0),
    JPEG_ARITAB(0x00e5, 25, 7, 0),    JPEG_ARITAB(0x006f, 28, 8, 0),
    JPEG_ARITAB(0x0036, 30, 9, 0),    JPEG_ARITAB(0x001a, 33, 10, 0),
    JPEG_ARITAB(0x000d, 35, 11, 0),   JPEG_ARITAB(0x0006, 9, 12, 0),
    JPEG_ARITAB(0x0003, 10, 13, 0),   JPEG_ARITAB(0x0001, 12, 13, 0),
    JPEG_ARITAB(0x5a7f, 15, 15, 1),   JPEG_ARITAB(0x3f25, 36, 16, 0),
    JPEG_ARITAB(0x2cf2, 38, 17, 0),   JPEG_ARITAB(0x207c, 39, 18, 0),
    JPEG_ARITAB(0x17b9, 40, 19, 0),   JPEG_ARITAB(0x1182, 42, 20, 0),
    JPEG_ARITAB(0x0cef, 43, 21, 0),   JPEG_ARITAB(0x09a1, 45, 22, 0),
    JPEG_ARITAB(0x072f, 46, 23, 0),   JPEG_ARITAB(0x055c, 48, 24, 0),
    JPEG_ARITAB(0x0406, 49, 25, 0),   JPEG_ARITAB(0x0303, 51, 26, 0),
    JPEG_ARITAB(0x0240, 52, 27, 0),   JPEG_ARITAB(0x01b1, 54, 28, 0),
    JPEG_ARITAB(0x0144, 56, 29, 0),   JPEG_ARITAB(0x00f5, 57, 30, 0),
    JPEG_ARITAB(0x00b7, 59, 31, 0),   JPEG_ARITAB(0x008a, 60, 32, 0),
    JPEG_ARITAB(0x0068, 62, 33, 0),   JPEG_ARITAB(0x004e, 63, 34, 0),
    JPEG_ARITAB(0x003b, 32, 35, 0),   JPEG_ARITAB(0x002c, 33, 9, 0),
    JPEG_ARITAB(0x5ae1, 37, 37, 1),   JPEG_ARITAB(0x484c, 64, 38, 0),
    JPEG_ARITAB(0x3a0d, 65, 39, 0),   JPEG_ARITAB(0x2ef1, 67, 40, 0),
    JPEG_ARITAB(0x261f, 68, 41, 0),   JPEG_ARITAB(0x1f33, 69, 42, 0),
    JPEG_ARITAB(0x19a8, 70, 43, 0),   JPEG_ARITAB(0x1518, 72, 44, 0),
    JPEG_ARITAB(0x1177, 73, 45, 0),   JPEG_ARITAB(0x0e74, 74, 46, 0),
    JPEG_ARITAB(0x0bfb, 75, 47, 0),   JPEG_ARITAB(0x09f8, 77, 48, 0),
    JPEG_ARITAB(0x0861, 78, 49, 0),   JPEG_ARITAB(0x0706, 79, 50, 0),
    JPEG_ARITAB(0x05cd, 48, 51, 0),   JPEG_ARITAB(0x04de, 50, 52, 0),
    JPEG_ARITAB(0x040f, 50, 53, 0),   JPEG_ARITAB(0x0363, 51, 54, 0),
    JPEG_ARITAB(0x02d4, 52, 55, 0),   JPEG_ARITAB(0x025c, 53, 56, 0),
    JPEG_ARITAB(0x01f8, 54, 57, 0),   JPEG_ARITAB(0x01a4, 55, 58, 0),
    JPEG_ARITAB(0x0160, 56, 59, 0),   JPEG_ARITAB(0x0125, 57, 60, 0),
    JPEG_ARITAB(0x00f6, 58, 61, 0),   JPEG_ARITAB(0x00cb, 59, 62, 0),
    JPEG_ARITAB(0x00ab, 61, 63, 0),   JPEG_ARITAB(0x008f, 61, 32, 0),
    JPEG_ARITAB(0x5b12, 65, 65, 1),   JPEG_ARITAB(0x4d04, 80, 66, 0),
    JPEG_ARITAB(0x412c, 81, 67, 0),   JPEG_ARITAB(0x37d8, 82, 68, 0),
    JPEG_ARITAB(0x2fe8, 83, 69, 0),   JPEG_ARITAB(0x293c, 84, 70, 0),
    JPEG_ARITAB(0x2379, 86, 71, 0),   JPEG_ARITAB(0x1edf, 87, 72, 0),
    JPEG_ARITAB(0x1aa9, 87, 73, 0),   JPEG_ARITAB(0x174e, 72, 74, 0),
    JPEG_ARITAB(0x1424, 72, 75, 0),   JPEG_ARITAB(0x119c, 74, 76, 0),
    JPEG_ARITAB(0x0f6b, 74, 77, 0),   JPEG_ARITAB(0x0d51, 75, 78, 0),
    JPEG_ARITAB(0x0bb6, 77, 79, 0),   JPEG_ARITAB(0x0a40, 77, 48, 0),
    JPEG_ARITAB(0x5832, 80, 81, 1),   JPEG_ARITAB(0x4d1c, 88, 82, 0),
    JPEG_ARITAB(0x438e, 89, 83, 0),   JPEG_ARITAB(0x3bdd, 90, 84, 0),
    JPEG_ARITAB(0x34ee, 91, 85, 0),   JPEG_ARITAB(0x2eae, 92, 86, 0),
    JPEG_ARITAB(0x299a, 93, 87, 0),   JPEG_ARITAB(0x2516, 86, 71, 0),
    JPEG_ARITAB(0x5570, 88, 89, 1),   JPEG_ARITAB(0x4ca9, 95, 90, 0),
    JPEG_ARITAB(0x44d9, 96, 91, 0),   JPEG_ARITAB(0x3e22, 97, 92, 0),
    JPEG_ARITAB(0x3824, 99, 93, 0),   JPEG_ARITAB(0x32b4, 99, 94, 0),
    JPEG_ARITAB(0x2e17, 93, 86, 0),   JPEG_ARITAB(0x56a8, 95, 96, 1),
    JPEG_ARITAB(0x4f46, 101, 97, 0),  JPEG_ARITAB(0x47e5, 102, 98, 0),
    JPEG_ARITAB(0x41cf, 103, 99, 0),  JPEG_ARITAB(0x3c3d, 104, 100, 0),
    JPEG_ARITAB(0x375e, 99, 93, 0),   JPEG_ARITAB(0x5231, 105, 102, 0),
    JPEG_ARITAB(0x4c0f, 106, 103, 0), JPEG_ARITAB(0x4639, 107, 104, 0),
    JPEG_ARITAB(0x415e, 103, 99, 0),  JPEG_ARITAB(0x5627, 105, 106, 1),
    JPEG_ARITAB(0x50e7, 108, 107, 0), JPEG_ARITAB(0x4b85, 109, 103, 0),
    JPEG_ARITAB(0x5597, 110, 109, 0), JPEG_ARITAB(0x504f, 111, 107, 0),
    JPEG_ARITAB(0x5a10, 110, 111, 1), JPEG_ARITAB(0x5522, 112, 109, 0),
    JPEG_ARITAB(0x59eb, 112, 111, 1), JPEG_ARITAB(0x5a1d, 113, 113, 0)};
#undef JPEG_ARITAB

static const int kDcStatBins = 64, kAcStatBins = 256;

// libjpeg's NUM_ARITH_TBLS: a scan may name conditioning tables 0-15
static const int kArithTables = 16;

// The conditioning of each table (DAC marker; T.81 defaults L 0, U 1,
// K 5)
struct ArithConditioning {
  uint8_t dc_l[kArithTables], dc_u[kArithTables], ac_k[kArithTables];
  ArithConditioning() {
    std::memset(dc_l, 0, sizeof dc_l);
    std::memset(dc_u, 1, sizeof dc_u);
    std::memset(ac_k, 5, sizeof ac_k);
  }
};

struct ArithDecoder {
  const uint8_t* data;
  size_t size, pos;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: fetch two bytes before the first decision
  bool at_marker = false;
  bool broken = false;  // libjpeg's ct == -1 after a bad code: stop
  uint8_t fixed_bin = 113;
  uint8_t dc_stats[kArithTables][kDcStatBins];
  uint8_t ac_stats[kArithTables][kAcStatBins];
  int dc_context[4] = {0, 0, 0, 0};

  int next_byte() {
    if (at_marker || pos >= size) return 0;
    int b = data[pos];
    if (b != 0xFF) {
      ++pos;
      return b;
    }
    size_t q = pos + 1;
    while (q < size && data[q] == 0xFF) ++q;  // fill bytes
    if (q < size && data[q] == 0x00) {
      pos = q + 1;
      return 0xFF;
    }
    at_marker = true;  // the marker stays at `pos` for the caller
    return 0;
  }

  // jdarith.c arith_decode: one binary decision with the bin `st`
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | next_byte();
        if ((ct += 8) < 0) {
          if (++ct == 0) a = 0x8000;  // two initial bytes read
        }
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const int nl = (int)(qe & 0xFF);
    qe >>= 8;
    const int nm = (int)(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional LPS exchange
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {  // conditional MPS exchange
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // the registers as a scan or a restart interval starts them
  void reset_registers() {
    c = 0;
    a = 0;
    ct = -16;
  }

  // F.1.4.4.1: a DC difference with the component's context; returns
  // false on a bad code
  bool dc_diff(int tbl, int ci, const ArithConditioning& cond, int* out) {
    uint8_t* st = dc_stats[tbl] + dc_context[ci];
    if (decode(st) == 0) {
      dc_context[ci] = 0;
      *out = 0;
      return true;
    }
    const int sign = decode(st + 1);
    st += 2 + sign;
    int m = decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;  // X1
      while (decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    if (m < (int)((1L << cond.dc_l[tbl]) >> 1))
      dc_context[ci] = 0;
    else if (m > (int)((1L << cond.dc_u[tbl]) >> 1))
      dc_context[ci] = 12 + sign * 4;
    else
      dc_context[ci] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (decode(st)) v |= m;
    v += 1;
    *out = sign ? -v : v;
    return true;
  }

  // F.2.4.2 / G.1.3.2: the AC coefficients ss..se of one block (first
  // scan, or the whole band of a sequential one), shifted left by al
  bool ac_first(int tbl, int ss, int se, int al, const ArithConditioning& cond,
                int16_t* blk, const int* natural) {
    int k = ss - 1;
    do {
      uint8_t* st = ac_stats[tbl] + 3 * k;
      if (decode(st)) break;  // EOB
      for (;;) {
        k++;
        if (decode(st + 1)) break;
        st += 3;
        if (k >= se) return false;  // spectral overflow
      }
      const int sign = decode(&fixed_bin);
      st += 2;
      int m = decode(st);
      if (m != 0) {
        if (decode(st)) {
          m <<= 1;
          st = ac_stats[tbl] + (k <= cond.ac_k[tbl] ? 189 : 217);
          while (decode(st)) {
            if ((m <<= 1) == 0x8000) return false;
            st += 1;
          }
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[natural[k]] = (int16_t)((unsigned)v << al);
    } while (k < se);
    return true;
  }

  // G.1.3.3: the refinement of the AC band ss..se at bit al
  bool ac_refine(int tbl, int ss, int se, int al, int16_t* blk,
                 const int* natural) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;  // the previous stage's end of block
    for (; kex > 0; kex--)
      if (blk[natural[kex]]) break;
    for (int k = ss - 1; k < se;) {
      uint8_t* st = ac_stats[tbl] + 3 * k;
      if (k >= kex)
        if (decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + natural[++k];
        if (*coef) {  // previously nonzero: a correction bit
          if (decode(st + 2)) *coef = (int16_t)(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (decode(st + 1)) {  // newly nonzero: its sign
          *coef = (int16_t)(decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (k >= se) return false;  // spectral overflow
      }
    }
    return true;
  }
};

}  // namespace jpeg
