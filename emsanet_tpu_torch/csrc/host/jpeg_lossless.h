// Lossless JPEG (ITU T.81 Annex H, SOF3) reconstruction, as libjpeg-turbo
// 3.x's jdlossls.c undoes the prediction; included by jpeg_baseline.h.
//
// A scan's Huffman-decoded differences (jdlhuff.c) arrive here per
// component, over its MCU-padded sample grid; only its real samples are
// reconstructed. The first row of the image and the first sample row of
// each restart interval (libjpeg-turbo requires the interval to be whole
// MCU rows) predicts its first sample by 2^(P - Pt - 1) and the others
// by the sample on the left; every other row predicts its first sample
// by the one above and the rest by the scan's predictor 1-7 (Ra left,
// Rb above, Rc above left). Values wrap modulo 2^16; the output is the
// value shifted left by the point transform Pt, kept to 8 bits.

#include <cstdint>
#include <vector>

namespace jpeg {

static inline int lossless_predict(int predictor, int ra, int rb, int rc) {
  switch (predictor) {
    case 1: return ra;
    case 2: return rb;
    case 3: return rc;
    case 4: return ra + rb - rc;
    case 5: return ra + ((rb - rc) >> 1);
    case 6: return rb + ((ra - rc) >> 1);
    default: return (ra + rb) >> 1;  // 7
  }
}

// diff: the component's differences, rows of `stride` (MCU-padded);
// out: its (h, w) samples. first[y]: row y starts the image or a restart
// interval.
static void lossless_undifference(const int32_t* diff, size_t stride,
                                  uint8_t* out, int w, int h, int predictor,
                                  int pt, const std::vector<uint8_t>& first) {
  std::vector<int32_t> prev((size_t)w), row((size_t)w);
  const int initial = 1 << (8 - pt - 1);
  for (int y = 0; y < h; ++y) {
    const int32_t* d = diff + (size_t)y * stride;
    if (first[y]) {
      int ra = (d[0] + initial) & 0xFFFF;
      row[0] = ra;
      for (int x = 1; x < w; ++x) row[x] = ra = (d[x] + ra) & 0xFFFF;
    } else {
      int rb = prev[0];
      int ra = (d[0] + rb) & 0xFFFF;
      row[0] = ra;
      for (int x = 1; x < w; ++x) {
        const int rc = rb;
        rb = prev[x];
        row[x] = ra = (d[x] + lossless_predict(predictor, ra, rb, rc)) &
                      0xFFFF;
      }
    }
    uint8_t* o = out + (size_t)y * w;
    for (int x = 0; x < w; ++x) o[x] = (uint8_t)(row[x] << pt);
    prev.swap(row);
  }
}

}  // namespace jpeg
