// The port's native host library: per-sample preprocessing and PNG
// unfiltering for the loader's worker threads and processes.
//
// A copy of the JAX package's `native/emsanet_native.cpp` (instance
// targets, label / image resizes, normalization, HSV jitter), built at
// first use with the same flags by `emsanet_tpu_torch/native.py` and
// bound there with ctypes; every function is a plain C symbol, so a call
// releases the GIL. The numpy bodies in `preprocessing/transforms.py`
// are the plain versions the tests hold these against. Added here:
// `png_unfilter`, the row-filter inverse of the PNG reader
// (`datasets/png.py`), and `jpeg_decode`, the baseline JPEG decoder of
// `datasets/jpeg.py` (in jpeg_baseline.h).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Instance target generation (Panoptic-DeepLab center/offset targets).
// semantic, instance: (h, w) int32; is_thing: (n_classes,) uint8.
// Outputs: center (h, w) f32, offset (h, w, 2) f32, foreground (h, w) u8,
// center_mask (h, w) u8. Matches transforms._instance_targets.
void instance_targets(const int32_t* semantic, const int32_t* instance,
                      const uint8_t* is_thing, int n_classes, int h, int w,
                      float sigma, int normalized_offset, float* center,
                      float* offset, uint8_t* foreground,
                      uint8_t* center_mask) {
  const int64_t n = (int64_t)h * w;
  std::memset(center, 0, n * sizeof(float));
  std::memset(offset, 0, 2 * n * sizeof(float));

  struct Acc {
    double sy = 0.0, sx = 0.0;
    int64_t cnt = 0;
  };
  std::unordered_map<int32_t, Acc> accs;

  for (int64_t i = 0; i < n; ++i) {
    const int32_t sem = semantic[i];
    const bool thing =
        sem >= 0 && sem < n_classes && is_thing[sem] && instance[i] > 0;
    foreground[i] = thing ? 1 : 0;
    center_mask[i] = sem > 0 ? 1 : 0;
    if (thing) {
      Acc& a = accs[instance[i]];
      a.sy += (double)(i / w);
      a.sx += (double)(i % w);
      a.cnt += 1;
    }
  }

  const float inv2s2 = 1.0f / (2.0f * sigma * sigma);
  const int r = (int)(3.0f * sigma);
  for (const auto& kv : accs) {
    const int32_t iid = kv.first;
    const float my = (float)(kv.second.sy / kv.second.cnt);
    const float mx = (float)(kv.second.sx / kv.second.cnt);

    // gaussian splat, max-accumulated (numpy: window [m-3s, m+3s+1))
    int y0 = (int)(my - 3.0f * sigma), y1 = (int)(my + 3.0f * sigma) + 1;
    int x0 = (int)(mx - 3.0f * sigma), x1 = (int)(mx + 3.0f * sigma) + 1;
    if (y0 < 0) y0 = 0;
    if (x0 < 0) x0 = 0;
    if (y1 > h) y1 = h;
    if (x1 > w) x1 = w;
    for (int y = y0; y < y1; ++y) {
      const float gy = (float)y - my;
      for (int x = x0; x < x1; ++x) {
        const float gx = (float)x - mx;
        const float g = std::exp(-(gy * gy + gx * gx) * inv2s2);
        float& c = center[(int64_t)y * w + x];
        if (g > c) c = g;
      }
    }

    // offsets on this instance's pixels (second pass below is fused here
    // by re-scanning only when writing; cheaper: single global pass after)
    (void)iid;
  }

  // offsets: one global pass (cache-friendly)
  const float inv_h = 1.0f / (float)h, inv_w = 1.0f / (float)w;
  for (int64_t i = 0; i < n; ++i) {
    if (!foreground[i]) continue;
    const auto it = accs.find(instance[i]);
    if (it == accs.end()) continue;
    const float my = (float)(it->second.sy / it->second.cnt);
    const float mx = (float)(it->second.sx / it->second.cnt);
    float dy = my - (float)(i / w);
    float dx = mx - (float)(i % w);
    if (normalized_offset) {
      dy *= inv_h;
      dx *= inv_w;
    }
    offset[2 * i] = dy;
    offset[2 * i + 1] = dx;
  }
}

// ---------------------------------------------------------------------------
// Nearest-neighbor resize for int32 label maps (torch-free, matches
// transforms._resize_nearest: src index = min((i+0.5)*ih/oh, ih-1)).
void resize_nearest_i32(const int32_t* src, int ih, int iw, int32_t* dst,
                        int oh, int ow) {
  std::vector<int> ys(oh), xs(ow);
  for (int i = 0; i < oh; ++i) {
    int v = (int)(((double)i + 0.5) * ih / oh);
    ys[i] = v < ih - 1 ? v : ih - 1;
  }
  for (int j = 0; j < ow; ++j) {
    int v = (int)(((double)j + 0.5) * iw / ow);
    xs[j] = v < iw - 1 ? v : iw - 1;
  }
  for (int i = 0; i < oh; ++i) {
    const int32_t* row = src + (int64_t)ys[i] * iw;
    int32_t* out = dst + (int64_t)i * ow;
    for (int j = 0; j < ow; ++j) out[j] = row[xs[j]];
  }
}

// Bilinear resize for float32 images (c channels), half-pixel centers;
// matches transforms._resize_bilinear.
void resize_bilinear_f32(const float* src, int ih, int iw, int c, float* dst,
                         int oh, int ow) {
  std::vector<int> y0s(oh), y1s(oh), x0s(ow), x1s(ow);
  std::vector<float> wys(oh), wxs(ow);
  for (int i = 0; i < oh; ++i) {
    double y = ((double)i + 0.5) * ih / oh - 0.5;
    if (y < 0) y = 0;
    if (y > ih - 1) y = ih - 1;
    int y0 = (int)y;
    y0s[i] = y0;
    y1s[i] = y0 + 1 < ih ? y0 + 1 : ih - 1;
    wys[i] = (float)(y - y0);
  }
  for (int j = 0; j < ow; ++j) {
    double x = ((double)j + 0.5) * iw / ow - 0.5;
    if (x < 0) x = 0;
    if (x > iw - 1) x = iw - 1;
    int x0 = (int)x;
    x0s[j] = x0;
    x1s[j] = x0 + 1 < iw ? x0 + 1 : iw - 1;
    wxs[j] = (float)(x - x0);
  }
  for (int i = 0; i < oh; ++i) {
    const float* r0 = src + (int64_t)y0s[i] * iw * c;
    const float* r1 = src + (int64_t)y1s[i] * iw * c;
    const float wy = wys[i];
    float* out = dst + (int64_t)i * ow * c;
    for (int j = 0; j < ow; ++j) {
      const float wx = wxs[j];
      const float* p00 = r0 + (int64_t)x0s[j] * c;
      const float* p01 = r0 + (int64_t)x1s[j] * c;
      const float* p10 = r1 + (int64_t)x0s[j] * c;
      const float* p11 = r1 + (int64_t)x1s[j] * c;
      for (int ch = 0; ch < c; ++ch) {
        out[(int64_t)j * c + ch] =
            p00[ch] * (1 - wy) * (1 - wx) + p01[ch] * (1 - wy) * wx +
            p10[ch] * wy * (1 - wx) + p11[ch] * wy * wx;
      }
    }
  }
}

// uint8 in / uint8 out bilinear resize (same sampling grid as the f32
// kernel). One pass replaces the u8->f32 astype + f32 resize + np.round +
// astype-u8 chain, which profiled as ~80% of a train sample on one core.
// Rounding via nearbyintf = round-half-to-even, matching np.round.
void resize_bilinear_u8(const uint8_t* src, int ih, int iw, int c,
                        uint8_t* dst, int oh, int ow) {
  std::vector<int> y0s(oh), y1s(oh), x0s(ow), x1s(ow);
  std::vector<float> wys(oh), wxs(ow);
  for (int i = 0; i < oh; ++i) {
    double y = ((double)i + 0.5) * ih / oh - 0.5;
    if (y < 0) y = 0;
    if (y > ih - 1) y = ih - 1;
    int y0 = (int)y;
    y0s[i] = y0;
    y1s[i] = y0 + 1 < ih ? y0 + 1 : ih - 1;
    wys[i] = (float)(y - y0);
  }
  for (int j = 0; j < ow; ++j) {
    double x = ((double)j + 0.5) * iw / ow - 0.5;
    if (x < 0) x = 0;
    if (x > iw - 1) x = iw - 1;
    int x0 = (int)x;
    x0s[j] = x0;
    x1s[j] = x0 + 1 < iw ? x0 + 1 : iw - 1;
    wxs[j] = (float)(x - x0);
  }
  for (int i = 0; i < oh; ++i) {
    const uint8_t* r0 = src + (int64_t)y0s[i] * iw * c;
    const uint8_t* r1 = src + (int64_t)y1s[i] * iw * c;
    const float wy = wys[i];
    uint8_t* out = dst + (int64_t)i * ow * c;
    for (int j = 0; j < ow; ++j) {
      const float wx = wxs[j];
      const uint8_t* p00 = r0 + (int64_t)x0s[j] * c;
      const uint8_t* p01 = r0 + (int64_t)x1s[j] * c;
      const uint8_t* p10 = r1 + (int64_t)x0s[j] * c;
      const uint8_t* p11 = r1 + (int64_t)x1s[j] * c;
      for (int ch = 0; ch < c; ++ch) {
        const float v = (float)p00[ch] * (1 - wy) * (1 - wx) +
                        (float)p01[ch] * (1 - wy) * wx +
                        (float)p10[ch] * wy * (1 - wx) +
                        (float)p11[ch] * wy * wx;
        float r = nearbyintf(v);
        r = r < 0.0f ? 0.0f : (r > 255.0f ? 255.0f : r);
        out[(int64_t)j * c + ch] = (uint8_t)r;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Normalization: rgb uint8 (h, w, 3) -> standardized f32 with ImageNet
// stats; depth f32 -> standardized with optional raw-zero masking.
void normalize_rgb_u8(const uint8_t* rgb, int64_t n_pixels, const float* mean,
                      const float* std_, float* out) {
  for (int64_t i = 0; i < n_pixels; ++i) {
    for (int ch = 0; ch < 3; ++ch) {
      out[3 * i + ch] =
          ((float)rgb[3 * i + ch] / 255.0f - mean[ch]) / std_[ch];
    }
  }
}

void normalize_depth_f32(const float* depth, int64_t n, float mean,
                         float std_, int raw_depth, float* out) {
  const float inv = 1.0f / std_;
  for (int64_t i = 0; i < n; ++i) {
    const float d = depth[i];
    float v = (d - mean) * inv;
    if (raw_depth && d <= 0.0f) v = 0.0f;
    out[i] = v;
  }
}

// ---------------------------------------------------------------------------
// HSV jitter (train augmentation). The numpy implementation
// (transforms.RandomHSVJitter) was the loader's hottest op (~71 ms of a
// 112 ms sample at 672x896); this is the same math per pixel in one pass.
// dh/ds/dv are the already-drawn uniform jitters (RNG stays in Python for
// determinism parity). rgb/out: (n_pixels, 3) uint8 (may alias).
void hsv_jitter_u8(const uint8_t* rgb, int64_t n_pixels, float dh, float ds,
                   float dv, uint8_t* out) {
  for (int64_t idx = 0; idx < n_pixels; ++idx) {
    const float r = (float)rgb[3 * idx + 0] / 255.0f;
    const float g = (float)rgb[3 * idx + 1] / 255.0f;
    const float b = (float)rgb[3 * idx + 2] / 255.0f;
    const float maxc = r > g ? (r > b ? r : b) : (g > b ? g : b);
    const float minc = r < g ? (r < b ? r : b) : (g < b ? g : b);
    float v = maxc;
    const float delta = maxc - minc;
    float s = maxc > 0.0f
                  ? delta / (maxc > 1e-12f ? maxc : 1e-12f)
                  : 0.0f;
    float h;
    const float rd = 1.0f / (delta > 1e-12f ? delta : 1e-12f);
    if (maxc == r) {
      // (g-b)/delta is already in [-1, 1]: floored %6 == +6 when negative
      h = (g - b) * rd;
      if (h < 0.0f) h += 6.0f;
    } else if (maxc == g) {
      h = (b - r) * rd + 2.0f;
    } else {
      h = (r - g) * rd + 4.0f;
    }
    h *= (1.0f / 6.0f);
    if (!(delta > 0.0f)) h = 0.0f;

    // h in [0,1), |dh| < 1 in practice: wrap with adds, no fmod
    h += dh;
    while (h < 0.0f) h += 1.0f;
    while (h >= 1.0f) h -= 1.0f;
    s += ds;
    s = s < 0.0f ? 0.0f : (s > 1.0f ? 1.0f : s);
    v += dv;
    v = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);

    const float h6 = h * 6.0f;
    const float fl = floorf(h6);
    int i = (int)fl % 6;
    if (i < 0) i += 6;
    const float f = h6 - fl;
    const float p = v * (1.0f - s);
    const float q = v * (1.0f - f * s);
    const float t = v * (1.0f - (1.0f - f) * s);
    float ro, go, bo;
    switch (i) {
      case 0: ro = v; go = t; bo = p; break;
      case 1: ro = q; go = v; bo = p; break;
      case 2: ro = p; go = v; bo = t; break;
      case 3: ro = p; go = q; bo = v; break;
      case 4: ro = t; go = p; bo = v; break;
      default: ro = v; go = p; bo = q; break;
    }
    const float vals[3] = {ro, go, bo};
    for (int ch = 0; ch < 3; ++ch) {
      float x = vals[ch] * 255.0f;
      x = x < 0.0f ? 0.0f : (x > 255.0f ? 255.0f : x);
      out[3 * idx + ch] = (uint8_t)x;  // trunc, matching .astype(np.uint8)
    }
  }
}


// ---------------------------------------------------------------------------
// PNG row unfiltering (PNG spec, section 9). `data`: the inflated IDAT
// stream of a non-interlaced image, `height` rows of one filter-type byte
// and `stride` bytes each. `bpp`: bytes per complete pixel, rounded up to
// 1 for sub-byte depths (1-8). Writes the `height * stride` raw bytes to
// `out`. Returns 0, or the row + 1 of the first unknown filter type.
static inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p;
  const int pb = p > b ? p - b : b - p;
  const int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

int png_unfilter(const uint8_t* data, int64_t height, int64_t stride,
                 int bpp, uint8_t* out) {
  const uint8_t* prev = nullptr;  // the row above, already unfiltered
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = data + y * (stride + 1);
    const uint8_t type = in[0];
    ++in;
    uint8_t* row = out + y * stride;
    switch (type) {
      case 0:
        std::memcpy(row, in, stride);
        break;
      case 1:  // sub
        for (int64_t i = 0; i < stride; ++i)
          row[i] = (uint8_t)(in[i] + (i >= bpp ? row[i - bpp] : 0));
        break;
      case 2:  // up
        for (int64_t i = 0; i < stride; ++i)
          row[i] = (uint8_t)(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:  // average
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          row[i] = (uint8_t)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // paeth
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          row[i] = (uint8_t)(in[i] + paeth(a, b, c));
        }
        break;
      default:
        return (int)(y + 1);
    }
    prev = row;
  }
  return 0;
}

// h5py's LZF filter (liblzf's lzf_decompress): literal runs of 1-32
// bytes and back references of 3-264 bytes up to 8 KiB back. Returns the
// bytes written to `out`, or -1 for a stream that overruns either buffer
// or refers before the output's start.
int64_t lzf_decompress(const uint8_t* in, int64_t in_len, uint8_t* out,
                       int64_t out_len) {
  const uint8_t* ip = in;
  const uint8_t* const in_end = in + in_len;
  uint8_t* op = out;
  uint8_t* const out_end = out + out_len;
  while (ip < in_end) {
    unsigned ctrl = *ip++;
    if (ctrl < (1u << 5)) {
      ++ctrl;
      if (ctrl > (size_t)(out_end - op) || ctrl > (size_t)(in_end - ip))
        return -1;
      std::memcpy(op, ip, ctrl);
      op += ctrl;
      ip += ctrl;
      continue;
    }
    unsigned len = ctrl >> 5;
    if (ip >= in_end) return -1;
    if (len == 7) {
      len += *ip++;
      if (ip >= in_end) return -1;
    }
    const int64_t back = (int64_t)((ctrl & 0x1f) << 8) + *ip++ + 1;
    len += 2;
    if (back > op - out || len > (size_t)(out_end - op)) return -1;
    const uint8_t* ref = op - back;
    for (unsigned i = 0; i < len; ++i) *op++ = *ref++;  // may overlap
  }
  return op - out;
}

}  // extern "C"

#include "jpeg_baseline.h"
