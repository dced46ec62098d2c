// Fused ResNet stems of both encoders in one launch:
// 7x7/2 conv (no bias, zero padding 3) + folded BatchNorm + ReLU +
// 3x3/2 max pool (padding 1).
//
// Replaces the TPU kernel `emsanet_tpu/ops/stem.py::fused_stems`
// (`_stem_kernel`, pl.pallas_call at stem.py:348).
//
// What bounds it: the conv output is 4x the size of the pooled output, so
// an unfused stem writes and re-reads it through device memory. Here the
// conv outputs a tile of POOLED outputs needs stay on the SM, BatchNorm
// and ReLU applied and rounded to the storage type, and are max-pooled
// there: device memory sees one read of the input (with its 7x7 halo)
// and one write of the pooled output. Rounding is monotonic, so the max
// of rounded values is the rounded max. Since ReLU output is >= 0, conv
// positions outside the image are stored as 0: they can tie with, but
// never exceed, the real maximum of a pooling window, which always holds
// at least one in-image position. This gives the -inf padded max pool.
// On the H100 the bf16 kernel is bound by its mma.sync rate and the
// shared-memory traffic that feeds it (6 ldmatrix per 16 mma), not by
// bytes: b8 640x480 is 5.86 M mma for 15.4 GFLOP of useful work.
//
// bf16 (every frame), on the tensor cores (mma.sync m16n8k16, f32
// accumulators). As in the TPU kernel (`pack_stem_inputs`, `_pack_k4`,
// stem.py:102-134), 2x2 space-to-depth turns the 7x7/2 conv into a
// stride-1 4x4 conv over packed pixels (padding 2 before, 1 after):
// packed pixel (py, px) holds x[2py + a, 2px + b, c] at slot
// (a*2 + b)*C + c, 4C slots (the TPU kernel pads them to 16). Each input
// row of a packed pixel is 2C contiguous elements of the NHWC input, so
// the staging copies whole words (4-byte cp.async) and the packing costs
// no pass over the frame. Tap row dy of a conv pixel is four neighbouring
// packed pixels, 16C contiguous elements of a staged row: C K steps of
// 16, which ldmatrix reads straight from the staged tile (no im2col).
// K = 64C (192 for RGB, 64 for depth) by N = 64 features. For odd C, an
// odd conv column's row starts 8C bytes past a 16-byte boundary, so the
// tile is staged twice, the second copy shifted by one packed pixel.
// A tile is 6 x 15 pooled outputs of one modality: 13 conv rows of 32
// columns (31 used), 16 x 35 packed pixels; each warp computes whole conv
// rows, 32 pixels x 64 features (2 m-tiles x 8 n-tiles). BatchNorm and
// ReLU are applied in f32 to the accumulators; the pool's max along a row
// runs in registers (shuffles), its max down the columns from shared
// memory. A persistent grid (256-thread blocks, <= 128 registers; two
// per SM for the frame's C = 3 and 1) walks the tiles modality-major: a
// block loads a modality's weights once, and stages the next tile by
// cp.async while it computes this one. Each staging buffer is sized for
// the larger tile of the two modalities. Swizzles and pitches keep the
// ldmatrix phases and the pooled rows' stores free of bank conflicts
// (C = 4 excepted: 2-way).
//
// f32 (tests only): the CUDA cores, one 8 x 8 pooled tile per block; a
// thread computes one feature at kCG neighbouring conv columns. TF32
// would break its 1e-4 tolerance.
//
// Layouts: inputs (N, H, W, C) NHWC, C <= 4 per modality; weights bf16
// (4C K steps, 64, 16) from `ops/stem.py::stem_mma_weights`, or f32
// [c][ky][kx][64]; folded BN scale/shift f32 [64]; outputs (N, Hq, Wq, 64)
// NHWC in the input dtype.

#include <cstdint>

#include "conv_tc.cuh"

namespace emsanet {

constexpr int kF = 64;        // stem features
constexpr int kThreads = 256;

struct StemMod {
  const void* x;
  const void* w;
  const float* scale;
  const float* shift;
  void* out;
  int c;
};

struct StemArgs {
  StemMod mod[2];
  int n, n_mod, h, w, hc, wc, hq, wq;
  int vec;  // W even and the inputs 4-byte aligned: whole-word loads
};

// The block's modality, field by field: indexing the parameter array at
// run time would copy it into a stack frame.
__device__ __forceinline__ StemMod pick_mod(const StemArgs& a, int i) {
  StemMod m;
  m.x = i ? a.mod[1].x : a.mod[0].x;
  m.w = i ? a.mod[1].w : a.mod[0].w;
  m.scale = i ? a.mod[1].scale : a.mod[0].scale;
  m.shift = i ? a.mod[1].shift : a.mod[0].shift;
  m.out = i ? a.mod[1].out : a.mod[0].out;
  m.c = i ? a.mod[1].c : a.mod[0].c;
  return m;
}

// ---- bf16: tensor cores ------------------------------------------------

namespace stem_tc {

constexpr int kTQH = 6, kTQW = 15;       // pooled outputs per tile
constexpr int kRows = 2 * kTQH + 1;      // 13 conv rows
constexpr int kCols = 32;                // conv columns (2 m-tiles; 31 used)
constexpr int kPR = kRows + 3;           // 16 packed rows
constexpr int kPW = kCols + 3;           // 35 packed columns
constexpr int kCS = kF + 8;              // pooled-row pixel pitch: 144 B
constexpr int kWarps = kThreads / 32;
constexpr size_t kHpBytes = (size_t)kRows * kTQW * kCS * 2;

// Shared memory of a modality with C channels. A packed pixel takes 8C
// bytes, a packed row `in_pitch` (16-byte multiple). For odd C a second
// copy of the tile, shifted by one packed pixel, starts at `in_copy1`
// (64 bytes past a 128-byte boundary, so that an ldmatrix phase of 8
// rows, alternating between the copies, hits distinct banks).
__host__ __device__ inline int in_pitch(int c) {
  return (kPW * 8 * c + 15) / 16 * 16;
}
__host__ __device__ inline int in_copy1(int c) {
  return (kPR * in_pitch(c) + 127) / 128 * 128 + 64;
}
__host__ __device__ inline int in_bytes(int c) {
  return (c & 1) ? in_copy1(c) + kPR * in_pitch(c) : kPR * in_pitch(c);
}
__host__ __device__ inline int w_bytes(int c) {  // 4C K steps x 64 x 32 B
  return 4 * c * kF * 32;
}
// in_bytes is not monotonic in C (odd C stages two copies: in_bytes(3) >
// in_bytes(4)), so a staging buffer, which holds a tile of either
// modality, takes the larger of the two; w_bytes grows with C.
__host__ __device__ inline int buf_bytes(int n_mod, int c0, int c1) {
  const int b0 = in_bytes(c0), b1 = n_mod > 1 ? in_bytes(c1) : 0;
  return b0 > b1 ? b0 : b1;
}
__host__ __device__ inline int wbuf_bytes(int n_mod, int c0, int c1) {
  return w_bytes(n_mod > 1 && c1 > c0 ? c1 : c0);
}
// both buffers of the input, the weights, the row-pooled tile, BN
inline size_t smem_bytes(int buf, int wbuf) {
  return 2 * (size_t)buf + wbuf + kHpBytes + 2 * kF * sizeof(float);
}

// Bits of element i of the input (0 outside the image).
__device__ __forceinline__ unsigned elem(const unsigned short* x, size_t i,
                                         bool ok) {
  return ok ? (unsigned)x[i] : 0u;
}

// Stage the tile's packed pixels: item (packed row, parity row a, packed
// column) copies the two input pixels (2C elements, C words) of input row
// 2 py + a into words [a C, a C + C) of the packed pixel, in both copies
// for odd C. With `vec` (W even: a pair of pixels is wholly inside the
// image or wholly outside) the words go by 4-byte cp.async, zero-filled
// outside the image, and nothing waits for them here; else element by
// element.
__device__ __forceinline__ void stage_packed(unsigned char* s_in,
                                             const StemArgs& a,
                                             const StemMod& m, int img,
                                             int pr0, int pc0) {
  const int c = m.c;
  const int pitch = in_pitch(c), copy1 = in_copy1(c);
  const unsigned short* x = static_cast<const unsigned short*>(m.x);
  for (int i = threadIdx.x; i < kPR * 2 * kPW; i += kThreads) {
    const int pc = i % kPW, rest = i / kPW;
    const int ar = rest & 1, pr = rest >> 1;
    const int gy = 2 * (pr0 + pr) + ar;
    const int gx = 2 * (pc0 + pc);
    const bool row_ok = gy >= 0 && gy < a.h;
    const size_t first = ((size_t)(img * a.h + gy) * a.w + gx) * c;
    unsigned char* d0 = s_in + pr * pitch + (pc * 2 + ar) * c * 4;
    unsigned char* d1 = s_in + copy1 + pr * pitch + ((pc - 1) * 2 + ar) * c * 4;
    const bool two = (c & 1) && pc > 0;
    if (a.vec) {
      const bool ok = row_ok && gx >= 0 && gx < a.w;
      const unsigned* src = reinterpret_cast<const unsigned*>(ok ? x + first
                                                                 : x);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k < c) {
          cp_async4(d0 + 4 * k, src + (ok ? k : 0), ok);
          if (two) cp_async4(d1 + 4 * k, src + (ok ? k : 0), ok);
        }
      }
    } else {
      const bool ok0 = row_ok && gx >= 0 && gx < a.w;
      const bool ok1 = row_ok && gx + 1 >= 0 && gx + 1 < a.w;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        unsigned wv = 0u;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int e = 2 * k + hh;  // element b C + ch of the pair
          if (e < 2 * c) {
            const int b = e >= c ? 1 : 0;
            wv |= elem(x, first + e, b ? ok1 : ok0) << (16 * hh);
          }
        }
        if (k < c) {
          *reinterpret_cast<unsigned*>(d0 + 4 * k) = wv;
          if (two) *reinterpret_cast<unsigned*>(d1 + 4 * k) = wv;
        }
      }
    }
  }
}

// One conv row r of the tile: 32 pixels x 64 features, K = 64 C in 4C
// steps of 16. Tap row dy of conv pixel l is the 16 C contiguous elements
// of packed pixels l .. l + 3 in packed row r + dy; step (dy, j) takes
// elements [16 j, 16 j + 16) of it, so ldmatrix reads the m-tile's 16
// rows straight from the staged tile. For odd C an odd l starts 8C bytes
// past a 16-byte boundary: its row is read from the shifted copy.
template <int C>
__device__ __forceinline__ void conv_row(float (&acc)[2][8][4],
                                         const unsigned char* s_in,
                                         const unsigned char* s_w, int r,
                                         int lane) {
  constexpr int kSteps = 4 * C;
  const int pitch = in_pitch(C);
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;  // m-tile row
  const int a_kh = lane >> 4;                             // k half
  const int b_n = (lane & 7) + (lane >> 4) * 8;           // n of the pair
  const int b_kh = (lane >> 3) & 1;
  // the lane's row start in each m-tile, in bytes
  int a_base[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int l = mt * 16 + a_row;
    a_base[mt] = ((C & 1) && (l & 1))
                     ? in_copy1(C) + r * pitch + (l - 1) * 8 * C
                     : r * pitch + l * 8 * C;
    a_base[mt] += a_kh * 16;
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
#pragma unroll 2  // <= 128 registers without a spill
  for (int kk = 0; kk < kSteps; ++kk) {
    const int dy = kk / C, j = kk % C;
    unsigned af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4(af[mt], s_in + a_base[mt] + dy * pitch + j * 32);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      const int n = np * 16 + b_n;
      unsigned bf[4];
      ldmatrix_x4(bf, s_w + ((kk * kF + n) * 2 + (b_kh ^ ((n >> 2) & 1))) * 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
        mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
      }
    }
  }
}

// A tile of kTQH x kTQW pooled outputs of one modality and image. Tiles
// are numbered modality-major, so a block of the persistent grid, which
// takes tiles blockIdx.x, + gridDim.x, ..., changes modality at most once.
struct Tile {
  int mod, img, py0, px0;
};

__device__ __forceinline__ Tile tile_at(int t, int n, int tiles_x,
                                        int tiles_y) {
  Tile r;
  const int per_img = tiles_x * tiles_y;
  r.mod = t / (n * per_img);
  const int rem = t - r.mod * n * per_img;
  r.img = rem / per_img;
  const int q = rem - r.img * per_img;
  r.py0 = (q / tiles_x) * kTQH;
  r.px0 = (q % tiles_x) * kTQW;
  return r;
}

// The modality's weights (4C K steps, 64, 16) by 16-byte cp.async, half
// h of row (kk, n) at 16-byte unit (kk 64 + n) 2 + (h ^ bit 2 of n) (so
// the 8 rows of an ldmatrix phase hit distinct banks), and its folded
// BatchNorm.
__device__ __forceinline__ void load_weights(unsigned char* s_w, float* s_sc,
                                             float* s_sh, const StemMod& m) {
  const uint4* wg = static_cast<const uint4*>(m.w);
  const int w_units = 4 * m.c * kF * 2;
  for (int i = threadIdx.x; i < w_units; i += kThreads) {
    const int h = i & 1, row = i >> 1, n = row & (kF - 1);
    cp_async16(s_w + (row * 2 + (h ^ ((n >> 2) & 1))) * 16, wg + i, true);
  }
  if (threadIdx.x < kF) {
    s_sc[threadIdx.x] = m.scale[threadIdx.x];
    s_sh[threadIdx.x] = m.shift[threadIdx.x];
  }
}

__device__ __forceinline__ unsigned hmax2u(unsigned x, unsigned y) {
  const __nv_bfloat162 r =
      __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&x),
              *reinterpret_cast<const __nv_bfloat162*>(&y));
  return *reinterpret_cast<const unsigned*>(&r);
}

// Conv row r of the tile at (cr0, cc0): BatchNorm, ReLU, 0 outside the
// image, rounded to bf16, then the pool's 3-wide stride-2 max along the
// row, in registers: lane (g, t) holds columns 8 s + g of features
// nt 8 + 2t, 2t + 1; the lanes of even g take pooled column 4 s + g / 2
// from their own column and the next two (shuffles) and store it to s_hp.
__device__ __forceinline__ void row_epilogue(const float (&acc)[2][8][4],
                                             bf16* s_hp, const float* s_sc,
                                             const float* s_sh,
                                             const StemArgs& a, int r,
                                             int cr0, int cc0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int gr = cr0 + r;
  const bool row_ok = gr >= 0 && gr < a.hc;
  unsigned w[4][8];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int mt = s >> 1, hh = s & 1;
    const int gc = cc0 + 8 * s + g;
    const bool ok = row_ok && gc >= 0 && gc < a.wc;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = nt * 8 + 2 * t;
      const float2 sc = *reinterpret_cast<const float2*>(s_sc + n);
      const float2 sh = *reinterpret_cast<const float2*>(s_sh + n);
      const float v0 =
          ok ? fmaxf(fmaf(acc[mt][nt][2 * hh], sc.x, sh.x), 0.f) : 0.f;
      const float v1 =
          ok ? fmaxf(fmaf(acc[mt][nt][2 * hh + 1], sc.y, sh.y), 0.f) : 0.f;
      const __nv_bfloat162 b = __floats2bfloat162_rn(v0, v1);
      w[s][nt] = *reinterpret_cast<const unsigned*>(&b);
    }
  }
  const int src1 = ((g + 1) & 7) * 4 + t, src2 = ((g + 2) & 7) * 4 + t;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int q = 4 * s + (g >> 1);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const unsigned next = s < 3 ? w[s + 1][nt] : 0u;
      const unsigned x1 = __shfl_sync(0xffffffffu, w[s][nt], src1);
      const unsigned x2 =
          __shfl_sync(0xffffffffu, g == 0 ? next : w[s][nt], src2);
      if (!(g & 1) && q < kTQW)
        *reinterpret_cast<unsigned*>(s_hp + (r * kTQW + q) * kCS + nt * 8 +
                                     2 * t) = hmax2u(w[s][nt],
                                                     hmax2u(x1, x2));
    }
  }
}

__device__ __forceinline__ void conv_rows(const StemArgs& a, int c,
                                          const unsigned char* s_in,
                                          const unsigned char* s_w,
                                          bf16* s_hp, const float* s_sc,
                                          const float* s_sh, int cr0,
                                          int cc0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows; r += kWarps) {
    float acc[2][8][4];
    switch (c) {
      case 1: conv_row<1>(acc, s_in, s_w, r, lane); break;
      case 2: conv_row<2>(acc, s_in, s_w, r, lane); break;
      case 3: conv_row<3>(acc, s_in, s_w, r, lane); break;
      default: conv_row<4>(acc, s_in, s_w, r, lane); break;
    }
    row_epilogue(acc, s_hp, s_sc, s_sh, a, r, cr0, cc0, lane);
  }
}

__device__ __forceinline__ void run(const StemArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  // computed here, not passed in StemArgs: that took a 16-byte stack
  // frame at the 128-register bound
  const int buf = buf_bytes(a.n_mod, a.mod[0].c, a.mod[1].c);
  const int wbuf = wbuf_bytes(a.n_mod, a.mod[0].c, a.mod[1].c);
  unsigned char* s_w = smem + 2 * buf;
  bf16* s_hp = reinterpret_cast<bf16*>(s_w + wbuf);
  float* s_sc = reinterpret_cast<float*>(s_w + wbuf + kHpBytes);
  float* s_sh = s_sc + kF;
  const int tiles_x = ceil_div(a.wq, kTQW), tiles_y = ceil_div(a.hq, kTQH);
  const int total = a.n_mod * a.n * tiles_x * tiles_y;

  int t = blockIdx.x;
  Tile cur = tile_at(t, a.n, tiles_x, tiles_y);
  StemMod m = pick_mod(a, cur.mod);
  load_weights(s_w, s_sc, s_sh, m);
  stage_packed(smem, a, m, cur.img, 2 * cur.py0 - 3, 2 * cur.px0 - 3);
  cp_async_commit();
  for (int i = 0;; ++i) {
    // prefetch the next tile into the other buffer: the tile before this
    // one read it, and every warp has passed the barrier after its MMA
    const int tn = t + gridDim.x;
    Tile nxt = cur;
    StemMod mn = m;
    if (tn < total) {
      nxt = tile_at(tn, a.n, tiles_x, tiles_y);
      mn = pick_mod(a, nxt.mod);
      stage_packed(smem + ((i + 1) & 1) * buf, a, mn, nxt.img,
                   2 * nxt.py0 - 3, 2 * nxt.px0 - 3);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and its weights) staged; s_hp is free
    conv_rows(a, m.c, smem + (i & 1) * buf, s_w, s_hp, s_sc, s_sh,
              2 * cur.py0 - 1, 2 * cur.px0 - 1);
    __syncthreads();  // s_hp complete; s_w and the input are read

    // the pool's 3-high max: one item per (pooled pixel, 8 features),
    // 16-byte loads and stores
    bf16* out = static_cast<bf16*>(m.out);
    for (int k = threadIdx.x; k < kTQH * kTQW * 8; k += kThreads) {
      const int fg = k & 7, p = k >> 3;
      const int qy = p / kTQW, qx = p % kTQW;
      const int gy = cur.py0 + qy, gx = cur.px0 + qx;
      if (gy >= a.hq || gx >= a.wq) continue;
      const uint4* src = reinterpret_cast<const uint4*>(
          s_hp + (2 * qy * kTQW + qx) * kCS + fg * 8);
      constexpr int kRowStep = kTQW * kCS * 2 / 16;  // uint4 per s_hp row
      const uint4 v0 = src[0], v1 = src[kRowStep], v2 = src[2 * kRowStep];
      uint4 o;
      o.x = hmax2u(v0.x, hmax2u(v1.x, v2.x));
      o.y = hmax2u(v0.y, hmax2u(v1.y, v2.y));
      o.z = hmax2u(v0.z, hmax2u(v1.z, v2.z));
      o.w = hmax2u(v0.w, hmax2u(v1.w, v2.w));
      *reinterpret_cast<uint4*>(
          out + ((size_t)(cur.img * a.hq + gy) * a.wq + gx) * kF + fg * 8) =
          o;
    }
    if (tn >= total) break;
    t = tn;
    if (nxt.mod != cur.mod) {  // once at most: no warp reads s_w any more
      load_weights(s_w, s_sc, s_sh, mn);
      cp_async_commit();
    }
    cur = nxt;
    m = mn;
  }
}

}  // namespace stem_tc

// ---- f32: CUDA cores ---------------------------------------------------

namespace stem_f32 {

constexpr int kTQ = 8;                   // pooled outputs per block side
constexpr int kRC = 2 * kTQ + 1;         // conv outputs per block side
constexpr int kIR = 2 * kRC + 5;         // input rows per block
constexpr int kCG = 6;                   // conv columns per thread task
constexpr int kNCG = (kRC + kCG - 1) / kCG;  // column groups per conv row
constexpr int kIW = 2 * kNCG * kCG + 5;      // input columns per block

inline size_t smem_bytes(int c_max) {
  return sizeof(float) * (c_max * 49 * kF + kIR * kIW * c_max + kRC * kRC * kF);
}

__device__ __forceinline__ void run(const StemArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int mod_i = blockIdx.z % a.n_mod;
  const int img = blockIdx.z / a.n_mod;
  const StemMod m = pick_mod(a, mod_i);
  const int c = m.c;
  float* w_s = reinterpret_cast<float*>(smem);  // c*49*64
  float* x_s = w_s + c * 49 * kF;               // kIR*kIW*c
  float* conv_s = x_s + kIR * kIW * c;          // kRC*kRC*64

  const int tid = threadIdx.x;
  const int py0 = blockIdx.y * kTQ, px0 = blockIdx.x * kTQ;
  const int cr0 = 2 * py0 - 1, cc0 = 2 * px0 - 1;   // first conv row/col
  const int ir0 = 2 * cr0 - 3, ic0 = 2 * cc0 - 3;   // first input row/col

  const float* wg = static_cast<const float*>(m.w);
  for (int i = tid; i < c * 49 * kF; i += kThreads) w_s[i] = wg[i];
  const float* x = static_cast<const float*>(m.x);
  for (int i = tid; i < kIR * kIW * c; i += kThreads) {
    const int ch = i % c, p = i / c;
    const int gy = ir0 + p / kIW, gx = ic0 + p % kIW;
    float v = 0.f;
    if (gy >= 0 && gy < a.h && gx >= 0 && gx < a.w)
      v = x[((size_t)(img * a.h + gy) * a.w + gx) * c + ch];
    x_s[i] = v;
  }
  __syncthreads();

  const int f = tid % kF;
  const float sc = m.scale[f], sh = m.shift[f];
  for (int task = tid / kF; task < kRC * kNCG; task += kThreads / kF) {
    const int cy = task / kNCG, cx0 = (task % kNCG) * kCG;
    float acc[kCG];
#pragma unroll
    for (int j = 0; j < kCG; ++j) acc[j] = 0.f;
    for (int ch = 0; ch < c; ++ch)
      for (int ky = 0; ky < 7; ++ky) {
        const float* xr = x_s + ((2 * cy + ky) * kIW + 2 * cx0) * c + ch;
        const float* wr = w_s + (ch * 49 + ky * 7) * kF + f;
        float xv[2 * kCG + 5];
#pragma unroll
        for (int i = 0; i < 2 * kCG + 5; ++i) xv[i] = xr[i * c];
#pragma unroll
        for (int kx = 0; kx < 7; ++kx) {
          const float wv = wr[kx * kF];
#pragma unroll
          for (int j = 0; j < kCG; ++j) acc[j] += xv[2 * j + kx] * wv;
        }
      }
    const int gr = cr0 + cy;
#pragma unroll
    for (int j = 0; j < kCG; ++j) {
      const int cx = cx0 + j, gc = cc0 + cx;
      float v = 0.f;
      if (gr >= 0 && gr < a.hc && gc >= 0 && gc < a.wc)
        v = fmaxf(acc[j] * sc + sh, 0.f);
      if (cx < kRC) conv_s[(cy * kRC + cx) * kF + f] = v;
    }
  }
  __syncthreads();

  float* out = static_cast<float*>(m.out);
  for (int i = tid; i < kTQ * kTQ * kF; i += kThreads) {
    const int ff = i % kF, p = i / kF;
    const int qy = p / kTQ, qx = p % kTQ;
    const int gy = py0 + qy, gx = px0 + qx;
    if (gy >= a.hq || gx >= a.wq) continue;
    float mx = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        mx = fmaxf(mx, conv_s[((2 * qy + dy) * kRC + 2 * qx + dx) * kF + ff]);
    out[((size_t)(img * a.hq + gy) * a.wq + gx) * kF + ff] = mx;
  }
}

}  // namespace stem_f32

// bf16: two blocks per SM (<= 128 registers a thread)
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
stem_kernel(const StemArgs a) {
  if constexpr (sizeof(T) == 2)
    stem_tc::run(a);
  else
    stem_f32::run(a);
}

}  // namespace emsanet

extern "C" int fused_stems_launch(
    int dtype, int n, int h, int w, int n_mod,
    const void* x0, int c0, const void* w0, const void* s0, const void* t0,
    void* out0,
    const void* x1, int c1, const void* w1, const void* s1, const void* t1,
    void* out1, void* stream) {
  using namespace emsanet;
  StemArgs a;
  a.mod[0] = {x0, w0, (const float*)s0, (const float*)t0, out0, c0};
  a.mod[1] = {x1, w1, (const float*)s1, (const float*)t1, out1, c1};
  a.n = n;
  a.n_mod = n_mod;
  a.h = h;
  a.w = w;
  a.hc = (h - 1) / 2 + 1;
  a.wc = (w - 1) / 2 + 1;
  a.hq = (a.hc - 1) / 2 + 1;
  a.wq = (a.wc - 1) / 2 + 1;
  a.vec = w % 2 == 0 && reinterpret_cast<uintptr_t>(x0) % 4 == 0 &&
          (n_mod < 2 || reinterpret_cast<uintptr_t>(x1) % 4 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kBF16) {
    const size_t smem = stem_tc::smem_bytes(
        stem_tc::buf_bytes(n_mod, c0, c1), stem_tc::wbuf_bytes(n_mod, c0, c1));
    err = cudaFuncSetAttribute(stem_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    // a persistent grid of as many blocks as fit on this device at once,
    // asked on every launch (a few microseconds of host time): a cache
    // would need a key of device and shared memory
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, stem_kernel<__nv_bfloat16>, kThreads, smem);
    if (per_sm < 1) per_sm = 1;
    const int tiles = n_mod * n * ceil_div(a.wq, stem_tc::kTQW) *
                      ceil_div(a.hq, stem_tc::kTQH);
    const int slots = per_sm * sms;
    stem_kernel<__nv_bfloat16><<<tiles < slots ? tiles : slots, kThreads,
                                 smem, s>>>(a);
  } else {
    const int c_max = n_mod > 1 && c1 > c0 ? c1 : c0;
    const size_t smem = stem_f32::smem_bytes(c_max);
    err = cudaFuncSetAttribute(stem_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(ceil_div(a.wq, stem_f32::kTQ), ceil_div(a.hq, stem_f32::kTQ),
              n * n_mod);
    stem_kernel<float><<<grid, kThreads, smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}
