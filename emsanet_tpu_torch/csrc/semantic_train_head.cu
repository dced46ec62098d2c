// Train-mode semantic head loss: the final learned x2 upsample of the
// semantic head (nearest x2 + zero-padded depthwise 3x3, in its polyphase
// form) fused with the weighted, label-smoothed, void-ignoring cross
// entropy, forward and backward.
//
// Replaces the TPU kernels of `emsanet_tpu/ops/semantic_train_head.py`:
// `_run_fwd` (`_fwd_kernel`, pl.pallas_call at :490) and `_run_bwd`
// (`_bwd_kernel`, pl.pallas_call at :536).
//
// Per full-res pixel (parity p of half-res pixel (Y, X)) and class k the
// logit is the parity value of common.cuh, summed in f32 and rounded to
// the storage type T (the unfused path writes the logits in T). With
// m = max_k logit, d_k = logit_k - m rounded to T, sumexp = sum exp(d_k),
// logz = m + log(sumexp), label l (0 = void), class l - 1:
//   nll = logz - logit_{l-1}, label-smoothed (1 - ls) nll + ls (logz -
//   mean_k logit_k); weight w = cw[l-1], 0 for void.
// The forward gives (sum w nll, sum w); the loss is their ratio. The
// backward, with gscale = cotangent / sum w:
//   dz_k = gscale w (exp(d_k) / sumexp - ((1 - ls) [k = l-1] + ls / C)),
//   rounded to T; dx = the transposed polyphase conv of dz;
//   dkp[p][tap][k] = sum over own pixels of dz_p,k * x[tap neighbour][k],
//   the 16 non-zero polyphase taps' weight gradients, which the wrapper
//   maps back to the 3x3 kernel.
//
// What bounds it on the H100: bytes (b8 640x480, C = 40, bf16: it reads
// the 49 MB half-res head output and the 9.8 MB int32 labels, the
// backward also writes the 49 MB dx), against ~30 operations per logit.
// The design keeps the (N, H, W, C) full-res logits and their gradient out
// of device memory, as the TPU kernel does: a block stages a tile of
// half-res pixels with its halo in shared memory, all classes at once
// (C <= kMaxLossClasses). Both kernels run a persistent grid of a fixed
// size per device, type and C (as many blocks as fit at once) that walks
// the tiles in a fixed order; each block writes one row of partial sums
// and `reduce_rows` (common.cuh) adds the rows in a fixed order, so the
// loss and dkp do not vary from run to run. The forward's and the
// backward's notes are above their kernels.
//
// Layouts: x, dx (N, H2, W2, C) NHWC in T; taps (4, 4, C) f32 (common.cuh);
// target (N, 2 H2, 2 W2) int32; cw (C) f32; gscale one f32 on the device.

#include <cstdint>

#include "common.cuh"

namespace emsanet {

constexpr int kMaxLossClasses = 64;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int label_at(const int* target, int img, int h2,
                                        int w2, int y, int x, int p) {
  const int row = 2 * y + (p >> 1), col = 2 * x + (p & 1);
  return target[((size_t)img * 2 * h2 + row) * 2 * w2 + col];
}

// Stage all C classes of the SH x SW window of half-res pixels at (y0 -
// halo, x0 - halo) of image img in the storage type T, `stride` elements
// per pixel, zero outside the image. vec: C a multiple of the 16-byte
// vector and x 16-byte aligned, so whole vectors are loaded.
template <typename T, int SH, int SW, int NT>
__device__ __forceinline__ void stage_window(T* s_x, const T* x, int img,
                                             int y0, int x0, int halo,
                                             int h2, int w2, int c,
                                             int stride, int vec) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  const int tid = threadIdx.x;
  if (vec) {
    const int vpp = c / V;
    for (int i = tid; i < SH * SW * vpp; i += NT) {
      const int pix = i / vpp, v = i % vpp;
      const int r = y0 - halo + pix / SW, q = x0 - halo + pix % SW;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r >= 0 && r < h2 && q >= 0 && q < w2)
        val = *reinterpret_cast<const uint4*>(
            x + (((size_t)img * h2 + r) * w2 + q) * c + v * V);
      T* dst = s_x + pix * stride + v * V;
      if constexpr (sizeof(T) == 2) {  // the stride is even
        unsigned* d = reinterpret_cast<unsigned*>(dst);
        d[0] = val.x;
        d[1] = val.y;
        d[2] = val.z;
        d[3] = val.w;
      } else {
        const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
        for (int j = 0; j < V; ++j) dst[j] = e[j];
      }
    }
  } else {
    for (int i = tid; i < SH * SW * c; i += NT) {
      const int ch = i % c, pix = i / c;
      const int r = y0 - halo + pix / SW, q = x0 - halo + pix % SW;
      T v = T(0.f);
      if (r >= 0 && r < h2 && q >= 0 && q < w2)
        v = x[(((size_t)img * h2 + r) * w2 + q) * c + ch];
      s_x[pix * stride + ch] = v;
    }
  }
}

// ---- backward ---------------------------------------------------------
//
// A persistent grid walks 8 x 16 tiles of half-res pixels in a fixed
// order, as many blocks as fit on the card at once (a fixed number per
// device, type and C, so every call splits the work the same way). Per
// tile:
// (1) stage the tile with a 2-pixel halo, all C classes, in the storage
//     type T (16-byte loads where C allows);
// (2) one thread per position of the tile and its 1-pixel halo (180
//     positions) forms the four parity logits of each class (the parity is
//     a compile-time constant: no register array is indexed at run time,
//     and the taps are read as float4 from a class-major copy), their max,
//     and then their sum of exp, and keeps max, sum, weight and target in
//     registers. In bf16 the logits (rounded to T, as the TPU kernel
//     rounds them) are kept in shared memory, 8 bytes per position and
//     class, for the sum and for dz; in f32 they are recomputed;
// (3) for a chunk of kChunk classes at a time, the same thread forms dz of
//     its position's four parities (rounded to T); after one barrier every
//     thread computes dx of (own pixel, class) items, summing the 16
//     polyphase terms in the TPU kernel's order (parity, then tap
//     row-major), and the tap-gradient partials of (half, parity, tap,
//     class) items over the half's 4 rows, in pixel order, added into
//     per-block shared sums;
// (4) the tile's dx leaves in coalesced rows.
// The barriers and the halo recompute are paid per chunk of classes, not
// per class. At the end each block writes its 16 C tap-gradient row (the
// two halves added in order) and `reduce_rows` adds the rows in a fixed
// order: repeated calls give the same bits.
constexpr int kBH = 8, kBW = 16;           // own tile
constexpr int kOwn = kBH * kBW;
constexpr int kChunk = 8;                  // classes per dz chunk
constexpr int kPosW = kBW + 2;             // 1-halo grid: 10 x 18
constexpr int kPos = (kBH + 2) * kPosW;
constexpr int kStageW = kBW + 4;           // 2-halo stage: 12 x 20
constexpr int kStage = (kBH + 4) * kStageW;
constexpr int kG = 2;                      // threads per position
constexpr int kBwdThreads = (kPos * kG + 31) / 32 * 32;

// Elements per staged pixel: an odd number of 4-byte words in T, so the
// threads of a warp (consecutive pixels, one class) hit distinct banks.
template <typename T>
__host__ __device__ inline int bwd_stride(int c) {
  return sizeof(T) == 2 ? (((c + 1) / 2) | 1) * 2 : (c | 1);
}

// bf16 keeps every position's logits (4 parities x C classes, in T).
template <typename T>
constexpr bool kLogitCache = sizeof(T) == 2;

// Shared memory: the f32 arrays (taps, class weights, tap-gradient sums),
// padded to 16 bytes, then the T arrays, the logits first (8-byte loads).
__host__ __device__ inline size_t bwd_float_bytes(int c) {
  return (sizeof(float) * 49 * (size_t)c + 15) / 16 * 16;
}

template <typename T>
__host__ __device__ inline size_t bwd_smem_bytes(int c) {
  const int s = bwd_stride<T>(c);
  return bwd_float_bytes(c) +
         sizeof(T) * ((kLogitCache<T> ? (size_t)c * kPos * 4 : 0) +
                      (size_t)kStage * s + (size_t)kChunk * 4 * kPos +
                      (size_t)kOwn * s);
}

// f32 -> T -> f32, round to nearest even (finite values and infinities),
// by integer operations: the same bits as __float2bfloat16_rn at the
// integer units' rate rather than the conversion unit's.
template <typename T>
__device__ __forceinline__ float rne(float v) {
  if constexpr (sizeof(T) == 2) {
    unsigned u = __float_as_uint(v);
    u += 0x7fffu + ((u >> 16) & 1u);
    return __uint_as_float(u & 0xffff0000u);
  } else {
    return v;
  }
}

template <typename T>
__device__ __forceinline__ T to_storage(float v) {
  if constexpr (sizeof(T) == 2) {
    return __ushort_as_bfloat16(
        (unsigned short)(__float_as_uint(rne<T>(v)) >> 16));
  } else {
    return v;
  }
}

// The four parity logits of one class from a 3x3 neighbourhood and the
// class's 16 taps ([parity][tap], `parity_value` of common.cuh).
template <typename T>
__device__ __forceinline__ void parity_logits(const float v[3][3],
                                              const float* tk,
                                              float out[4]) {
  float k[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 t4 = reinterpret_cast<const float4*>(tk)[q];
    k[4 * q] = t4.x;
    k[4 * q + 1] = t4.y;
    k[4 * q + 2] = t4.z;
    k[4 * q + 3] = t4.w;
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int pr = p >> 1, pc = p & 1;
    float acc = __fmul_rn(v[pr][pc], k[4 * p]);
    acc = __fadd_rn(acc, __fmul_rn(v[pr][pc + 1], k[4 * p + 1]));
    acc = __fadd_rn(acc, __fmul_rn(v[pr + 1][pc], k[4 * p + 2]));
    acc = __fadd_rn(acc, __fmul_rn(v[pr + 1][pc + 1], k[4 * p + 3]));
    out[p] = rne<T>(acc);
  }
}

// v holds bf16 values: their high halves are exact
__device__ __forceinline__ void store_logits(__nv_bfloat16* p,
                                             const float v[4]) {
  uint2 u;
  u.x = (__float_as_uint(v[0]) >> 16) | (__float_as_uint(v[1]) & 0xffff0000u);
  u.y = (__float_as_uint(v[2]) >> 16) | (__float_as_uint(v[3]) & 0xffff0000u);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void load_logits(const __nv_bfloat16* p,
                                            float v[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
head_loss_bwd_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                     const int* __restrict__ target,
                     const float* __restrict__ cw,
                     const float* __restrict__ gscale_p, T* __restrict__ dx,
                     float* __restrict__ partials, int n, int h2, int w2,
                     int c, float ls, int vec) {
  extern __shared__ float4 smem4[];
  const int stride = bwd_stride<T>(c);
  float* s_tk = reinterpret_cast<float*>(smem4);  // (C, 4 parities, 4 taps)
  float* s_cw = s_tk + 16 * c;                  // (C)
  float* s_dkp = s_cw + c;                      // (2 halves, 16, C)
  T* s_lg = reinterpret_cast<T*>(reinterpret_cast<char*>(smem4) +
                                 bwd_float_bytes(c));  // (C, kPos, 4), bf16
  T* s_x = s_lg + (kLogitCache<T> ? c * kPos * 4 : 0);  // 2-halo stage
  T* s_dz = s_x + kStage * stride;              // (kChunk, 4, kPos)
  T* s_dx = s_dz + kChunk * 4 * kPos;           // (own pixel, stride)
  const int tid = threadIdx.x;
  for (int i = tid; i < 16 * c; i += kBwdThreads)
    s_tk[(i % c) * 16 + i / c] = taps[i];
  for (int i = tid; i < c; i += kBwdThreads) s_cw[i] = cw[i];
  for (int i = tid; i < 32 * c; i += kBwdThreads) s_dkp[i] = 0.f;
  const float gscale = *gscale_p;
  const float inv_c = 1.f / (float)c;
  const int tiles_x = ceil_div(w2, kBW), tiles_y = ceil_div(h2, kBH);
  const int n_tiles = n * tiles_x * tiles_y;
  // this thread's position of the 1-halo grid (kG neighbouring lanes
  // share one, each taking every kG-th class; threads past kG kPos have
  // none)
  const int pos = tid / kG, g = tid % kG;
  const int qy = pos / kPosW, qx = pos % kPosW;
  const bool has_pos = pos < kPos;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int img = tile / (tiles_x * tiles_y);
    const int rem = tile % (tiles_x * tiles_y);
    const int y0 = (rem / tiles_x) * kBH, x0 = (rem % tiles_x) * kBW;
    __syncthreads();  // the previous tile's stage, logits, dz, dx are read
    stage_window<T, kBH + 4, kStageW, kBwdThreads>(s_x, x, img, y0, x0, 2,
                                                  h2, w2, c, stride, vec);
    // the thread's position; outside the image or with a void label its
    // weight is 0, so its dz is 0
    float m[4], se[4], wgt[4];
    int ti[4];
    const int yy = y0 - 1 + qy, xq = x0 - 1 + qx;
    const bool in_img = has_pos && yy >= 0 && yy < h2 && xq >= 0 && xq < w2;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int lab = in_img ? label_at(target, img, h2, w2, yy, xq, p) : 0;
      ti[p] = min(max(lab - 1, 0), c - 1);
      wgt[p] = lab > 0 ? gscale * s_cw[ti[p]] : 0.f;
      m[p] = __int_as_float(0xff800000);  // -inf
      se[p] = 0.f;
    }
    __syncthreads();  // the stage is complete
    const bool any = wgt[0] != 0.f || wgt[1] != 0.f || wgt[2] != 0.f ||
                     wgt[3] != 0.f;
    // the logits of class k at the thread's position
    auto logits = [&](int k, float l[4]) {
      if constexpr (kLogitCache<T>) {
        load_logits(s_lg + ((size_t)k * kPos + pos) * 4, l);
      } else {
        float v[3][3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j)
            v[i][j] = ld(s_x + ((qy + i) * kStageW + qx + j) * stride + k);
        parity_logits<T>(v, s_tk + 16 * k, l);
      }
    };
    if (any) {
      for (int k = g; k < c; k += kG) {
        float v[3][3], l[4];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j)
            v[i][j] = ld(s_x + ((qy + i) * kStageW + qx + j) * stride + k);
        parity_logits<T>(v, s_tk + 16 * k, l);
        if constexpr (kLogitCache<T>)
          store_logits(s_lg + ((size_t)k * kPos + pos) * 4, l);
#pragma unroll
        for (int p = 0; p < 4; ++p) m[p] = fmaxf(m[p], l[p]);
      }
    }
    // the lanes of a position exchange their partial max, then their
    // partial sums (a + b is b + a: both lanes hold the same bits)
#pragma unroll
    for (int p = 0; p < 4; ++p)
      m[p] = fmaxf(m[p], __shfl_xor_sync(0xffffffffu, m[p], 1));
    if (any) {
      for (int k = g; k < c; k += kG) {
        float l[4];
        logits(k, l);
#pragma unroll
        for (int p = 0; p < 4; ++p) se[p] += expf(rne<T>(l[p] - m[p]));
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
      se[p] += __shfl_xor_sync(0xffffffffu, se[p], 1);

    for (int c0 = 0; c0 < c; c0 += kChunk) {
      const int kc = min(kChunk, c - c0);
      // dz of the thread's position, the chunk's classes, four parities
      if (has_pos) {
        for (int kk = g; kk < kc; kk += kG) {
          const int k = c0 + kk;
          float l[4] = {0.f, 0.f, 0.f, 0.f};
          if (any) logits(k, l);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            float dz = 0.f;
            if (wgt[p] != 0.f) {
              const float sm = expf(rne<T>(l[p] - m[p])) / se[p];
              const float tdist =
                  (1.f - ls) * (k == ti[p] ? 1.f : 0.f) + ls * inv_c;
              dz = wgt[p] * (sm - tdist);
            }
            s_dz[(kk * 4 + p) * kPos + pos] = to_storage<T>(dz);
          }
        }
      }
      __syncthreads();
      // dx of (own pixel, class): dz_p at (y + 1 - pr - a, x + 1 - pc - b)
      for (int i = tid; i < kc * kOwn; i += kBwdThreads) {
        const int kk = i / kOwn, px = i % kOwn;
        const int ty = px / kBW, tx = px % kBW, k = c0 + kk;
        float acc = 0.f;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int pr = p >> 1, pc = p & 1;
          const T* dzp = s_dz + (kk * 4 + p) * kPos;
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              const int pos = (ty + 2 - pr - a) * kPosW + tx + 2 - pc - b;
              acc = __fadd_rn(acc, __fmul_rn(ld(dzp + pos),
                                             s_tk[16 * k + p * 4 + a * 2 + b]));
            }
        }
        s_dx[px * stride + k] = to_storage<T>(acc);
      }
      // tap gradients of (half, parity, tap, class) over the half's own
      // rows inside the image, in pixel order
      const int txn = min(kBW, w2 - x0);
      for (int i = tid; i < 2 * 16 * kc; i += kBwdThreads) {
        const int half = i / (16 * kc), j = i % (16 * kc);
        const int kk = j / 16, pt = j % 16, k = c0 + kk;
        const int p = pt / 4, tap = pt % 4;
        const int pr = p >> 1, pc = p & 1, a = tap >> 1, b = tap & 1;
        float acc = 0.f;
        for (int ty = half * (kBH / 2); ty < (half + 1) * (kBH / 2); ++ty) {
          if (y0 + ty >= h2) break;
          const T* dzp = s_dz + (kk * 4 + p) * kPos + (ty + 1) * kPosW + 1;
          const T* xp = s_x + ((ty + 1 + pr + a) * kStageW + 1 + pc + b) *
                                  stride + k;
          for (int tx = 0; tx < txn; ++tx)
            acc += ld(dzp + tx) * ld(xp + tx * stride);
        }
        s_dkp[(half * 16 + pt) * c + k] += acc;
      }
      __syncthreads();  // the chunk's dz is read
    }
    // the tile's dx, row by row (each row of the tile is contiguous)
    for (int i = tid; i < kOwn * c; i += kBwdThreads) {
      const int pix = i / c, k = i % c;
      const int yy2 = y0 + pix / kBW, xq2 = x0 + pix % kBW;
      if (yy2 < h2 && xq2 < w2)
        dx[(((size_t)img * h2 + yy2) * w2 + xq2) * c + k] =
            s_dx[pix * stride + k];
    }
  }
  __syncthreads();
  for (int i = tid; i < 16 * c; i += kBwdThreads) {
    const int pt = i / c, k = i % c;  // dkp row layout (parity, tap, C)
    partials[(size_t)blockIdx.x * 16 * c + i] =
        s_dkp[pt * c + k] + s_dkp[(16 + pt) * c + k];
  }
}

// ---- forward ----------------------------------------------------------
//
// Redesigned for the H100. The first design (one 4 x 32 tile per block,
// one thread per pixel looping over the parities at run time) indexed the
// 3x3 neighbourhood with a run-time parity, so it lived in a 72-byte
// stack frame, and rebuilt it from shared memory for every class in both
// passes. Now a persistent grid walks 8 x 32 tiles of half-res pixels in a
// fixed order, a fixed number of blocks per device, type and C, one
// thread per half-res position. Per tile:
// (1) the tile and its 1-pixel halo (10 x 34 pixels, all C classes) are
//     staged in the storage type T, 16-byte loads where C allows, with an
//     odd number of 4-byte words per pixel (the 32 positions of a warp hit
//     distinct banks); the taps are kept class-major and read as float4;
// (2) pass 1, per class: the 3x3 neighbourhood is loaded once and gives
//     all four parity logits (compile-time parities: no register array is
//     indexed at run time, and ptxas gives the kernel no stack frame),
//     rounded to T as the TPU kernel rounds them; the thread keeps their
//     max, the target logit and the logit sum. In bf16 the logits are kept
//     in shared memory, 8 bytes per position and class;
// (3) pass 2, per class: the sum of exp(round_T(logit - max)), from the
//     kept logits in bf16, recomputed in f32 (the rounding points of the
//     reference rule out an online softmax);
// (4) the thread adds w nll and w of its labelled parities to its running
//     sums. A position whose four labels are void skips both passes.
// At the end each block adds its threads' sums in a fixed order and writes
// one (sum w nll, sum w) row; `reduce_rows` adds the rows in a fixed
// order, so two calls give the same bits.
constexpr int kFH = 8, kFW = 32;           // own tile
constexpr int kFOwn = kFH * kFW;           // positions, one thread each
constexpr int kFwdThreads = kFOwn;
constexpr int kFStageW = kFW + 2;          // 1-halo stage: 10 x 34
constexpr int kFStage = (kFH + 2) * kFStageW;

// Shared memory: the f32 taps and class weights, padded to 16 bytes, then
// the kept logits (bf16) and the stage, in T.
__host__ __device__ inline size_t fwd_float_bytes(int c) {
  return (sizeof(float) * 17 * (size_t)c + 15) / 16 * 16;
}

template <typename T>
__host__ __device__ inline size_t fwd_smem_bytes(int c) {
  return fwd_float_bytes(c) +
         sizeof(T) * ((kLogitCache<T> ? (size_t)c * kFOwn * 4 : 0) +
                      (size_t)kFStage * bwd_stride<T>(c));
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
head_loss_fwd_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                     const int* __restrict__ target,
                     const float* __restrict__ cw,
                     float* __restrict__ partials, int n, int h2, int w2,
                     int c, float ls, int vec) {
  extern __shared__ float4 smem4[];
  __shared__ float s_red[2][kFwdThreads / 32];
  const int stride = bwd_stride<T>(c);
  float* s_tk = reinterpret_cast<float*>(smem4);  // (C, 4 parities, 4 taps)
  float* s_cw = s_tk + 16 * c;                  // (C)
  T* s_lg = reinterpret_cast<T*>(reinterpret_cast<char*>(smem4) +
                                 fwd_float_bytes(c));  // (C, kFOwn, 4)
  T* s_x = s_lg + (kLogitCache<T> ? c * kFOwn * 4 : 0);  // 1-halo stage
  const int tid = threadIdx.x;
  for (int i = tid; i < 16 * c; i += kFwdThreads)
    s_tk[(i % c) * 16 + i / c] = taps[i];
  for (int i = tid; i < c; i += kFwdThreads) s_cw[i] = cw[i];
  const float inv_c = 1.f / (float)c;
  const int tiles_x = ceil_div(w2, kFW), tiles_y = ceil_div(h2, kFH);
  const int n_tiles = n * tiles_x * tiles_y;
  const int ty = tid / kFW, tx = tid % kFW;
  // the neighbourhood of the thread's position starts at stage (ty, tx)
  const T* sx = s_x + (ty * kFStageW + tx) * stride;
  T* lg = s_lg + (size_t)tid * 4;  // class k at lg + k kFOwn 4
  float wnll = 0.f, wsum = 0.f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int img = tile / (tiles_x * tiles_y);
    const int rem = tile % (tiles_x * tiles_y);
    const int y0 = (rem / tiles_x) * kFH, x0 = (rem % tiles_x) * kFW;
    __syncthreads();  // the previous tile's stage and logits are read
    stage_window<T, kFH + 2, kFStageW, kFwdThreads>(s_x, x, img, y0, x0, 1,
                                                    h2, w2, c, stride, vec);
    const int y = y0 + ty, xq = x0 + tx;
    const bool in_img = y < h2 && xq < w2;
    int lab[4], ti[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      lab[p] = in_img ? label_at(target, img, h2, w2, y, xq, p) : 0;
      ti[p] = min(max(lab[p] - 1, 0), c - 1);
    }
    __syncthreads();  // the stage is complete
    if (lab[0] <= 0 && lab[1] <= 0 && lab[2] <= 0 && lab[3] <= 0) continue;
    float m[4], tg[4], sum[4], se[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      m[p] = __int_as_float(0xff800000);  // -inf
      tg[p] = sum[p] = se[p] = 0.f;
    }
    for (int k = 0; k < c; ++k) {
      float v[3][3], l[4];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          v[i][j] = ld(sx + (i * kFStageW + j) * stride + k);
      parity_logits<T>(v, s_tk + 16 * k, l);
      if constexpr (kLogitCache<T>) store_logits(lg + (size_t)k * kFOwn * 4, l);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        m[p] = fmaxf(m[p], l[p]);
        sum[p] += l[p];
        tg[p] = k == ti[p] ? l[p] : tg[p];
      }
    }
    for (int k = 0; k < c; ++k) {
      float l[4];
      if constexpr (kLogitCache<T>) {
        load_logits(lg + (size_t)k * kFOwn * 4, l);
      } else {
        float v[3][3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j)
            v[i][j] = ld(sx + (i * kFStageW + j) * stride + k);
        parity_logits<T>(v, s_tk + 16 * k, l);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) se[p] += expf(rne<T>(l[p] - m[p]));
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (lab[p] <= 0) continue;  // void: weight 0
      const float logz = m[p] + logf(se[p]);
      float nll = logz - tg[p];
      if (ls > 0.f)
        nll = (1.f - ls) * nll + ls * (logz - sum[p] * inv_c);
      const float wv = s_cw[ti[p]];
      wnll += wv * nll;
      wsum += wv;
    }
  }
  wnll = warp_sum(wnll);
  wsum = warp_sum(wsum);
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) {
    s_red[0][warp] = wnll;
    s_red[1][warp] = wsum;
  }
  __syncthreads();
  if (tid < 2) {
    float acc = 0.f;
    for (int i = 0; i < kFwdThreads / 32; ++i) acc += s_red[tid][i];
    partials[(size_t)blockIdx.x * 2 + tid] = acc;
  }
}

// Blocks of a persistent grid: as many as fit on the card at once, a
// fixed number per device, kernel and C (`per_sm` caches it per C).
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, size_t smem, int* per_sm,
                    int c, int tiles) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (per_sm[c] == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[c], kernel,
                                                  threads, smem);
    if (per_sm[c] < 1) per_sm[c] = 1;
  }
  const int slots = sms * per_sm[c];
  return tiles < slots ? tiles : slots;
}

inline int n_fwd_tiles(int n, int h2, int w2) {
  return n * ceil_div(h2, kFH) * ceil_div(w2, kFW);
}

template <typename T>
int launch_loss_fwd(int n, int h2, int w2, int c, float ls, const void* x,
                    const void* taps, const void* target, const void* cw,
                    void* sums, float* work, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<T>(c);
  const cudaError_t attr = cudaFuncSetAttribute(
      head_loss_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  static int per_sm[kMaxLossClasses + 1] = {0};
  const int blocks = resident_blocks(head_loss_fwd_kernel<T>, kFwdThreads,
                                     smem, per_sm, c, n_fwd_tiles(n, h2, w2));
  const int vec = c % (16 / (int)sizeof(T)) == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  head_loss_fwd_kernel<T><<<blocks, kFwdThreads, smem, stream>>>(
      (const T*)x, (const float*)taps, (const int*)target, (const float*)cw,
      work, n, h2, w2, c, ls, vec);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return reduce_rows(work, (float*)sums, work + (size_t)blocks * 2, blocks,
                     2, stream);
}

template <typename T>
int launch_loss_bwd(int n, int h2, int w2, int c, float ls, const void* x,
                    const void* taps, const void* target, const void* cw,
                    const void* gscale, void* dx, void* dkp, float* work,
                    cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<T>(c);
  const cudaError_t attr = cudaFuncSetAttribute(
      head_loss_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  static int per_sm[kMaxLossClasses + 1] = {0};
  const int blocks =
      resident_blocks(head_loss_bwd_kernel<T>, kBwdThreads, smem, per_sm, c,
                      n * ceil_div(h2, kBH) * ceil_div(w2, kBW));
  const int vec = c % (16 / (int)sizeof(T)) == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  head_loss_bwd_kernel<T><<<blocks, kBwdThreads, smem, stream>>>(
      (const T*)x, (const float*)taps, (const int*)target, (const float*)cw,
      (const float*)gscale, (T*)dx, work, n, h2, w2, c, ls, vec);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return reduce_rows(work, (float*)dkp, work + (size_t)blocks * 16 * c,
                     blocks, 16 * c, stream);
}

}  // namespace emsanet

// Workspace floats of one call (the backward's is the larger).
extern "C" int semantic_train_head_workspace(int n, int h2, int w2, int c) {
  using namespace emsanet;
  const int bwd_rows = n * ceil_div(h2, kBH) * ceil_div(w2, kBW);
  const int rows = n_fwd_tiles(n, h2, w2);
  return ((rows > bwd_rows ? rows : bwd_rows) + kReduceSplits) * 16 * c;
}

// sums (2) f32: sum w nll, sum w. C in [1, 64]; the wrapper checks shapes.
extern "C" int semantic_train_head_fwd_launch(int dtype, int n, int h2,
                                              int w2, int c, float ls,
                                              const void* x, const void* taps,
                                              const void* target,
                                              const void* cw, void* sums,
                                              void* work, void* stream) {
  using namespace emsanet;
  if (c < 1 || c > kMaxLossClasses) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_loss_fwd<__nv_bfloat16>(n, h2, w2, c, ls, x, taps, target,
                                          cw, sums, (float*)work, s);
  return launch_loss_fwd<float>(n, h2, w2, c, ls, x, taps, target, cw, sums,
                                (float*)work, s);
}

// dx like x; dkp (4, 4, C) f32, the polyphase taps' weight gradients.
extern "C" int semantic_train_head_bwd_launch(
    int dtype, int n, int h2, int w2, int c, float ls, const void* x,
    const void* taps, const void* target, const void* cw, const void* gscale,
    void* dx, void* dkp, void* work, void* stream) {
  using namespace emsanet;
  if (c < 1 || c > kMaxLossClasses) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_loss_bwd<__nv_bfloat16>(n, h2, w2, c, ls, x, taps, target,
                                          cw, gscale, dx, dkp, (float*)work,
                                          s);
  return launch_loss_bwd<float>(n, h2, w2, c, ls, x, taps, target, cw,
                                gscale, dx, dkp, (float*)work, s);
}
