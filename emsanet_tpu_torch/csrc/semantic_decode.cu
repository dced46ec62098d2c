// Semantic decode: the final learned x2 upsample of the semantic head
// (nearest x2 + zero-padded depthwise 3x3, in its polyphase form) fused
// with the per-pixel class argmax and max-softmax score.
//
// Replaces the TPU kernel `emsanet_tpu/ops/semantic_decode.py`
// (`_decode_kernel`; pl.pallas_call at :311 in
// `semantic_decode_fused_planes` and at :398 in
// `semantic_decode_fused_interleaved`).
//
// What bounds it on the H100: bytes, in principle. It reads the (N, H/2,
// W/2, C) head output once and writes an int32 index and an f32 score per
// full-res pixel (b8 640x480, C = 40, bf16: 49 MB in, 20 MB out); the
// (N, H, W, C) upsampled logits never reach device memory. In practice it
// is bound by instructions, ~70 per half-res pixel and class, so the
// design spends as few as it can on shared memory:
// - a block owns 8 x 32 half-res pixels, and each thread two horizontal
//   neighbours, whose 3 x 4 input neighbourhood serves both;
// - the classes are staged 8 at a time (a compile-time chunk), one 16-byte
//   vector (bf16; two in f32) per pixel and chunk, by cp.async with two
//   buffers, so the next chunk's loads overlap this chunk's arithmetic.
//   Every class is read from device memory once, whatever C (up to 512).
//   The even and odd columns of the staged window are stored apart, so
//   the 12 vector loads of a warp hit distinct banks. Per half-res pixel
//   and class that is 0.75 shared loads of the neighbourhood and 2
//   (broadcast) loads of the 16 taps, which are kept class-major in f32;
// - one pass: the max, its argmax and the sum of exp run online. When a
//   class raises the max, the sum is rescaled by exp(old - new): one exp
//   per class and parity, as in two passes, and no parity value is kept
//   or recomputed.
//
// Numerics, as the TPU kernel: the four taps are summed in f32 in its
// order (in bf16 the products of bf16 values are exact in f32, so a fused
// multiply-add gives the same sums), the sum is rounded to the storage
// type before the argmax and the exp (so a bf16 argmax matches the
// unfused conv's), the difference v - max is taken in f32, the first
// maximum wins, score = 1 / sumexp. The online sum differs from a
// two-pass sum by a few f32 roundings per raise of the max; bf16 takes
// exp2 of the hardware approximation, f32 `expf`.
//
// Layouts: x (N, H2, W2, C) f32 or bf16; taps (4, 4, C) f32 (see
// common.cuh); outputs idx int32 and score f32, either as parity planes
// (N, 4, H2, W2), parity p*2+q, or interleaved (N, 2 H2, 2 W2).

#include <cstdint>

#include "conv_tc.cuh"

namespace emsanet {

constexpr int kMaxDecodeClasses = 512;
constexpr int kDH = 8, kDW = 32;               // half-res pixels per block
constexpr int kDThreads = kDH * kDW / 2;       // two pixels per thread
constexpr int kDTW = kDW / 2;                  // threads per tile row
constexpr int kDHH = kDH + 2, kDHW = kDW + 2;  // staged window: 10 x 34
constexpr int kDHalf = kDHW / 2;               // its columns of one parity
constexpr int kDChunk = 8;                     // classes per stage

// Staged pixel (row r, column q) of the window: even columns first, then
// odd, so thread tx's columns 2tx .. 2tx+3 are 16-byte slots tx, tx of
// the odd half, tx + 1, tx + 1 of the odd half.
__device__ __forceinline__ int stage_slot(int r, int q) {
  return r * kDHW + (q & 1) * kDHalf + (q >> 1);
}

template <typename T>
constexpr int kChunkBytes = kDChunk * (int)sizeof(T);  // per staged pixel

template <typename T>
constexpr int kStageBytes = kDHH * kDHW * kChunkBytes<T>;

inline size_t decode_smem_bytes(int c, int t_size) {
  return sizeof(float) * 16 * (size_t)c +
         2 * (size_t)kDHH * kDHW * kDChunk * t_size;
}

// Stage classes [c0, c0 + 8) of the window at (y0 - 1, x0 - 1) of image
// img into buf; classes past C and pixels outside the image are zero.
// vec: C a multiple of the 16-byte vector and x 16-byte aligned, so whole
// vectors are copied by cp.async; else element by element.
template <typename T>
__device__ __forceinline__ void stage_chunk(unsigned char* buf, const T* x,
                                            int img, int y0, int x0, int h2,
                                            int w2, int c, int c0, int vec) {
  constexpr int V = 16 / (int)sizeof(T);      // elements per vector
  constexpr int NV = kDChunk / V;             // vectors per staged pixel
  if (vec) {
    for (int i = threadIdx.x; i < kDHH * kDHW * NV; i += kDThreads) {
      const int v = i % NV, pix = i / NV;
      const int r = pix / kDHW, q = pix % kDHW;
      const int gy = y0 - 1 + r, gx = x0 - 1 + q;
      const bool ok = gy >= 0 && gy < h2 && gx >= 0 && gx < w2 &&
                      c0 + v * V < c;
      const T* src = ok ? x + (((size_t)img * h2 + gy) * w2 + gx) * c + c0 +
                              v * V
                        : x;
      cp_async16(buf + stage_slot(r, q) * kChunkBytes<T> + v * 16, src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kDHH * kDHW * kDChunk; i += kDThreads) {
      const int e = i % kDChunk, pix = i / kDChunk;
      const int r = pix / kDHW, q = pix % kDHW;
      const int gy = y0 - 1 + r, gx = x0 - 1 + q;
      T val = T(0.f);
      if (gy >= 0 && gy < h2 && gx >= 0 && gx < w2 && c0 + e < c)
        val = x[(((size_t)img * h2 + gy) * w2 + gx) * c + c0 + e];
      reinterpret_cast<T*>(buf + stage_slot(r, q) * kChunkBytes<T>)[e] = val;
    }
  }
}

// f32 -> storage type -> f32, round to nearest even (one conversion
// instruction: on the H100 this took the b8 decode from 0.101 to 0.091 ms
// against the integer form u + 0x7fff + bit 16).
template <typename T>
__device__ __forceinline__ float round_storage(float v) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Parity p of neighbourhood column offset px (0 or 1) from the 3 x 4
// neighbourhood nb and the class's taps k[p][tap], in the TPU kernel's
// order, rounded to T.
template <typename T, int PX, int P>
__device__ __forceinline__ float parity_sum(const float (&nb)[3][4],
                                            const float (&k)[16]) {
  constexpr int pr = P >> 1, pc = P & 1;
  const float v0 = nb[pr][PX + pc], v1 = nb[pr][PX + pc + 1];
  const float v2 = nb[pr + 1][PX + pc], v3 = nb[pr + 1][PX + pc + 1];
  float acc;
  if constexpr (sizeof(T) == 2) {  // exact products: fma is the same sum
    acc = __fmul_rn(v0, k[4 * P]);
    acc = __fmaf_rn(v1, k[4 * P + 1], acc);
    acc = __fmaf_rn(v2, k[4 * P + 2], acc);
    acc = __fmaf_rn(v3, k[4 * P + 3], acc);
  } else {
    acc = __fmul_rn(v0, k[4 * P]);
    acc = __fadd_rn(acc, __fmul_rn(v1, k[4 * P + 1]));
    acc = __fadd_rn(acc, __fmul_rn(v2, k[4 * P + 2]));
    acc = __fadd_rn(acc, __fmul_rn(v3, k[4 * P + 3]));
  }
  return round_storage<T>(acc);
}

// Online max / argmax / sum of exp(v - max) for one more class.
template <typename T>
__device__ __forceinline__ void online(float s, int k, float& m, float& se,
                                       int& arg) {
  const float d = s - m;
  const bool up = d > 0.f;  // the first maximum wins
  float e;
  if constexpr (sizeof(T) == 2)
    e = ex2_approx(-fabsf(d) * 1.4426950408889634f);
  else
    e = expf(-fabsf(d));
  se = fmaf(se, up ? e : 1.f, up ? 1.f : e);
  m = up ? s : m;
  arg = up ? k : arg;
}

template <typename T>
__global__ void __launch_bounds__(kDThreads)
semantic_decode_kernel(const T* __restrict__ x,
                       const float* __restrict__ taps, int* __restrict__ idx,
                       float* __restrict__ score, int h2, int w2, int c,
                       int interleaved, int vec) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int NV = kDChunk / V;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_tk = reinterpret_cast<float*>(smem);  // (C, 4 parities, 4 taps)
  unsigned char* s_buf = smem + sizeof(float) * 16 * (size_t)c;
  for (int i = threadIdx.x; i < 16 * c; i += kDThreads)
    s_tk[(i % c) * 16 + i / c] = taps[i];
  const int tx = threadIdx.x % kDTW, ty = threadIdx.x / kDTW;
  const int x0 = blockIdx.x * kDW, y0 = blockIdx.y * kDH;
  const int img = blockIdx.z;
  const int y = y0 + ty, xa = x0 + 2 * tx;  // pixels (y, xa), (y, xa + 1)

  float m[2][4], se[2][4];
  int arg[2][4];
#pragma unroll
  for (int px = 0; px < 2; ++px)
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      m[px][p] = __int_as_float(0xff800000);  // -inf: the first class raises
      se[px][p] = 0.f;
      arg[px][p] = 0;
    }

  const int n_chunks = ceil_div(c, kDChunk);
  stage_chunk<T>(s_buf, x, img, y0, x0, h2, w2, c, 0, vec);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      stage_chunk<T>(s_buf + ((ch + 1) & 1) * kStageBytes<T>, x, img, y0, x0,
                     h2, w2, c, (ch + 1) * kDChunk, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the chunk (and, the first time, the taps) is staged
    const unsigned char* buf = s_buf + (ch & 1) * kStageBytes<T>;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      uint4 nb4[3][4];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          nb4[i][j] = *reinterpret_cast<const uint4*>(
              buf + stage_slot(ty + i, 2 * tx + j) * kChunkBytes<T> + v * 16);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int k = ch * kDChunk + v * V + e;
        if (k >= c) break;
        float kt[16];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 t4 = reinterpret_cast<const float4*>(s_tk + 16 * k)[q];
          kt[4 * q] = t4.x;
          kt[4 * q + 1] = t4.y;
          kt[4 * q + 2] = t4.z;
          kt[4 * q + 3] = t4.w;
        }
        // element e of every staged vector (e is a compile-time constant
        // after unrolling)
        float nb[3][4];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const unsigned w4[4] = {nb4[i][j].x, nb4[i][j].y, nb4[i][j].z,
                                    nb4[i][j].w};
            if constexpr (sizeof(T) == 2) {
              const unsigned word = w4[e >> 1];
              nb[i][j] = __uint_as_float(e & 1 ? word & 0xffff0000u
                                               : word << 16);
            } else {
              nb[i][j] = __uint_as_float(w4[e]);
            }
          }
        online<T>(parity_sum<T, 0, 0>(nb, kt), k, m[0][0], se[0][0], arg[0][0]);
        online<T>(parity_sum<T, 0, 1>(nb, kt), k, m[0][1], se[0][1], arg[0][1]);
        online<T>(parity_sum<T, 0, 2>(nb, kt), k, m[0][2], se[0][2], arg[0][2]);
        online<T>(parity_sum<T, 0, 3>(nb, kt), k, m[0][3], se[0][3], arg[0][3]);
        online<T>(parity_sum<T, 1, 0>(nb, kt), k, m[1][0], se[1][0], arg[1][0]);
        online<T>(parity_sum<T, 1, 1>(nb, kt), k, m[1][1], se[1][1], arg[1][1]);
        online<T>(parity_sum<T, 1, 2>(nb, kt), k, m[1][2], se[1][2], arg[1][2]);
        online<T>(parity_sum<T, 1, 3>(nb, kt), k, m[1][3], se[1][3], arg[1][3]);
      }
    }
    __syncthreads();  // this buffer is read before the stage after next
  }
  if (y >= h2 || xa >= w2) return;

  const bool pair = xa + 1 < w2 && w2 % 2 == 0;  // both pixels, aligned
  if (interleaved) {
    // row 2y + pr, columns 2 xa .. 2 xa + 3
    const int ww = 2 * w2;
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      const size_t o = ((size_t)img * 2 * h2 + 2 * y + pr) * ww + 2 * xa;
      if (pair) {
        *reinterpret_cast<int4*>(idx + o) =
            make_int4(arg[0][2 * pr], arg[0][2 * pr + 1], arg[1][2 * pr],
                      arg[1][2 * pr + 1]);
        *reinterpret_cast<float4*>(score + o) =
            make_float4(1.f / se[0][2 * pr], 1.f / se[0][2 * pr + 1],
                        1.f / se[1][2 * pr], 1.f / se[1][2 * pr + 1]);
      } else {
#pragma unroll
        for (int px = 0; px < 2; ++px) {
          if (xa + px >= w2) break;
#pragma unroll
          for (int pc = 0; pc < 2; ++pc) {
            idx[o + 2 * px + pc] = arg[px][2 * pr + pc];
            score[o + 2 * px + pc] = 1.f / se[px][2 * pr + pc];
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const size_t o = (((size_t)img * 4 + p) * h2 + y) * w2 + xa;
      if (pair) {
        *reinterpret_cast<int2*>(idx + o) = make_int2(arg[0][p], arg[1][p]);
        *reinterpret_cast<float2*>(score + o) =
            make_float2(1.f / se[0][p], 1.f / se[1][p]);
      } else {
#pragma unroll
        for (int px = 0; px < 2; ++px) {
          if (xa + px >= w2) break;
          idx[o + px] = arg[px][p];
          score[o + px] = 1.f / se[px][p];
        }
      }
    }
  }
}

template <typename T>
int launch_decode(int n, int h2, int w2, int c, int interleaved,
                  const void* x, const void* taps, void* idx, void* score,
                  cudaStream_t stream) {
  const size_t smem = decode_smem_bytes(c, (int)sizeof(T));
  if (smem > 48 * 1024) {  // 54 KB at 512 classes in f32
    const cudaError_t err = cudaFuncSetAttribute(
        semantic_decode_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec = c % (16 / (int)sizeof(T)) == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  dim3 grid(ceil_div(w2, kDW), ceil_div(h2, kDH), n);
  semantic_decode_kernel<T><<<grid, kDThreads, smem, stream>>>(
      (const T*)x, (const float*)taps, (int*)idx, (float*)score, h2, w2, c,
      interleaved, vec);
  return (int)cudaGetLastError();
}

}  // namespace emsanet

// c must be in [1, 512]; the wrapper checks it and the shapes.
extern "C" int semantic_decode_launch(int dtype, int n, int h2, int w2,
                                      int c, int interleaved, const void* x,
                                      const void* taps, void* idx,
                                      void* score, void* stream) {
  using namespace emsanet;
  if (c < 1 || c > kMaxDecodeClasses) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    return launch_decode<__nv_bfloat16>(n, h2, w2, c, interleaved, x, taps,
                                        idx, score, s);
  }
  return launch_decode<float>(n, h2, w2, c, interleaved, x, taps, idx, score,
                              s);
}
