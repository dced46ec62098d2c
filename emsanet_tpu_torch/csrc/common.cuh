// Shared helpers of the hand-written kernels: element load/store between
// the storage type (float or bf16) and the float32 compute type, and the
// dtype codes the Python wrappers pass (0 = float32, 1 = bfloat16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace emsanet {

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Round a float32 value to the storage type and back (the rounding the
// unfused path applies when it writes an intermediate in that type).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Deterministic column sums of a (rows, cols) f32 array of per-block
// partials, for the kernels whose TPU versions accumulate across a
// sequential grid (the train kernels). Two passes, each summing its rows
// in a fixed order: (rows, cols) -> (splits, cols) in `tmp` -> (cols).
constexpr int kReduceSplits = 64;

static __global__ void reduce_rows_kernel(const float* __restrict__ in,
                                          float* __restrict__ out, int rows,
                                          int cols, int splits) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  float acc = 0.f;
  for (int r = blockIdx.y; r < rows; r += splits)
    acc += in[(size_t)r * cols + col];
  out[(size_t)blockIdx.y * cols + col] = acc;
}

// tmp holds kReduceSplits * cols floats.
inline int reduce_rows(const float* in, float* out, float* tmp, int rows,
                       int cols, cudaStream_t stream) {
  const int splits = rows < kReduceSplits ? rows : kReduceSplits;
  reduce_rows_kernel<<<dim3(ceil_div(cols, 128), splits), 128, 0, stream>>>(
      in, tmp, rows, cols, splits);
  reduce_rows_kernel<<<dim3(ceil_div(cols, 128), 1), 128, 0, stream>>>(
      tmp, out, splits, cols, 1);
  return (int)cudaGetLastError();
}

// The final learned x2 stage (nearest x2 + zero-padded depthwise 3x3) in
// its polyphase form, for the kernels that fuse it with their consumer
// (semantic_decode.cu, instance_head.cu). Output parity p = pr*2 + pc of
// half-res pixel (y, x) is full-res pixel (2y+pr, 2x+pc). It reads the
// four inputs at rows y-1+pr+{0,1} and columns x-1+pc+{0,1}, each with
// its own parity weight; the other five taps of the 3x3 are zero.
//
// Input x is NHWC (N, H2, W2, C). The parity weights are (4 parities,
// 4 taps, C) f32, tap t = a*2 + b for row y-1+pr+a and column x-1+pc+b:
// the order in which the TPU kernel accumulates them.
//
// A block owns a kTileH x kTileW tile of half-res pixels of one image,
// one thread each (thread t: row t / kTileW, column t % kTileW). It
// stages the tile's (kTileH+2) x (kTileW+2) input neighbourhood, for a
// chunk of channels, in shared memory as f32, with zeros outside the
// image (the zero padding). The staging reads contiguous NHWC rows, so
// the global loads are coalesced; each staged pixel takes an odd number
// of words, so the 32 pixels of a warp read 32 different banks.
constexpr int kTileW = 32, kTileH = 4;
constexpr int kTileThreads = kTileW * kTileH;
constexpr int kHaloW = kTileW + 2, kHaloH = kTileH + 2;

// Words per staged pixel for a chunk of `cc` channels (odd).
__host__ __device__ inline int tile_stride(int cc) { return cc | 1; }

// Stage channels [c0, c0 + cc) of the tile at (y0, x0) of image img.
template <typename T>
__device__ __forceinline__ void stage_tile(float* s, const T* x, int img,
                                           int y0, int x0, int h2, int w2,
                                           int c, int c0, int cc,
                                           int stride) {
  const int total = kHaloH * kHaloW * cc;
  for (int i = threadIdx.x; i < total; i += kTileThreads) {
    const int ch = i % cc, pix = i / cc;
    const int r = y0 - 1 + pix / kHaloW, q = x0 - 1 + pix % kHaloW;
    float v = 0.f;
    if (r >= 0 && r < h2 && q >= 0 && q < w2) {
      v = ld(x + (((size_t)img * h2 + r) * w2 + q) * c + c0 + ch);
    }
    s[pix * stride + ch] = v;
  }
}

// The 3x3 neighbourhood of the thread's pixel (ty, tx), staged channel k.
__device__ __forceinline__ void tile_neighbourhood(const float* s,
                                                   int stride, int ty,
                                                   int tx, int k,
                                                   float v[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      v[i][j] = s[((ty + i) * kHaloW + tx + j) * stride + k];
    }
  }
}

// Parity p's value of one channel, summed in f32 in the TPU kernel's tap
// order, without FMA contraction, then rounded to the storage type T (the
// type in which the unfused path writes the conv output).
template <typename T>
__device__ __forceinline__ float parity_value(const float v[3][3],
                                              const float* taps, int c,
                                              int p) {
  const int pr = p >> 1, pc = p & 1;
  const float* k = taps + (size_t)p * 4 * c;
  float acc = __fmul_rn(v[pr][pc], k[0]);
  acc = __fadd_rn(acc, __fmul_rn(v[pr][pc + 1], k[c]));
  acc = __fadd_rn(acc, __fmul_rn(v[pr + 1][pc], k[2 * c]));
  acc = __fadd_rn(acc, __fmul_rn(v[pr + 1][pc + 1], k[3 * c]));
  return round_to<T>(acc);
}

}  // namespace emsanet
