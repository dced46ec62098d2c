// Semantic decode: the final learned x2 upsample of the semantic head
// (nearest x2 + zero-padded depthwise 3x3, in its polyphase form) fused
// with the per-pixel class argmax and max-softmax score.
//
// Replaces the TPU kernel `emsanet_tpu/ops/semantic_decode.py`
// (`_decode_kernel`; pl.pallas_call at :311 in
// `semantic_decode_fused_planes` and at :398 in
// `semantic_decode_fused_interleaved`).
//
// What bounds it on the H100: bytes. It reads the (N, H/2, W/2, C) head
// output once and writes an int32 index and an f32 score per full-res
// pixel (b8 640x480, C = 40, bf16: 49 MB in, 20 MB out); it does ~25
// operations per input element. The design keeps the (N, H, W, C)
// upsampled logits out of device memory: a block stages a 4x32 tile of
// half-res pixels with its 1-pixel halo in shared memory (common.cuh),
// and each thread computes all four output parities of every class of
// its pixel there; the reductions run in registers. Two passes over the
// classes: max and argmax first, then the sum of exp(v - max); the second
// pass recomputes the parity values instead of keeping 4 C of them in
// registers. Up to kMaxChunk classes are staged at once, so the usual
// class counts (19 to 40) are read from device memory once; more classes
// are staged chunk by chunk, once per pass.
//
// Numerics, as the TPU kernel: the four taps are summed in f32 in its
// order, the sum is rounded to the storage type before the argmax and
// the exp (so a bf16 argmax matches the unfused conv's), the difference
// v - max is taken in f32, the first maximum wins, score = 1 / sumexp.
//
// Layouts: x (N, H2, W2, C) f32 or bf16; taps (4, 4, C) f32 (see
// common.cuh); outputs idx int32 and score f32, either as parity planes
// (N, 4, H2, W2), parity p*2+q, or interleaved (N, 2 H2, 2 W2).

#include "common.cuh"

namespace emsanet {

constexpr int kMaxDecodeClasses = 512;
constexpr int kMaxChunk = 48;  // staged classes: 6 * 34 * 49 floats, 40 KB

inline size_t decode_smem_bytes(int c) {
  const int chunk = c < kMaxChunk ? c : kMaxChunk;
  return sizeof(float) * (16 * c + kHaloH * kHaloW * tile_stride(chunk));
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
semantic_decode_kernel(const T* __restrict__ x,
                       const float* __restrict__ taps, int* __restrict__ idx,
                       float* __restrict__ score, int h2, int w2, int c,
                       int interleaved) {
  extern __shared__ float smem[];
  float* s_taps = smem;           // (4, 4, C)
  float* s_x = smem + 16 * c;     // the staged chunk of classes
  for (int i = threadIdx.x; i < 16 * c; i += kTileThreads) s_taps[i] = taps[i];
  const int tx = threadIdx.x % kTileW, ty = threadIdx.x / kTileW;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int img = blockIdx.z;
  const int xx = x0 + tx, y = y0 + ty;
  const bool inside = xx < w2 && y < h2;
  const int chunk = c < kMaxChunk ? c : kMaxChunk;
  const int stride = tile_stride(chunk);

  float best[4], sum[4] = {0.f, 0.f, 0.f, 0.f};
  int arg[4];
  for (int pass = 0; pass < 2; ++pass) {
    for (int c0 = 0; c0 < c; c0 += chunk) {
      const int cc = c - c0 < chunk ? c - c0 : chunk;
      if (pass == 0 || chunk < c) {  // one chunk serves both passes
        __syncthreads();  // the previous chunk has been read
        stage_tile(s_x, x, img, y0, x0, h2, w2, c, c0, cc, stride);
        __syncthreads();
      }
      if (!inside) continue;
      for (int k = 0; k < cc; ++k) {
        const int ch = c0 + k;
        float v[3][3];
        tile_neighbourhood(s_x, stride, ty, tx, k, v);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float s = parity_value<T>(v, s_taps + ch, c, p);
          if (pass == 1) {
            sum[p] += expf(s - best[p]);
          } else if (ch == 0 || s > best[p]) {
            best[p] = s;
            arg[p] = ch;
          }
        }
      }
    }
  }
  if (!inside) return;

  if (interleaved) {
    // row 2y+pr, columns 2xx and 2xx+1: one 8-byte store each
    const int ww = 2 * w2;
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      const size_t o = ((size_t)img * 2 * h2 + 2 * y + pr) * ww + 2 * xx;
      *reinterpret_cast<int2*>(idx + o) = make_int2(arg[2 * pr],
                                                    arg[2 * pr + 1]);
      *reinterpret_cast<float2*>(score + o) =
          make_float2(1.f / sum[2 * pr], 1.f / sum[2 * pr + 1]);
    }
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const size_t o = (((size_t)img * 4 + p) * h2 + y) * w2 + xx;
      idx[o] = arg[p];
      score[o] = 1.f / sum[p];
    }
  }
}

template <typename T>
int launch_decode(int n, int h2, int w2, int c, int interleaved,
                  const void* x, const void* taps, void* idx, void* score,
                  cudaStream_t stream) {
  const size_t smem = decode_smem_bytes(c);  // up to 72 KB at 512 classes
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        semantic_decode_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(ceil_div(w2, kTileW), ceil_div(h2, kTileH), n);
  semantic_decode_kernel<T><<<grid, kTileThreads, smem, stream>>>(
      (const T*)x, (const float*)taps, (int*)idx, (float*)score, h2, w2, c,
      interleaved);
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
