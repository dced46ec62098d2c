// Instance head: the final learned x2 upsample of the instance head
// (nearest x2 + zero-padded depthwise 3x3, in its polyphase form) fused
// with the per-channel output encode: sigmoid for the center, tanh for
// the offsets, identity for the orientation (as the ENC_* codes say).
//
// Replaces the TPU kernel `emsanet_tpu/ops/instance_head.py`
// (`_head_kernel`; pl.pallas_call at :289 in `instance_head_upsample`
// and at :375 in `instance_head_upsample_interleaved`).
//
// What bounds it on the H100: bytes. C <= 8 channels (5 with
// orientation) are read once at half resolution and written as f32 at
// full resolution (b8 640x480 bf16: 6 MB in, 49 MB out). A block stages
// a 4x32 tile of half-res pixels with its 1-pixel halo, all channels, in
// shared memory (common.cuh); one thread per half-res pixel computes the
// four output parities of every channel and writes them channel-major,
// so each channel's map is a plain slice of the output; the (N, H, W, C)
// channel-minor tensor never exists.
//
// Numerics, as the TPU kernel: taps summed in f32 in its order, the sum
// rounded to the storage type before the encode.
//
// Layouts: x (N, H2, W2, C) f32 or bf16; taps (4, 4, C) f32 (see
// common.cuh); enc packs channel ch's code in bits 4ch..4ch+3 (0
// identity, 1 sigmoid, 2 tanh); out f32, either parity planes
// (N, C, 4, H2, W2), parity p*2+q, or interleaved (N, C, 2 H2, 2 W2).

#include "common.cuh"

namespace emsanet {

constexpr int kMaxHeadChannels = 8;

__device__ __forceinline__ float encode(float v, int code) {
  if (code == 1) return 1.f / (1.f + expf(-v));
  if (code == 2) return tanhf(v);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
instance_head_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                     float* __restrict__ out, int h2, int w2, int c, int enc,
                     int interleaved) {
  __shared__ float s_taps[16 * kMaxHeadChannels];
  __shared__ float s_x[kHaloH * kHaloW * (kMaxHeadChannels | 1)];
  for (int i = threadIdx.x; i < 16 * c; i += kTileThreads) s_taps[i] = taps[i];
  const int tx = threadIdx.x % kTileW, ty = threadIdx.x / kTileW;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int img = blockIdx.z;
  const int stride = tile_stride(c);
  stage_tile(s_x, x, img, y0, x0, h2, w2, c, 0, c, stride);
  __syncthreads();
  const int xx = x0 + tx, y = y0 + ty;
  if (xx >= w2 || y >= h2) return;
  for (int ch = 0; ch < c; ++ch) {
    float v[3][3];
    tile_neighbourhood(s_x, stride, ty, tx, ch, v);
    const int code = (enc >> (4 * ch)) & 15;
    float e[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      e[p] = encode(parity_value<T>(v, s_taps + ch, c, p), code);
    }
    const size_t map = (size_t)img * c + ch;
    if (interleaved) {
      // row 2y+pr, columns 2xx and 2xx+1: one 8-byte store each
      const int ww = 2 * w2;
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        const size_t o = (map * 2 * h2 + 2 * y + pr) * ww + 2 * xx;
        *reinterpret_cast<float2*>(out + o) =
            make_float2(e[2 * pr], e[2 * pr + 1]);
      }
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        out[((map * 4 + p) * h2 + y) * w2 + xx] = e[p];
      }
    }
  }
}

}  // namespace emsanet

// c must be in [1, 8]; the wrapper checks it and the shapes.
extern "C" int instance_head_launch(int dtype, int n, int h2, int w2, int c,
                                    int enc, int interleaved, const void* x,
                                    const void* taps, void* out,
                                    void* stream) {
  using namespace emsanet;
  if (c < 1 || c > kMaxHeadChannels) return (int)cudaErrorInvalidValue;
  dim3 grid(ceil_div(w2, kTileW), ceil_div(h2, kTileH), n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    instance_head_kernel<__nv_bfloat16><<<grid, kTileThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)taps, (float*)out, h2, w2, c,
        enc, interleaved);
  } else {
    instance_head_kernel<float><<<grid, kTileThreads, 0, s>>>(
        (const float*)x, (const float*)taps, (float*)out, h2, w2, c, enc,
        interleaved);
  }
  return (int)cudaGetLastError();
}
