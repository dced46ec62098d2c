// Instance head: the final learned x2 upsample of the instance head
// (nearest x2 + zero-padded depthwise 3x3, in its polyphase form) fused
// with the per-channel output encode: sigmoid for the center, tanh for
// the offsets, identity for the orientation (as the ENC_* codes say).
//
// Replaces the TPU kernel `emsanet_tpu/ops/instance_head.py`
// (`_head_kernel`; pl.pallas_call at :289 in `instance_head_upsample`
// and at :375 in `instance_head_upsample_interleaved`).
//
// What bounds it on the H100: bytes, the f32 output above all. C <= 8
// channels (5 with orientation) are read once at half resolution and
// written as f32 at full resolution (b8 640x480 bf16: 6 MB in, 49 MB
// out). The design spends its instructions on the output:
// - a block owns 8 x 64 half-res pixels of one image and each of its 128
//   threads four horizontal neighbours, so every store is a 16-byte
//   vector: in planes, the four pixels of one parity row (one float4);
//   interleaved, the eight full-res columns of one output row (two
//   float4). Half a warp writes 256 (planes) or 512 (interleaved)
//   contiguous bytes per store. The stores are marked evict-first
//   (st.global.cs): on the H100 that took the b8 call from ~0.031 to
//   ~0.025 ms, and the frames that read the maps next did not slow. A
//   thread computes and stores one output row at a time;
// - the block stages its 10 x 66 input window once, every channel, in
//   shared memory as f32 planes with a row stride of 72 words (column j of
//   the tile at word j + 4), so a thread reads its 3 x 6 neighbourhood of
//   a channel as nine float4 (three per row, bank-conflict free); the 16
//   parity taps of a channel are four broadcast float4. Each thread stages
//   whole pixels, three at a time with their loads issued together;
// - one block per tile, 150 blocks per 240 x 320 image.
// Each output channel is a plain slice of the output; the (N, H, W, C)
// channel-minor tensor never exists.
//
// Numerics, as the TPU kernel: taps summed in f32 in its order, the sum
// rounded to the storage type before the encode; `expf` and `tanhf` (no
// approximate intrinsics; the sigmoid's reciprocal correctly rounded, as
// the division 1 / (1 + e) is). In bf16 the products of bf16 values are
// exact in f32, so a fused multiply-add gives the same sums; f32 keeps
// separate multiplies and adds. Every output is computed by one thread in
// a fixed order: two calls give the same bits.
//
// Layouts: x (N, H2, W2, C) f32 or bf16; taps (4, 4, C) f32 (see
// common.cuh); enc packs channel ch's code in bits 4ch..4ch+3 (0
// identity, 1 sigmoid, 2 tanh); out f32, either parity planes
// (N, C, 4, H2, W2), parity p*2+q, or interleaved (N, C, 2 H2, 2 W2).

#include <cstdint>

#include "common.cuh"

namespace emsanet {

constexpr int kMaxHeadChannels = 8;
constexpr int kHeadPx = 4;                       // pixels per thread
constexpr int kHeadW = 64, kHeadH = 8;           // half-res pixels per block
constexpr int kHeadRowThreads = kHeadW / kHeadPx;  // 16
constexpr int kHeadThreads = kHeadRowThreads * kHeadH;  // 128
constexpr int kHeadWinW = kHeadW + 2, kHeadWinH = kHeadH + 2;
constexpr int kHeadStride = kHeadW + 8;  // words per staged row
// words per staged channel; the 8 spare words spread the staging stores of
// neighbouring channels over the banks
constexpr int kHeadPlane = kHeadWinH * kHeadStride + 8;

// A 16-byte store marked evict-first (st.global.cs): the head writes
// 49 MB at b8, which would otherwise push its own input and other lines
// out of L2 first. No memory clobber: nothing in the kernel reads it.
__device__ __forceinline__ void store_cs(float* p, float a, float b, float c,
                                         float d) {
  asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "f"(a), "f"(b), "f"(c), "f"(d));
}

__device__ __forceinline__ float encode(float v, int code) {
  if (code == 1) return __frcp_rn(1.f + expf(-v));  // = 1 / (1 + e^-v)
  if (code == 2) return tanhf(v);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kHeadThreads)
instance_head_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                     float* __restrict__ out, int h2, int w2, int c, int enc,
                     int interleaved, int vec) {
  __shared__ __align__(16) float s_taps[16 * kMaxHeadChannels];
  __shared__ __align__(16) float s_x[kMaxHeadChannels * kHeadPlane];
  const int x0 = blockIdx.x * kHeadW, y0 = blockIdx.y * kHeadH;
  const int img = blockIdx.z;
  // taps (4 parities, 4 taps, C) -> channel-major (C, 16)
  for (int i = threadIdx.x; i < 16 * c; i += kHeadThreads)
    s_taps[(i % c) * 16 + i / c] = taps[i];
  // the window: rows y0-1 .. y0+8, columns x0-1 .. x0+64, zero outside the
  // image. Thread t stages pixels t, t + 128, ..., kBatch at a time: it
  // issues a batch's loads before it stores any, so their latencies
  // overlap (all six at once need more registers than the rest of the
  // kernel: ptxas then spills)
  constexpr int kWinPix = kHeadWinH * kHeadWinW;
  constexpr int kPerThread = (kWinPix + kHeadThreads - 1) / kHeadThreads;
  constexpr int kBatch = 3;
#pragma unroll
  for (int k0 = 0; k0 < kPerThread; k0 += kBatch) {
    float v[kBatch][kMaxHeadChannels];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int pix = threadIdx.x + (k0 + k) * kHeadThreads;
      const int gy = y0 - 1 + pix / kHeadWinW;
      const int gx = x0 - 1 + pix % kHeadWinW;
      const bool in = pix < kWinPix && gy >= 0 && gy < h2 && gx >= 0 &&
                      gx < w2;
      const T* src = x + (((size_t)img * h2 + (in ? gy : 0)) * w2 +
                          (in ? gx : 0)) * c;
#pragma unroll
      for (int ch = 0; ch < kMaxHeadChannels; ++ch)
        v[k][ch] = in && ch < c ? ld(src + ch) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int pix = threadIdx.x + (k0 + k) * kHeadThreads;
      if (pix >= kWinPix) break;
      float* dst =
          s_x + (pix / kHeadWinW) * kHeadStride + pix % kHeadWinW + 3;
#pragma unroll
      for (int ch = 0; ch < kMaxHeadChannels; ++ch)
        if (ch < c) dst[ch * kHeadPlane] = v[k][ch];
    }
  }
  __syncthreads();

  const int tx = threadIdx.x % kHeadRowThreads;
  const int ty = threadIdx.x / kHeadRowThreads;
  const int y = y0 + ty, xa = x0 + kHeadPx * tx;  // pixels (y, xa .. xa+3)
  if (y >= h2 || xa >= w2) return;
  const bool full = vec && xa + kHeadPx <= w2;  // whole 16-byte stores
  for (int ch = 0; ch < c; ++ch) {
    float k[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 t4 = reinterpret_cast<const float4*>(s_taps + 16 * ch)[q];
      k[4 * q] = t4.x, k[4 * q + 1] = t4.y, k[4 * q + 2] = t4.z,
      k[4 * q + 3] = t4.w;
    }
    // nb[i][j]: row y-1+i, column xa-1+j
    float nb[3][kHeadPx + 2];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float4* row = reinterpret_cast<const float4*>(
          s_x + ch * kHeadPlane + (ty + i) * kHeadStride);
      const float4 l = row[tx], m = row[tx + 1], r = row[tx + 2];
      nb[i][0] = l.w;
      nb[i][1] = m.x, nb[i][2] = m.y, nb[i][3] = m.z, nb[i][4] = m.w;
      nb[i][5] = r.x;
    }
    const int code = (enc >> (4 * ch)) & 15;
    // the encoded value of pixel xa + px, parity p = pr * 2 + pc
    auto value = [&](int px, int p) {
      const int pr = p >> 1, pc = p & 1;
      const float v0 = nb[pr][px + pc], v1 = nb[pr][px + pc + 1];
      const float v2 = nb[pr + 1][px + pc], v3 = nb[pr + 1][px + pc + 1];
      float acc = __fmul_rn(v0, k[4 * p]);
      if constexpr (sizeof(T) == 2) {  // exact products: fma, same sum
        acc = __fmaf_rn(v1, k[4 * p + 1], acc);
        acc = __fmaf_rn(v2, k[4 * p + 2], acc);
        acc = __fmaf_rn(v3, k[4 * p + 3], acc);
      } else {
        acc = __fadd_rn(acc, __fmul_rn(v1, k[4 * p + 1]));
        acc = __fadd_rn(acc, __fmul_rn(v2, k[4 * p + 2]));
        acc = __fadd_rn(acc, __fmul_rn(v3, k[4 * p + 3]));
      }
      return encode(round_to<T>(acc), code);
    };
    // one output row at a time, stored as soon as it is computed (all 16
    // values at once made ptxas spill)
    const size_t map = (size_t)img * c + ch;
    if (interleaved) {
      // row 2y+pr, columns 2xa .. 2xa+7
      const int ww = 2 * w2;
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        float e[2 * kHeadPx];  // column 2 px + pc
#pragma unroll
        for (int px = 0; px < kHeadPx; ++px)
#pragma unroll
          for (int pc = 0; pc < 2; ++pc)
            e[2 * px + pc] = value(px, 2 * pr + pc);
        float* o = out + (map * 2 * h2 + 2 * y + pr) * ww + 2 * xa;
        if (full) {
          store_cs(o, e[0], e[1], e[2], e[3]);
          store_cs(o + 4, e[4], e[5], e[6], e[7]);
        } else {
#pragma unroll
          for (int px = 0; px < kHeadPx; ++px) {
            if (xa + px >= w2) break;
            o[2 * px] = e[2 * px];
            o[2 * px + 1] = e[2 * px + 1];
          }
        }
      }
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float e[kHeadPx];
#pragma unroll
        for (int px = 0; px < kHeadPx; ++px) e[px] = value(px, p);
        float* o = out + ((map * 4 + p) * h2 + y) * w2 + xa;
        if (full) {
          store_cs(o, e[0], e[1], e[2], e[3]);
        } else {
#pragma unroll
          for (int px = 0; px < kHeadPx; ++px) {
            if (xa + px >= w2) break;
            o[px] = e[px];
          }
        }
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
  // 16-byte stores: every row of the output starts 16-byte aligned
  const int vec = (interleaved ? w2 % 2 == 0 : w2 % 4 == 0) &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  dim3 grid(ceil_div(w2, kHeadW), ceil_div(h2, kHeadH), n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    instance_head_kernel<__nv_bfloat16><<<grid, kHeadThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)taps, (float*)out, h2, w2, c,
        enc, interleaved, vec);
  } else {
    instance_head_kernel<float><<<grid, kHeadThreads, 0, s>>>(
        (const float*)x, (const float*)taps, (float*)out, h2, w2, c, enc,
        interleaved, vec);
  }
  return (int)cudaGetLastError();
}
