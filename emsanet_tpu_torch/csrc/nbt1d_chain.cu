// Stride-1 NonBottleneck1D blocks, one launch per conv pair.
//
// Replaces the TPU kernel `emsanet_tpu/ops/nbt1d_chain.py::nbt1d_chain`
// (`_chain_kernel`, pl.pallas_call at nbt1d_chain.py:434). A block is
//   h = relu(bn1(conv1x3(relu(conv3x1(x) + b0)) + b1))
//   y = relu(bn2(conv1x3(relu(conv3x1(h) + b2)) + b3) + x)
// with the BatchNorms folded to per-channel scale/shift. One call of
// `nbt1d_pair_launch` runs one such conv pair: conv3x1 + bias + ReLU, then
// conv1x3 + bias + folded BN (+ residual) + ReLU. Two calls make a block;
// the Python wrapper makes them for every block of the chain.
//
// What bounds it on the H100: at the chain shapes of the flagship
// (C = 64..512, 15x20 .. 120x160 pixels) a conv does 3*C*C multiply-adds
// per pixel against 2 * C * 2 bytes of activation traffic, so it is bound
// by arithmetic (bf16 tensor cores), not by device memory. The TPU kernel
// kept a K-block chain resident in 16 MB of VMEM; that does not fit in
// Hopper's 227 KB of shared memory.
//
// Two paths. bf16 (the inference path): the tensor cores, each conv an
// implicit GEMM (conv3tap_tc_kernel, below). f32 (the path that checks
// the arithmetic): the CUDA cores, f32 FMA, the whole pair in one launch
// (nbt1d_pair_kernel). Both apply zero padding per conv: pixels outside
// the image read 0, never a bias/ReLU value of the previous conv. The
// pair's intermediate is rounded to the storage type, as the unfused path
// writes it in that type.
//
// f32 tiling: one block per (image, row, segment of TW columns), C
// threads, thread j owns output channel j of every pixel of the segment;
// the segment's conv3x1 intermediate covers TW + 2 columns (the conv1x3
// halo) and stays in shared memory.
//
// Layouts: x, res, out (N, H, W, C) NHWC contiguous; w31, w13 (3, C, C)
// [tap][c_in][c_out] in the storage type; b31, b13, scale, shift f32 [C].

#include "conv_tc.cuh"

namespace emsanet {

constexpr int kTW = 16;         // output columns per block
constexpr int kM1 = kTW + 2;    // intermediate columns per block
constexpr int kKC = 32;         // input channels per shared-memory chunk

template <typename T>
__global__ void __launch_bounds__(512)
nbt1d_pair_kernel(const T* __restrict__ x,
                                  const T* __restrict__ w31,
                                  const float* __restrict__ b31,
                                  const T* __restrict__ w13,
                                  const float* __restrict__ b13,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ shift,
                                  const T* __restrict__ res,
                                  T* __restrict__ out, int h, int w, int c) {
  extern __shared__ float smem[];
  float* b_s = smem;                 // [kKC][c]      weight chunk
  float* mid = b_s + kKC * c;        // [kM1][c]      conv3x1 output
  float* a_s = mid + kM1 * c;        // [kM1][kKC]    input chunk

  const int j = threadIdx.x;         // output channel
  const int col0 = blockIdx.x * kTW;
  const int row = blockIdx.y;
  const int img = blockIdx.z;
  const size_t img_off = (size_t)img * h * w * c;

  // ---- conv3x1 over kM1 columns (col0 - 1 .. col0 + kTW) -------------
  float acc[kM1];
#pragma unroll
  for (int m = 0; m < kM1; ++m) acc[m] = 0.f;
  for (int dy = 0; dy < 3; ++dy) {
    const int r = row - 1 + dy;
    const bool row_ok = r >= 0 && r < h;
    for (int k0 = 0; k0 < c; k0 += kKC) {
      __syncthreads();
      for (int i = j; i < kM1 * kKC; i += c) {
        const int m = i / kKC, kk = i % kKC;
        const int cc = col0 - 1 + m;
        float v = 0.f;
        if (row_ok && cc >= 0 && cc < w)
          v = ld(x + img_off + ((size_t)r * w + cc) * c + k0 + kk);
        a_s[i] = v;
      }
      for (int i = j; i < kKC * c; i += c)
        b_s[i] = ld(w31 + ((size_t)dy * c + k0) * c + i);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKC; kk += 4) {
        const float bv0 = b_s[(kk + 0) * c + j];
        const float bv1 = b_s[(kk + 1) * c + j];
        const float bv2 = b_s[(kk + 2) * c + j];
        const float bv3 = b_s[(kk + 3) * c + j];
#pragma unroll
        for (int m = 0; m < kM1; ++m) {
          const float4 av = *reinterpret_cast<const float4*>(a_s + m * kKC + kk);
          acc[m] += av.x * bv0 + av.y * bv1 + av.z * bv2 + av.w * bv3;
        }
      }
    }
  }
  {
    const float bias = b31[j];
#pragma unroll
    for (int m = 0; m < kM1; ++m) {
      const int cc = col0 - 1 + m;
      const bool col_ok = cc >= 0 && cc < w;
      mid[m * c + j] = col_ok ? round_to<T>(fmaxf(acc[m] + bias, 0.f)) : 0.f;
    }
  }

  // ---- conv1x3 over kTW columns, reading the intermediate ------------
  float acc2[kTW];
#pragma unroll
  for (int m = 0; m < kTW; ++m) acc2[m] = 0.f;
  for (int dx = 0; dx < 3; ++dx) {
    for (int k0 = 0; k0 < c; k0 += kKC) {
      __syncthreads();
      for (int i = j; i < kKC * c; i += c)
        b_s[i] = ld(w13 + ((size_t)dx * c + k0) * c + i);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKC; kk += 4) {
        const float bv0 = b_s[(kk + 0) * c + j];
        const float bv1 = b_s[(kk + 1) * c + j];
        const float bv2 = b_s[(kk + 2) * c + j];
        const float bv3 = b_s[(kk + 3) * c + j];
#pragma unroll
        for (int m = 0; m < kTW; ++m) {
          const float4 av =
              *reinterpret_cast<const float4*>(mid + (m + dx) * c + k0 + kk);
          acc2[m] += av.x * bv0 + av.y * bv1 + av.z * bv2 + av.w * bv3;
        }
      }
    }
  }
  const float bias = b13[j], sc = scale[j], sh = shift[j];
#pragma unroll
  for (int m = 0; m < kTW; ++m) {
    const int cc = col0 + m;
    if (cc >= w) break;
    const size_t o = img_off + ((size_t)row * w + cc) * c + j;
    float y = (acc2[m] + bias) * sc + sh;
    if (res != nullptr) y += ld(res + o);
    st(out + o, fmaxf(y, 0.f));
  }
}

template <typename T>
int launch_pair(const void* x, const void* w31, const void* b31,
                const void* w13, const void* b13, const void* scale,
                const void* shift, const void* res, void* out, int n, int h,
                int w, int c, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kKC * c + kM1 * c + kM1 * kKC);
  static int configured = 0;
  if (configured < (int)smem) {
    cudaFuncSetAttribute(nbt1d_pair_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    configured = (int)smem;
  }
  dim3 grid(ceil_div(w, kTW), h, n);
  nbt1d_pair_kernel<T><<<grid, c, smem, stream>>>(
      (const T*)x, (const T*)w31, (const float*)b31, (const T*)w13,
      (const float*)b13, (const float*)scale, (const float*)shift,
      (const T*)res, (T*)out, h, w, c);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 path: each conv of the pair is an implicit GEMM on the tensor cores
// (`mma_conv_tile`, csrc/conv_tc.cuh) with M = all N*H*W pixels (images
// and rows flattened), K = 3 taps x C, N = C: a 3x1 kernel for the conv3x1,
// 1x3 for the conv1x3; a source pixel outside the image reads 0 (the
// per-conv zero padding).
//
// Why not the fused pair here: a block that keeps the pair's intermediate
// in shared memory must compute it for ALL C channels of its pixels, so
// either a block owns all C outputs (too few blocks at the 15x20 / 30x40
// sites: 300 pixels per image at C = 512) or blocks split the outputs and
// recompute the first conv. The unfused pair writes the bf16 intermediate
// to device memory and reads it back (2 * N*H*W*C*2 bytes, about 20 MB at
// the b8 120x160 site, a few microseconds against the conv's arithmetic),
// which mostly stays in the 50 MB L2.
//
// A block computes BM pixels x 64 output channels; BM is 128, or 64 where
// that leaves too few blocks to fill the card (the 15x20 sites). The
// epilogue (bias, folded BN, residual, ReLU) runs on the accumulators and
// stores bf16 pairs.

constexpr int kTargetBlocks = 264;  // 2 per SM

// scale/shift/res may be null: y = relu((acc + bias) [* scale + shift]
// [+ res]). vertical = 1 for the conv3x1, 0 for the conv1x3.
template <int BM>
__global__ void __launch_bounds__(kTcThreads)
conv3tap_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                   const float* __restrict__ bias,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift,
                   const bf16* __restrict__ res, bf16* __restrict__ out,
                   int total, int h, int w, int c, int vertical) {
  __shared__ ConvTileSmem<BM> sm;
  mma_conv_tile<BM>(
      sm, x, total, h, w, c, vertical ? 3 : 1, vertical ? 1 : 3, wt, c,
      blockIdx.x * BM, blockIdx.y * kBN,
      [&](int p, int ch, float v0, float v1) {
        v0 += bias[ch];
        v1 += bias[ch + 1];
        if (scale != nullptr) {
          v0 = v0 * scale[ch] + shift[ch];
          v1 = v1 * scale[ch + 1] + shift[ch + 1];
        }
        const size_t o = (size_t)p * c + ch;
        if (res != nullptr) {
          const float2 r =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                  res + o));
          v0 += r.x;
          v1 += r.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + o) =
            __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      });
}

int launch_conv3tap(const void* x, const void* wt, const void* bias,
                    const void* scale, const void* shift, const void* res,
                    void* out, int n, int h, int w, int c, int vertical,
                    cudaStream_t stream) {
  const int total = n * h * w;
  const bool big = (long)ceil_div(total, 128) * (c / kBN) >= kTargetBlocks;
  const int bm = big ? 128 : 64;
  dim3 grid(ceil_div(total, bm), c / kBN);
  if (big)
    conv3tap_tc_kernel<128><<<grid, kTcThreads, 0, stream>>>(
        (const bf16*)x, (const bf16*)wt, (const float*)bias,
        (const float*)scale, (const float*)shift, (const bf16*)res,
        (bf16*)out, total, h, w, c, vertical);
  else
    conv3tap_tc_kernel<64><<<grid, kTcThreads, 0, stream>>>(
        (const bf16*)x, (const bf16*)wt, (const float*)bias,
        (const float*)scale, (const float*)shift, (const bf16*)res,
        (bf16*)out, total, h, w, c, vertical);
  return (int)cudaGetLastError();
}

}  // namespace emsanet

// res may be null (first pair of a block). c must be a multiple of 64 in
// [64, 512]; the wrapper checks it. mid is bf16 scratch of x's size for
// the pair's intermediate (the bf16 path); the f32 path keeps it in
// shared memory and ignores mid.
extern "C" int nbt1d_pair_launch(int dtype, int n, int h, int w, int c,
                                 const void* x, const void* w31,
                                 const void* b31, const void* w13,
                                 const void* b13, const void* scale,
                                 const void* shift, const void* res,
                                 void* mid, void* out, void* stream) {
  using namespace emsanet;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    const int err = launch_conv3tap(x, w31, b31, nullptr, nullptr, nullptr,
                                    mid, n, h, w, c, 1, s);
    if (err != 0) return err;
    return launch_conv3tap(mid, w13, b13, scale, shift, res, out, n, h, w, c,
                           0, s);
  }
  return launch_pair<float>(x, w31, b31, w13, b13, scale, shift, res, out, n,
                            h, w, c, s);
}
