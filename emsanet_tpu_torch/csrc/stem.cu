// Fused ResNet stems of both encoders in one launch:
// 7x7/2 conv (no bias, zero padding 3) + folded BatchNorm + ReLU +
// 3x3/2 max pool (padding 1).
//
// Replaces the TPU kernel `emsanet_tpu/ops/stem.py::fused_stems`
// (`_stem_kernel`, pl.pallas_call at stem.py:348).
//
// What bounds it on the H100: the conv output is 4x the size of the pooled
// output, so an unfused stem writes and re-reads it through device memory.
// Here each block computes one tile of POOLED outputs: it first computes
// the (2*TQ+1)^2 conv outputs the tile needs into shared memory (f32,
// BatchNorm and ReLU applied), then max-pools them. Device memory sees one
// read of the input tile (with its 7x7 halo) and one write of the pooled
// output; the conv output never leaves the SM. The arithmetic runs on the
// CUDA cores in f32 (a first, simple design: the conv has only 3 or 1
// input channels, a poor fit for tensor-core tiles). A thread computes one
// feature at kCG neighbouring conv columns, so that each input value it
// reads from shared memory serves several of its multiply-adds. The conv
// tile is kept in the storage type: rounding is monotonic, so the max of
// rounded values is the rounded max, and bf16 halves the tile (two blocks
// fit on an SM).
//
// Since ReLU output is >= 0, conv positions outside the image are stored
// as 0: they can tie with, but never exceed, the real maximum of a pooling
// window, which always holds at least one in-image position. This gives
// the result of the -inf padded max pool.
//
// Layouts: inputs (N, H, W, C) NHWC, C <= 4; weights f32 [c][ky][kx][64];
// folded BN scale/shift f32 [64]; outputs (N, Hq, Wq, 64) NHWC in the
// input dtype.

#include "common.cuh"

namespace emsanet {

constexpr int kF = 64;        // stem features
constexpr int kTQ = 8;        // pooled outputs per block side
constexpr int kRC = 2 * kTQ + 1;  // conv outputs per block side
constexpr int kIR = 2 * kRC + 5;  // input rows per block
constexpr int kCG = 6;        // conv columns per thread task
constexpr int kNCG = (kRC + kCG - 1) / kCG;  // column groups per conv row
constexpr int kIW = 2 * kNCG * kCG + 5;      // input columns per block
constexpr int kThreads = 256;

struct StemMod {
  const void* x;
  const float* w;
  const float* scale;
  const float* shift;
  void* out;
  int c;
};

struct StemArgs {
  StemMod mod[2];
  int n_mod, h, w, hc, wc, hq, wq;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_kernel(StemArgs a) {
  extern __shared__ float smem[];
  const int mod_i = blockIdx.z % a.n_mod;
  const int img = blockIdx.z / a.n_mod;
  const StemMod m = a.mod[mod_i];
  const int c = m.c;
  float* w_s = smem;                        // c*49*64
  float* x_s = w_s + c * 49 * kF;           // kIR*kIW*c
  T* conv_s = reinterpret_cast<T*>(x_s + kIR * kIW * c);  // kRC*kRC*64

  const int tid = threadIdx.x;
  const int py0 = blockIdx.y * kTQ, px0 = blockIdx.x * kTQ;
  const int cr0 = 2 * py0 - 1, cc0 = 2 * px0 - 1;   // first conv row/col
  const int ir0 = 2 * cr0 - 3, ic0 = 2 * cc0 - 3;   // first input row/col

  for (int i = tid; i < c * 49 * kF; i += kThreads) w_s[i] = m.w[i];
  const T* x = static_cast<const T*>(m.x);
  for (int i = tid; i < kIR * kIW * c; i += kThreads) {
    const int ch = i % c, p = i / c;
    const int gy = ir0 + p / kIW, gx = ic0 + p % kIW;
    float v = 0.f;
    if (gy >= 0 && gy < a.h && gx >= 0 && gx < a.w)
      v = ld(x + ((size_t)(img * a.h + gy) * a.w + gx) * c + ch);
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
      if (cx >= kRC) break;
      float v = 0.f;
      if (gr >= 0 && gr < a.hc && gc >= 0 && gc < a.wc)
        v = fmaxf(acc[j] * sc + sh, 0.f);
      st(conv_s + (cy * kRC + cx) * kF + f, v);
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(m.out);
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
        mx = fmaxf(mx, ld(conv_s + ((2 * qy + dy) * kRC + 2 * qx + dx) * kF + ff));
    st(out + ((size_t)(img * a.hq + gy) * a.wq + gx) * kF + ff, mx);
  }
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
  a.mod[0] = {x0, (const float*)w0, (const float*)s0, (const float*)t0, out0,
              c0};
  a.mod[1] = {x1, (const float*)w1, (const float*)s1, (const float*)t1, out1,
              c1};
  a.n_mod = n_mod;
  a.h = h;
  a.w = w;
  a.hc = (h - 1) / 2 + 1;
  a.wc = (w - 1) / 2 + 1;
  a.hq = (a.hc - 1) / 2 + 1;
  a.wq = (a.wc - 1) / 2 + 1;
  const int c_max = n_mod > 1 && c1 > c0 ? c1 : c0;
  const size_t smem =
      sizeof(float) * (c_max * 49 * kF + kIR * kIW * c_max) +
      (dtype == kBF16 ? 2 : 4) * kRC * kRC * kF;
  dim3 grid(ceil_div(a.wq, kTQ), ceil_div(a.hq, kTQ), n * n_mod);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    cudaFuncSetAttribute(stem_kernel<__nv_bfloat16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    stem_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(a);
  } else {
    cudaFuncSetAttribute(stem_kernel<float>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    stem_kernel<float><<<grid, kThreads, smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}
