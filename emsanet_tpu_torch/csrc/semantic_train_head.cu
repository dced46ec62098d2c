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
// of device memory, as the TPU kernel does: a block stages a 4 x 32 tile
// of half-res pixels with its halo in shared memory, all classes at once
// (C <= kMaxLossClasses), one thread per pixel. The forward makes two
// passes over the classes (max, target logit and logit sum; then the sum
// of exp). The backward first computes every halo pixel's max, sumexp,
// class and weight, then for each class the dz of the tile and its 1-pixel
// halo (in shared memory), the pixel's dx (kept in shared memory until a
// coalesced store) and the block's 16 tap sums. Block partials go through
// the fixed-order reduction of common.cuh, so the loss and dkp do not
// vary from run to run.
//
// Layouts: x, dx (N, H2, W2, C) NHWC in T; taps (4, 4, C) f32 (common.cuh);
// target (N, 2 H2, 2 W2) int32; cw (C) f32; gscale one f32 on the device.

#include "common.cuh"

namespace emsanet {

constexpr int kMaxLossClasses = 64;
// the backward's staged input: the tile with a 2-pixel halo
constexpr int kHalo2H = kTileH + 4, kHalo2W = kTileW + 4;
// positions whose dz the backward forms: the tile with a 1-pixel halo
constexpr int kDzPos = kHaloH * kHaloW;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The 3x3 neighbourhood of a pixel whose top-left neighbour sits at staged
// position (sy, sx) of a stage `sw` pixels wide, channel k.
__device__ __forceinline__ void neighbourhood(const float* s, int stride,
                                              int sw, int sy, int sx, int k,
                                              float v[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      v[i][j] = s[((sy + i) * sw + sx + j) * stride + k];
}

// Stage all C channels of the (hh x ww) window at (y0 - halo, x0 - halo),
// zero outside the image.
template <typename T>
__device__ __forceinline__ void stage_window(float* s, const T* x, int img,
                                             int y0, int x0, int halo,
                                             int hh, int ww, int h2, int w2,
                                             int c, int stride) {
  const int total = hh * ww * c;
  for (int i = threadIdx.x; i < total; i += kTileThreads) {
    const int ch = i % c, pix = i / c;
    const int r = y0 - halo + pix / ww, q = x0 - halo + pix % ww;
    float v = 0.f;
    if (r >= 0 && r < h2 && q >= 0 && q < w2)
      v = ld(x + (((size_t)img * h2 + r) * w2 + q) * c + ch);
    s[pix * stride + ch] = v;
  }
}

struct PixelStats {
  float m, sumexp, logz, tgt, sum;
};

// Max, target logit and logit sum (pass 1), then the sum of exp (pass 2)
// of parity p at the pixel whose neighbourhood starts at (sy, sx).
template <typename T>
__device__ __forceinline__ PixelStats pixel_stats(const float* s_x,
                                                  int stride, int sw, int sy,
                                                  int sx, const float* taps,
                                                  int c, int p, int ti) {
  PixelStats r{__int_as_float(0xff800000), 0.f, 0.f, 0.f, 0.f};  // -inf
  for (int k = 0; k < c; ++k) {
    float v[3][3];
    neighbourhood(s_x, stride, sw, sy, sx, k, v);
    const float val = parity_value<T>(v, taps + k, c, p);
    r.m = fmaxf(r.m, val);
    if (k == ti) r.tgt = val;
    r.sum += val;
  }
  for (int k = 0; k < c; ++k) {
    float v[3][3];
    neighbourhood(s_x, stride, sw, sy, sx, k, v);
    const float val = parity_value<T>(v, taps + k, c, p);
    r.sumexp += expf(round_to<T>(val - r.m));
  }
  r.logz = r.m + logf(r.sumexp);
  return r;
}

__device__ __forceinline__ int label_at(const int* target, int img, int h2,
                                        int w2, int y, int x, int p) {
  const int row = 2 * y + (p >> 1), col = 2 * x + (p & 1);
  return target[((size_t)img * 2 * h2 + row) * 2 * w2 + col];
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
head_loss_fwd_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                     const int* __restrict__ target,
                     const float* __restrict__ cw,
                     float* __restrict__ partials, int h2, int w2, int c,
                     float ls) {
  extern __shared__ float smem[];
  float* s_taps = smem;             // (4, 4, C)
  float* s_cw = s_taps + 16 * c;    // (C)
  float* s_x = s_cw + c;            // (kHaloH x kHaloW) pixels, stride
  __shared__ float s_red[2][kTileThreads / 32];
  for (int i = threadIdx.x; i < 16 * c; i += kTileThreads) s_taps[i] = taps[i];
  for (int i = threadIdx.x; i < c; i += kTileThreads) s_cw[i] = cw[i];
  const int stride = tile_stride(c);
  const int tx = threadIdx.x % kTileW, ty = threadIdx.x / kTileW;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int img = blockIdx.z;
  stage_window<T>(s_x, x, img, y0, x0, 1, kHaloH, kHaloW, h2, w2, c,
                  stride);
  __syncthreads();
  const int xx = x0 + tx, y = y0 + ty;
  float wnll = 0.f, wsum = 0.f;
  if (xx < w2 && y < h2) {
#pragma unroll 1
    for (int p = 0; p < 4; ++p) {
      const int lab = label_at(target, img, h2, w2, y, xx, p);
      if (lab <= 0) continue;  // void: weight 0
      const int ti = min(lab - 1, c - 1);
      const PixelStats st = pixel_stats<T>(s_x, stride, kHaloW, ty, tx,
                                           s_taps, c, p, ti);
      float nll = st.logz - st.tgt;
      if (ls > 0.f)
        nll = (1.f - ls) * nll + ls * (st.logz - st.sum / (float)c);
      const float wv = s_cw[ti];
      wnll += wv * nll;
      wsum += wv;
    }
  }
  wnll = warp_sum(wnll);
  wsum = warp_sum(wsum);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_red[0][warp] = wnll;
    s_red[1][warp] = wsum;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float acc = 0.f;
    for (int i = 0; i < kTileThreads / 32; ++i) acc += s_red[threadIdx.x][i];
    const size_t blk =
        ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
        blockIdx.x;
    partials[blk * 2 + threadIdx.x] = acc;
  }
}

inline size_t bwd_smem_floats(int c) {
  const int stride = tile_stride(c);
  return 16 * (size_t)c + c + (size_t)kHalo2H * kHalo2W * stride +
         4 * 4 * (size_t)kDzPos + 4 * (size_t)kDzPos +
         (size_t)kTileThreads * stride + 16 * (kTileThreads / 32);
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
head_loss_bwd_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                     const int* __restrict__ target,
                     const float* __restrict__ cw,
                     const float* __restrict__ gscale_p, T* __restrict__ dx,
                     float* __restrict__ partials, int h2, int w2, int c,
                     float ls) {
  extern __shared__ float smem[];
  const int stride = tile_stride(c);
  float* s_taps = smem;                                   // (4, 4, C)
  float* s_cw = s_taps + 16 * c;                          // (C)
  float* s_x = s_cw + c;                                  // 2-halo stage
  float* s_m = s_x + kHalo2H * kHalo2W * stride;          // [pos][p]
  float* s_se = s_m + 4 * kDzPos;
  float* s_wg = s_se + 4 * kDzPos;
  int* s_ti = reinterpret_cast<int*>(s_wg + 4 * kDzPos);
  float* s_dz = reinterpret_cast<float*>(s_ti + 4 * kDzPos);  // [pos][p]
  float* s_dx = s_dz + 4 * kDzPos;                        // [pix][stride]
  float* s_red = s_dx + kTileThreads * stride;            // [warp][16]
  for (int i = threadIdx.x; i < 16 * c; i += kTileThreads) s_taps[i] = taps[i];
  for (int i = threadIdx.x; i < c; i += kTileThreads) s_cw[i] = cw[i];
  const float gscale = *gscale_p;
  const int tid = threadIdx.x;
  const int tx = tid % kTileW, ty = tid / kTileW;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int img = blockIdx.z;
  stage_window<T>(s_x, x, img, y0, x0, 2, kHalo2H, kHalo2W, h2, w2, c,
                  stride);
  __syncthreads();

  // per-position statistics of the tile and its 1-pixel halo; a position
  // outside the image gets weight 0, so its dz is 0
  for (int i = tid; i < 4 * kDzPos; i += kTileThreads) {
    const int pos = i / 4, p = i % 4;
    const int qy = pos / kHaloW, qx = pos % kHaloW;
    const int yy = y0 - 1 + qy, xq = x0 - 1 + qx;
    float wg = 0.f, m = 0.f, se = 1.f;
    int ti = 0;
    if (yy >= 0 && yy < h2 && xq >= 0 && xq < w2) {
      const int lab = label_at(target, img, h2, w2, yy, xq, p);
      ti = min(max(lab - 1, 0), c - 1);
      if (lab > 0) {
        const PixelStats st = pixel_stats<T>(s_x, stride, kHalo2W, qy, qx,
                                             s_taps, c, p, ti);
        m = st.m;
        se = st.sumexp;
        wg = gscale * s_cw[ti];
      }
    }
    s_m[i] = m;
    s_se[i] = se;
    s_wg[i] = wg;
    s_ti[i] = ti;
  }
  const bool inside = x0 + tx < w2 && y0 + ty < h2;
  const int warp = tid / 32, lane = tid % 32;

  for (int k = 0; k < c; ++k) {
    __syncthreads();  // statistics ready; the previous class's dz read
    for (int i = tid; i < 4 * kDzPos; i += kTileThreads) {
      float dz = 0.f;
      if (s_wg[i] != 0.f) {
        const int pos = i / 4, p = i % 4;
        float v[3][3];
        neighbourhood(s_x, stride, kHalo2W, pos / kHaloW, pos % kHaloW, k,
                      v);
        const float val = parity_value<T>(v, s_taps + k, c, p);
        const float sm = expf(round_to<T>(val - s_m[i])) / s_se[i];
        const float tdist =
            (1.f - ls) * (k == s_ti[i] ? 1.f : 0.f) + ls / (float)c;
        dz = round_to<T>(s_wg[i] * (sm - tdist));
      }
      s_dz[i] = dz;
    }
    __syncthreads();
    // dx of the own pixel: dz_p at (y + 1 - pr - a, x + 1 - pc - b), in
    // the TPU kernel's order (parity, then tap row-major)
    float acc = 0.f;
    float prod[16];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int pr = p >> 1, pc = p & 1;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          // dz position in the 1-halo grid of (ty + 1 - pr - a + 1, ...)
          const int pos = (ty + 2 - pr - a) * kHaloW + tx + 2 - pc - b;
          const float dzv = s_dz[pos * 4 + p];
          const float kv = s_taps[(p * 4 + a * 2 + b) * c + k];
          acc = __fadd_rn(acc, __fmul_rn(dzv, kv));
          // dkp: own dz times the tap's input x[y-1+pr+a][x-1+pc+b]
          const int own = ((ty + 1) * kHaloW + tx + 1) * 4 + p;
          const float xv =
              s_x[((ty + 1 + pr + a) * kHalo2W + tx + 1 + pc + b) * stride +
                  k];
          prod[p * 4 + a * 2 + b] = inside ? s_dz[own] * xv : 0.f;
        }
    }
    s_dx[tid * stride + k] = acc;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const float v = warp_sum(prod[q]);
      if (lane == 0) s_red[warp * 16 + q] = v;
    }
    __syncthreads();
    if (tid < 16) {
      float v = 0.f;
      for (int wi = 0; wi < kTileThreads / 32; ++wi) v += s_red[wi * 16 + tid];
      const size_t blk =
          ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
          blockIdx.x;
      partials[blk * 16 * c + (size_t)tid * c + k] = v;
    }
  }
  __syncthreads();
  for (int i = tid; i < kTileThreads * c; i += kTileThreads) {
    const int pix = i / c, k = i % c;
    const int yy = y0 + pix / kTileW, xq = x0 + pix % kTileW;
    if (yy < h2 && xq < w2)
      st(dx + (((size_t)img * h2 + yy) * w2 + xq) * c + k,
         s_dx[pix * stride + k]);
  }
}

inline int n_tile_blocks(int n, int h2, int w2) {
  return n * ceil_div(h2, kTileH) * ceil_div(w2, kTileW);
}

template <typename T>
int launch_loss_fwd(int n, int h2, int w2, int c, float ls, const void* x,
                    const void* taps, const void* target, const void* cw,
                    void* sums, float* work, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (17 * (size_t)c + kHaloH * kHaloW * tile_stride(c));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        head_loss_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int rows = n_tile_blocks(n, h2, w2);
  head_loss_fwd_kernel<T>
      <<<dim3(ceil_div(w2, kTileW), ceil_div(h2, kTileH), n), kTileThreads,
         smem, stream>>>((const T*)x, (const float*)taps,
                         (const int*)target, (const float*)cw, work, h2, w2,
                         c, ls);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return reduce_rows(work, (float*)sums, work + (size_t)rows * 2, rows, 2,
                     stream);
}

template <typename T>
int launch_loss_bwd(int n, int h2, int w2, int c, float ls, const void* x,
                    const void* taps, const void* target, const void* cw,
                    const void* gscale, void* dx, void* dkp, float* work,
                    cudaStream_t stream) {
  const size_t smem = sizeof(float) * bwd_smem_floats(c);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        head_loss_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int rows = n_tile_blocks(n, h2, w2);
  head_loss_bwd_kernel<T>
      <<<dim3(ceil_div(w2, kTileW), ceil_div(h2, kTileH), n), kTileThreads,
         smem, stream>>>((const T*)x, (const float*)taps,
                         (const int*)target, (const float*)cw,
                         (const float*)gscale, (T*)dx, work, h2, w2, c, ls);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return reduce_rows(work, (float*)dkp, work + (size_t)rows * 16 * c, rows,
                     16 * c, stream);
}

}  // namespace emsanet

// Workspace floats of one call (the backward's is the larger).
extern "C" int semantic_train_head_workspace(int n, int h2, int w2, int c) {
  using namespace emsanet;
  return (n_tile_blocks(n, h2, w2) + kReduceSplits) * 16 * c;
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
