// Train-mode NonBottleneck1D conv pair, forward and backward.
//
// Replaces the TPU kernels of `emsanet_tpu/ops/nbt1d_train.py`:
// `_pair_fwd` (`_pair_fwd_kernel`, pl.pallas_call at :536) and `_pair_bwd`
// (`_pair_bwd_kernel`, pl.pallas_call at :619). One pair is
//   v = prologue(u)            identity, or relu(s*u + t) rounded to T
//   a = relu(conv3x1(v) + b31) rounded to T, zero padding after the prologue
//   y = conv1x3(a) + b13       rounded to T
//   sums = [sum y, sum y^2] per channel, f32, from the rounded y
// and its backward, given gy and the cotangent gsums of the sums:
//   dy  = gy + gsums[0] + 2 y gsums[1]
//   da  = conv1x3^T(dy) * (a > 0)
//   dv  = conv3x1^T(da)
//   gu  = dv * (v > 0) * s (affine) or dv (plain), rounded to T
//   gb13 = sum dy, gb31 = sum da, gs = sum dv (v > 0) u, gt = sum dv (v > 0)
//   gw13[d] = sum_p a[p + (d-1) cols] (x) dy[p]
//   gw31[d] = sum_p v[p + (d-1) rows] (x) da[p]
//
// What bounds it on the H100: at the flagship site (b8, 120x160, C = 64,
// bf16) a pair does 2 x 3 x C^2 multiply-adds per pixel forward (three
// times that backward) against 4 C bytes of activations in and out:
// 0.0118 ms of bytes and 0.0076 ms of bf16 tensor-core operations forward,
// 0.0229 ms of operations backward. Device memory bounds the forward,
// the tensor cores the backward.
//
// Two paths. bf16 (namespace tc, the training path): the tensor cores,
// mma.sync m16n8k16 with f32 accumulators through csrc/conv_tc.cuh's
// ldmatrix / mma helpers. f32 (the path that checks the arithmetic): the
// CUDA cores in f32 FMA, as the first version; tensor cores would mean
// TF32 and miss the f32 bounds.
//
// bf16 design. Every kernel is persistent: as many blocks as fit on the
// card at once walk the output tiles (TH rows x 16 columns; TH = 8 at
// C = 64, 4 at 128, 2 at 256) in a fixed order. At C = 64 each block
// stages its convs' weights in shared memory once and keeps them; at 128
// and 256 they do not fit and stream through a two-slot cp.async ring, 64
// input channels of one tap at a time. A tile's input and its halo are
// staged with cp.async (zero outside the image); the affine prologue is
// applied once per staged element. A conv is an implicit GEMM over the
// staged tile: M = the tile's pixels, K = 3 taps x C, N = C; each warp
// owns m16 x n64 units of it. Sums over pixels are per-thread f32
// partials across all of a block's tiles, then added across lanes,
// warps and blocks in a fixed order (no float atomics): two calls on the
// same inputs give the same bits.
// - forward, one cooperative launch: conv3x1 over the tile plus the
//   one-column halo into shared memory (bias, ReLU, rounded; never in
//   device memory), conv1x3 from there, bias, rounding, the store of y
//   and the sums; after a grid barrier the grid adds the blocks' sums.
// - backward, three launches. (1) recompute a over the tile plus two
//   halo columns and y plus one, form dy (zero outside the image) and
//   round it to bf16, as the TPU kernel rounds it for its matrix unit
//   (nbt1d_train.py:400); da = conv1x3^T(dy) * (a > 0), rounded to bf16
//   likewise (:439); store a, dy, da in bf16; partial gb13, gb31 from
//   the unrounded f32 values, as the TPU kernel sums them. (2) dv =
//   conv3x1^T(da), reading da's row halo from L2, and the prologue's
//   backward: gu, partial gs, gt. (3) the weight gradients as GEMMs with
//   K = pixels: a block owns a 64 x 64 (C_in x C_out) block of gw13 or
//   gw31 for all three taps and a share of the tiles, staging a and dy,
//   or prologue(u) and da, per tile; after a grid barrier the grid adds
//   the blocks' partial weight gradients and every vector partial.
// The grid-wide sums run inside the cooperative kernels, after their grid
// barrier (grid_col_sums), not through common.cuh's reduce_rows, which
// takes two launches of its own: that keeps the forward at one launch and
// the backward at three. A kernel without a grid barrier uses reduce_rows,
// as the f32 path does. A launch the card refuses (shared memory,
// co-residency) returns its error; there is no other kernel to fall back
// to.
//
// f32 design (the first version). The TPU kernel walks a sequential grid
// and accumulates sums, gs, gt and every weight gradient into
// constant-index output blocks; here each block writes its own partial
// sums and `reduce_rows` (common.cuh) adds them in a fixed order.
// - forward: one block per (image, row, 16 columns), one thread per
//   output channel (as csrc/nbt1d_chain.cu's f32 pair). The conv3x1 runs
//   over 18 columns (the conv1x3 halo), its intermediate stays in shared
//   memory, then the conv1x3, the store and the block's sums.
// - backward, five kernels: (1) recompute a and y, form dy (f32): store a
//   and dy, partial gb13; (2) da, a conv1x3 of dy with the tap-reversed
//   transposed weights, masked by a > 0: store da (f32), partial gb31;
//   (3) dv, the same conv3x1 of da, then the prologue's backward: store
//   gu, partial gs and gt; (4) the weight gradients, one block per (1024
//   pixels, 32 x 32 channel tile) from shared memory; (5) the reductions.
//
// Layouts: u, y, gy, gu, a (N, H, W, C) NHWC in T (float or bf16), dy
// and da the same in T; w31, w13 (3, C_in, C_out) and the transposed
// w31t, w13t (3, C_out, C_in), tap-reversed, in T; s, t, b31, b13,
// gsums f32.

#include <cooperative_groups.h>

#include "conv_tc.cuh"

namespace emsanet {

constexpr int kTW = 16;        // own output columns per block
constexpr int kM1 = kTW + 2;   // columns of the forward's intermediate
constexpr int kKC = 32;        // input channels per shared-memory chunk
constexpr int kMaxC = 256;     // threads per block = C
constexpr int kWgPix = 64;     // pixels staged at once (weight gradients)
constexpr int kWgChunk = 1024; // pixels per weight-gradient block
constexpr int kWgT = 32;       // channel tile of the weight gradients

// The prologue of one input element: relu(s*u + t), with the multiply and
// add rounded separately (as the plain version's ops).
__device__ __forceinline__ float prologue(float u, float s, float t) {
  return fmaxf(__fadd_rn(__fmul_rn(u, s), t), 0.f);
}

// acc[m] += sum_tap sum_k src(r, cc)[k] * wt[tap][k][j] for the thread's
// output channel j = threadIdx.x, over M pixels of row `row` at columns
// col_start + m. vertical: (r, cc) = (row + tap - 1, col_start + m);
// otherwise (row, col_start + m + tap - 1). Source pixels outside the image
// read 0; with `affine` the prologue is applied to the others. Uses the
// shared buffers a_s [M][kKC] and b_s [kKC][C].
template <int M>
__device__ __forceinline__ void conv3_accumulate(
    const float* __restrict__ src, const float* __restrict__ wt, int img,
    int row, int col_start, bool vertical, int affine,
    const float* __restrict__ s, const float* __restrict__ t, float* a_s,
    float* b_s, int h, int w, int c, float (&acc)[M]) {
  const int j = threadIdx.x;
  for (int tap = 0; tap < 3; ++tap) {
    const int r = vertical ? row + tap - 1 : row;
    const int shift = vertical ? 0 : tap - 1;
    const bool row_ok = r >= 0 && r < h;
    for (int k0 = 0; k0 < c; k0 += kKC) {
      __syncthreads();  // the previous chunk has been read
      for (int i = j; i < M * kKC; i += c) {
        const int m = i / kKC, kk = i % kKC;
        const int cc = col_start + m + shift;
        float v = 0.f;
        if (row_ok && cc >= 0 && cc < w) {
          v = ld(src + (((size_t)img * h + r) * w + cc) * c + k0 + kk);
          if (affine) v = prologue(v, s[k0 + kk], t[k0 + kk]);
        }
        a_s[i] = v;
      }
      for (int i = j; i < kKC * c; i += c)
        b_s[i] = ld(wt + ((size_t)tap * c + k0) * c + i);
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < kKC; kk += 4) {
        const float bv0 = b_s[(kk + 0) * c + j];
        const float bv1 = b_s[(kk + 1) * c + j];
        const float bv2 = b_s[(kk + 2) * c + j];
        const float bv3 = b_s[(kk + 3) * c + j];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float4 av =
              *reinterpret_cast<const float4*>(a_s + m * kKC + kk);
          acc[m] += av.x * bv0 + av.y * bv1 + av.z * bv2 + av.w * bv3;
        }
      }
    }
  }
}

// Shared floats of the pair kernels: b_s, a_s and the intermediate.
inline size_t pair_smem_bytes(int c) {
  return sizeof(float) * ((size_t)kKC * c + kM1 * kKC + (size_t)kM1 * c);
}

// The forward's first conv over kM1 columns into `mid` (rounded, zero at
// columns outside the image): the part of the forward the backward's
// first kernel recomputes.
__device__ __forceinline__ void pair_first_conv(
    const float* __restrict__ u, const float* __restrict__ s,
    const float* __restrict__ t, const float* __restrict__ w31,
    const float* __restrict__ b31, int affine, int img, int row, int col0,
    float* b_s, float* a_s, float* mid, int h, int w, int c) {
  const int j = threadIdx.x;
  float acc[kM1];
#pragma unroll
  for (int m = 0; m < kM1; ++m) acc[m] = 0.f;
  conv3_accumulate<kM1>(u, w31, img, row, col0 - 1, true, affine, s,
                              t, a_s, b_s, h, w, c, acc);
  const float bias = b31[j];
#pragma unroll
  for (int m = 0; m < kM1; ++m) {
    const int cc = col0 - 1 + m;
    mid[m * c + j] =
        (cc >= 0 && cc < w) ? fmaxf(acc[m] + bias, 0.f) : 0.f;
  }
  __syncthreads();
}

// The second conv of the pair at the kTW own columns, from `mid`.
__device__ __forceinline__ void conv1x3_from_mid(const float* __restrict__ w13,
                                                 const float* mid, float* b_s,
                                                 int c, float (&acc)[kTW]) {
  const int j = threadIdx.x;
#pragma unroll
  for (int m = 0; m < kTW; ++m) acc[m] = 0.f;
  for (int dx = 0; dx < 3; ++dx) {
    for (int k0 = 0; k0 < c; k0 += kKC) {
      __syncthreads();
      for (int i = j; i < kKC * c; i += c)
        b_s[i] = ld(w13 + ((size_t)dx * c + k0) * c + i);
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < kKC; kk += 4) {
        const float bv0 = b_s[(kk + 0) * c + j];
        const float bv1 = b_s[(kk + 1) * c + j];
        const float bv2 = b_s[(kk + 2) * c + j];
        const float bv3 = b_s[(kk + 3) * c + j];
#pragma unroll
        for (int m = 0; m < kTW; ++m) {
          const float4 av =
              *reinterpret_cast<const float4*>(mid + (m + dx) * c + k0 + kk);
          acc[m] += av.x * bv0 + av.y * bv1 + av.z * bv2 + av.w * bv3;
        }
      }
    }
  }
}

__device__ __forceinline__ size_t block_index() {
  return ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
         blockIdx.x;
}

__global__ void __launch_bounds__(kMaxC)
pair_fwd_kernel(const float* __restrict__ u, const float* __restrict__ s,
                const float* __restrict__ t, const float* __restrict__ w31,
                const float* __restrict__ b31, const float* __restrict__ w13,
                const float* __restrict__ b13, float* __restrict__ y,
                float* __restrict__ partials, int h, int w, int c,
                int affine) {
  extern __shared__ float smem[];
  float* b_s = smem;               // [kKC][c]
  float* a_s = b_s + kKC * c;      // [kM1][kKC]
  float* mid = a_s + kM1 * kKC;    // [kM1][c]
  const int j = threadIdx.x;
  const int col0 = blockIdx.x * kTW, row = blockIdx.y, img = blockIdx.z;
  pair_first_conv(u, s, t, w31, b31, affine, img, row, col0, b_s, a_s,
                     mid, h, w, c);
  float acc[kTW];
  conv1x3_from_mid(w13, mid, b_s, c, acc);
  const float bias = b13[j];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int m = 0; m < kTW; ++m) {
    const int cc = col0 + m;
    if (cc >= w) break;
    const float v = acc[m] + bias;
    st(y + (((size_t)img * h + row) * w + cc) * c + j, v);
    s1 += v;
    s2 += v * v;
  }
  float* part = partials + block_index() * 2 * c;
  part[j] = s1;
  part[c + j] = s2;
}

// Backward (1): recompute a and y, form dy; store a, dy; partial gb13.
__global__ void __launch_bounds__(kMaxC)
pair_bwd_dy_kernel(const float* __restrict__ u, const float* __restrict__ gy,
                   const float* __restrict__ gsums,
                   const float* __restrict__ s, const float* __restrict__ t,
                   const float* __restrict__ w31, const float* __restrict__ b31,
                   const float* __restrict__ w13, const float* __restrict__ b13,
                   float* __restrict__ a_out, float* __restrict__ dy_out,
                   float* __restrict__ partials, int h, int w, int c,
                   int affine) {
  extern __shared__ float smem[];
  float* b_s = smem;
  float* a_s = b_s + kKC * c;
  float* mid = a_s + kM1 * kKC;
  const int j = threadIdx.x;
  const int col0 = blockIdx.x * kTW, row = blockIdx.y, img = blockIdx.z;
  pair_first_conv(u, s, t, w31, b31, affine, img, row, col0, b_s, a_s,
                     mid, h, w, c);
  float acc[kTW];
  conv1x3_from_mid(w13, mid, b_s, c, acc);
  const float bias = b13[j], g0 = gsums[j], g1 = gsums[c + j];
  float sdy = 0.f;
#pragma unroll
  for (int m = 0; m < kTW; ++m) {
    const int cc = col0 + m;
    if (cc >= w) break;
    const size_t o = (((size_t)img * h + row) * w + cc) * c + j;
    const float yv = acc[m] + bias;
    const float dy = (ld(gy + o) + g0) + 2.f * yv * g1;
    st(a_out + o, mid[(m + 1) * c + j]);
    dy_out[o] = dy;
    sdy += dy;
  }
  partials[block_index() * 4 * c + 3 * c + j] = sdy;
}

// Backward (2): da = conv1x3^T(dy) * (a > 0); store da; partial gb31.
__global__ void __launch_bounds__(kMaxC)
pair_bwd_da_kernel(const float* __restrict__ dy, const float* __restrict__ a,
                   const float* __restrict__ w13t, float* __restrict__ da_out,
                   float* __restrict__ partials, int h, int w, int c) {
  extern __shared__ float smem[];
  float* b_s = smem;
  float* a_s = b_s + kKC * c;
  const int j = threadIdx.x;
  const int col0 = blockIdx.x * kTW, row = blockIdx.y, img = blockIdx.z;
  float acc[kTW];
#pragma unroll
  for (int m = 0; m < kTW; ++m) acc[m] = 0.f;
  conv3_accumulate<kTW>(dy, w13t, img, row, col0, false, 0,
                                  nullptr, nullptr, a_s, b_s, h, w, c, acc);
  float sda = 0.f;
#pragma unroll
  for (int m = 0; m < kTW; ++m) {
    const int cc = col0 + m;
    if (cc >= w) break;
    const size_t o = (((size_t)img * h + row) * w + cc) * c + j;
    const float da = ld(a + o) > 0.f ? acc[m] : 0.f;
    da_out[o] = da;
    sda += da;
  }
  partials[block_index() * 4 * c + 2 * c + j] = sda;
}

// Backward (3): dv = conv3x1^T(da), the prologue's backward; store gu;
// partial gs, gt.
__global__ void __launch_bounds__(kMaxC)
pair_bwd_du_kernel(const float* __restrict__ da, const float* __restrict__ u,
                   const float* __restrict__ s, const float* __restrict__ t,
                   const float* __restrict__ w31t, float* __restrict__ gu,
                   float* __restrict__ partials, int h, int w, int c,
                   int affine) {
  extern __shared__ float smem[];
  float* b_s = smem;
  float* a_s = b_s + kKC * c;
  const int j = threadIdx.x;
  const int col0 = blockIdx.x * kTW, row = blockIdx.y, img = blockIdx.z;
  float acc[kTW];
#pragma unroll
  for (int m = 0; m < kTW; ++m) acc[m] = 0.f;
  conv3_accumulate<kTW>(da, w31t, img, row, col0, true, 0,
                                  nullptr, nullptr, a_s, b_s, h, w, c, acc);
  float sgs = 0.f, sgt = 0.f;
#pragma unroll
  for (int m = 0; m < kTW; ++m) {
    const int cc = col0 + m;
    if (cc >= w) break;
    const size_t o = (((size_t)img * h + row) * w + cc) * c + j;
    float g = acc[m];
    if (affine) {
      const float uv = ld(u + o);
      const float gz = prologue(uv, s[j], t[j]) > 0.f ? g : 0.f;
      g = gz * s[j];
      sgs += gz * uv;
      sgt += gz;
    }
    st(gu + o, g);
  }
  float* part = partials + block_index() * 4 * c;
  part[j] = sgs;
  part[c + j] = sgt;
}

// Backward (4): partials[chunk][tap][ci][co] = sum over the chunk's pixels
// p of x(p shifted by tap - 1 rows or columns)[ci] * g(p)[co], x read
// through the prologue where `affine`, zero outside the image. One block
// per (chunk of kWgChunk pixels, 32 ci, 32 co); thread (cig, co) holds
// 4 ci x 3 taps.
__global__ void __launch_bounds__(256)
wgrad_kernel(const float* __restrict__ x, const float* __restrict__ g,
             const float* __restrict__ s, const float* __restrict__ t,
             int affine, int vertical, float* __restrict__ partials,
             int total, int h, int w, int c) {
  __shared__ float xs[3][kWgPix][kWgT];
  __shared__ float gs[kWgPix][kWgT];
  const int tid = threadIdx.x;
  const int co_l = tid % kWgT, cig = tid / kWgT;  // cig in [0, 8)
  const int ci0 = blockIdx.y * kWgT, co0 = blockIdx.z * kWgT;
  const int chunk0 = blockIdx.x * kWgChunk;
  float acc[3][4];
#pragma unroll
  for (int tap = 0; tap < 3; ++tap)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[tap][i] = 0.f;

  for (int p0 = chunk0; p0 < chunk0 + kWgChunk && p0 < total;
       p0 += kWgPix) {
    __syncthreads();
    for (int i = tid; i < kWgPix * kWgT; i += 256) {
      const int pp = i / kWgT, col = i % kWgT;
      const int p = p0 + pp;
      gs[pp][col] = p < total ? g[(size_t)p * c + co0 + col] : 0.f;
    }
    for (int i = tid; i < 3 * kWgPix * kWgT; i += 256) {
      const int tap = i / (kWgPix * kWgT);
      const int pp = (i / kWgT) % kWgPix, col = i % kWgT;
      const int p = p0 + pp;
      float v = 0.f;
      if (p < total) {
        const int rem = p % (h * w);
        const int r = rem / w, cc = rem % w;
        const int d = tap - 1;
        const bool ok = vertical ? (r + d >= 0 && r + d < h)
                                 : (cc + d >= 0 && cc + d < w);
        if (ok) {
          const int q = p + (vertical ? d * w : d);
          const int ci = ci0 + col;
          v = ld(x + (size_t)q * c + ci);
          if (affine) v = prologue(v, s[ci], t[ci]);
        }
      }
      xs[tap][pp][col] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int pp = 0; pp < kWgPix; ++pp) {
      const float gv = gs[pp][co_l];
#pragma unroll
      for (int tap = 0; tap < 3; ++tap)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[tap][i] += xs[tap][pp][cig * 4 + i] * gv;
    }
  }
  float* part = partials + (size_t)blockIdx.x * 3 * c * c;
#pragma unroll
  for (int tap = 0; tap < 3; ++tap)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      part[((size_t)tap * c + ci0 + cig * 4 + i) * c + co0 + co_l] =
          acc[tap][i];
}

inline int n_row_blocks(int n, int h, int w) {
  return n * h * ceil_div(w, kTW);
}
inline int n_wg_chunks(int n, int h, int w) {
  return ceil_div(n * h * w, kWgChunk);
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int launch_fwd(int affine, int n, int h, int w, int c, const void* u,
               const void* s, const void* t, const void* w31, const void* b31,
               const void* w13, const void* b13, void* y, void* sums,
               float* work, cudaStream_t stream) {
  const size_t smem = pair_smem_bytes(c);
  int err = allow_smem(pair_fwd_kernel, smem);
  if (err != 0) return err;
  const int rows = n_row_blocks(n, h, w);
  float* partials = work;
  float* tmp = work + (size_t)rows * 2 * c;
  pair_fwd_kernel<<<dim3(ceil_div(w, kTW), h, n), c, smem, stream>>>(
      (const float*)u, (const float*)s, (const float*)t, (const float*)w31,
      (const float*)b31, (const float*)w13, (const float*)b13, (float*)y,
      partials, h, w, c, affine);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return reduce_rows(partials, (float*)sums, tmp, rows, 2 * c, stream);
}

int launch_bwd(int affine, int n, int h, int w, int c, const void* u,
               const void* gy, const void* gsums, const void* s,
               const void* t, const void* w31, const void* b31,
               const void* w13, const void* b13, const void* w31t,
               const void* w13t, void* gu, void* gvec, void* gw31, void* gw13,
               void* a_act, void* g_act, float* work, cudaStream_t stream) {
  const size_t pix = (size_t)n * h * w * c;
  float* a = (float*)a_act;
  float* dy = (float*)g_act;
  float* da = dy + pix;
  const int rows = n_row_blocks(n, h, w);
  const int chunks = n_wg_chunks(n, h, w);
  float* vec_part = work;
  float* wg_part = vec_part + (size_t)rows * 4 * c;
  float* tmp = wg_part + (size_t)chunks * 3 * c * c;
  const dim3 grid(ceil_div(w, kTW), h, n);
  const size_t smem_pair = pair_smem_bytes(c);
  const size_t smem_conv = sizeof(float) * ((size_t)kKC * c + kTW * kKC);
  int err = allow_smem(pair_bwd_dy_kernel, smem_pair);
  if (err != 0) return err;

  pair_bwd_dy_kernel<<<grid, c, smem_pair, stream>>>(
      (const float*)u, (const float*)gy, (const float*)gsums, (const float*)s,
      (const float*)t, (const float*)w31, (const float*)b31, (const float*)w13,
      (const float*)b13, a, dy, vec_part, h, w, c, affine);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  pair_bwd_da_kernel<<<grid, c, smem_conv, stream>>>(
      dy, a, (const float*)w13t, da, vec_part, h, w, c);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  pair_bwd_du_kernel<<<grid, c, smem_conv, stream>>>(
      da, (const float*)u, (const float*)s, (const float*)t, (const float*)w31t,
      (float*)gu, vec_part, h, w, c, affine);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  if ((err = reduce_rows(vec_part, (float*)gvec, tmp, rows, 4 * c, stream)))
    return err;

  const int total = n * h * w;
  const dim3 wg_grid(chunks, c / kWgT, c / kWgT);
  wgrad_kernel<<<wg_grid, 256, 0, stream>>>(
      a, dy, nullptr, nullptr, 0, 0, wg_part, total, h, w, c);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  if ((err = reduce_rows(wg_part, (float*)gw13, tmp, chunks, 3 * c * c,
                         stream)))
    return err;
  wgrad_kernel<<<wg_grid, 256, 0, stream>>>(
      (const float*)u, da, (const float*)s, (const float*)t, affine, 1, wg_part,
      total, h, w, c);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  return reduce_rows(wg_part, (float*)gw31, tmp, chunks, 3 * c * c, stream);
}

inline bool channels_ok(int c) {
  return c == 64 || c == 128 || c == 256;
}

// ---------------------------------------------------------------------------
// bf16 path: the tensor cores (see the note at the top)

namespace tc {

namespace cg = cooperative_groups;

constexpr int kTW = 16;  // own output columns of a tile

// Tile and staging geometry of one channel width.
template <int C>
struct Geo {
  static constexpr int TH = C == 64 ? 8 : (C == 128 ? 4 : 2);  // own rows
  static constexpr int PS = C + 8;  // shared row stride (elements): a pixel
                                    // or a weight row, padded by 16 bytes so
                                    // that ldmatrix reads no bank twice
  static constexpr int KC = C / 64;  // 64-channel K chunks per tap
  static constexpr int NB = C / 64;  // 64-channel N blocks
  static constexpr int NQ = 3 * KC;  // weight chunks per conv
  static constexpr bool kResident = C == 64;  // weights stay in shared memory
  static constexpr int kChunk = 64 * PS;      // elements of a weight chunk
};

__host__ __device__ constexpr int units_of(int m, int nb) {
  return (m + 15) / 16 * nb;
}
__host__ __device__ constexpr int per_warp(int units, int nw) {
  return (units + nw - 1) / nw;
}

struct Tile {
  int img, r0, c0;
};

__device__ __forceinline__ Tile tile_at(int t, int tiles_h, int tiles_w,
                                        int th) {
  const int per_img = tiles_h * tiles_w;
  const int rem = t % per_img;
  return {t / per_img, (rem / tiles_w) * th, (rem % tiles_w) * kTW};
}

// cp.async channels [c_off, c_off + CS) of the R x Q pixels at rows row0..,
// columns col0.. of image img of x (NHWC, cx channels) into xs, one pixel
// per CS + 8 elements; a pixel outside the image reads 0.
template <int CS>
__device__ __forceinline__ void stage(bf16* xs, const bf16* x, int img,
                                      int row0, int col0, int R, int Q,
                                      int h, int w, int cx, int c_off) {
  constexpr int P = CS / 8;
  for (int i = threadIdx.x; i < R * Q * P; i += blockDim.x) {
    const int pix = i / P, pc = i % P;
    const int r = row0 + pix / Q, c = col0 + pix % Q;
    const bool ok = r >= 0 && r < h && c >= 0 && c < w;
    const bf16* src =
        ok ? x + (((size_t)img * h + r) * w + c) * cx + c_off + pc * 8 : x;
    cp_async16(xs + pix * (CS + 8) + pc * 8, src, ok);
  }
}

// The prologue relu(s*u + t), rounded to bf16, in place on a staged tile
// (as `stage` laid it out); pixels outside the image stay 0, the zero
// padding after the prologue.
template <int CS>
__device__ __forceinline__ void prologue_tile(bf16* xs, int row0, int col0,
                                              int R, int Q, int h, int w,
                                              const float* s,
                                              const float* t) {
  constexpr int P = CS / 8;
  for (int i = threadIdx.x; i < R * Q * P; i += blockDim.x) {
    const int pix = i / P, pc = i % P;
    const int r = row0 + pix / Q, c = col0 + pix % Q;
    if (r < 0 || r >= h || c < 0 || c >= w) continue;
    uint4* p = reinterpret_cast<uint4*>(xs + pix * (CS + 8) + pc * 8);
    uint4 v = *p;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = pc * 8 + 2 * j;
      const float2 f = __bfloat1622float2(e[j]);
      e[j] = __floats2bfloat162_rn(prologue(f.x, s[ch], t[ch]),
                                   prologue(f.y, s[ch + 1],
                                                   t[ch + 1]));
    }
    *p = v;
  }
}

// cp.async weight chunk q of a conv, wg (3, C, C) [tap][k][n]: the 64 K rows
// (q % KC) * 64.. of tap q / KC, all C columns, into ws [64][PS].
template <int C>
__device__ __forceinline__ void load_wchunk(bf16* ws, const bf16* wg,
                                            int q) {
  using G = Geo<C>;
  constexpr int P = C / 8;
  const bf16* src = wg + ((size_t)(q / G::KC) * C + (q % G::KC) * 64) * C;
  for (int i = threadIdx.x; i < 64 * P; i += blockDim.x) {
    const int r = i / P, pc = i % P;
    cp_async16(ws + r * G::PS + pc * 8, src + (size_t)r * C + pc * 8, true);
  }
}

// A conv over a staged tile: acc[i] (unit u = warp + i * NW, m16 tile
// u / NB, N block u % NB) = sum over taps and K of the A rows
// row_ptr(m, tap) (a pixel's C channels in shared memory) times the
// weights. Resident weights are read from wres [NQ chunks]; otherwise
// chunk by chunk from wg through the two-slot ring.
template <int C, int UPW, int NW, class RowPtr>
__device__ __forceinline__ void conv_mma(float (&acc)[UPW][8][4], int units,
                                         const RowPtr& row_ptr,
                                         const bf16* wres, bf16* ring,
                                         const bf16* wg) {
  using G = Geo<C>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < UPW; ++i)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;
  if constexpr (!G::kResident) {
    load_wchunk<C>(ring, wg, 0);
    cp_async_commit();
  }
  for (int q = 0; q < G::NQ; ++q) {
    const bf16* wq;
    if constexpr (G::kResident) {
      wq = wres + q * G::kChunk;
    } else {
      cp_async_wait<0>();
      __syncthreads();  // chunk q landed; chunk q - 1's slot is free
      if (q + 1 < G::NQ)
        load_wchunk<C>(ring + ((q + 1) & 1) * G::kChunk, wg, q + 1);
      cp_async_commit();
      wq = ring + (q & 1) * G::kChunk;
    }
    const int tap = q / G::KC, k0 = (q % G::KC) * 64;
    const bf16* arow[UPW];
#pragma unroll
    for (int i = 0; i < UPW; ++i) {
      const int u = warp + i * NW;
      arow[i] = row_ptr((u < units ? u / G::NB : 0) * 16 + (lane & 15), tap) +
                k0 + (lane >> 4) * 8;
    }
#pragma unroll
    for (int ks = 0; ks < 64; ks += 16) {
#pragma unroll
      for (int i = 0; i < UPW; ++i) {
        const int u = warp + i * NW;
        if (u < units) {
          const int nb = u % G::NB;
          unsigned af[4];
          ldmatrix_x4(af, arow[i] + ks);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            unsigned r[4];
            ldmatrix_x4_trans(r, wq + (ks + (lane & 15)) * G::PS + nb * 64 +
                                     np * 16 + (lane >> 4) * 8);
            mma_bf16(acc[i][2 * np], af, r[0], r[1]);
            mma_bf16(acc[i][2 * np + 1], af, r[2], r[3]);
          }
        }
      }
    }
  }
  if constexpr (!G::kResident) __syncthreads();  // the ring is free
}

// epi(i, nt, m, ch, v0, v1) for every accumulator pair of the warp's
// units: pixel m < m_count of the conv, channels ch (even) and ch + 1.
template <int C, int UPW, int NW, class Epi>
__device__ __forceinline__ void for_each_out(const float (&acc)[UPW][8][4],
                                             int units, int m_count,
                                             const Epi& epi) {
  using G = Geo<C>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < UPW; ++i) {
    const int u = warp + i * NW;
    if (u >= units) continue;
    const int mt = u / G::NB, nb = u % G::NB;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mt * 16 + g + half * 8;
      if (m >= m_count) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        epi(i, nt, m, nb * 64 + nt * 8 + tq * 2, acc[i][nt][2 * half],
            acc[i][nt][2 * half + 1]);
    }
  }
}

// Adds the thread's partial sums part[i][nt][2 s + e] (statistic s of
// channel nb * 64 + nt * 8 + 2 tq + e) over the warp's lanes in a fixed
// order and into red_s[warp][slot0 + s][C].
template <int C, int UPW, int NW, int S>
__device__ __forceinline__ void warp_partials(float (&part)[UPW][8][2 * S],
                                              int units, float* red_s,
                                              int slot0) {
  using G = Geo<C>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < UPW; ++i) {
    const int u = warp + i * NW;
    if (u >= units) continue;  // uniform across the warp
    const int nb = u % G::NB;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2 * S; ++e) {
        float v = part[i][nt][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0)
          red_s[(warp * 2 + slot0 + e / 2) * C + nb * 64 + nt * 8 + tq * 2 +
                e % 2] += v;
      }
    }
  }
}

// The block's row of partials: out[j] = sum over warps of red_s[w][j],
// j < 2C, in warp order.
template <int C, int NW>
__device__ __forceinline__ void block_partials(const float* red_s,
                                               float* out) {
  for (int j = threadIdx.x; j < 2 * C; j += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < NW; ++w) s += red_s[w * 2 * C + j];
    out[j] = s;
  }
}

// Column sums over rows of per-block partials, by every warp of the grid
// after a grid barrier (reduce_rows without its two launches), in a fixed
// order: a warp takes 8 columns; lane pairs read 32 bytes of
// rows grp, grp + 16, ... (grp = lane / 2); a fixed butterfly adds the 16
// groups. store(j, float4) receives columns j..j+3 (cols % 8 == 0).
template <class Store>
__device__ __forceinline__ void grid_col_sums(const float* in, int rows,
                                              int ld, int cols,
                                              const Store& store) {
  const int lane = threadIdx.x & 31, grp = lane >> 1, half = lane & 1;
  const int gwarp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int nwarps = (gridDim.x * blockDim.x) >> 5;
  for (int j0 = gwarp * 8; j0 < cols; j0 += nwarps * 8) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int r = grp; r < rows; r += 16) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          in + (size_t)r * ld + j0 + half * 4));
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
#pragma unroll
    for (int off = 2; off < 32; off <<= 1) {
      s.x += __shfl_xor_sync(0xffffffffu, s.x, off);
      s.y += __shfl_xor_sync(0xffffffffu, s.y, off);
      s.z += __shfl_xor_sync(0xffffffffu, s.z, off);
      s.w += __shfl_xor_sync(0xffffffffu, s.w, off);
    }
    if (grp == 0) store(j0 + half * 4, s);
  }
}

__device__ __forceinline__ void st_bf16x2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ float2 ld_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ---- the pieces the three persistent conv kernels share

// A block's set-up: the NV vectors src[k] of C floats into vec_s[k C..],
// red_s[0, red_n) zeroed and, at C = 64, the weights of the NCONV convs
// wg[k] staged (chunk q of conv k at chunk k NQ + q of w_s) by cp.async,
// committed with the first tile.
template <int C, int NV, int NCONV>
__device__ __forceinline__ void block_setup(float* vec_s,
                                            const float* const (&src)[NV],
                                            float* red_s, int red_n,
                                            bf16* w_s,
                                            const bf16* const (&wg)[NCONV]) {
  using G = Geo<C>;
  for (int i = threadIdx.x; i < C; i += blockDim.x)
#pragma unroll
    for (int k = 0; k < NV; ++k) vec_s[k * C + i] = src[k][i];
  for (int i = threadIdx.x; i < red_n; i += blockDim.x) red_s[i] = 0.f;
  if constexpr (G::kResident) {
    for (int q = 0; q < G::NQ; ++q)
#pragma unroll
      for (int k = 0; k < NCONV; ++k)
        load_wchunk<C>(w_s + (k * G::NQ + q) * G::kChunk, wg[k], q);
  }
}

// Stages the input of tile t, if the grid has it, and commits the copies:
// rows r0 - 1 .. r0 + TH and Q columns, the tile's 16 and (Q - 16) / 2 of
// halo a side, of x (NHWC, C channels). A (FwdArgs or BwdArgs) gives the
// image and the tile grid.
template <int C, int Q, class A>
__device__ __forceinline__ void stage_tile(bf16* xs, const bf16* x, int t,
                                           const A& a) {
  if (t < a.tiles) {
    const Tile tl = tile_at(t, a.tiles_h, a.tiles_w, Geo<C>::TH);
    stage<C>(xs, x, tl.img, tl.r0 - 1, tl.c0 - (Q - kTW) / 2, Geo<C>::TH + 2,
             Q, a.h, a.w, C, 0);
  }
  cp_async_commit();
}

// Waits for tile tl's input in in_s (stage_tile<C, Q>), applies the
// prologue to it in place in affine mode, and writes a = relu(conv3x1(v) +
// b31), rounded to bf16, over the tile's TH rows and Q columns into a_s
// [TH x Q][PS]: 0 in columns outside the image, the conv1x3's zero
// padding. own(m, col, ch, p) follows the store of each pixel m inside
// the image's columns (p its two channels ch, ch + 1 in a_s).
template <int C, int Q, int NW, class A, class Own>
__device__ __forceinline__ void relu_conv3x1(const A& a, bf16* in_s,
                                             bf16* a_s, const Tile& tl,
                                             const float* s_s,
                                             const float* t_s,
                                             const float* b31_s,
                                             bf16* w_s, const Own& own) {
  using G = Geo<C>;
  constexpr int M = G::TH * Q, U = units_of(M, G::NB);
  constexpr int UPW = per_warp(U, NW), off = (Q - kTW) / 2;
  cp_async_wait<0>();
  __syncthreads();  // the tile (and the weights) landed; a_s is free
  if (a.affine) {
    prologue_tile<C>(in_s, tl.r0 - 1, tl.c0 - off, G::TH + 2, Q, a.h, a.w,
                     s_s, t_s);
    __syncthreads();
  }
  float acc[UPW][8][4];
  conv_mma<C, UPW, NW>(
      acc, U,
      [&](int m, int tap) { return in_s + (min(m, M - 1) + tap * Q) * G::PS; },
      w_s, w_s, a.w31);
  for_each_out<C, UPW, NW>(
      acc, U, M, [&](int, int, int m, int ch, float v0, float v1) {
        const int col = tl.c0 - off + m % Q;
        const bool ok = col >= 0 && col < a.w;
        bf16* p = a_s + m * G::PS + ch;
        st_bf16x2(p, ok ? fmaxf(v0 + b31_s[ch], 0.f) : 0.f,
                  ok ? fmaxf(v1 + b31_s[ch + 1], 0.f) : 0.f);
        if (ok) own(m, col, ch, p);
      });
}

// ---- forward

struct FwdArgs {
  const bf16 *u, *w31, *w13;
  const float *s, *t, *b31, *b13;
  bf16* y;
  float *part, *sums;  // part: (grid, 2C) block partials; sums (2, C)
  int h, w, affine, tiles_h, tiles_w, tiles;
};

template <int C>
struct FwdCfg {
  using G = Geo<C>;
  static constexpr int NW = 9;                  // warps
  static constexpr int MA = G::TH * (kTW + 2);  // conv3x1 pixels (+ halo)
  static constexpr int MB = G::TH * kTW;        // conv1x3 pixels
  static constexpr int UB = units_of(MB, G::NB), UPWB = per_warp(UB, NW);
  static constexpr int IN_PX = (G::TH + 2) * (kTW + 2);
  static constexpr int W_ELEMS = (G::kResident ? 2 * G::NQ : 2) * G::kChunk;
  static constexpr size_t SMEM =
      sizeof(float) * (4 * C + NW * 2 * C) +
      sizeof(bf16) * (W_ELEMS + (size_t)(IN_PX + MA) * G::PS);
};

template <int C>
__global__ void __launch_bounds__(FwdCfg<C>::NW * 32, C == 64 ? 2 : 1)
pair_fwd_tc(FwdArgs a) {
  using G = Geo<C>;
  using F = FwdCfg<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_s = reinterpret_cast<float*>(smem);
  float* t_s = s_s + C;
  float* b31_s = t_s + C;
  float* b13_s = b31_s + C;
  float* red_s = b13_s + C;  // [NW][2][C]
  bf16* w_s = reinterpret_cast<bf16*>(red_s + F::NW * 2 * C);
  bf16* in_s = w_s + F::W_ELEMS;        // [(TH+2) x 18][PS]
  bf16* mid_s = in_s + F::IN_PX * G::PS;  // [TH x 18][PS]
  constexpr int Q = kTW + 2;
  const float* const vecs[] = {a.s, a.t, a.b31, a.b13};
  const bf16* const convs[] = {a.w31, a.w13};
  block_setup<C>(s_s, vecs, red_s, F::NW * 2 * C, w_s, convs);
  stage_tile<C, Q>(in_s, a.u, blockIdx.x, a);

  float part[F::UPWB][8][4];  // sum y, sum y^2 at channels ch, ch + 1
#pragma unroll
  for (int i = 0; i < F::UPWB; ++i)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][nt][e] = 0.f;

  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const Tile tl = tile_at(t, a.tiles_h, a.tiles_w, G::TH);
    // conv3x1 over the tile's rows and 18 columns -> mid_s
    relu_conv3x1<C, Q, F::NW>(a, in_s, mid_s, tl, s_s, t_s, b31_s, w_s,
                              [](int, int, int, const bf16*) {});
    __syncthreads();  // mid_s written; in_s no longer read
    stage_tile<C, Q>(in_s, a.u, t + gridDim.x, a);
    {  // conv1x3 from mid_s -> y, sums
      float acc[F::UPWB][8][4];
      conv_mma<C, F::UPWB, F::NW>(
          acc, F::UB,
          [&](int m, int tap) {
            return mid_s + ((m / kTW) * (kTW + 2) + m % kTW + tap) * G::PS;
          },
          w_s + G::NQ * G::kChunk, w_s, a.w13);
      for_each_out<C, F::UPWB, F::NW>(
          acc, F::UB, F::MB,
          [&](int i, int nt, int m, int ch, float v0, float v1) {
            const int row = tl.r0 + m / kTW, col = tl.c0 + m % kTW;
            if (row >= a.h || col >= a.w) return;
            const __nv_bfloat162 yb =
                __floats2bfloat162_rn(v0 + b13_s[ch], v1 + b13_s[ch + 1]);
            *reinterpret_cast<__nv_bfloat162*>(
                a.y + (((size_t)tl.img * a.h + row) * a.w + col) * C + ch) = yb;
            const float2 y = __bfloat1622float2(yb);
            part[i][nt][0] += y.x;
            part[i][nt][1] += y.y;
            part[i][nt][2] += y.x * y.x;
            part[i][nt][3] += y.y * y.y;
          });
    }
  }
  warp_partials<C, F::UPWB, F::NW, 2>(part, F::UB, red_s, 0);
  __syncthreads();
  block_partials<C, F::NW>(red_s, a.part + (size_t)blockIdx.x * 2 * C);
  cg::this_grid().sync();
  grid_col_sums(a.part, gridDim.x, 2 * C, 2 * C, [&](int j, float4 v) {
    *reinterpret_cast<float4*>(a.sums + j) = v;
  });
}

// ---- backward

struct BwdArgs {
  const bf16 *u, *gy, *w31, *w13, *w31t, *w13t;
  const float *s, *t, *b31, *b13, *gsums;
  bf16 *a, *dy, *da, *gu;
  // vpart1 (rows1, 2C): gb31, gb13; vpart2 (rows2, 2C): gs, gt; wpart
  // (jobs, 3, 64, 64) weight-gradient partials
  float *vpart1, *vpart2, *wpart, *gvec, *gw31, *gw13;
  int h, w, affine, tiles_h, tiles_w, tiles, rows1, rows2, chunks;
};

// (1): recompute, dy, da.
template <int C>
struct DyCfg {
  using G = Geo<C>;
  static constexpr int NW = 10;
  static constexpr int MA = G::TH * (kTW + 4);  // a: 2 halo columns a side
  static constexpr int MB = G::TH * (kTW + 2);  // y, dy: 1 a side
  static constexpr int MC = G::TH * kTW;        // da
  static constexpr int UB = units_of(MB, G::NB), UC = units_of(MC, G::NB);
  static constexpr int UPWB = per_warp(UB, NW), UPWC = per_warp(UC, NW);
  static constexpr int IN_PX = (G::TH + 2) * (kTW + 4);
  static constexpr int W_ELEMS = (G::kResident ? 3 * G::NQ : 2) * G::kChunk;
  static constexpr size_t SMEM =
      sizeof(float) * (6 * C + NW * 2 * C) +
      sizeof(bf16) * (W_ELEMS + (size_t)(IN_PX + MA + MB) * G::PS);
};

template <int C>
__global__ void __launch_bounds__(DyCfg<C>::NW * 32, 1)
pair_bwd_dy_tc(BwdArgs a) {
  using G = Geo<C>;
  using F = DyCfg<C>;
  constexpr int QA = kTW + 4, QB = kTW + 2;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_s = reinterpret_cast<float*>(smem);
  float* t_s = s_s + C;
  float* b31_s = t_s + C;
  float* b13_s = b31_s + C;
  float* g0_s = b13_s + C;
  float* g1_s = g0_s + C;
  float* red_s = g1_s + C;  // [NW][2][C]: gb31, gb13
  bf16* w_s = reinterpret_cast<bf16*>(red_s + F::NW * 2 * C);
  bf16* in_s = w_s + F::W_ELEMS;          // [(TH+2) x 20]
  bf16* a_s = in_s + F::IN_PX * G::PS;    // [TH x 20]
  bf16* dy_s = a_s + F::MA * G::PS;       // [TH x 18]
  const float* const vecs[] = {a.s, a.t, a.b31, a.b13, a.gsums,
                               a.gsums + C};
  const bf16* const convs[] = {a.w31, a.w13, a.w13t};
  block_setup<C>(s_s, vecs, red_s, F::NW * 2 * C, w_s, convs);
  stage_tile<C, QA>(in_s, a.u, blockIdx.x, a);

  float pb[F::UPWB][8][2], pc[F::UPWC][8][2];  // gb13, gb31
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int i = 0; i < F::UPWB; ++i) pb[i][nt][0] = pb[i][nt][1] = 0.f;
#pragma unroll
    for (int i = 0; i < F::UPWC; ++i) pc[i][nt][0] = pc[i][nt][1] = 0.f;
  }

  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const Tile tl = tile_at(t, a.tiles_h, a.tiles_w, G::TH);
    // a over 20 columns -> a_s, and a's own 16 to device memory
    relu_conv3x1<C, QA, F::NW>(
        a, in_s, a_s, tl, s_s, t_s, b31_s, w_s,
        [&](int m, int col, int ch, const bf16* p) {
          const int row = tl.r0 + m / QA, cc = m % QA;
          if (row < a.h && cc >= 2 && cc < kTW + 2)
            *reinterpret_cast<__nv_bfloat162*>(
                a.a + (((size_t)tl.img * a.h + row) * a.w + col) * C + ch) =
                *reinterpret_cast<const __nv_bfloat162*>(p);
        });
    __syncthreads();
    stage_tile<C, QA>(in_s, a.u, t + gridDim.x, a);
    {  // y = conv1x3(a) + b13 over 18 columns; dy -> dy_s (bf16), own dy
      float acc[F::UPWB][8][4];
      conv_mma<C, F::UPWB, F::NW>(
          acc, F::UB,
          [&](int m, int tap) {
            m = min(m, F::MB - 1);
            return a_s + ((m / QB) * QA + m % QB + tap) * G::PS;
          },
          w_s + G::NQ * G::kChunk, w_s, a.w13);
      for_each_out<C, F::UPWB, F::NW>(
          acc, F::UB, F::MB,
          [&](int i, int nt, int m, int ch, float v0, float v1) {
            const int row = tl.r0 + m / QB, cc = m % QB;
            const int col = tl.c0 - 1 + cc;
            float d0 = 0.f, d1 = 0.f;
            if (row < a.h && col >= 0 && col < a.w) {
              const size_t o =
                  (((size_t)tl.img * a.h + row) * a.w + col) * C + ch;
              const float y0 = round_to<bf16>(v0 + b13_s[ch]);
              const float y1 = round_to<bf16>(v1 + b13_s[ch + 1]);
              const float2 g = ld_bf16x2(a.gy + o);
              d0 = (g.x + g0_s[ch]) + 2.f * y0 * g1_s[ch];
              d1 = (g.y + g0_s[ch + 1]) + 2.f * y1 * g1_s[ch + 1];
              if (cc >= 1 && cc <= kTW) {
                st_bf16x2(a.dy + o, d0, d1);
                pb[i][nt][0] += d0;
                pb[i][nt][1] += d1;
              }
            }
            st_bf16x2(dy_s + m * G::PS + ch, d0, d1);
          });
    }
    __syncthreads();
    {  // da = conv1x3^T(dy) * (a > 0) over the own 16 columns
      float acc[F::UPWC][8][4];
      conv_mma<C, F::UPWC, F::NW>(
          acc, F::UC,
          [&](int m, int tap) {
            return dy_s + ((m / kTW) * QB + m % kTW + tap) * G::PS;
          },
          w_s + 2 * G::NQ * G::kChunk, w_s, a.w13t);
      for_each_out<C, F::UPWC, F::NW>(
          acc, F::UC, F::MC,
          [&](int i, int nt, int m, int ch, float v0, float v1) {
            const int r = m / kTW, cc = m % kTW;
            const int row = tl.r0 + r, col = tl.c0 + cc;
            if (row >= a.h || col >= a.w) return;
            const float2 av = ld_bf16x2(a_s + (r * QA + cc + 2) * G::PS + ch);
            const float d0 = av.x > 0.f ? v0 : 0.f;
            const float d1 = av.y > 0.f ? v1 : 0.f;
            st_bf16x2(a.da + (((size_t)tl.img * a.h + row) * a.w + col) * C +
                          ch,
                      d0, d1);
            pc[i][nt][0] += d0;
            pc[i][nt][1] += d1;
          });
    }
  }
  warp_partials<C, F::UPWC, F::NW, 1>(pc, F::UC, red_s, 0);
  warp_partials<C, F::UPWB, F::NW, 1>(pb, F::UB, red_s, 1);
  __syncthreads();
  block_partials<C, F::NW>(red_s, a.vpart1 + (size_t)blockIdx.x * 2 * C);
}

// (2): dv = conv3x1^T(da), gu, partial gs and gt.
template <int C>
struct DuCfg {
  using G = Geo<C>;
  static constexpr int NW = 8;
  static constexpr int M = G::TH * kTW;
  static constexpr int U = units_of(M, G::NB);
  static constexpr int UPW = per_warp(U, NW);
  static constexpr int IN_PX = (G::TH + 2) * kTW;
  static constexpr int W_ELEMS = (G::kResident ? G::NQ : 2) * G::kChunk;
  static constexpr size_t SMEM = sizeof(float) * (2 * C + NW * 2 * C) +
                                 sizeof(bf16) * (W_ELEMS +
                                                 (size_t)IN_PX * G::PS);
};

template <int C>
__global__ void __launch_bounds__(DuCfg<C>::NW * 32, 2)
pair_bwd_du_tc(BwdArgs a) {
  using G = Geo<C>;
  using F = DuCfg<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_s = reinterpret_cast<float*>(smem);
  float* t_s = s_s + C;
  float* red_s = t_s + C;  // [NW][2][C]: gs, gt
  bf16* w_s = reinterpret_cast<bf16*>(red_s + F::NW * 2 * C);
  bf16* in_s = w_s + F::W_ELEMS;  // da over [(TH+2) x 16]
  const float* const vecs[] = {a.s, a.t};
  const bf16* const convs[] = {a.w31t};
  block_setup<C>(s_s, vecs, red_s, F::NW * 2 * C, w_s, convs);
  stage_tile<C, kTW>(in_s, a.da, blockIdx.x, a);

  float part[F::UPW][8][4];  // gs, gt at channels ch, ch + 1
#pragma unroll
  for (int i = 0; i < F::UPW; ++i)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][nt][e] = 0.f;

  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const Tile tl = tile_at(t, a.tiles_h, a.tiles_w, G::TH);
    cp_async_wait<0>();
    __syncthreads();
    float acc[F::UPW][8][4];
    conv_mma<C, F::UPW, F::NW>(
        acc, F::U,
        [&](int m, int tap) {
          return in_s + (min(m, F::M - 1) + tap * kTW) * G::PS;
        },
        w_s, w_s, a.w31t);
    __syncthreads();  // in_s no longer read
    stage_tile<C, kTW>(in_s, a.da, t + gridDim.x, a);
    for_each_out<C, F::UPW, F::NW>(
        acc, F::U, F::M, [&](int i, int nt, int m, int ch, float v0, float v1) {
          const int row = tl.r0 + m / kTW, col = tl.c0 + m % kTW;
          if (row >= a.h || col >= a.w) return;
          const size_t o = (((size_t)tl.img * a.h + row) * a.w + col) * C + ch;
          if (a.affine) {
            const float2 u = ld_bf16x2(a.u + o);
            const float z0 =
                round_to<bf16>(prologue(u.x, s_s[ch], t_s[ch])) > 0.f
                    ? v0 : 0.f;
            const float z1 = round_to<bf16>(prologue(
                                 u.y, s_s[ch + 1], t_s[ch + 1])) > 0.f
                                 ? v1 : 0.f;
            v0 = z0 * s_s[ch];
            v1 = z1 * s_s[ch + 1];
            part[i][nt][0] += z0 * u.x;
            part[i][nt][1] += z1 * u.y;
            part[i][nt][2] += z0;
            part[i][nt][3] += z1;
          }
          st_bf16x2(a.gu + o, v0, v1);
        });
  }
  warp_partials<C, F::UPW, F::NW, 2>(part, F::U, red_s, 0);
  __syncthreads();
  block_partials<C, F::NW>(red_s, a.vpart2 + (size_t)blockIdx.x * 2 * C);
}

// (3): weight gradients and every reduction. Block b: chunk b % chunks of
// the tiles, job b / chunks = (which, cib, cob): gw13 (which 0) or gw31
// (1), input channels cib * 64.., output channels cob * 64... Warp w owns
// input channels 16 w.. of the block and all three taps.
template <int C>
struct WgCfg {
  using G = Geo<C>;
  static constexpr int KB = C / 64;
  static constexpr int TH = G::TH;
  static constexpr int XPX = (TH + 2) * kTW > TH * (kTW + 2)
                                 ? (TH + 2) * kTW : TH * (kTW + 2);
  static constexpr int GPX = TH * kTW;
  static constexpr int S = 72;  // staged pixel stride (64 channels + 8)
  static constexpr int kPart = 3 * 64 * 64;
};

template <int C>
__global__ void __launch_bounds__(128, 3) pair_wgrad_tc(BwdArgs a) {
  using F = WgCfg<C>;
  constexpr int KB = F::KB, TH = F::TH, S = F::S;
  __shared__ __align__(128) bf16 xs[F::XPX * S];
  __shared__ __align__(128) bf16 gs[F::GPX * S];
  __shared__ float st_s[128];  // s, t of the block's 64 input channels
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int chunk = blockIdx.x % a.chunks, job = blockIdx.x / a.chunks;
  const int which = job / (KB * KB), cib = (job / KB) % KB, cob = job % KB;
  for (int i = tid; i < 64; i += blockDim.x) {
    st_s[i] = a.s[cib * 64 + i];
    st_s[64 + i] = a.t[cib * 64 + i];
  }
  float acc[3][8][4];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][nt][e] = 0.f;

  for (int t = chunk; t < a.tiles; t += a.chunks) {
    const Tile tl = tile_at(t, a.tiles_h, a.tiles_w, TH);
    __syncthreads();  // the previous tile's reads are done
    if (which == 0)  // a with one halo column a side
      stage<64>(xs, a.a, tl.img, tl.r0, tl.c0 - 1, TH, kTW + 2, a.h, a.w, C,
                cib * 64);
    else  // u with one halo row a side
      stage<64>(xs, a.u, tl.img, tl.r0 - 1, tl.c0, TH + 2, kTW, a.h, a.w, C,
                cib * 64);
    stage<64>(gs, which == 0 ? a.dy : a.da, tl.img, tl.r0, tl.c0, TH, kTW,
              a.h, a.w, C, cob * 64);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (which == 1 && a.affine) {
      prologue_tile<64>(xs, tl.r0 - 1, tl.c0, TH + 2, kTW, a.h, a.w, st_s,
                        st_s + 64);
      __syncthreads();
    }
    // A (16 input channels x 16 pixels) from xs [pixel][channel] by
    // ldmatrix.trans: lane l addresses pixel kp + l % 8 (+ 8 for l >= 16)
    // at channels 16 warp + 8 ((l / 8) % 2). B (16 pixels x 64 output
    // channels) from gs as the conv's weights.
    const int pl = (lane & 7) + ((lane >> 4) << 3);
    const int ci = warp * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kp = 0; kp < TH * kTW; kp += 16) {
      unsigned bfr[8][2];
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned r[4];
        ldmatrix_x4_trans(r, gs + (kp + (lane & 15)) * S + np * 16 +
                                 (lane >> 4) * 8);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
      const int p = kp + pl;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const int xp = which == 0 ? (p / kTW) * (kTW + 2) + p % kTW + d
                                  : p + d * kTW;
        unsigned af[4];
        ldmatrix_x4_trans(af, xs + xp * S + ci);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          mma_bf16(acc[d][nt], af, bfr[nt][0], bfr[nt][1]);
      }
    }
  }
  float* part = a.wpart + (size_t)blockIdx.x * F::kPart;
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<float2*>(
            part + (d * 64 + warp * 16 + g + half * 8) * 64 + nt * 8 +
            tq * 2) = make_float2(acc[d][nt][2 * half],
                                  acc[d][nt][2 * half + 1]);
  cg::this_grid().sync();
  // every job's partials over its chunks, in chunk order
  for (int jb = 0; jb < 2 * KB * KB; ++jb) {
    const int wh = jb / (KB * KB), ib = (jb / KB) % KB, ob = jb % KB;
    float* out = wh == 0 ? a.gw13 : a.gw31;
    grid_col_sums(a.wpart + (size_t)jb * a.chunks * F::kPart, a.chunks,
                  F::kPart, F::kPart, [&](int j, float4 v) {
                    const int d = j / 4096, r = (j / 64) % 64, c = j % 64;
                    *reinterpret_cast<float4*>(
                        out + ((size_t)d * C + ib * 64 + r) * C + ob * 64 +
                        c) = v;
                  });
  }
  grid_col_sums(a.vpart2, a.rows2, 2 * C, 2 * C, [&](int j, float4 v) {
    *reinterpret_cast<float4*>(a.gvec + j) = v;  // gs, gt
  });
  grid_col_sums(a.vpart1, a.rows1, 2 * C, 2 * C, [&](int j, float4 v) {
    *reinterpret_cast<float4*>(a.gvec + 2 * C + j) = v;  // gb31, gb13
  });
}

// ---- host side

// Blocks of `kernel` that fit on the card at once (threads, dynamic
// shared memory), or a CUDA error (negative).
template <class K>
int resident_blocks(K kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (!err && smem > 48 * 1024)
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                             threads, smem);
  if (err) return -err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  return sms * per_sm;
}

// The grids of one shape: co-resident blocks of each kernel, capped by
// the tiles. err != 0 if a kernel cannot be resident.
struct Plan {
  int err, tiles_h, tiles_w, tiles, fwd, dy, du, chunks, wg;
};

template <int C>
Plan make_plan(int n, int h, int w) {
  static int res[4] = {0, 0, 0, 0};  // fwd, dy, du, wgrad
  if (res[0] <= 0) {
    res[0] = resident_blocks(pair_fwd_tc<C>, FwdCfg<C>::NW * 32,
                             FwdCfg<C>::SMEM);
    res[1] = resident_blocks(pair_bwd_dy_tc<C>, DyCfg<C>::NW * 32,
                             DyCfg<C>::SMEM);
    res[2] = resident_blocks(pair_bwd_du_tc<C>, DuCfg<C>::NW * 32,
                             DuCfg<C>::SMEM);
    res[3] = resident_blocks(pair_wgrad_tc<C>, 128, 0);
    for (int& r : res)
      if (r <= 0) {
        const int err = r < 0 ? -r : (int)cudaErrorInvalidConfiguration;
        res[0] = 0;
        return Plan{err};
      }
  }
  Plan p{};
  p.tiles_h = ceil_div(h, Geo<C>::TH);
  p.tiles_w = ceil_div(w, kTW);
  p.tiles = n * p.tiles_h * p.tiles_w;
  p.fwd = p.tiles < res[0] ? p.tiles : res[0];
  p.dy = p.tiles < res[1] ? p.tiles : res[1];
  p.du = p.tiles < res[2] ? p.tiles : res[2];
  const int jobs = 2 * (C / 64) * (C / 64);
  if (res[3] < jobs) return Plan{(int)cudaErrorCooperativeLaunchTooLarge};
  p.chunks = res[3] / jobs < p.tiles ? res[3] / jobs : p.tiles;
  p.wg = jobs * p.chunks;
  return p;
}

inline Plan plan_for(int n, int h, int w, int c) {
  if (c == 64) return make_plan<64>(n, h, w);
  if (c == 128) return make_plan<128>(n, h, w);
  return make_plan<256>(n, h, w);
}

// Workspace floats: the forward's block sums; the backward's vector and
// weight-gradient partials.
inline long fwd_workspace(const Plan& p, int c) { return (long)p.fwd * 2 * c; }
inline long bwd_workspace(const Plan& p, int c) {
  return (long)(p.dy + p.du) * 2 * c + (long)p.wg * WgCfg<64>::kPart;
}

template <int C>
int launch_fwd(int affine, int n, int h, int w, const void* u,
               const void* s, const void* t, const void* w31,
               const void* b31, const void* w13, const void* b13, void* y,
               void* sums, float* work, cudaStream_t stream) {
  const Plan p = make_plan<C>(n, h, w);
  if (p.err) return p.err;
  FwdArgs args{(const bf16*)u,     (const bf16*)w31,   (const bf16*)w13,
               (const float*)s,    (const float*)t,    (const float*)b31,
               (const float*)b13,  (bf16*)y,           work,
               (float*)sums,       h,                  w,
               affine,             p.tiles_h,          p.tiles_w,
               p.tiles};
  void* params[] = {&args};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)pair_fwd_tc<C>, dim3(p.fwd), dim3(FwdCfg<C>::NW * 32),
      params, FwdCfg<C>::SMEM, stream);
}

template <int C>
int launch_bwd(int affine, int n, int h, int w, const void* u,
               const void* gy, const void* gsums, const void* s,
               const void* t, const void* w31, const void* b31,
               const void* w13, const void* b13, const void* w31t,
               const void* w13t, void* gu, void* gvec, void* gw31, void* gw13,
               void* a_act, void* g_act, float* work, cudaStream_t stream) {
  const Plan p = make_plan<C>(n, h, w);
  if (p.err) return p.err;
  const size_t pix = (size_t)n * h * w * C;
  BwdArgs args{};
  args.u = (const bf16*)u;
  args.gy = (const bf16*)gy;
  args.w31 = (const bf16*)w31;
  args.w13 = (const bf16*)w13;
  args.w31t = (const bf16*)w31t;
  args.w13t = (const bf16*)w13t;
  args.s = (const float*)s;
  args.t = (const float*)t;
  args.b31 = (const float*)b31;
  args.b13 = (const float*)b13;
  args.gsums = (const float*)gsums;
  args.a = (bf16*)a_act;
  args.dy = (bf16*)g_act;
  args.da = (bf16*)g_act + pix;
  args.gu = (bf16*)gu;
  args.vpart1 = work;
  args.vpart2 = work + (size_t)p.dy * 2 * C;
  args.wpart = args.vpart2 + (size_t)p.du * 2 * C;
  args.gvec = (float*)gvec;
  args.gw31 = (float*)gw31;
  args.gw13 = (float*)gw13;
  args.h = h;
  args.w = w;
  args.affine = affine;
  args.tiles_h = p.tiles_h;
  args.tiles_w = p.tiles_w;
  args.tiles = p.tiles;
  args.rows1 = p.dy;
  args.rows2 = p.du;
  args.chunks = p.chunks;
  pair_bwd_dy_tc<C><<<p.dy, DyCfg<C>::NW * 32, DyCfg<C>::SMEM, stream>>>(
      args);
  int err = (int)cudaGetLastError();
  if (err) return err;
  pair_bwd_du_tc<C><<<p.du, DuCfg<C>::NW * 32, DuCfg<C>::SMEM, stream>>>(
      args);
  if ((err = (int)cudaGetLastError())) return err;
  void* params[] = {&args};
  return (int)cudaLaunchCooperativeKernel((const void*)pair_wgrad_tc<C>,
                                          dim3(p.wg), dim3(128), params, 0,
                                          stream);
}

}  // namespace tc

}  // namespace emsanet

// Workspace floats of one forward / backward call at this shape and
// dtype, or a negative CUDA error if the bf16 kernels cannot be resident.
extern "C" int nbt1d_train_fwd_workspace(int dtype, int n, int h, int w,
                                         int c) {
  using namespace emsanet;
  if (!channels_ok(c)) return -(int)cudaErrorInvalidValue;
  if (dtype == kBF16) {
    const tc::Plan p = tc::plan_for(n, h, w, c);
    return p.err ? -p.err : (int)tc::fwd_workspace(p, c);
  }
  return n_row_blocks(n, h, w) * 2 * c + kReduceSplits * 2 * c;
}

extern "C" int nbt1d_train_bwd_workspace(int dtype, int n, int h, int w,
                                         int c) {
  using namespace emsanet;
  if (!channels_ok(c)) return -(int)cudaErrorInvalidValue;
  if (dtype == kBF16) {
    const tc::Plan p = tc::plan_for(n, h, w, c);
    return p.err ? -p.err : (int)tc::bwd_workspace(p, c);
  }
  return n_row_blocks(n, h, w) * 4 * c + n_wg_chunks(n, h, w) * 3 * c * c +
         kReduceSplits * 3 * c * c;
}

// C in {64, 128, 256}; the wrapper checks the shapes. sums (2, C) f32.
extern "C" int nbt1d_train_fwd_launch(int dtype, int affine, int n, int h,
                                      int w, int c, const void* u,
                                      const void* s, const void* t,
                                      const void* w31, const void* b31,
                                      const void* w13, const void* b13,
                                      void* y, void* sums, void* work,
                                      void* stream) {
  using namespace emsanet;
  if (!channels_ok(c)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    auto* f = c == 64 ? tc::launch_fwd<64>
              : c == 128 ? tc::launch_fwd<128> : tc::launch_fwd<256>;
    return f(affine, n, h, w, u, s, t, w31, b31, w13, b13, y, sums,
             (float*)work, st);
  }
  return launch_fwd(affine, n, h, w, c, u, s, t, w31, b31, w13, b13,
                           y, sums, (float*)work, st);
}

// gvec (4, C) f32: gs, gt, gb31, gb13; gw31, gw13 (3, C, C) f32; a_act
// holds one (N, H, W, C) tensor of the storage type (a), g_act two (dy,
// da), also in the storage type.
extern "C" int nbt1d_train_bwd_launch(
    int dtype, int affine, int n, int h, int w, int c, const void* u,
    const void* gy, const void* gsums, const void* s, const void* t,
    const void* w31, const void* b31, const void* w13, const void* b13,
    const void* w31t, const void* w13t, void* gu, void* gvec, void* gw31,
    void* gw13, void* a_act, void* g_act, void* work, void* stream) {
  using namespace emsanet;
  if (!channels_ok(c)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    auto* f = c == 64 ? tc::launch_bwd<64>
              : c == 128 ? tc::launch_bwd<128> : tc::launch_bwd<256>;
    return f(affine, n, h, w, u, gy, gsums, s, t, w31, b31, w13, b13, w31t,
             w13t, gu, gvec, gw31, gw13, a_act, g_act, (float*)work, st);
  }
  return launch_bwd(affine, n, h, w, c, u, gy, gsums, s, t, w31, b31,
                           w13, b13, w31t, w13t, gu, gvec, gw31, gw13, a_act,
                           g_act, (float*)work, st);
}
