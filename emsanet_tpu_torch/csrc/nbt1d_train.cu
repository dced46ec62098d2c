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
//   dy  = gy + gsums[0] + 2 y gsums[1]       (f32)
//   da  = conv1x3^T(dy) * (a > 0)            (f32)
//   dv  = conv3x1^T(da)
//   gu  = dv * (v > 0) * s (affine) or dv (plain), rounded to T
//   gb13 = sum dy, gb31 = sum da, gs = sum dv (v > 0) u, gt = sum dv (v > 0)
//   gw13[d] = sum_p a[p + (d-1) cols] (x) dy[p]
//   gw31[d] = sum_p v[p + (d-1) rows] (x) da[p]
// The TPU kernel rounds dy and da to the compute dtype before its matrix
// unit takes them; on the CUDA cores they stay f32, so the gradients are
// the f32 gradients of the rounded forward, as the plain version's.
//
// What bounds it on the H100: at the flagship site (b8, 120x160, C = 64,
// bf16) a pair does 2 x 3 x C^2 multiply-adds per pixel against 4 C bytes
// of activations in and out, about 190 operations per byte: below the bf16
// tensor cores' 295 operations per byte, so device memory bounds an ideal
// kernel (PERF.md). These kernels are the simple first version: f32 FMA on
// the CUDA cores, so arithmetic bounds them instead; tensor cores (mma,
// wgmma) are later work.
//
// Design. The TPU kernel walks a sequential grid and accumulates sums,
// gs, gt and every weight gradient into constant-index output blocks.
// CUDA blocks run in no order, so each block writes its own partial sums
// and a second pass (`reduce_rows`, common.cuh) adds them in a fixed
// order: the results do not vary from run to run.
// - forward: one block per (image, row, 16 columns), one thread per
//   output channel (as csrc/nbt1d_chain.cu's f32 pair). The conv3x1 runs
//   over 18 columns (the conv1x3 halo), its intermediate stays in shared
//   memory, then the conv1x3, the rounding, the store and the block's sums.
// - backward, five kernels: (1) recompute a and y as the forward does and
//   form dy: store a and dy, partial gb13; (2) da, a conv1x3 of dy with
//   the tap-reversed transposed weights, masked by a > 0: store da,
//   partial gb31; (3) dv, the same conv3x1 of da, then the prologue's
//   backward: store gu, partial gs and gt; (4) the weight gradients, one
//   block per (1024 pixels, 32 x 32 channel tile) accumulating the three
//   taps' outer products from shared memory, the prologue applied to u as
//   it is staged (no v tensor); (5) the reductions. The TPU kernel keeps
//   a, dy, da in VMEM; here they go through device memory (a in bf16, dy
//   and da in f32 at the flagship), which the simple version accepts.
//
// Layouts: u, y, gy, gu, a (N, H, W, C) NHWC in T (float or bf16), dy
// and da the same in f32; w31, w13 (3, C_in, C_out) and the transposed
// w31t, w13t (3, C_out, C_in), tap-reversed, in T; s, t, b31, b13,
// gsums f32.

#include "common.cuh"

namespace emsanet {

constexpr int kTW = 16;        // own output columns per block
constexpr int kM1 = kTW + 2;   // columns of the forward's intermediate
constexpr int kKC = 32;        // input channels per shared-memory chunk
constexpr int kMaxC = 256;     // threads per block = C
constexpr int kWgPix = 64;     // pixels staged at once (weight gradients)
constexpr int kWgChunk = 1024; // pixels per weight-gradient block
constexpr int kWgT = 32;       // channel tile of the weight gradients

// The prologue of one input element: relu(s*u + t) rounded to T, with
// the multiply and add rounded separately (as the plain version's ops).
template <typename T>
__device__ __forceinline__ float prologue(float u, float s, float t) {
  return round_to<T>(fmaxf(__fadd_rn(__fmul_rn(u, s), t), 0.f));
}

// acc[m] += sum_tap sum_k src(r, cc)[k] * wt[tap][k][j] for the thread's
// output channel j = threadIdx.x, over M pixels of row `row` at columns
// col_start + m. vertical: (r, cc) = (row + tap - 1, col_start + m);
// otherwise (row, col_start + m + tap - 1). Source pixels outside the image
// read 0; with `affine` the prologue is applied to the others. Uses the
// shared buffers a_s [M][kKC] and b_s [kKC][C].
template <typename TS, typename TW, int M>
__device__ __forceinline__ void conv3_accumulate(
    const TS* __restrict__ src, const TW* __restrict__ wt, int img, int row,
    int col_start, bool vertical, int affine, const float* __restrict__ s,
    const float* __restrict__ t, float* a_s, float* b_s, int h, int w, int c,
    float (&acc)[M]) {
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
          if (affine) v = prologue<TS>(v, s[k0 + kk], t[k0 + kk]);
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
template <typename T>
__device__ __forceinline__ void pair_first_conv(
    const T* __restrict__ u, const float* __restrict__ s,
    const float* __restrict__ t, const T* __restrict__ w31,
    const float* __restrict__ b31, int affine, int img, int row, int col0,
    float* b_s, float* a_s, float* mid, int h, int w, int c) {
  const int j = threadIdx.x;
  float acc[kM1];
#pragma unroll
  for (int m = 0; m < kM1; ++m) acc[m] = 0.f;
  conv3_accumulate<T, T, kM1>(u, w31, img, row, col0 - 1, true, affine, s,
                              t, a_s, b_s, h, w, c, acc);
  const float bias = b31[j];
#pragma unroll
  for (int m = 0; m < kM1; ++m) {
    const int cc = col0 - 1 + m;
    mid[m * c + j] =
        (cc >= 0 && cc < w) ? round_to<T>(fmaxf(acc[m] + bias, 0.f)) : 0.f;
  }
  __syncthreads();
}

// The second conv of the pair at the kTW own columns, from `mid`.
template <typename T>
__device__ __forceinline__ void conv1x3_from_mid(const T* __restrict__ w13,
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

template <typename T>
__global__ void __launch_bounds__(kMaxC)
pair_fwd_kernel(const T* __restrict__ u, const float* __restrict__ s,
                const float* __restrict__ t, const T* __restrict__ w31,
                const float* __restrict__ b31, const T* __restrict__ w13,
                const float* __restrict__ b13, T* __restrict__ y,
                float* __restrict__ partials, int h, int w, int c,
                int affine) {
  extern __shared__ float smem[];
  float* b_s = smem;               // [kKC][c]
  float* a_s = b_s + kKC * c;      // [kM1][kKC]
  float* mid = a_s + kM1 * kKC;    // [kM1][c]
  const int j = threadIdx.x;
  const int col0 = blockIdx.x * kTW, row = blockIdx.y, img = blockIdx.z;
  pair_first_conv<T>(u, s, t, w31, b31, affine, img, row, col0, b_s, a_s,
                     mid, h, w, c);
  float acc[kTW];
  conv1x3_from_mid<T>(w13, mid, b_s, c, acc);
  const float bias = b13[j];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int m = 0; m < kTW; ++m) {
    const int cc = col0 + m;
    if (cc >= w) break;
    const float v = round_to<T>(acc[m] + bias);
    st(y + (((size_t)img * h + row) * w + cc) * c + j, v);
    s1 += v;
    s2 += v * v;
  }
  float* part = partials + block_index() * 2 * c;
  part[j] = s1;
  part[c + j] = s2;
}

// Backward (1): recompute a and y, form dy; store a, dy; partial gb13.
template <typename T>
__global__ void __launch_bounds__(kMaxC)
pair_bwd_dy_kernel(const T* __restrict__ u, const T* __restrict__ gy,
                   const float* __restrict__ gsums,
                   const float* __restrict__ s, const float* __restrict__ t,
                   const T* __restrict__ w31, const float* __restrict__ b31,
                   const T* __restrict__ w13, const float* __restrict__ b13,
                   T* __restrict__ a_out, float* __restrict__ dy_out,
                   float* __restrict__ partials, int h, int w, int c,
                   int affine) {
  extern __shared__ float smem[];
  float* b_s = smem;
  float* a_s = b_s + kKC * c;
  float* mid = a_s + kM1 * kKC;
  const int j = threadIdx.x;
  const int col0 = blockIdx.x * kTW, row = blockIdx.y, img = blockIdx.z;
  pair_first_conv<T>(u, s, t, w31, b31, affine, img, row, col0, b_s, a_s,
                     mid, h, w, c);
  float acc[kTW];
  conv1x3_from_mid<T>(w13, mid, b_s, c, acc);
  const float bias = b13[j], g0 = gsums[j], g1 = gsums[c + j];
  float sdy = 0.f;
#pragma unroll
  for (int m = 0; m < kTW; ++m) {
    const int cc = col0 + m;
    if (cc >= w) break;
    const size_t o = (((size_t)img * h + row) * w + cc) * c + j;
    const float yv = round_to<T>(acc[m] + bias);
    const float dy = (ld(gy + o) + g0) + 2.f * yv * g1;
    st(a_out + o, mid[(m + 1) * c + j]);
    dy_out[o] = dy;
    sdy += dy;
  }
  partials[block_index() * 4 * c + 3 * c + j] = sdy;
}

// Backward (2): da = conv1x3^T(dy) * (a > 0); store da; partial gb31.
template <typename T>
__global__ void __launch_bounds__(kMaxC)
pair_bwd_da_kernel(const float* __restrict__ dy, const T* __restrict__ a,
                   const T* __restrict__ w13t, float* __restrict__ da_out,
                   float* __restrict__ partials, int h, int w, int c) {
  extern __shared__ float smem[];
  float* b_s = smem;
  float* a_s = b_s + kKC * c;
  const int j = threadIdx.x;
  const int col0 = blockIdx.x * kTW, row = blockIdx.y, img = blockIdx.z;
  float acc[kTW];
#pragma unroll
  for (int m = 0; m < kTW; ++m) acc[m] = 0.f;
  conv3_accumulate<float, T, kTW>(dy, w13t, img, row, col0, false, 0,
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
template <typename T>
__global__ void __launch_bounds__(kMaxC)
pair_bwd_du_kernel(const float* __restrict__ da, const T* __restrict__ u,
                   const float* __restrict__ s, const float* __restrict__ t,
                   const T* __restrict__ w31t, T* __restrict__ gu,
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
  conv3_accumulate<float, T, kTW>(da, w31t, img, row, col0, true, 0,
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
      const float gz = prologue<T>(uv, s[j], t[j]) > 0.f ? g : 0.f;
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
template <typename T>
__global__ void __launch_bounds__(256)
wgrad_kernel(const T* __restrict__ x, const float* __restrict__ g,
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
          if (affine) v = prologue<T>(v, s[ci], t[ci]);
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

template <typename T>
int launch_fwd(int affine, int n, int h, int w, int c, const void* u,
               const void* s, const void* t, const void* w31, const void* b31,
               const void* w13, const void* b13, void* y, void* sums,
               float* work, cudaStream_t stream) {
  const size_t smem = pair_smem_bytes(c);
  int err = allow_smem(pair_fwd_kernel<T>, smem);
  if (err != 0) return err;
  const int rows = n_row_blocks(n, h, w);
  float* partials = work;
  float* tmp = work + (size_t)rows * 2 * c;
  pair_fwd_kernel<T><<<dim3(ceil_div(w, kTW), h, n), c, smem, stream>>>(
      (const T*)u, (const float*)s, (const float*)t, (const T*)w31,
      (const float*)b31, (const T*)w13, (const float*)b13, (T*)y, partials,
      h, w, c, affine);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return reduce_rows(partials, (float*)sums, tmp, rows, 2 * c, stream);
}

template <typename T>
int launch_bwd(int affine, int n, int h, int w, int c, const void* u,
               const void* gy, const void* gsums, const void* s,
               const void* t, const void* w31, const void* b31,
               const void* w13, const void* b13, const void* w31t,
               const void* w13t, void* gu, void* gvec, void* gw31, void* gw13,
               void* a_act, void* g_act, float* work, cudaStream_t stream) {
  const size_t pix = (size_t)n * h * w * c;
  T* a = (T*)a_act;
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
  int err = allow_smem(pair_bwd_dy_kernel<T>, smem_pair);
  if (err != 0) return err;

  pair_bwd_dy_kernel<T><<<grid, c, smem_pair, stream>>>(
      (const T*)u, (const T*)gy, (const float*)gsums, (const float*)s,
      (const float*)t, (const T*)w31, (const float*)b31, (const T*)w13,
      (const float*)b13, a, dy, vec_part, h, w, c, affine);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  pair_bwd_da_kernel<T><<<grid, c, smem_conv, stream>>>(
      dy, a, (const T*)w13t, da, vec_part, h, w, c);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  pair_bwd_du_kernel<T><<<grid, c, smem_conv, stream>>>(
      da, (const T*)u, (const float*)s, (const float*)t, (const T*)w31t,
      (T*)gu, vec_part, h, w, c, affine);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  if ((err = reduce_rows(vec_part, (float*)gvec, tmp, rows, 4 * c, stream)))
    return err;

  const int total = n * h * w;
  const dim3 wg_grid(chunks, c / kWgT, c / kWgT);
  wgrad_kernel<T><<<wg_grid, 256, 0, stream>>>(
      a, dy, nullptr, nullptr, 0, 0, wg_part, total, h, w, c);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  if ((err = reduce_rows(wg_part, (float*)gw13, tmp, chunks, 3 * c * c,
                         stream)))
    return err;
  wgrad_kernel<T><<<wg_grid, 256, 0, stream>>>(
      (const T*)u, da, (const float*)s, (const float*)t, affine, 1, wg_part,
      total, h, w, c);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  return reduce_rows(wg_part, (float*)gw31, tmp, chunks, 3 * c * c, stream);
}

inline bool channels_ok(int c) {
  return c == 64 || c == 128 || c == 256;
}

}  // namespace emsanet

// Workspace floats of one forward / backward call at this shape.
extern "C" int nbt1d_train_fwd_workspace(int n, int h, int w, int c) {
  using namespace emsanet;
  return n_row_blocks(n, h, w) * 2 * c + kReduceSplits * 2 * c;
}

extern "C" int nbt1d_train_bwd_workspace(int n, int h, int w, int c) {
  using namespace emsanet;
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
  if (dtype == kBF16)
    return launch_fwd<__nv_bfloat16>(affine, n, h, w, c, u, s, t, w31, b31,
                                     w13, b13, y, sums, (float*)work, st);
  return launch_fwd<float>(affine, n, h, w, c, u, s, t, w31, b31, w13, b13,
                           y, sums, (float*)work, st);
}

// gvec (4, C) f32: gs, gt, gb31, gb13; gw31, gw13 (3, C, C) f32; a_act
// holds one (N, H, W, C) tensor of the storage type (a), g_act two in
// f32 (dy, da).
extern "C" int nbt1d_train_bwd_launch(
    int dtype, int affine, int n, int h, int w, int c, const void* u,
    const void* gy, const void* gsums, const void* s, const void* t,
    const void* w31, const void* b31, const void* w13, const void* b13,
    const void* w31t, const void* w13t, void* gu, void* gvec, void* gw31,
    void* gw13, void* a_act, void* g_act, void* work, void* stream) {
  using namespace emsanet;
  if (!channels_ok(c)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_bwd<__nv_bfloat16>(affine, n, h, w, c, u, gy, gsums, s, t,
                                     w31, b31, w13, b13, w31t, w13t, gu, gvec,
                                     gw31, gw13, a_act, g_act, (float*)work,
                                     st);
  return launch_bwd<float>(affine, n, h, w, c, u, gy, gsums, s, t, w31, b31,
                           w13, b13, w31t, w13t, gu, gvec, gw31, gw13, a_act,
                           g_act, (float*)work, st);
}
