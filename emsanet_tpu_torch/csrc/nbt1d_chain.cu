// Stride-1 NonBottleneck1D blocks at inference, the whole chain per call.
//
// Replaces the TPU kernel `emsanet_tpu/ops/nbt1d_chain.py::nbt1d_chain`
// (`_chain_kernel`, pl.pallas_call at nbt1d_chain.py:434). A block is
//   h = relu(bn1(conv1x3(relu(conv3x1(x) + b0)) + b1))
//   y = relu(bn2(conv1x3(relu(conv3x1(h) + b2)) + b3) + x)
// with the BatchNorms folded to per-channel scale/shift: two conv pairs,
// each conv3x1 + bias + ReLU, then conv1x3 + bias + folded BN (+ the
// block's input) + ReLU. `nbt1d_chain_launch` runs all K blocks of a
// chain, ping-ponging between two output buffers.
//
// What bounds it on the H100: at the flagship's sites (C = 64..512,
// 15x20 .. 120x160 pixels) a conv does 3 C^2 multiply-adds per pixel
// against 2 x 2 C bytes of bf16 activations: ~1.5 C flop per byte, so
// the bf16 tensor cores bound every site with C >= 256; at C = 64 (96
// flop per byte, below the card's ~295) device memory does, and C = 128
// sits near the line. The TPU kernel kept a K-block chain resident in
// 16 MB of VMEM; that does not fit in Hopper's 227 KB of shared memory.
//
// Paths. bf16 (the inference path): warpgroup MMA (`wgmma`, m64nNk16,
// f32 accumulators) fed by TMA, csrc/conv_wgmma.cuh:
//  - C = 64 and 128: the pair in one launch (nbt1d_pair64_kernel,
//    nbt1d_pair128_kernel) that keeps the conv3x1 output tile and its
//    one-column halo in shared memory, as the train pair's forward
//    (csrc/nbt1d_train.cu, namespace tc) does; C = 64 keeps its weights
//    in shared memory, C = 128 streams them.
//  - C = 256 and 512: each conv is one implicit GEMM launch
//    (conv3tap_wgmma_kernel, M = pixels, K = 3 taps x C, N = C), the
//    pair's bf16 intermediate written to device memory (it stays in the
//    50 MB L2 at these sizes). A fused pair's conv3x1 output (all C
//    channels of 128 pixels, three shifted copies) would not fit in
//    shared memory beside its input.
// f32 (the path that checks the arithmetic): the CUDA cores, f32 FMA, the
// whole pair in one launch (nbt1d_pair_kernel, below). Every path applies
// zero padding per conv (a pixel outside the image reads 0, never a
// bias/ReLU value of the previous conv) and rounds the pair's
// intermediate to the storage type, as the unfused path writes it in
// that type; the epilogues run in f32.
//
// Layouts: x, res, out (N, H, W, C) NHWC contiguous. f32 path: w31, w13
// (K, 2, 3, C, C) [block][pair][tap][c_in][c_out]; bf16 path: wt (K, 2,
// 2, 3, C, C) [block][pair][conv][tap][c_out][c_in] (K-major, the wgmma
// B operand); b31, b13, scale, shift (K, 2, C) f32.

#include "conv_wgmma.cuh"

namespace emsanet {

// f32 path: one block per (image, row, segment of kTW columns), C
// threads, thread j owns output channel j of every pixel of the segment;
// the segment's conv3x1 intermediate covers kTW + 2 columns (the conv1x3
// halo) and stays in shared memory.
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
// bf16 path
//
// Loads. Weights: a 2-D tensor map over wt viewed as (C_in, rows), one
// box of 64 input channels x BN output channels per K step. Activations:
// a 4-D tensor map over NHWC (C, W, H, N) whose box is a rectangle of
// pixels x 64 channels; a tap's shift is a shift of the box's coordinates,
// and the map's out-of-bounds zero fill is exactly the per-conv zero
// padding, so no pixel predicate is evaluated anywhere. The rectangle is
// 8 columns x 8 rows (64 pixels, one m64); boxes at W = 20 and 40 waste
// at most 4 of 24 columns, so TMA was chosen over predicated cp.async or
// register A operands.
//
// Work. A persistent grid, two blocks per SM, walks units (64-pixel
// tile, 128-channel N tile, K split) with the N tiles of a pixel tile
// adjacent, so concurrently running blocks share the A tile in L2 (all
// weights, <= 1.5 MB per conv, stay there too). In a block one producer
// warp keeps the TMA loads of the next stages in flight behind a 4-stage
// mbarrier ring (24 KB a stage) and one consumer warpgroup issues the
// wgmma (m64n128k16) and runs the epilogue on the accumulators (bias,
// folded BN, residual, ReLU, bf16 store): one block's epilogue runs under
// the other's MMAs. Two warpgroups sharing 128-pixel tiles in one block
// per SM measured slower: fewer, larger tiles leave a worse last wave and
// no epilogue overlap. Where the tiles fill few of the blocks that fit
// (the b1 15x20 site at C = 512: 24 tiles), K is split across blocks:
// each split writes f32 partials, and splitk_epilogue_kernel adds them in
// split order and runs the epilogue, so repeated calls give the same
// bits (no float atomics). Adding them in the conv kernel instead, by the
// last split to arrive or by all splits after a grid barrier, measured
// slower.

namespace chain {

using wg::bf16;

constexpr int kCW = 8, kCH = 8;    // conv tile: 8 columns x 8 rows
constexpr int kBM = kCW * kCH;     // 64 pixels: one m64 of one warpgroup
constexpr int kBK = 64;            // K step: 64 channels of one tap
constexpr int kBN = 128;           // output channels per unit
constexpr int kStages = 4;
constexpr int kConvThreads = 128 + 32;  // a consumer warpgroup, a producer
constexpr int kConvBlocks = 2;          // per SM
constexpr int kABytes = kBM * kBK * 2;
constexpr int kBBytes = kBN * kBK * 2;
constexpr size_t kConvSmem = kStages * (kABytes + kBBytes) + 1024 + 256;

constexpr int kPairWGs = 2;        // warpgroups of the C = 64 pair kernel
constexpr int kPairThreads = kPairWGs * 128 + 32;

struct Epilogue {
  const float* bias;
  const float* scale;  // null: no BatchNorm (the conv3x1)
  const float* shift;
  const bf16* res;     // null: no residual
  bf16* out;
  int c;
};

// A conv's per-channel epilogue constants, staged in shared memory once
// per block (scale 1 and shift 0 where there is no BatchNorm: the same
// bits as leaving them out), so the epilogue's loads of them do not wait
// behind its global stores.
struct EpiConsts {
  float bias[512], scale[512], shift[512];
};

__device__ __forceinline__ void stage_consts(EpiConsts& s, const Epilogue& e) {
  for (int i = threadIdx.x; i < e.c; i += blockDim.x) {
    s.bias[i] = e.bias[i];
    s.scale[i] = e.scale != nullptr ? e.scale[i] : 1.f;
    s.shift[i] = e.scale != nullptr ? e.shift[i] : 0.f;
  }
}

// The epilogue of one accumulator row: channels ch0 + 8 j (+ 1) of pixel
// pix from accumulators 4 j + 2 half (+ 1). The row's residual loads are
// all issued before its first store.
template <int NJ>
__device__ __forceinline__ void epilogue_row(const EpiConsts& s,
                                             const Epilogue& e, size_t pix,
                                             int ch0,
                                             const float (&acc)[NJ * 4],
                                             int half) {
  const size_t o = pix * e.c + ch0;
  __nv_bfloat162 r[NJ];
  if (e.res != nullptr) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      r[j] = *reinterpret_cast<const __nv_bfloat162*>(e.res + o + 8 * j);
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int ch = ch0 + 8 * j;
    float v0 = (acc[4 * j + 2 * half] + s.bias[ch]) * s.scale[ch] +
               s.shift[ch];
    float v1 = (acc[4 * j + 2 * half + 1] + s.bias[ch + 1]) *
                   s.scale[ch + 1] +
               s.shift[ch + 1];
    if (e.res != nullptr) {
      const float2 f = __bfloat1622float2(r[j]);
      v0 += f.x;
      v1 += f.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(e.out + o + 8 * j) =
        __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
  }
}

// The epilogue of channels ch and ch + 1 of pixel pix (the split-K
// epilogue).
__device__ __forceinline__ void epilogue_pair(const EpiConsts& s,
                                              const Epilogue& e, size_t pix,
                                              int ch, float v0, float v1) {
  v0 = (v0 + s.bias[ch]) * s.scale[ch] + s.shift[ch];
  v1 = (v1 + s.bias[ch + 1]) * s.scale[ch + 1] + s.shift[ch + 1];
  const size_t o = pix * e.c + ch;
  if (e.res != nullptr) {
    const float2 r = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(e.res + o));
    v0 += r.x;
    v1 += r.y;
  }
  *reinterpret_cast<__nv_bfloat162*>(e.out + o) =
      __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
}

struct ConvArgs {
  CUtensorMap src;  // activations (C, W, H, N), box (64, kCW, kCH, 1)
  CUtensorMap wts;  // weights (C_in, rows), box (64, kBN)
  Epilogue epi;
  float* partial;   // splits > 1: (m tiles, splits, kBM, C) f32
  int h, w, c;
  int w_row0;       // weight row of tap 0, output channel 0
  int vertical;     // 1: conv3x1 (taps shift rows), 0: conv1x3 (columns)
  int tiles_x, tiles_y, tiles_n, splits, units;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (wg::smem_u32(p) & 1023)) & 1023);
}

__global__ void __launch_bounds__(kConvThreads, kConvBlocks)
conv3tap_wgmma_kernel(const __grid_constant__ ConvArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = align1024(smem_raw);
  uint8_t* sb = sa + kStages * kABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kStages * kBBytes);
  uint64_t* empty = full + kStages;
  __shared__ EpiConsts consts;
  const int kc_n = a.c / kBK;
  const int n_it = 3 * kc_n / a.splits;  // K steps per unit
  stage_consts(consts, a.epi);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 1);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();
  const int per_img = a.tiles_x * a.tiles_y;

  if (threadIdx.x >= 128) {  // the producer warp
    if (threadIdx.x == 128) {
      int it = 0;
      for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
        const int sp = u % a.splits, nt = (u / a.splits) % a.tiles_n;
        const int mt = u / (a.splits * a.tiles_n);
        const int img = mt / per_img, rem = mt % per_img;
        const int y0 = (rem / a.tiles_x) * kCH, x0 = (rem % a.tiles_x) * kCW;
        for (int i = 0; i < n_it; ++i, ++it) {
          const int s = it % kStages;
          wg::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          wg::mbar_expect_tx(&full[s], kABytes + kBBytes);
          const int g = sp * n_it + i;
          const int tap = g / kc_n, kc = g % kc_n;
          const int dy = a.vertical ? tap - 1 : 0;
          const int dx = a.vertical ? 0 : tap - 1;
          wg::tma_load_4d(sa + s * kABytes, &a.src, &full[s], kc * kBK,
                          x0 + dx, y0 + dy, img);
          wg::tma_load_2d(sb + s * kBBytes, &a.wts, &full[s], kc * kBK,
                          a.w_row0 + tap * a.c + nt * kBN);
        }
      }
    }
    return;
  }
  // the consumer warpgroup
  const int t = threadIdx.x;
  const int row_base = (t / 32) * 16 + (t % 32) / 4;
  const int col_base = (t % 4) * 2;
  float acc[kBN / 2];
  int it = 0;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    const int sp = u % a.splits, nt = (u / a.splits) % a.tiles_n;
    const int mt = u / (a.splits * a.tiles_n);
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    for (int i = 0; i < n_it; ++i, ++it) {
      const int s = it % kStages;
      wg::mbar_wait(&full[s], (it / kStages) & 1);
      wg::fence_regs(acc);
      wg::wgmma_fence();
      const uint64_t da = wg::make_desc(sa + s * kABytes);
      const uint64_t db = wg::make_desc(sb + s * kBBytes);
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k)
        wg::wgmma_k16<kBN>(acc, da + 2 * k, db + 2 * k);
      wg::wgmma_commit();
      wg::fence_regs(acc);
      wg::wgmma_wait<1>();  // the previous step's MMAs are done
      if (i > 0 && t == 0) wg::mbar_arrive(&empty[(it - 1) % kStages]);
    }
    wg::wgmma_wait<0>();
    wg::fence_regs(acc);
    if (t == 0) wg::mbar_arrive(&empty[(it - 1) % kStages]);

    // accumulator 4 j + 2 half + e: tile row row_base + 8 half, channel
    // nt kBN + 8 j + col_base + e
    if (a.splits > 1) {  // the split's partials
      float* part = a.partial + ((size_t)mt * a.splits + sp) * kBM * a.c +
                    nt * kBN + col_base;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row_base + 8 * half;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
          *reinterpret_cast<float2*>(part + (size_t)r * a.c + 8 * j) =
              make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
      continue;
    }
    const int img = mt / per_img, rem = mt % per_img;
    const int y0 = (rem / a.tiles_x) * kCH, x0 = (rem % a.tiles_x) * kCW;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row_base + 8 * half;
      const int y = y0 + r / kCW, x = x0 + r % kCW;
      if (y >= a.h || x >= a.w) continue;
      epilogue_row<kBN / 8>(consts, a.epi,
                            ((size_t)img * a.h + y) * a.w + x,
                            nt * kBN + col_base, acc, half);
    }
  }
}

// The split partials of every pixel tile added in split order, then the
// epilogue; one thread per pair of channels of one tile row.
__global__ void __launch_bounds__(256)
splitk_epilogue_kernel(const float* __restrict__ partial, Epilogue e, int h,
                       int w, int tiles_x, int tiles_y, int splits,
                       int m_tiles) {
  __shared__ EpiConsts consts;
  stage_consts(consts, e);
  __syncthreads();
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int half_c = e.c / 2;
  if (idx >= (size_t)m_tiles * kBM * half_c) return;
  const int cp = 2 * (int)(idx % half_c);
  const int r = (idx / half_c) % kBM;
  const int mt = idx / ((size_t)kBM * half_c);
  const int per_img = tiles_x * tiles_y;
  const int img = mt / per_img, rem = mt % per_img;
  const int y = (rem / tiles_x) * kCH + r / kCW;
  const int x = (rem % tiles_x) * kCW + r % kCW;
  if (y >= h || x >= w) return;
  const float* p = partial + ((size_t)mt * splits * kBM + r) * e.c + cp;
  float v0 = 0.f, v1 = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float2 q =
        *reinterpret_cast<const float2*>(p + (size_t)s * kBM * e.c);
    v0 += q.x;
    v1 += q.y;
  }
  epilogue_pair(consts, e, ((size_t)img * h + y) * w + x, cp, v0, v1);
}

// ---- the C = 64 pair in one launch -----------------------------------------
//
// A warpgroup's tile is 4 rows x 14 output columns. Its conv3x1 runs over
// the tile plus one column each side, 4 x 16 = 64 pixels (one m64), from
// one TMA box of 6 rows x 16 columns: a row shift is 16 pixels, 2048
// bytes, a whole number of swizzle periods, so the three taps' A operands
// are the box at three offsets. Its epilogue (bias, ReLU, bf16 rounding;
// 0 outside the image's columns) writes each intermediate value into three
// 64-pixel K-major tiles, one per conv1x3 tap, shifted by that tap's
// column, so each tap's A operand is again an aligned swizzled tile; then
// fence.proxy.async and a warpgroup barrier before the conv1x3's wgmma.
// The pair's weights (48 KB) are loaded once per block and stay; the input
// boxes stream through a 3-stage ring; two warpgroups per block share an
// 8 x 14 tile (one box of 10 rows). One warpgroup per block and two
// blocks per SM measured slower (more halo rows per output row).

constexpr int kFW = 16;                 // intermediate columns
constexpr int kFOut = kFW - 2;          // output columns per tile
constexpr int kFStages = 3;
constexpr int kFWBytes = 64 * 64 * 2;   // one tap of one conv
constexpr int kFABytes = 64 * 128;      // one warpgroup's conv1x3 operand

constexpr int kFRows = 4 * kPairWGs;  // output rows per tile
constexpr int kFXBytes = (kFRows + 2) * kFW * 128;
constexpr size_t kPairSmem = 6 * kFWBytes + kFStages * kFXBytes +
                             3 * kPairWGs * kFABytes + 1024 + 256;

struct PairArgs {
  CUtensorMap src;  // (64, W, H, N), box (64, 16, rows + 2, 1)
  CUtensorMap wts;  // (64, rows), box (64, 64)
  const float* b31;
  Epilogue epi;     // the conv1x3's: b13, scale, shift, res, out
  int h, w, w_row0, tiles_x, tiles_y, units;
};

__global__ void __launch_bounds__(kPairThreads, 1)
nbt1d_pair64_kernel(const __grid_constant__ PairArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sw = align1024(smem_raw);
  uint8_t* sx = sw + 6 * kFWBytes;
  uint8_t* s2 = sx + kFStages * kFXBytes;  // [tap][warpgroup] tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(s2 + 3 * kPairWGs * kFABytes);
  uint64_t* empty = full + kFStages;
  uint64_t* wbar = empty + kFStages;
  __shared__ float b31[64];
  __shared__ EpiConsts consts;  // the conv1x3's (64 channels used)
  stage_consts(consts, a.epi);
  if (threadIdx.x < 64) b31[threadIdx.x] = a.b31[threadIdx.x];
  // rows of the conv1x3 tiles that no intermediate value reaches stay 0
  // (their outputs are not stored)
  for (int i = threadIdx.x; i < 3 * kPairWGs * kFABytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(s2)[i] = make_uint4(0, 0, 0, 0);
  wg::fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFStages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], kPairWGs);
    }
    wg::mbar_init(wbar, 1);
    wg::mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int per_img = a.tiles_x * a.tiles_y;

  if (warp == kPairWGs * 4) {  // producer
    if (threadIdx.x % 32 == 0) {
      wg::mbar_expect_tx(wbar, 6 * kFWBytes);
      for (int q = 0; q < 6; ++q)  // [conv][tap]
        wg::tma_load_2d(sw + q * kFWBytes, &a.wts, wbar, 0, a.w_row0 + q * 64);
      int it = 0;
      for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++it) {
        const int img = u / per_img, rem = u % per_img;
        const int y0 = (rem / a.tiles_x) * kFRows;
        const int x0 = (rem % a.tiles_x) * kFOut;
        const int s = it % kFStages;
        wg::mbar_wait(&empty[s], ((it / kFStages) & 1) ^ 1);
        wg::mbar_expect_tx(&full[s], kFXBytes);
        wg::tma_load_4d(sx + s * kFXBytes, &a.src, &full[s], 0, x0 - 1,
                        y0 - 1, img);
      }
    }
    return;
  }

  const int cw = warp / 4, t = threadIdx.x % 128;
  const int row_base = (t / 32) * 16 + (t % 32) / 4;  // within the m64
  const int col_base = (t % 4) * 2;
  uint8_t* s2w = s2 + cw * kFABytes;
  wg::mbar_wait(wbar, 0);
  float acc[32];
  int it = 0;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++it) {
    const int img = u / per_img, rem = u % per_img;
    const int y0 = (rem / a.tiles_x) * kFRows + 4 * cw;  // this warpgroup
    const int x0 = (rem % a.tiles_x) * kFOut;
    const int s = it % kFStages;
    wg::mbar_wait(&full[s], (it / kFStages) & 1);
    // conv3x1 over the warpgroup's 4 rows and their column halo
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    wg::fence_regs(acc);
    wg::wgmma_fence();
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const uint64_t da =
          wg::make_desc(sx + s * kFXBytes + ((dy + 4 * cw) * kFW) * 128);
      const uint64_t db = wg::make_desc(sw + dy * kFWBytes);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wg::wgmma_k16<64>(acc, da + 2 * k, db + 2 * k);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(acc);
    if (t == 0) wg::mbar_arrive(&empty[s]);
    // bias, ReLU, bf16; the intermediate at column j of the tile becomes
    // row (r - dx) of tap dx's conv1x3 operand
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row_base + 8 * half;
      const int j = r % kFW, xc = x0 - 1 + j;
      const bool inside = xc >= 0 && xc < a.w;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int ch = 8 * q + col_base;
        const float v0 = fmaxf(acc[4 * q + 2 * half] + b31[ch], 0.f);
        const float v1 = fmaxf(acc[4 * q + 2 * half + 1] + b31[ch + 1], 0.f);
        const __nv_bfloat162 v = inside ? __floats2bfloat162_rn(v0, v1)
                                        : __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          if (j - dx < 0) continue;
          *reinterpret_cast<__nv_bfloat162*>(s2w + dx * kPairWGs * kFABytes +
                                             wg::swizzled_offset(r - dx, ch)) =
              v;
        }
      }
    }
    wg::fence_proxy_async();
    wg::named_barrier(1 + cw, 128);
    // conv1x3 from the three shifted tiles
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    wg::fence_regs(acc);
    wg::wgmma_fence();
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const uint64_t da = wg::make_desc(s2w + dx * kPairWGs * kFABytes);
      const uint64_t db = wg::make_desc(sw + (3 + dx) * kFWBytes);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wg::wgmma_k16<64>(acc, da + 2 * k, db + 2 * k);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(acc);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row_base + 8 * half;
      const int tx = r % kFW, y = y0 + r / kFW, x = x0 + tx;
      if (tx >= kFOut || y >= a.h || x >= a.w) continue;
      epilogue_row<8>(consts, a.epi, ((size_t)img * a.h + y) * a.w + x,
                      col_base, acc, half);
    }
  }
}

// ---- the C = 128 pair in one launch ----------------------------------------
//
// The C = 64 pair's tiling, with the weights streamed: the pair's 192 KB
// of weights do not fit beside the tiles, so the 12 chunks of 64 input x
// 128 output channels a tile needs (2 convs x 3 taps x 2 input halves)
// stream through a 4-slot mbarrier ring, shared by both warpgroups. A
// tile's input box (2 halves of 64 channels) has one slot, reloaded
// during the tile's conv1x3. Per tile the weights are read once for 128
// intermediate pixels, where the unfused pair's convs read them once per
// 64-pixel tile; the conv3x1 output never leaves shared memory.

constexpr int kQWSlots = 4;                 // weight ring slots
constexpr int kQWBytes = 64 * 128 * 2;      // 64 input x 128 output ch
constexpr int kQXBytes = 2 * kFXBytes;      // both 64-channel halves
constexpr size_t kPair128Smem = kQXBytes + kQWSlots * kQWBytes +
                                3 * 2 * kPairWGs * kFABytes + 1024 + 256;

__global__ void __launch_bounds__(kPairThreads, 1)
nbt1d_pair128_kernel(const __grid_constant__ PairArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sx = align1024(smem_raw);      // [half] input boxes
  uint8_t* sw = sx + kQXBytes;            // [slot] weight chunks
  uint8_t* s2 = sw + kQWSlots * kQWBytes;  // [tap][half][warpgroup] tiles
  uint64_t* wfull = reinterpret_cast<uint64_t*>(s2 + 6 * kPairWGs * kFABytes);
  uint64_t* wempty = wfull + kQWSlots;
  uint64_t* xfull = wempty + kQWSlots;
  uint64_t* xempty = xfull + 1;
  __shared__ float b31[128];
  __shared__ EpiConsts consts;  // the conv1x3's (128 channels used)
  stage_consts(consts, a.epi);
  if (threadIdx.x < 128) b31[threadIdx.x] = a.b31[threadIdx.x];
  // rows of the conv1x3 tiles that no intermediate value reaches stay 0
  for (int i = threadIdx.x; i < 6 * kPairWGs * kFABytes / 16;
       i += blockDim.x)
    reinterpret_cast<uint4*>(s2)[i] = make_uint4(0, 0, 0, 0);
  wg::fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kQWSlots; ++s) {
      wg::mbar_init(&wfull[s], 1);
      wg::mbar_init(&wempty[s], kPairWGs);
    }
    wg::mbar_init(xfull, 1);
    wg::mbar_init(xempty, kPairWGs);
    wg::mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int per_img = a.tiles_x * a.tiles_y;

  if (warp == kPairWGs * 4) {  // producer
    if (threadIdx.x % 32 == 0) {
      int wit = 0, it = 0;
      for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++it) {
        const int img = u / per_img, rem = u % per_img;
        const int y0 = (rem / a.tiles_x) * kFRows;
        const int x0 = (rem % a.tiles_x) * kFOut;
        wg::mbar_wait(xempty, (it & 1) ^ 1);
        wg::mbar_expect_tx(xfull, kQXBytes);
        for (int hc = 0; hc < 2; ++hc)
          wg::tma_load_4d(sx + hc * kFXBytes, &a.src, xfull, 64 * hc, x0 - 1,
                          y0 - 1, img);
        for (int q = 0; q < 12; ++q, ++wit) {  // [conv][tap][half]
          const int s = wit % kQWSlots;
          wg::mbar_wait(&wempty[s], ((wit / kQWSlots) & 1) ^ 1);
          wg::mbar_expect_tx(&wfull[s], kQWBytes);
          wg::tma_load_2d(sw + s * kQWBytes, &a.wts, &wfull[s], 64 * (q % 2),
                          a.w_row0 + (q / 2) * 128);
        }
      }
    }
    return;
  }

  const int cw = warp / 4, t = threadIdx.x % 128;
  const int row_base = (t / 32) * 16 + (t % 32) / 4;  // within the m64
  const int col_base = (t % 4) * 2;
  float acc[64];
  int wit = 0, it = 0;
  // six chunks of one conv: A of chunk q from a_of(q), B the ring's next
  auto conv = [&](auto a_of) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int q = 0; q < 6; ++q, ++wit) {
      const int s = wit % kQWSlots;
      wg::mbar_wait(&wfull[s], (wit / kQWSlots) & 1);
      wg::fence_regs(acc);
      wg::wgmma_fence();
      const uint64_t da = wg::make_desc(a_of(q));
      const uint64_t db = wg::make_desc(sw + s * kQWBytes);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wg::wgmma_k16<128>(acc, da + 2 * k, db + 2 * k);
      wg::wgmma_commit();
      wg::fence_regs(acc);
      wg::wgmma_wait<1>();
      if (q > 0 && t == 0) wg::mbar_arrive(&wempty[(wit - 1) % kQWSlots]);
    }
    wg::wgmma_wait<0>();
    wg::fence_regs(acc);
    if (t == 0) wg::mbar_arrive(&wempty[(wit - 1) % kQWSlots]);
  };
  for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++it) {
    const int img = u / per_img, rem = u % per_img;
    const int y0 = (rem / a.tiles_x) * kFRows + 4 * cw;  // this warpgroup
    const int x0 = (rem % a.tiles_x) * kFOut;
    wg::mbar_wait(xfull, it & 1);
    // conv3x1 over the warpgroup's 4 rows and their column halo: chunk q
    // is tap q / 2, input half q % 2
    conv([&](int q) {
      return sx + (q % 2) * kFXBytes + ((q / 2 + 4 * cw) * kFW) * 128;
    });
    if (t == 0) wg::mbar_arrive(xempty);
    // bias, ReLU, bf16; the intermediate at column j of the tile becomes
    // row (r - dx) of tap dx's conv1x3 operand, in channel half j / 8
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row_base + 8 * half;
      const int j = r % kFW, xc = x0 - 1 + j;
      const bool inside = xc >= 0 && xc < a.w;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int ch = 8 * q + col_base;
        const float v0 = fmaxf(acc[4 * q + 2 * half] + b31[ch], 0.f);
        const float v1 = fmaxf(acc[4 * q + 2 * half + 1] + b31[ch + 1], 0.f);
        const __nv_bfloat162 v = inside ? __floats2bfloat162_rn(v0, v1)
                                        : __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          if (j - dx < 0) continue;
          uint8_t* tile =
              s2 + ((dx * 2 + q / 8) * kPairWGs + cw) * kFABytes;
          *reinterpret_cast<__nv_bfloat162*>(
              tile + wg::swizzled_offset(r - dx, ch % 64)) = v;
        }
      }
    }
    wg::fence_proxy_async();
    wg::named_barrier(1 + cw, 128);
    // conv1x3 from the shifted tiles: chunk q is tap q / 2, half q % 2
    conv([&](int q) { return s2 + (q * kPairWGs + cw) * kFABytes; });
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row_base + 8 * half;
      const int tx = r % kFW, y = y0 + r / kFW, x = x0 + tx;
      if (tx >= kFOut || y >= a.h || x >= a.w) continue;
      epilogue_row<16>(consts, a.epi, ((size_t)img * a.h + y) * a.w + x,
                       col_base, acc, half);
    }
  }
}

// ---- host side -----------------------------------------------------------

inline int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

struct ConvGeom {
  int tiles_x, tiles_y, tiles_n, m_tiles, splits, slots;
};

// slots: the blocks that fit on the card at once. K is split only where a
// unit has 24 or more K steps (C = 512), into up to 4 parts while the
// units fit the slots: at the smaller C the split epilogue's launch and
// partials cost more than the K steps they save (measured at the b1
// sites, PERF.md, PR 6).
inline ConvGeom conv_geom(int n, int h, int w, int c) {
  ConvGeom g;
  g.tiles_x = ceil_div(w, kCW);
  g.tiles_y = ceil_div(h, kCH);
  g.tiles_n = c / kBN;
  g.m_tiles = n * g.tiles_x * g.tiles_y;
  g.slots = num_sms() * kConvBlocks;
  const int steps = 3 * c / kBK, tiles = g.m_tiles * g.tiles_n;
  g.splits = 1;
  for (int d = 1; steps >= 24 && d <= 4; ++d)
    if (steps % d == 0 && tiles * d <= g.slots) g.splits = d;
  return g;
}

// (C, W, H, N) over NHWC bf16 with a (64, bw, bh, 1) box.
inline int act_map(CUtensorMap* m, const void* p, int n, int h, int w, int c,
                   int bw, int bh) {
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 2, (cuuint64_t)w * c * 2,
                                 (cuuint64_t)h * w * c * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  return encode_map(m, p, 4, dims, strides, box);
}

inline int weight_map(CUtensorMap* m, const void* p, int rows, int c, int bn) {
  const cuuint64_t dims[2] = {(cuuint64_t)c, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)c * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)bn};
  return encode_map(m, p, 2, dims, strides, box);
}

inline int set_smem(const void* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The C = 64 or C = 128 pairs, one launch each.
int run_pairs(int n, int h, int w, int c, int k, const bf16* x,
              const void* wt, const float* b31, const float* b13,
              const float* sc, const float* sh, bf16* const bufs[4],
              cudaStream_t st) {
  const void* kernel = c == 64 ? (const void*)nbt1d_pair64_kernel
                               : (const void*)nbt1d_pair128_kernel;
  const size_t smem = c == 64 ? kPairSmem : kPair128Smem;
  static bool configured[2] = {false, false};
  int err = 0;
  if (!configured[c == 128]) {
    if ((err = set_smem(kernel, smem))) return err;
    configured[c == 128] = true;
  }
  PairArgs a;
  if ((err = weight_map(&a.wts, wt, k * 2 * 2 * 3 * c, c, c))) return err;
  CUtensorMap maps[4];  // x, mid, and the two block outputs
  const void* bases[4] = {x, bufs[1], bufs[2], bufs[3]};
  for (int i = 0; i < 4; ++i)
    if ((err = act_map(&maps[i], bases[i], n, h, w, c, kFW, kFRows + 2)))
      return err;
  a.h = h;
  a.w = w;
  a.tiles_x = ceil_div(w, kFOut);
  a.tiles_y = ceil_div(h, kFRows);
  a.units = n * a.tiles_x * a.tiles_y;
  const int grid = a.units < num_sms() ? a.units : num_sms();
  const bf16* cur = x;
  int cur_map = 0;
  for (int b = 0; b < k; ++b) {
    for (int p = 0; p < 2; ++p) {
      const size_t v = (size_t)(2 * b + p) * c;
      a.src = maps[p == 0 ? cur_map : 1];
      a.w_row0 = (2 * b + p) * 2 * 3 * c;
      a.b31 = b31 + v;
      a.epi = {b13 + v, sc + v, sh + v, p == 0 ? nullptr : cur,
               p == 0 ? bufs[1] : bufs[2 + b % 2], c};
      void* params[] = {&a};
      if ((err = (int)cudaLaunchKernel(kernel, dim3(grid), dim3(kPairThreads),
                                       params, smem, st)))
        return err;
    }
    cur = bufs[2 + b % 2];
    cur_map = 2 + b % 2;
  }
  return 0;
}

int run_convs(int n, int h, int w, int c, int k, const bf16* x,
              const void* wt, const float* b31, const float* b13,
              const float* sc, const float* sh, bf16* const bufs[4],
              float* ws, cudaStream_t st) {
  static bool configured = false;
  int err = 0;
  if (!configured) {
    if ((err = set_smem((const void*)conv3tap_wgmma_kernel, kConvSmem)))
      return err;
    configured = true;
  }
  const ConvGeom g = conv_geom(n, h, w, c);
  CUtensorMap wmap, maps[5];  // x, t, mid, and the two block outputs
  if ((err = weight_map(&wmap, wt, k * 2 * 2 * 3 * c, c, kBN))) return err;
  const void* bases[5] = {x, bufs[0], bufs[1], bufs[2], bufs[3]};
  for (int i = 0; i < 5; ++i)
    if ((err = act_map(&maps[i], bases[i], n, h, w, c, kCW, kCH))) return err;
  ConvArgs a;
  a.wts = wmap;
  a.partial = ws;
  a.h = h;
  a.w = w;
  a.c = c;
  a.tiles_x = g.tiles_x;
  a.tiles_y = g.tiles_y;
  a.tiles_n = g.tiles_n;
  a.splits = g.splits;
  a.units = g.m_tiles * g.tiles_n * g.splits;
  const int grid = a.units < g.slots ? a.units : g.slots;
  const int red_blocks =
      (int)(((size_t)g.m_tiles * kBM * (c / 2) + 255) / 256);
  // one conv: a.src -> a.epi, through the split partials if any
  auto conv = [&]() {
    conv3tap_wgmma_kernel<<<grid, kConvThreads, kConvSmem, st>>>(a);
    const int r = (int)cudaGetLastError();
    if (r != 0 || g.splits == 1) return r;
    splitk_epilogue_kernel<<<red_blocks, 256, 0, st>>>(
        ws, a.epi, h, w, g.tiles_x, g.tiles_y, g.splits, g.m_tiles);
    return (int)cudaGetLastError();
  };
  const bf16* cur = x;
  int cur_map = 0;
  for (int b = 0; b < k; ++b) {
    for (int p = 0; p < 2; ++p) {
      const size_t vo = (size_t)(2 * b + p) * c;
      const int row0 = (2 * b + p) * 2 * 3 * c;
      // conv3x1 (+ bias, ReLU) into t, then conv1x3 (+ bias, BN, residual,
      // ReLU) into mid or the block's output
      a.src = maps[p == 0 ? cur_map : 2];
      a.w_row0 = row0;
      a.vertical = 1;
      a.epi = {b31 + vo, nullptr, nullptr, nullptr, bufs[0], c};
      if ((err = conv())) return err;
      a.src = maps[1];
      a.w_row0 = row0 + 3 * c;
      a.vertical = 0;
      a.epi = {b13 + vo, sc + vo, sh + vo, p == 0 ? nullptr : cur,
               p == 0 ? bufs[1] : bufs[2 + b % 2], c};
      if ((err = conv())) return err;
    }
    cur = bufs[2 + b % 2];
    cur_map = 3 + b % 2;
  }
  return 0;
}

}  // namespace chain

}  // namespace emsanet

// Floats of split-K workspace that `nbt1d_chain_launch` needs (units
// never exceed the blocks that fit on the card: it stays < 2^31).
// Floats of split-K workspace that `nbt1d_chain_launch` needs (units
// never exceed the blocks that fit on the card: it stays < 2^31).
extern "C" int nbt1d_chain_workspace(int n, int h, int w, int c) {
  using namespace emsanet::chain;
  if (c <= 128) return 0;
  const ConvGeom g = conv_geom(n, h, w, c);
  return g.splits > 1 ? g.m_tiles * g.splits * kBM * c : 0;
}

// The K blocks of a chain over x. Block b writes its output to p0 (b
// even) or p1 (b odd); t and mid are scratch of x's size (the bf16 path's
// conv3x1 output and the output of a block's first pair). C is a multiple
// of 64 in [64, 512]; the wrapper checks shapes, types and alignment.
extern "C" int nbt1d_chain_launch(int dtype, int n, int h, int w, int c, int k,
                                  const void* x, const void* w31,
                                  const void* w13, const void* wt,
                                  const void* b31, const void* b13,
                                  const void* scale, const void* shift,
                                  void* t, void* mid, void* p0, void* p1,
                                  void* ws, void* stream) {
  using namespace emsanet;
  using namespace emsanet::chain;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fb31 = static_cast<const float*>(b31);
  const float* fb13 = static_cast<const float*>(b13);
  const float* fsc = static_cast<const float*>(scale);
  const float* fsh = static_cast<const float*>(shift);
  if (dtype != kBF16) {
    void* outs[2] = {p0, p1};
    const size_t wsz = (size_t)3 * c * c;
    const float* fw31 = static_cast<const float*>(w31);
    const float* fw13 = static_cast<const float*>(w13);
    const void* cur = x;
    for (int b = 0; b < k; ++b) {
      for (int p = 0; p < 2; ++p) {
        const size_t v = (size_t)(2 * b + p) * c;
        const int err = launch_pair<float>(
            p == 0 ? cur : mid, fw31 + (2 * b + p) * wsz, fb31 + v,
            fw13 + (2 * b + p) * wsz, fb13 + v, fsc + v, fsh + v,
            p == 0 ? nullptr : cur, p == 0 ? mid : outs[b % 2], n, h, w, c,
            st);
        if (err != 0) return err;
      }
      cur = outs[b % 2];
    }
    return 0;
  }
  const bf16* bx = static_cast<const bf16*>(x);
  bf16* const bufs[4] = {static_cast<bf16*>(t), static_cast<bf16*>(mid),
                         static_cast<bf16*>(p0), static_cast<bf16*>(p1)};
  if (c <= 128)
    return run_pairs(n, h, w, c, k, bx, wt, fb31, fb13, fsc, fsh, bufs, st);
  return run_convs(n, h, w, c, k, bx, wt, fb31, fb13, fsc, fsh, bufs,
                   static_cast<float*>(ws), st);
}
