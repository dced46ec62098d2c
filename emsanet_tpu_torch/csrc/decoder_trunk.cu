// Every dense decoder's whole trunk in one launch.
//
// Replaces the TPU kernel `emsanet_tpu/ops/decoder_trunk.py::decoder_trunk`
// (`_trunk_kernel`, pl.pallas_call at decoder_trunk.py:638). For D decoders
// and N images, per decoder module (input h x w, C_in channels; C
// channels; a C_s-channel encoder skip at 2h x 2w):
//   x = round(relu(conv3x3(x) * s_in + t_in))
//   K NonBottleneck1D blocks, each half
//     z = round(relu(conv3x1(src) + b31))
//     z = (conv1x3(z) + b13) * bn_s + bn_t
//     first half: y = round(relu(z)); second: x = round(relu(z + x))
//   x2 upsample (nearest + zero-padded depthwise 3x3) in polyphase form:
//     parity (pr, pc) of pixel (i, j) = round(sum over its 4 taps
//     x[i + pr - 1 + a, j + pc - 1 + b] * coef), in f32, in tap order
//   skip fusion: out = round(up + round(skip @ Wp * s_p + t_p))
// Every conv pads with zeros of its own; `round` is the storage type, at
// the points where the TPU kernel rounds. The last module's output, (D, N,
// 8 h0, 8 w0, C_last) NHWC, is each decoder's head input.
//
// What bounds it on the H100: at the flagship (640x480: 15x20x512 context,
// modules of 512, 256, 128 channels, K = 3) a decoder does 25 GFLOP per
// image against ~33 MB of bf16 weights and ~15 MB of activations, so it
// is bound by arithmetic (0.051 ms at b1, D = 2, at 989 TFLOP/s). What the
// TPU kernel was built for, and this one keeps, is one launch instead of
// ~50 per decoder: the b1 frame is bound by the host's launches.
//
// Design. The TPU kernel runs one grid step per (decoder, image) with the
// whole image resident in 16 MB of VMEM; here that would use 2 of 132 SMs
// and more shared memory than an SM has. Instead a persistent kernel,
// launched cooperatively with as many blocks as fit on the card at once,
// walks the trunk's phases in order, with a grid-wide barrier after each:
// per module conv_in, then the 4K convs of the blocks (the 1x3 conv needs
// the 3x1 conv's output of neighbouring tiles, so each conv is a phase),
// then one phase of projection + upsample + add: 3 (2 + 4K) = 42 phases
// at the flagship. In a phase every block loops over work items
// (decoder, 64-pixel tile, 64-channel tile), each an implicit-GEMM conv
// tile: bf16 on the tensor cores (`mma_conv_tile`, csrc/conv_tc.cuh), f32
// on the CUDA cores (f32 FMA, the path that checks the arithmetic). The
// projection is a 1x1 conv whose epilogue computes the parity value of
// its pixel and channel from the module's map. Intermediates live in
// scratch maps in device memory (mostly L2-resident); a block reads them
// only through L2 (cp.async.cg, ld.global.cg), so no stale L1 line
// survives a barrier.
//
// Layouts: activations NHWC contiguous; per decoder d the weights are
// cin_w (3*3, C_in, C) and proj_w (C_s, C) in the storage type; w31 / w13
// (K, 2, 3, C, C); b31, b13, bn_s, bn_t (K, 2, C), s_in, t_in, s_p, t_p
// (C) and the parity taps (4 parities, 4 taps, C) in f32.

#include <cooperative_groups.h>

#include "conv_tc.cuh"

namespace cg = cooperative_groups;

namespace emsanet {

constexpr int kBM = 64;         // pixels per work item
constexpr int kMaxModules = 4;
constexpr int kFStride = kBM + 4;  // padded row of the f32 A tile

struct TrunkModule {
  int h, w, cin, c, cs;  // input size, channels in / out, skip channels
  const void* cin_w;
  const float* cin_s;
  const float* cin_t;
  const void* w31;
  const void* w13;
  const float* b31;
  const float* b13;
  const float* bn_s;
  const float* bn_t;
  const float* ups;
  const void* skip;  // (N, 2h, 2w, cs), shared by the decoders
  const void* proj_w;
  const float* proj_s;
  const float* proj_t;
  void* out;  // (D, N, 2h, 2w, c)
};

struct TrunkArgs {
  int d, n, k, n_modules;
  const void* ctx;  // (N, h0, w0, C_in of module 0), shared
  void* bx;         // scratch maps, D * N * h * w * c each
  void* by;
  void* bz;
  TrunkModule m[kMaxModules];
};

// Loads through L2 only: the maps are written by other blocks of the same
// launch before the last barrier.
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

struct F32TileSmem {
  float a[kBK * kFStride];  // [k][pixel]
  float b[kBK * kBN];       // [k][channel]
};

union TileSmem {
  ConvTileSmem<kBM> tc;
  F32TileSmem f32;
};

// The f32 counterpart of `mma_conv_tile` (same arguments and epilogue):
// thread t computes pixels 8 (t / 16) .. +7 and channels 4 (t % 16) .. +3
// of the tile, summing in f32 over taps, then channels.
template <class Epi>
__device__ __forceinline__ void conv_tile(TileSmem& smem, const float* x,
                                          int total, int h, int w, int cin,
                                          int th, int tw, const float* wt,
                                          int cout, int m0, int n0,
                                          const Epi& epi) {
  F32TileSmem& sm = smem.f32;
  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int tap = 0; tap < th * tw; ++tap) {
    const int dy = tap / tw - th / 2, dx = tap % tw - tw / 2;
    for (int k0 = 0; k0 < cin; k0 += kBK) {
      __syncthreads();
      for (int i = tid; i < kBM * kBK; i += kTcThreads) {
        const int m = i / kBK, kk = i % kBK, p = m0 + m;
        const int rem = p % (h * w), y = rem / w + dy, xx = rem % w + dx;
        float v = 0.f;
        if (p < total && y >= 0 && y < h && xx >= 0 && xx < w &&
            k0 + kk < cin)
          v = ld_cg(x + (size_t)(p + dy * w + dx) * cin + k0 + kk);
        sm.a[kk * kFStride + m] = v;
      }
      for (int i = tid; i < kBK * kBN; i += kTcThreads) {
        const int kr = i / kBN, nn = i % kBN;
        sm.b[i] = k0 + kr < cin
                      ? wt[((size_t)tap * cin + k0 + kr) * cout + n0 + nn]
                      : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = sm.a[kk * kFStride + tm * 8 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = sm.b[kk * kBN + tn * 4 + j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = m0 + tm * 8 + i;
    if (p >= total) continue;
#pragma unroll
    for (int j = 0; j < 4; j += 2)
      epi(p, n0 + tn * 4 + j, acc[i][j], acc[i][j + 1]);
  }
}

template <class Epi>
__device__ __forceinline__ void conv_tile(TileSmem& smem, const bf16* x,
                                          int total, int h, int w, int cin,
                                          int th, int tw, const bf16* wt,
                                          int cout, int m0, int n0,
                                          const Epi& epi) {
  mma_conv_tile<kBM>(smem.tc, x, total, h, w, cin, th, tw, wt, cout, m0, n0,
                     epi);
}

// One phase: a th x tw conv of every decoder's map, `total` pixels of
// images h x w each. Decoder d reads x + d * x_ds and weights wt + d *
// wt_ds; epi(d, p, ch, v0, v1) takes the outputs.
template <typename T, class Epi>
__device__ __forceinline__ void run_phase(TileSmem& smem, int n_dec,
                                          int total, int h, int w,
                                          const T* x, size_t x_ds, int cin,
                                          int th, int tw, const T* wt,
                                          size_t wt_ds, int cout,
                                          const Epi& epi) {
  const int m_tiles = (total + kBM - 1) / kBM, n_tiles = cout / kBN;
  const int per_dec = m_tiles * n_tiles;
  for (int item = blockIdx.x; item < n_dec * per_dec; item += gridDim.x) {
    const int d = item / per_dec, r = item % per_dec;
    __syncthreads();  // the previous item's reads of smem are done
    conv_tile(smem, x + d * x_ds, total, h, w, cin, th, tw, wt + d * wt_ds,
              cout, (r / n_tiles) * kBM, (r % n_tiles) * kBN,
              [&](int p, int ch, float v0, float v1) {
                epi(d, p, ch, v0, v1);
              });
  }
}

template <typename T>
__global__ void __launch_bounds__(kTcThreads)
decoder_trunk_kernel(const TrunkArgs args) {
  __shared__ TileSmem smem;
  // the modules' fields, indexed by the module loop: in shared memory,
  // since a kernel parameter indexed at run time goes to local memory
  __shared__ TrunkModule mods[kMaxModules];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kMaxModules; ++i) mods[i] = args.m[i];
  }
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  const int nd = args.d, n = args.n, nk = args.k;
  T* bx = static_cast<T*>(args.bx);
  T* by = static_cast<T*>(args.by);
  T* bz = static_cast<T*>(args.bz);
  for (int mi = 0; mi < args.n_modules; ++mi) {
    const TrunkModule& m = mods[mi];
    const int h = m.h, w = m.w, c = m.c, total = n * h * w;
    const size_t map = (size_t)total * c;  // one decoder's map

    // conv_in 3x3 + folded BN + ReLU -> x
    const T* src =
        static_cast<const T*>(mi == 0 ? args.ctx : mods[mi - 1].out);
    run_phase<T>(smem, nd, total, h, w, src,
                 mi == 0 ? 0 : (size_t)total * m.cin, m.cin, 3, 3,
                 static_cast<const T*>(m.cin_w), (size_t)9 * m.cin * c, c,
                 [&](int d, int p, int ch, float v0, float v1) {
                   const float* s = m.cin_s + d * c + ch;
                   const float* t = m.cin_t + d * c + ch;
                   T* o = bx + d * map + (size_t)p * c + ch;
                   st(o, fmaxf(v0 * s[0] + t[0], 0.f));
                   st(o + 1, fmaxf(v1 * s[1] + t[1], 0.f));
                 });
    grid.sync();

    // K NBt1D blocks: half 0 x -> z -> y, half 1 y -> z -> x (in place:
    // each output element reads only its own residual)
    for (int kb = 0; kb < nk; ++kb)
      for (int half = 0; half < 2; ++half) {
        const size_t vo = (size_t)(kb * 2 + half) * c;  // (K, 2, C) row
        const size_t wo = (size_t)(kb * 2 + half) * 3 * c * c;
        const size_t w_ds = (size_t)nk * 2 * 3 * c * c;
        const size_t v_ds = (size_t)nk * 2 * c;
        run_phase<T>(smem, nd, total, h, w, half ? by : bx, map, c, 3, 1,
                     static_cast<const T*>(m.w31) + wo, w_ds, c,
                     [&](int d, int p, int ch, float v0, float v1) {
                       const float* b = m.b31 + d * v_ds + vo + ch;
                       T* o = bz + d * map + (size_t)p * c + ch;
                       st(o, fmaxf(v0 + b[0], 0.f));
                       st(o + 1, fmaxf(v1 + b[1], 0.f));
                     });
        grid.sync();
        T* dst = half ? bx : by;
        run_phase<T>(smem, nd, total, h, w, bz, map, c, 1, 3,
                     static_cast<const T*>(m.w13) + wo, w_ds, c,
                     [&](int d, int p, int ch, float v0, float v1) {
                       const size_t q = d * v_ds + vo + ch;
                       const size_t o = d * map + (size_t)p * c + ch;
                       float y0 = (v0 + m.b13[q]) * m.bn_s[q] + m.bn_t[q];
                       float y1 = (v1 + m.b13[q + 1]) * m.bn_s[q + 1] +
                                  m.bn_t[q + 1];
                       if (half) {
                         y0 += ld_cg(bx + o);
                         y1 += ld_cg(bx + o + 1);
                       }
                       st(dst + o, fmaxf(y0, 0.f));
                       st(dst + o + 1, fmaxf(y1, 0.f));
                     });
        grid.sync();
      }

    // projection of the skip (a 1x1 conv at 2h x 2w) + folded BN, plus
    // the parity value of the x2 upsample of x at the same pixel
    const int h2 = 2 * h, w2 = 2 * w, total2 = n * h2 * w2;
    T* out = static_cast<T*>(m.out);
    run_phase<T>(
        smem, nd, total2, h2, w2, static_cast<const T*>(m.skip), 0, m.cs, 1,
        1, static_cast<const T*>(m.proj_w), (size_t)m.cs * c, c,
        [&](int d, int p, int ch, float v0, float v1) {
          const int img = p / (h2 * w2), rem = p % (h2 * w2);
          const int oy = rem / w2, ox = rem % w2;
          const int par = (oy & 1) * 2 + (ox & 1);
          const int y0 = (oy >> 1) + (oy & 1) - 1;
          const int x0 = (ox >> 1) + (ox & 1) - 1;
          const T* xm = bx + d * map + (size_t)img * h * w * c;
          const float* k = m.ups + ((size_t)d * 16 + par * 4) * c + ch;
          float up[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float acc = 0.f;
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const int y = y0 + (t >> 1), xx = x0 + (t & 1);
              const bool in = y >= 0 && y < h && xx >= 0 && xx < w;
              const float v =
                  in ? ld_cg(xm + ((size_t)y * w + xx) * c + ch + e) : 0.f;
              const float prod = __fmul_rn(v, k[(size_t)t * c + e]);
              acc = t == 0 ? prod : __fadd_rn(acc, prod);
            }
            up[e] = round_to<T>(acc);
          }
          const float* s = m.proj_s + d * c + ch;
          const float* t = m.proj_t + d * c + ch;
          T* o = out + d * (size_t)total2 * c + (size_t)p * c + ch;
          st(o, __fadd_rn(up[0], round_to<T>(v0 * s[0] + t[0])));
          st(o + 1, __fadd_rn(up[1], round_to<T>(v1 * s[1] + t[1])));
        });
    if (mi + 1 < args.n_modules) grid.sync();
  }
}

template <typename T>
int launch(const TrunkArgs& args, cudaStream_t stream) {
  static int blocks_per_sm = -1, sms = 0;
  if (blocks_per_sm < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, decoder_trunk_kernel<T>, kTcThreads, 0);
    const int err = (int)cudaGetLastError();
    if (err != 0) {
      blocks_per_sm = -1;
      return err;
    }
  }
  if (blocks_per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // every block must be resident at once for the grid barrier; the
  // cooperative launch refuses (and never hangs on) a larger grid
  dim3 grid(sms * (blocks_per_sm < 4 ? blocks_per_sm : 4));
  void* params[] = {const_cast<TrunkArgs*>(&args)};
  cudaLaunchCooperativeKernel((const void*)decoder_trunk_kernel<T>, grid,
                              dim3(kTcThreads), params, 0, stream);
  return (int)cudaGetLastError();
}

}  // namespace emsanet

// a: D, N, K, n_modules, ctx, bx, by, bz, then per module the 20 fields
// of TrunkModule in order (pointers as integers). The wrapper
// (ops/decoder_trunk.py) checks every shape, dtype and alignment.
extern "C" int decoder_trunk_launch(int dtype, const long long* a,
                                    void* stream) {
  using namespace emsanet;
  TrunkArgs args{};
  args.d = (int)a[0];
  args.n = (int)a[1];
  args.k = (int)a[2];
  args.n_modules = (int)a[3];
  if (args.n_modules < 1 || args.n_modules > kMaxModules)
    return (int)cudaErrorInvalidValue;
  args.ctx = (const void*)a[4];
  args.bx = (void*)a[5];
  args.by = (void*)a[6];
  args.bz = (void*)a[7];
  for (int i = 0; i < args.n_modules; ++i) {
    const long long* f = a + 8 + 20 * i;
    TrunkModule& m = args.m[i];
    m.h = (int)f[0];
    m.w = (int)f[1];
    m.cin = (int)f[2];
    m.c = (int)f[3];
    m.cs = (int)f[4];
    m.cin_w = (const void*)f[5];
    m.cin_s = (const float*)f[6];
    m.cin_t = (const float*)f[7];
    m.w31 = (const void*)f[8];
    m.w13 = (const void*)f[9];
    m.b31 = (const float*)f[10];
    m.b13 = (const float*)f[11];
    m.bn_s = (const float*)f[12];
    m.bn_t = (const float*)f[13];
    m.ups = (const float*)f[14];
    m.skip = (const void*)f[15];
    m.proj_w = (const void*)f[16];
    m.proj_s = (const float*)f[17];
    m.proj_t = (const float*)f[18];
    m.out = (void*)f[19];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == kBF16 ? launch<bf16>(args, s) : launch<float>(args, s);
}
