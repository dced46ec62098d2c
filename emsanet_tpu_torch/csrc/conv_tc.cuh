// bf16 implicit-GEMM convolution on the tensor cores (mma.sync m16n8k16),
// shared by csrc/nbt1d_chain.cu and csrc/decoder_trunk.cu.
//
// A conv is out[p, :] = epilogue(sum_tap x[p + shift(tap), :] @ wt[tap])
// with M = pixels, K = taps x C_in, N = C_out. Operand tiles (BM x kBK of
// x, kBK x kBN of the weights) stream through a kStages-deep ring of
// cp.async copies, the missing source pixels (and channels past C_in)
// zero-filled by the copy itself; ldmatrix feeds the mma from shared
// memory, whose tile rows are padded by 16 bytes so that its reads are
// free of bank conflicts. A block of kTcThreads (4 warps, 2 x 2) computes
// BM pixels x kBN output channels, each warp BM/2 x 32 with f32
// accumulators.
#pragma once

#include "common.cuh"

namespace emsanet {

using bf16 = __nv_bfloat16;

constexpr int kBK = 32;            // K chunk (input channels of one tap)
constexpr int kBN = 64;            // output channels per block
constexpr int kStages = 3;         // cp.async ring depth
constexpr int kTcThreads = 128;    // 4 warps
constexpr int kAStride = kBK + 8;  // padded row of an A tile (elements)
constexpr int kBStride = kBN + 8;  // padded row of a B tile (elements)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy through L2 (never a stale L1 line); valid = false
// fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of one mma_conv_tile<BM> call.
template <int BM>
struct ConvTileSmem {
  __align__(128) bf16 a[kStages][BM * kAStride];
  __align__(128) bf16 b[kStages][kBK * kBStride];
};

// One BM x kBN output tile of a SAME conv with a th x tw kernel (3x3,
// 3x1, 1x3 or 1x1) over x (`total` pixels of images h x w, flattened,
// NHWC with cin channels; cin a multiple of 8). wt is (th * tw, cin,
// cout) [tap][c_in][c_out], cout a multiple of kBN. Tap (i, j) reads the
// pixel at row offset i - th/2 and column offset j - tw/2; a source pixel
// outside its image reads 0. epi(p, ch, v0, v1) receives the outputs of
// pixel p < total at channels ch (even) and ch + 1. Callers separate two
// calls that share `sm` with __syncthreads().
template <int BM, class Epi>
__device__ __forceinline__ void mma_conv_tile(ConvTileSmem<BM>& sm,
                                              const bf16* x, int total,
                                              int h, int w, int cin, int th,
                                              int tw, const bf16* wt,
                                              int cout, int m0, int n0,
                                              const Epi& epi) {
  constexpr int kWM = BM / 2;                        // warp tile rows
  constexpr int kMT = kWM / 16;                      // m16 tiles per warp
  constexpr int kAChunks = BM * (kBK / 8) / kTcThreads;
  constexpr int kBChunks = kBK * (kBN / 8) / kTcThreads;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int k_chunks = (cin + kBK - 1) / kBK;
  const int n_iter = th * tw * k_chunks;

  // the pixels whose A rows this thread copies: index, row and column
  int a_p[kAChunks], a_y[kAChunks], a_x[kAChunks];
#pragma unroll
  for (int i = 0; i < kAChunks; ++i) {
    const int p = m0 + (tid + i * kTcThreads) / (kBK / 8);
    const int rem = p % (h * w);
    a_p[i] = p;
    a_y[i] = rem / w;
    a_x[i] = rem % w;
  }

  auto load_stage = [&](int stage, int it) {
    const int tap = it / k_chunks, k0 = (it % k_chunks) * kBK;
    const int dy = tap / tw - th / 2, dx = tap % tw - tw / 2;
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int v = tid + i * kTcThreads;
      const int r = v / (kBK / 8), q = v % (kBK / 8);
      const bool ok = a_p[i] < total && a_y[i] + dy >= 0 &&
                      a_y[i] + dy < h && a_x[i] + dx >= 0 &&
                      a_x[i] + dx < w && k0 + q * 8 < cin;
      const bf16* src =
          ok ? x + (size_t)(a_p[i] + dy * w + dx) * cin + k0 + q * 8 : x;
      cp_async16(&sm.a[stage][r * kAStride + q * 8], src, ok);
    }
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      const int v = tid + i * kTcThreads;
      const int kr = v / (kBN / 8), q = v % (kBN / 8);
      const bool ok = k0 + kr < cin;
      const bf16* src =
          ok ? wt + ((size_t)tap * cin + k0 + kr) * cout + n0 + q * 8 : wt;
      cp_async16(&sm.b[stage][kr * kBStride + q * 8], src, ok);
    }
  };

  float acc[kMT][4][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_iter) load_stage(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = it + kStages - 1;
    if (nxt < n_iter) load_stage(nxt % kStages, nxt);
    cp_async_commit();
    const bf16* as = sm.a[it % kStages];
    const bf16* bs = sm.b[it % kStages];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      unsigned af[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        ldmatrix_x4(af[mt], as + (wm * kWM + mt * 16 + (lane & 15)) * kAStride +
                                ks + (lane >> 4) * 8);
      unsigned bfr[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned r[4];
        ldmatrix_x4_trans(r, bs + (ks + (lane & 15)) * kBStride + wn * 32 +
                                 np * 16 + (lane >> 4) * 8);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    }
  }
  cp_async_wait<0>();

  // accumulator e of tile (mt, nt) is row g (+8 for e >= 2), column
  // 2 * (lane % 4) + (e % 2)
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = m0 + wm * kWM + mt * 16 + g + half * 8;
      if (p >= total) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int ch = n0 + wn * 32 + nt * 8 + tq * 2;
        epi(p, ch, acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
}

}  // namespace emsanet
