// Segment reductions of the panoptic merge:
//   segment_hist_and_sums: hist[n, s, c] = sum_p [inst==s][sem==c] w_p and
//                          sums[n, s, :] = sum_p [inst==s] vec_p
//   segment_lookup:        out[n, d, p] = tables[n, d, inst[n, p]]
// Keys outside [0, S) (and classes outside [0, C)) contribute nothing and
// look up 0, as the one-hot formulation of the JAX package does.
//
// Replace the TPU kernels `emsanet_tpu/ops/segment_pallas.py::
// segment_hist_and_sums` (`_hist_kernel`, pl.pallas_call at
// segment_pallas.py:102) and `segment_lookup` (`_lookup_kernel`,
// pl.pallas_call at segment_pallas.py:165).
//
// What bounds them on the H100: both read or write a few bytes per pixel
// and do a handful of operations on them, so device memory bounds them.
//
// The histogram (flagship frame: S = 65, C = 41, D = 2, 307,200 pixels
// an image) in two launches:
// 1. hist_kernel: each image is cut into `blocks` contiguous spans of
//    whole 1024-pixel tiles (the wrapper sizes them from the SM count and
//    the kernel's occupancy: one wave that covers every SM at b1 and b8).
//    Each of a block's 128 threads takes 8 neighbouring pixels of a tile,
//    read as 16-byte vectors (int4 keys and classes, float4 weights and
//    vectors), and walks them in order, adding runs in registers: the
//    sums' runs of equal key and the histogram's of equal (key, class).
//    Segmentation maps, and their parity planes, are runs along rows. A
//    run is flushed where it ends, in step across the warp:
//    - a histogram run whose weight is a whole number of at most one per
//      pixel (a count of votes; every run of the merge) is added to the
//      block's integer counts by a shared-memory atomic: integer sums do
//      not depend on their order. When all 32 lanes flush one entry (the
//      last flush of one key everywhere) the warp adds first;
//    - sums runs go to the warp's own table: `__match_any_sync` on the key
//      groups the lanes that flush one entry (a lone flushing lane, a
//      frame's usual case, skips that), and the lowest lane of a group
//      adds its peers' values (by shuffles) in lane order, so one lane
//      writes each entry. Other histogram runs (fractional weights) do
//      the same in a per-warp float table in the workspace, zeroed by the
//      warp on first use.
//    At the end the block writes its partial table to its workspace row:
//    the counts plus the fractional tables, and the warps' sums, each in
//    warp order.
// 2. hist_reduce_kernel: each output entry is the sum of its image's
//    partial tables, in a fixed order (warp q of a block takes blocks q,
//    q + 8, ...; then the 8 warps in order). It writes every output
//    element, so nothing is zeroed first.
// Two calls give the same bits; 0/1 votes give exact counts. The vector
// sums match the plain version (scatter_add) to rounding.
// What the measurements chose (H100, kernel_bench.py): 8 pixels a thread,
// not 16 (each inlined flush is code: 16 copies cost more in instruction
// fetch than the longer runs saved); integer counts, not a match on the
// class too (that match cost ~15 us of a b8 call on uniformly random
// keys); no per-warp float histograms in shared memory (they held the
// kernel to 4 blocks an SM and cost zeroing and adding in every block);
// no L2 prefetch or register double buffering of the next tile (no
// gain).
//
// The lookup (flagship frame: D = 2, S = 65, 307,200 pixels an image)
// moves 4 bytes of key in and 4 D bytes out a pixel, so the bytes bound
// it (0.0088 ms at b8). One launch; each block stages its image's whole
// (D, S) table in shared memory once (for D = 2 as (S, 2) pairs, so a
// pixel's two values are one 8-byte shared load) and walks groups of 4
// pixels with a grid-stride loop: one 16-byte load of keys, then one
// 16-byte evict-first store (st.global.cs) per output plane. The grid is
// at most one wave (kLookupBlocksPerSm blocks an SM, shared among the
// images) and no larger than the groups need, so a b8 call stages the
// table 1,056 times and not once per 256 pixels. D = 1 and 2 are
// compiled for; any other D takes a loop over the planes. Where P % 4 != 0
// or a pointer is not 16-byte aligned, every pixel takes the scalar path
// (one key a thread). Keys outside [0, S) look up 0; the table read uses
// a clamped key, so no shared load leaves the table. The copy is exact:
// the result equals the plain gather bit for bit.
//
// Layouts: inst, sem (N, P) int32; w (N, P) f32; vec (N, P, D) f32, D = 1
// (the merge without orientation: zeros) or 2 (orientation sin, cos;
// the wrapper takes larger D two components a call: a per-lane array of
// more spills to the stack); hist (N, S, C) f32; sums (N, S, D) f32;
// workspace (N, blocks, segment_hist_block_floats) f32; tables (N, D, S)
// f32; out (N, D, P) f32.

#include <cstdint>

#include "common.cuh"

namespace emsanet {

constexpr int kLookupThreads = 256;
constexpr int kLookupBlocksPerSm = 2048 / kLookupThreads;  // a full SM

constexpr int kHistWarps = 4;
constexpr int kHistThreads = 32 * kHistWarps;
constexpr int kRun = 8;                         // pixels per thread and tile
constexpr int kHistTile = kHistThreads * kRun;  // 1024
constexpr int kHistRows = 1 + kHistWarps;       // workspace rows per block
constexpr int kReduceWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

// Words of the block's counts (S C) and of a warp's sums (S D), each
// padded to 16 bytes, and of a workspace row: the histogram, then the
// sums, each so padded.
__host__ __device__ inline int hist_count_words(int s, int c) {
  return (s * c + 3) & ~3;
}
__host__ __device__ inline int hist_sum_words(int s, int d) {
  return (s * d + 3) & ~3;
}
__host__ __device__ inline int hist_row_words(int s, int c, int d) {
  return hist_count_words(s, c) + hist_sum_words(s, d);
}

// The block's counts and the warps' sums.
__host__ __device__ inline size_t hist_smem_bytes(int s, int c, int d) {
  return sizeof(float) *
         ((size_t)hist_count_words(s, c) + kHistWarps * hist_sum_words(s, d));
}

// One thread's kRun pixels from pixel `first` of an image: vector loads
// where the whole group of 4 lies inside the image and `vec` (P % 4 == 0,
// 16-byte aligned bases), else element by element; pixels past P get key
// -1 (contribute nothing).
template <int D>
__device__ __forceinline__ void load_run(const int* inst, const int* sem,
                                         const float* w, const float* vec,
                                         int first, int p, int vec_ok,
                                         int (&ki)[kRun], int (&kc)[kRun],
                                         float (&kw)[kRun],
                                         float (&kv)[kRun * D]) {
#pragma unroll
  for (int g = 0; g < kRun / 4; ++g) {
    const int i0 = first + 4 * g;
    if (vec_ok && i0 + 4 <= p) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(inst + i0));
      const int4 b = __ldg(reinterpret_cast<const int4*>(sem + i0));
      const float4 c = __ldg(reinterpret_cast<const float4*>(w + i0));
      ki[4 * g] = a.x, ki[4 * g + 1] = a.y, ki[4 * g + 2] = a.z,
      ki[4 * g + 3] = a.w;
      kc[4 * g] = b.x, kc[4 * g + 1] = b.y, kc[4 * g + 2] = b.z,
      kc[4 * g + 3] = b.w;
      kw[4 * g] = c.x, kw[4 * g + 1] = c.y, kw[4 * g + 2] = c.z,
      kw[4 * g + 3] = c.w;
#pragma unroll
      for (int v = 0; v < D; ++v) {  // 4 pixels x D components = D float4
        const float4 e =
            __ldg(reinterpret_cast<const float4*>(vec + (size_t)i0 * D) + v);
        kv[4 * g * D + 4 * v] = e.x, kv[4 * g * D + 4 * v + 1] = e.y,
        kv[4 * g * D + 4 * v + 2] = e.z, kv[4 * g * D + 4 * v + 3] = e.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + j;
        const bool in = i < p;
        ki[4 * g + j] = in ? inst[i] : -1;
        kc[4 * g + j] = in ? sem[i] : -1;
        kw[4 * g + j] = in ? w[i] : 0.f;
#pragma unroll
        for (int v = 0; v < D; ++v)
          kv[(4 * g + j) * D + v] = in ? vec[(size_t)i * D + v] : 0.f;
      }
    }
  }
}

// Flush the histogram runs of the lanes with `brk_h` and the sum runs of
// the lanes with `brk_s` (brk_s implies brk_h: both runs share their key).
// A histogram run whose weight is a whole number of at most one per pixel
// (a count of votes: every run of the panoptic merge) goes to the block's
// integer counts `cnt` by an atomic add: integer sums do not depend on
// their order. The sums go to the warp's table `sums`, and the other
// histogram runs to the warp's float table `frac` in the workspace (zeroed
// by the warp at its first such run; `frac_live`): there one lane per
// entry, the lowest of the lanes that flush it, adds the others' values in
// lane order; a lone flushing lane, a frame's usual case, needs no
// grouping. With kFinal, when every lane counts to the same entry, the
// warp adds the counts first and one lane adds them. Every lane of the
// warp calls it.
template <int D, bool kFinal = false>
__device__ __forceinline__ void flush_runs(bool brk_h, bool brk_s, int key,
                                           int cls, float a_w, int len,
                                           const float (&a_v)[D], int* cnt,
                                           float* sums, float* frac,
                                           bool& frac_live, int s, int c,
                                           int words, int lane) {
  const bool in_s = (unsigned)key < (unsigned)s;
  const bool ok_h = brk_h && in_s && (unsigned)cls < (unsigned)c;
  const bool ok_s = brk_s && in_s;
  const bool votes = ok_h && a_w == truncf(a_w) && fabsf(a_w) <= (float)len;
  const int key0 = kFinal ? __shfl_sync(kFull, key, 0) : 0;
  const int cls0 = kFinal ? __shfl_sync(kFull, cls, 0) : 0;
  if (kFinal && __all_sync(kFull, votes && key == key0 && cls == cls0)) {
    const int n = __reduce_add_sync(kFull, (int)a_w);
    if (lane == 0 && n != 0) atomicAdd(cnt + key * c + cls, n);
  } else if (votes && a_w != 0.f) {
    atomicAdd(cnt + key * c + cls, (int)a_w);
  }
  const bool fr = ok_h && !votes;
  const unsigned fh = __ballot_sync(kFull, fr);
  const unsigned fs = __ballot_sync(kFull, ok_s);
  if (fh && !frac_live) {  // the warp's first fractional run: zero its table
    for (int i = lane; i < words / 4; i += 32)
      __stcg(reinterpret_cast<float4*>(frac) + i,
             make_float4(0.f, 0.f, 0.f, 0.f));
    frac_live = true;
    __syncwarp();
  }
  const unsigned own = 1u << lane, lower = own - 1;
  unsigned ph = own, ps = own;  // the lanes that flush the same entry
  float acc_h = a_w, acc_v[D];  // the entries' sums, if this lane leads
#pragma unroll
  for (int v = 0; v < D; ++v) acc_v[v] = a_v[v];
  if ((fh & (fh - 1)) || (fs & (fs - 1))) {  // two or more lanes flush
    const unsigned same = __match_any_sync(kFull, key);
    if (fh & (fh - 1)) {
      const unsigned same_c = __match_any_sync(kFull, cls);
      if (fr) ph = same & same_c & fh;
    }
    if (ok_s) ps = same & fs;
    // a leader (the lowest lane of its group) adds its peers' values in
    // lane order, one peer a round
    unsigned mh = ph & lower ? 0u : ph & ~own;
    unsigned ms = ps & lower ? 0u : ps & ~own;
    while (__any_sync(kFull, mh | ms)) {
      const int src_h = mh ? __ffs(mh) - 1 : lane;
      const int src_s = ms ? __ffs(ms) - 1 : lane;
      const float w_peer = __shfl_sync(kFull, a_w, src_h);
      float v_peer[D];
#pragma unroll
      for (int v = 0; v < D; ++v) v_peer[v] = __shfl_sync(kFull, a_v[v], src_s);
      if (mh) acc_h += w_peer;
      if (ms) {
#pragma unroll
        for (int v = 0; v < D; ++v) acc_v[v] += v_peer[v];
      }
      mh &= mh - 1;
      ms &= ms - 1;
    }
  }
  if (fr && !(ph & lower)) {
    float* e = frac + key * c + cls;
    __stcg(e, __ldcg(e) + acc_h);
  }
  if (ok_s && !(ps & lower)) {
#pragma unroll
    for (int v = 0; v < D; ++v) sums[key * D + v] += acc_v[v];
  }
  __syncwarp();  // the tables, before the next flush
}

// grid (blocks, N); block b takes tiles [b * tiles, (b + 1) * tiles) of
// its image; thread t of tile k takes pixels kRun (128 k + t) .. + kRun-1.
// The block owns workspace rows kHistRows (blockIdx.y * blocks +
// blockIdx.x) + r of `words` floats: r = 0 its partial table (S x C
// histogram, then S x D sums), r = 1 + warp that warp's fractional table.
template <int D>
__global__ void __launch_bounds__(kHistThreads)
hist_kernel(const int* __restrict__ inst, const int* __restrict__ sem,
            const float* __restrict__ w, const float* __restrict__ vec,
            float* __restrict__ part, int p, int s, int c, int tiles,
            int vec_ok) {
  extern __shared__ __align__(16) int smem_i[];
  __shared__ int s_live[kHistWarps];
  const int words = hist_row_words(s, c, D);
  const int n_cnt = hist_count_words(s, c), n_sum = hist_sum_words(s, D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* cnt = smem_i;  // the block's [S][C] counts, then the warps' sums
  float* sums = reinterpret_cast<float*>(smem_i + n_cnt) + warp * n_sum;
  float* rows = part + (size_t)kHistRows *
                           ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                           words;
  float* frac = rows + (size_t)(1 + warp) * words;
  for (int i = threadIdx.x; i < (n_cnt + kHistWarps * n_sum) / 4;
       i += kHistThreads)
    reinterpret_cast<int4*>(smem_i)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();

  const int img = blockIdx.y;
  const size_t base = (size_t)img * p;
  inst += base, sem += base, w += base, vec += base * D;
  // the open runs: the sums' of key r_i, the histogram's of (r_i, r_c),
  // len pixels long
  int r_i = -1, r_c = -1, len = 0;
  float a_w = 0.f, a_v[D];
#pragma unroll
  for (int v = 0; v < D; ++v) a_v[v] = 0.f;
  bool frac_live = false;
  int ki[kRun], kc[kRun];
  float kw[kRun], kv[kRun * D];
  for (int k = 0; k < tiles; ++k) {
    const int tile = blockIdx.x * tiles + k;
    // the warp's pixels start past the image: so do the block's rest
    if ((tile * kHistThreads + warp * 32) * kRun >= p) break;
    load_run<D>(inst, sem, w, vec, (tile * kHistThreads + threadIdx.x) * kRun,
                p, vec_ok, ki, kc, kw, kv);
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const bool brk_s = ki[j] != r_i;
      const bool brk_h = brk_s || kc[j] != r_c;
      if (__any_sync(kFull, brk_h))
        flush_runs<D>(brk_h, brk_s, r_i, r_c, a_w, len, a_v, cnt, sums, frac,
                      frac_live, s, c, words, lane);
      a_w = brk_h ? kw[j] : a_w + kw[j];
      len = brk_h ? 1 : len + 1;
#pragma unroll
      for (int v = 0; v < D; ++v)
        a_v[v] = brk_s ? kv[j * D + v] : a_v[v] + kv[j * D + v];
      r_i = ki[j], r_c = kc[j];
    }
  }
  flush_runs<D, true>(true, true, r_i, r_c, a_w, len, a_v, cnt, sums, frac,
                      frac_live, s, c, words, lane);
  if (lane == 0) s_live[warp] = frac_live;
  __syncthreads();

  // the block's table: histogram = counts + the fractional tables in warp
  // order; sums = the warps' sums in warp order
  float4* row = reinterpret_cast<float4*>(rows);
  for (int i = threadIdx.x; i < n_cnt / 4; i += kHistThreads) {
    const int4 n = reinterpret_cast<const int4*>(cnt)[i];
    float4 acc = make_float4((float)n.x, (float)n.y, (float)n.z, (float)n.w);
#pragma unroll
    for (int q = 0; q < kHistWarps; ++q) {
      if (!s_live[q]) continue;
      const float4 t = __ldcg(reinterpret_cast<const float4*>(
                                  rows + (size_t)(1 + q) * words) + i);
      acc.x += t.x, acc.y += t.y, acc.z += t.z, acc.w += t.w;
    }
    row[i] = acc;
  }
  const float4* t4 = reinterpret_cast<const float4*>(smem_i + n_cnt);
  for (int i = threadIdx.x; i < n_sum / 4; i += kHistThreads) {
    float4 acc = t4[i];
#pragma unroll
    for (int q = 1; q < kHistWarps; ++q) {
      const float4 t = t4[q * n_sum / 4 + i];
      acc.x += t.x, acc.y += t.y, acc.z += t.z, acc.w += t.w;
    }
    row[n_cnt / 4 + i] = acc;
  }
}

// grid (ceil(E / 32), N), 8 warps: entry blockIdx.x * 32 + lane of image
// blockIdx.y; warp q adds the partial tables of the image's blocks q,
// q + 8, ... in order, then warp 0 adds the 8 warps' sums in order.
__global__ void __launch_bounds__(32 * kReduceWarps)
hist_reduce_kernel(const float* __restrict__ part, float* __restrict__ hist,
                   float* __restrict__ sums, int blocks, int s, int c,
                   int d) {
  __shared__ float s_acc[kReduceWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = s * (c + d), img = blockIdx.y;
  const size_t stride = (size_t)kHistRows * hist_row_words(s, c, d);
  const int i = blockIdx.x * 32 + lane;
  // entry i's word in a row: the sums follow the padded histogram
  const int at = i < s * c ? i : i - s * c + hist_count_words(s, c);
  float acc = 0.f;
  if (i < e) {
    const float* src = part + (size_t)img * blocks * stride + at;
#pragma unroll 8
    for (int b = warp; b < blocks; b += kReduceWarps)
      acc += src[(size_t)b * stride];
  }
  s_acc[warp][lane] = acc;
  __syncthreads();
  if (warp != 0 || i >= e) return;
  float t = s_acc[0][lane];
#pragma unroll
  for (int q = 1; q < kReduceWarps; ++q) t += s_acc[q][lane];
  if (i < s * c)
    hist[(size_t)img * s * c + i] = t;
  else
    sums[(size_t)img * s * d + i - s * c] = t;
}

template <int D>
int launch_hist(int n, int p, int s, int c, int blocks, int tiles,
                const void* inst, const void* sem, const void* w,
                const void* vec, void* hist, void* sums, void* part,
                cudaStream_t st) {
  const size_t smem = hist_smem_bytes(s, c, D);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(hist_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec_ok = p % 4 == 0 &&
                     ((reinterpret_cast<uintptr_t>(inst) |
                       reinterpret_cast<uintptr_t>(sem) |
                       reinterpret_cast<uintptr_t>(w) |
                       reinterpret_cast<uintptr_t>(vec)) & 15) == 0;
  hist_kernel<D><<<dim3(blocks, n), kHistThreads, smem, st>>>(
      (const int*)inst, (const int*)sem, (const float*)w, (const float*)vec,
      (float*)part, p, s, c, tiles, vec_ok);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hist_reduce_kernel<<<dim3(ceil_div(s * (c + D), 32), n),
                       32 * kReduceWarps, 0, st>>>(
      (const float*)part, (float*)hist, (float*)sums, blocks, s, c, D);
  return (int)cudaGetLastError();
}

// One value of plane dd of key k (ok: k in [0, s); kk: k clamped).
template <int D>
__device__ __forceinline__ float lookup_value(const float* t_s, int kk, bool ok,
                                             int dd, int s) {
  const float v = D == 2 ? t_s[2 * kk + dd] : t_s[dd * s + kk];
  return ok ? v : 0.f;
}

// D = 1 or 2 at compile time; D = 0: d planes at run time.
template <int D>
__global__ void __launch_bounds__(kLookupThreads)
lookup_kernel(const int* __restrict__ inst, const float* __restrict__ tables,
              float* __restrict__ out, int p, int d_run, int s, int vec_ok) {
  extern __shared__ float4 lookup_smem[];  // 16-byte aligned
  float* t_s = reinterpret_cast<float*>(lookup_smem);
  const int d = D > 0 ? D : d_run;
  const int img = blockIdx.y;
  const float* tab = tables + (size_t)img * d * s;
  for (int i = threadIdx.x; i < d * s; i += kLookupThreads) {
    if (D == 2)
      t_s[2 * (i % s) + i / s] = tab[i];  // (S, 2) pairs
    else
      t_s[i] = tab[i];
  }
  __syncthreads();
  const int* keys = inst + (size_t)img * p;
  float* o = out + (size_t)img * d * p;
  const unsigned us = (unsigned)s;
  const int stride = gridDim.x * kLookupThreads;
  if (vec_ok) {
    const int groups = p >> 2;
    for (int g = blockIdx.x * kLookupThreads + threadIdx.x; g < groups;
         g += stride) {
      const int4 k4 = __ldcs(reinterpret_cast<const int4*>(keys) + g);
      const int k[4] = {k4.x, k4.y, k4.z, k4.w};
      bool ok[4];
      int kk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = (unsigned)k[j] < us;
        kk[j] = ok[j] ? k[j] : 0;
      }
      if (D == 2) {
        float2 v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = reinterpret_cast<const float2*>(t_s)[kk[j]];
          if (!ok[j]) v[j] = make_float2(0.f, 0.f);
        }
        __stcs(reinterpret_cast<float4*>(o) + g,
               make_float4(v[0].x, v[1].x, v[2].x, v[3].x));
        __stcs(reinterpret_cast<float4*>(o + p) + g,
               make_float4(v[0].y, v[1].y, v[2].y, v[3].y));
      } else {
        for (int dd = 0; dd < d; ++dd)
          __stcs(reinterpret_cast<float4*>(o + (size_t)dd * p) + g,
                 make_float4(lookup_value<D>(t_s, kk[0], ok[0], dd, s),
                             lookup_value<D>(t_s, kk[1], ok[1], dd, s),
                             lookup_value<D>(t_s, kk[2], ok[2], dd, s),
                             lookup_value<D>(t_s, kk[3], ok[3], dd, s)));
      }
    }
  } else {
    for (int i = blockIdx.x * kLookupThreads + threadIdx.x; i < p;
         i += stride) {
      const int k = keys[i];
      const bool ok = (unsigned)k < us;
      const int kk = ok ? k : 0;
      for (int dd = 0; dd < d; ++dd)
        o[(size_t)dd * p + i] = lookup_value<D>(t_s, kk, ok, dd, s);
    }
  }
}

// SMs of the current device, asked once per device.
inline int device_sms() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 1;
  return sms[dev];
}

template <int D>
int launch_lookup(int n, int p, int d, int s, const int* inst,
                  const float* tables, float* out, cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)d * s;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lookup_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec_ok = p % 4 == 0 &&
                     ((reinterpret_cast<uintptr_t>(inst) |
                       reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int need = ceil_div(vec_ok ? p / 4 : p, kLookupThreads);
  const int room = device_sms() * kLookupBlocksPerSm / n;
  const int blocks = need < room ? need : (room > 0 ? room : 1);
  lookup_kernel<D><<<dim3(blocks, n), kLookupThreads, smem, st>>>(
      inst, tables, out, p, d, s, vec_ok);
  return (int)cudaGetLastError();
}

}  // namespace emsanet

// Pixels per tile of hist_kernel: the wrapper's plan counts in tiles.
extern "C" int segment_hist_tile() { return emsanet::kHistTile; }

// Workspace floats per block of hist_kernel: its kHistRows rows.
extern "C" int segment_hist_block_floats(int s, int c, int d) {
  return emsanet::kHistRows * emsanet::hist_row_words(s, c, d);
}

// hist_kernel<d> blocks resident on one SM of the current device (its
// shared memory and registers), or minus a cudaError code; 0 when the
// tables do not fit (d is 1 or 2).
extern "C" int segment_hist_blocks_per_sm(int s, int c, int d) {
  using namespace emsanet;
  const void* fn = d == 1 ? (const void*)hist_kernel<1>
                          : (const void*)hist_kernel<2>;
  const size_t smem = hist_smem_bytes(s, c, d);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: a table too large is not a fault
    return 0;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                      kHistThreads, smem);
  return err == cudaSuccess ? per_sm : -(int)err;
}

// blocks per image and tiles per block from the wrapper's plan; part holds
// n * blocks * segment_hist_block_floats(s, c, d) floats. d is 1 (no
// vectors: the merge without orientation) or 2 (orientation sin, cos);
// the wrapper checks it and the shapes.
extern "C" int segment_hist_and_sums_launch(int n, int p, int s, int c, int d,
                                            int blocks, int tiles,
                                            const void* inst, const void* sem,
                                            const void* w, const void* vec,
                                            void* hist, void* sums,
                                            void* part, void* stream) {
  using namespace emsanet;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 1)
    return launch_hist<1>(n, p, s, c, blocks, tiles, inst, sem, w, vec, hist,
                          sums, part, st);
  if (d == 2)
    return launch_hist<2>(n, p, s, c, blocks, tiles, inst, sem, w, vec, hist,
                          sums, part, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int segment_lookup_launch(int n, int p, int d, int s,
                                     const void* inst, const void* tables,
                                     void* out, void* stream) {
  using namespace emsanet;
  if (n <= 0 || p <= 0 || d <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* k = static_cast<const int*>(inst);
  const float* t = static_cast<const float*>(tables);
  float* o = static_cast<float*>(out);
  if (d == 1) return launch_lookup<1>(n, p, d, s, k, t, o, st);
  if (d == 2) return launch_lookup<2>(n, p, d, s, k, t, o, st);
  return launch_lookup<0>(n, p, d, s, k, t, o, st);
}
