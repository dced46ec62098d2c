// Pixel -> instance-center grouping: per pixel, the argmin over K centers
// of the squared distance between the pixel's voted position and each
// center; invalid centers count as 1e12, and a tie keeps the lowest index.
//
// Replaces the TPU kernel `emsanet_tpu/ops/grouping.py::group_pixels_argmin`
// (`_grouping_kernel`, pl.pallas_call at grouping.py:99).
//
// What bounds it on the H100: instruction issue. Per pixel it moves 16
// bytes, but each (pixel, center) pair needs 5 float instructions (2 FSUB,
// 2 FMUL, FADD: the distance may not be contracted into an FMA, so the
// 6-operation f32 bound counts fewer than the card issues) and a running
// argmin, which as FSETP + FSEL + SEL would add 3 more on the half-rate
// ALU pipe. A first design (one pixel a thread, the centers and their flags
// read from shared memory at every step) spent three shared loads per pair
// and was bound by shared-memory issue. This one:
//   - stages the block's image's centers once, as float2 (one 8-byte
//     broadcast load per center in the loop), compacted to the valid ones
//     in index order by a block-wide prefix count of warp ballots (no
//     atomics); `nv` is their number, `first_invalid` the lowest invalid
//     index (K if none); the slots past nv, up to a multiple of G, hold NaN
//     centers, whose distance never lowers a minimum nor equals one;
//   - keeps 4 pixels a thread in registers, loaded as float4 (two pixels
//     per 16 bytes) by read-only loads, so that each center load serves
//     4 pixels (8 a thread measured slower on the frame's inputs); idx
//     and dist leave as 16-byte evict-first
//     stores (scalar ones for a block that reaches past P, or when P is
//     not a multiple of 4);
//   - walks the nv valid centers only, in groups of G, keeping per pixel
//     the running minimum alone (one FMNMX a pair) and the first group
//     that lowered it (one compare and select a group); at the end it
//     rescans that group backwards for the first center at the minimum.
//
// Why this is the plain argmin bit for bit, for finite inputs. The plain
// version takes the first minimum, in (value, index) order, of
// v_j = valid_j ? d_j : 1e12 over j < K. Split the K candidates: the valid
// ones keep their distance, and every invalid one has the value 1e12, so of
// those only (1e12, first_invalid) can win. Over the valid centers, in index
// order: fminf returns one of its inputs, so the minimum is the exact
// minimum distance m; the group recorded is the first whose minimum is
// below the minimum of all earlier groups, i.e. the first group that holds
// a center at distance m; the backward rescan of that group (the same
// rounded distance, recomputed) ends on its first center at m. So
// (m, best_j) is the first minimum of the valid ones; from (+inf, group 0)
// a valid center at +inf (an overflowed distance) is found too. The final
// merge takes (1e12, first_invalid) when 1e12 < m, or 1e12 == m and
// first_invalid < best_j: the (value, index) order of the two. That covers
// all centers invalid (nv = 0, m stays +inf: index first_invalid = 0, dist
// 1e12) and a valid center at a distance >= 1e12 behind an invalid one.
// Nothing assumes that the valid centers are a prefix of K.
//
// Exactness of the distance: (v - c) per axis, then dy*dy + dx*dx, with
// __fsub_rn/__fmul_rn/__fadd_rn so that nvcc cannot contract it into an
// FMA (which rounds differently and can flip a near tie).
//
// Layouts: voted (N, P, 2) f32, centers (N, K, 2) f32, valid (N, K) bool
// (one byte each); outputs idx (N, P) int32, dist (N, P) f32.

#include <cstdint>

#include "common.cuh"

namespace emsanet {

constexpr int kGroupThreads = 128;
constexpr int kGroupWarps = kGroupThreads / 32;
constexpr int kMaxK = 1024;
constexpr int kCenterGroup = 4;  // G, the centers of a group
constexpr int kGroupPixels = 4;  // pixels a thread
constexpr float kInvalidDist = 1e12f;

// Dynamic shared memory of a block for K centers: the compacted centers
// (float2, padded by G) and their center indices (int).
inline int grouping_smem(int k) {
  return (k + kCenterGroup) * 8 + k * 4;
}

__device__ __forceinline__ float pair_dist(float vy, float vx, float2 c) {
  const float dy = __fsub_rn(vy, c.x);
  const float dx = __fsub_rn(vx, c.y);
  return __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx));
}

__global__ void __launch_bounds__(kGroupThreads)
grouping_kernel(const float* __restrict__ voted,
                const float* __restrict__ centers,
                const unsigned char* __restrict__ valid,
                int* __restrict__ idx, float* __restrict__ dist, int p, int k,
                int vec) {
  constexpr int PPT = kGroupPixels, G = kCenterGroup;
  constexpr int kPixelsPerBlock = kGroupThreads * PPT;
  extern __shared__ float2 s_center[];  // [k + G], then s_index [k]
  int* s_index = reinterpret_cast<int*>(s_center + k + G);
  __shared__ int s_count[kGroupWarps], s_bad[kGroupWarps];

  const int img = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * kPixelsPerBlock;
  const bool full = vec && b0 + kPixelsPerBlock <= p;
  const size_t row = (size_t)img * p;

  // the thread's pixels, b0 + 4 t + 0..3; loaded first, so that their
  // latency overlaps the staging. Their index is written out at each use:
  // held in a variable across the center loop it changed ptxas' schedule
  // of that loop, ~2% slower on an H100.
  float vy[PPT], vx[PPT];
  if (full) {
    const float4* src = reinterpret_cast<const float4*>(
        voted + (row + b0 + PPT * threadIdx.x) * 2);
    const float4 a = __ldg(src), b = __ldg(src + 1);
    vy[0] = a.x; vx[0] = a.y; vy[1] = a.z; vx[1] = a.w;
    vy[2] = b.x; vx[2] = b.y; vy[3] = b.z; vx[3] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int px = b0 + PPT * threadIdx.x + i;
      vy[i] = px < p ? __ldg(voted + (row + px) * 2) : 0.f;
      vx[i] = px < p ? __ldg(voted + (row + px) * 2 + 1) : 0.f;
    }
  }

  // NaN in every slot first: the compacted centers overwrite their slots
  // after the first barrier below
  for (int s = threadIdx.x; s < k + G; s += kGroupThreads)
    s_center[s] = make_float2(__int_as_float(0x7fc00000),
                              __int_as_float(0x7fc00000));
  // stage the valid centers, compacted in index order
  int nv = 0, first_invalid = k;
  for (int j0 = 0; j0 < k; j0 += kGroupThreads) {
    const int j = j0 + threadIdx.x;
    const bool in = j < k;
    float cy = 0.f, cx = 0.f;
    bool ok = false;
    if (in) {  // the three loads issue together
      ok = valid[(size_t)img * k + j];
      cy = centers[((size_t)img * k + j) * 2];
      cx = centers[((size_t)img * k + j) * 2 + 1];
    }
    const unsigned good = __ballot_sync(0xffffffffu, ok);
    const unsigned bad = __ballot_sync(0xffffffffu, in && !ok);
    if (lane == 0) {
      s_count[warp] = __popc(good);
      s_bad[warp] = bad ? j0 + warp * 32 + __ffs(bad) - 1 : k;
    }
    __syncthreads();
    int ahead = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kGroupWarps; ++w) {
      const int c = s_count[w];
      ahead += w < warp ? c : 0;
      total += c;
      first_invalid = min(first_invalid, s_bad[w]);
    }
    if (ok) {
      const int slot = nv + ahead + __popc(good & ((1u << lane) - 1u));
      s_center[slot] = make_float2(cy, cx);
      s_index[slot] = j;
    }
    nv += total;
    __syncthreads();  // s_count is reused; the last pass publishes s_center
  }

  // the running minimum, and the first group that lowered it
  float best[PPT];
  int group[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    best[i] = __int_as_float(0x7f800000);  // +inf
    group[i] = 0;
  }
  const int n_groups = (nv + G - 1) / G;
  for (int g = 0; g < n_groups; ++g) {
    float prev[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) prev[i] = best[i];
#pragma unroll
    for (int c = 0; c < G; ++c) {
      const float2 cc = s_center[g * G + c];
#pragma unroll
      for (int i = 0; i < PPT; ++i)
        best[i] = fminf(best[i], pair_dist(vy[i], vx[i], cc));
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i) group[i] = best[i] < prev[i] ? g : group[i];
  }

  int out_j[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    int j = 0;
    if (nv > 0) {
      // walked backwards, the last match is the group's first
      int slot = group[i] * G;
#pragma unroll
      for (int c = G - 1; c >= 0; --c) {
        const int at = group[i] * G + c;
        slot = pair_dist(vy[i], vx[i], s_center[at]) == best[i] ? at : slot;
      }
      j = s_index[slot];
    }
    if (first_invalid < k &&
        (kInvalidDist < best[i] ||
         (kInvalidDist == best[i] && first_invalid < j))) {
      best[i] = kInvalidDist;
      j = first_invalid;
    }
    out_j[i] = j;
  }

  if (full) {
    const size_t at = row + b0 + PPT * threadIdx.x;
    __stcs(reinterpret_cast<int4*>(idx + at),
           make_int4(out_j[0], out_j[1], out_j[2], out_j[3]));
    __stcs(reinterpret_cast<float4*>(dist + at),
           make_float4(best[0], best[1], best[2], best[3]));
  } else {
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int px = b0 + PPT * threadIdx.x + i;
      if (px < p) {
        idx[row + px] = out_j[i];
        dist[row + px] = best[i];
      }
    }
  }
}

inline int launch(int n, int p, int k, const void* voted,
                  const void* centers, const void* valid, void* idx,
                  void* dist, cudaStream_t stream) {
  // the 16-byte path needs every image's rows on 16-byte boundaries
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(voted) |
                         reinterpret_cast<uintptr_t>(idx) |
                         reinterpret_cast<uintptr_t>(dist);
  const int vec = p % 4 == 0 && ptrs % 16 == 0;
  dim3 grid(ceil_div(p, kGroupThreads * kGroupPixels), n);
  grouping_kernel<<<grid, kGroupThreads, grouping_smem(k), stream>>>(
      (const float*)voted, (const float*)centers,
      (const unsigned char*)valid, (int*)idx, (float*)dist, p, k, vec);
  return (int)cudaGetLastError();
}

}  // namespace emsanet

// k in [1, 1024]; the wrapper checks it.
extern "C" int group_pixels_argmin_launch(int n, int p, int k,
                                          const void* voted,
                                          const void* centers,
                                          const void* valid, void* idx,
                                          void* dist, void* stream) {
  using namespace emsanet;
  if (n < 1 || p < 1 || k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  return launch(n, p, k, voted, centers, valid, idx, dist,
                static_cast<cudaStream_t>(stream));
}
