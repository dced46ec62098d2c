// Parity-plane interleave: M maps, each (N, 4, H2, W2) parity planes
// (parity p*2+q) of 4-byte words or of bytes, woven into (N, 2 H2, 2 W2)
// in one launch: out[n, 2y+p, 2x+q] = in[n, p*2+q, y, x]. A bitwise copy,
// so f32 maps pass through as their bits and bool maps as their bytes.
//
// Replaces the TPU kernel `emsanet_tpu/ops/plane_interleave.py`
// (`_interleave_kernel`; pl.pallas_call at :85 in `_interleave_many_i32`,
// called by `interleave_planes_pallas`). The TPU kernel takes 4-byte maps
// only; here the 1-byte maps ride in the same launch, so a frame's bool
// foreground map costs no PyTorch copy of its own.
//
// What bounds it on the H100: bytes, each element read once and written
// once (the decode-planes frame's six word maps and one bool map at b8
// 640x480: 61 MB each way). The design:
//   - a unit of work reads two 8-byte pieces of one input row, from planes
//     p*2 and p*2+1 (words: 2 columns; bytes: 8 columns), and writes one
//     16-byte piece of output row 2y+p (words interleaved as int4, bytes
//     by two __byte_perm per 8 bytes);
//   - loads are read-only (ld.global.nc) and stores evict-first
//     (st.global.cs): the output is not read again by this kernel;
//   - a block takes a tile of kUnroll x kThreads units of one map and
//     issues all its loads before its stores; the tiles of all maps form
//     one range, one block per tile (persistent grids of 4 and 8 blocks
//     an SM measured slower);
//   - a map whose rows do not keep those pieces aligned (odd W2 for words,
//     W2 not a multiple of 8 for bytes, or an unaligned pointer) takes the
//     scalar path: a unit is one column, two elements read and two written.
// The maps' pointers, element sizes and tile ranges travel in the kernel's
// argument block (__grid_constant__: indexed in place, never copied to a
// stack frame).

#include <cstdint>

#include "common.cuh"

namespace emsanet {

constexpr int kInterleaveThreads = 256;
constexpr int kInterleaveUnroll = 2;
constexpr int kTileUnits = kInterleaveThreads * kInterleaveUnroll;
constexpr int kMaxMaps = 16;

enum MapKind { kWordsVec = 0, kWordsScalar = 1, kBytesVec = 2,
               kBytesScalar = 3 };

struct InterleaveArgs {
  const unsigned char* in[kMaxMaps];
  unsigned char* out[kMaxMaps];
  int kind[kMaxMaps];
  int units_per_row[kMaxMaps];
  int tile_start[kMaxMaps + 1];  // map m owns tiles [start[m], start[m+1])
  int rows, h2, w2;  // rows = N * 2 H2 output rows per map
};

// Element offsets of unit u of a map with `upr` units per output row and
// `cols` columns per unit: the input element of plane p*2 (plane p*2+1 is
// one plane further) and the output element.
__device__ __forceinline__ void unit_offsets(const InterleaveArgs& a, int u,
                                             int upr, int cols,
                                             size_t& src, size_t& dst) {
  const int row = u / upr;          // output row over the N images: n 2H2 + r
  const int xu = u - row * upr;
  const int yy = row >> 1;          // n H2 + y
  const int p = row & 1;
  const int img = yy / a.h2;
  // ((n 4 + 2p) H2 + y) W2 + x, with (n 4 + 2p) H2 + y = yy + (3n + 2p) H2
  src = ((size_t)yy + (size_t)(3 * img + 2 * p) * a.h2) * a.w2
        + (size_t)xu * cols;
  dst = (size_t)row * 2 * a.w2 + (size_t)xu * 2 * cols;
}

template <int KIND>
__device__ __forceinline__ void interleave_tile(const InterleaveArgs& a,
                                                int mi, int first) {
  constexpr bool kWords = KIND == kWordsVec || KIND == kWordsScalar;
  constexpr bool kVec = KIND == kWordsVec || KIND == kBytesVec;
  constexpr int kCols = kVec ? (kWords ? 2 : 8) : 1;
  constexpr int kSize = kWords ? 4 : 1;
  const int upr = a.units_per_row[mi];
  const int units = a.rows * upr;
  const size_t plane = (size_t)a.h2 * a.w2 * kSize;  // bytes
  const unsigned char* in = a.in[mi];
  unsigned char* out = a.out[mi];
  uint2 lo[kInterleaveUnroll], hi[kInterleaveUnroll];
  size_t dst[kInterleaveUnroll];
#pragma unroll
  for (int i = 0; i < kInterleaveUnroll; ++i) {
    const int u = first + i * kInterleaveThreads + threadIdx.x;
    dst[i] = 0;
    lo[i] = hi[i] = make_uint2(0u, 0u);
    if (u < units) {
      size_t src;
      unit_offsets(a, u, upr, kCols, src, dst[i]);
      const unsigned char* s = in + src * kSize;
      if (kVec) {
        lo[i] = __ldg(reinterpret_cast<const uint2*>(s));
        hi[i] = __ldg(reinterpret_cast<const uint2*>(s + plane));
      } else if (kWords) {
        lo[i].x = __ldg(reinterpret_cast<const unsigned*>(s));
        hi[i].x = __ldg(reinterpret_cast<const unsigned*>(s + plane));
      } else {
        lo[i].x = __ldg(s);
        hi[i].x = __ldg(s + plane);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kInterleaveUnroll; ++i) {
    const int u = first + i * kInterleaveThreads + threadIdx.x;
    if (u >= units) continue;
    unsigned char* d = out + dst[i] * kSize;
    if (KIND == kWordsVec) {
      __stcs(reinterpret_cast<uint4*>(d),
             make_uint4(lo[i].x, hi[i].x, lo[i].y, hi[i].y));
    } else if (KIND == kBytesVec) {
      __stcs(reinterpret_cast<uint4*>(d),
             make_uint4(__byte_perm(lo[i].x, hi[i].x, 0x5140),
                        __byte_perm(lo[i].x, hi[i].x, 0x7362),
                        __byte_perm(lo[i].y, hi[i].y, 0x5140),
                        __byte_perm(lo[i].y, hi[i].y, 0x7362)));
    } else if (KIND == kWordsScalar) {
      __stcs(reinterpret_cast<unsigned*>(d), lo[i].x);
      __stcs(reinterpret_cast<unsigned*>(d) + 1, hi[i].x);
    } else {
      d[0] = (unsigned char)lo[i].x;
      d[1] = (unsigned char)hi[i].x;
    }
  }
}

__global__ void __launch_bounds__(kInterleaveThreads)
plane_interleave_kernel(const __grid_constant__ InterleaveArgs a) {
  const int tile = blockIdx.x;
  int mi = 0;
  while (tile >= a.tile_start[mi + 1]) ++mi;
  const int first = (tile - a.tile_start[mi]) * kTileUnits;
  switch (a.kind[mi]) {
    case kWordsVec: interleave_tile<kWordsVec>(a, mi, first); break;
    case kWordsScalar: interleave_tile<kWordsScalar>(a, mi, first); break;
    case kBytesVec: interleave_tile<kBytesVec>(a, mi, first); break;
    default: interleave_tile<kBytesScalar>(a, mi, first); break;
  }
}

}  // namespace emsanet

// m in [1, 16] maps, each (n, 4, h2, w2) in and (n, 2 h2, 2 w2) out, given
// as host arrays of device pointers and of element sizes (4 or 1). The
// wrapper checks the shapes.
extern "C" int plane_interleave_launch(int m, int n, int h2, int w2,
                                       const void* const* ins,
                                       void* const* outs,
                                       const int* elem_sizes, void* stream) {
  using namespace emsanet;
  if (m < 1 || m > kMaxMaps || n < 1 || h2 < 1 || w2 < 1)
    return (int)cudaErrorInvalidValue;
  InterleaveArgs a = {};
  a.rows = 2 * n * h2;
  a.h2 = h2;
  a.w2 = w2;
  for (int i = 0; i < m; ++i) {
    const uintptr_t in = reinterpret_cast<uintptr_t>(ins[i]);
    const uintptr_t out = reinterpret_cast<uintptr_t>(outs[i]);
    const bool aligned = in % 8 == 0 && out % 16 == 0;
    if (elem_sizes[i] == 4) {
      a.kind[i] = aligned && w2 % 2 == 0 ? kWordsVec : kWordsScalar;
    } else if (elem_sizes[i] == 1) {
      a.kind[i] = aligned && w2 % 8 == 0 ? kBytesVec : kBytesScalar;
    } else {
      return (int)cudaErrorInvalidValue;
    }
    const int cols = a.kind[i] == kWordsVec ? 2
                     : a.kind[i] == kBytesVec ? 8 : 1;
    a.in[i] = static_cast<const unsigned char*>(ins[i]);
    a.out[i] = static_cast<unsigned char*>(outs[i]);
    a.units_per_row[i] = w2 / cols;
    a.tile_start[i + 1] =
        a.tile_start[i] + ceil_div(a.rows * a.units_per_row[i], kTileUnits);
  }
  plane_interleave_kernel<<<a.tile_start[m], kInterleaveThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
