// Parity-plane interleave: M maps of 4-byte words, each (N, 4, H2, W2)
// parity planes (parity p*2+q), woven into (N, 2 H2, 2 W2) in one launch:
// out[n, 2y+p, 2x+q] = in[n, p*2+q, y, x]. A bitwise copy, so f32 maps
// pass through as their bits.
//
// Replaces the TPU kernel `emsanet_tpu/ops/plane_interleave.py`
// (`_interleave_kernel`; pl.pallas_call at :85 in `_interleave_many_i32`,
// called by `interleave_planes_pallas`).
//
// What bounds it on the H100: bytes, each word read once and written once
// (six b8 640x480 maps: 59 MB each way). One thread writes two
// neighbouring words of an output row, (2y+p, 2x) and (2y+p, 2x+1), from
// planes p*2 and p*2+1: both loads and the 8-byte store are coalesced
// across the warp. blockIdx.z walks the maps and the images, so all M
// maps go in one launch; their pointers travel in the kernel's argument
// block.

#include <cstdint>

#include "common.cuh"

namespace emsanet {

constexpr int kInterleaveThreads = 128;
constexpr int kMaxMaps = 16;

struct MapPointers {
  const int32_t* in[kMaxMaps];
  int32_t* out[kMaxMaps];
};

__global__ void __launch_bounds__(kInterleaveThreads)
plane_interleave_kernel(MapPointers maps, int n, int h2, int w2) {
  const int xx = blockIdx.x * kInterleaveThreads + threadIdx.x;
  const int row = blockIdx.y;  // full-res row 2y+p
  const int m = blockIdx.z / n, img = blockIdx.z % n;
  if (xx >= w2) return;
  const int y = row >> 1, p = row & 1;
  const int32_t* in = maps.in[m];
  const size_t plane = (size_t)h2 * w2;
  const size_t src = (((size_t)img * 4 + 2 * p) * h2 + y) * w2 + xx;
  const int2 v = make_int2(in[src], in[src + plane]);
  const size_t dst = ((size_t)img * 2 * h2 + row) * (2 * w2) + 2 * xx;
  *reinterpret_cast<int2*>(maps.out[m] + dst) = v;
}

}  // namespace emsanet

// m in [1, 16] maps, each (n, 4, h2, w2) in and (n, 2 h2, 2 w2) out,
// given as host arrays of device pointers; the wrapper checks the shapes.
extern "C" int plane_interleave_launch(int m, int n, int h2, int w2,
                                       const void* const* ins,
                                       void* const* outs, void* stream) {
  using namespace emsanet;
  if (m < 1 || m > kMaxMaps || n < 1) return (int)cudaErrorInvalidValue;
  MapPointers maps = {};
  for (int i = 0; i < m; ++i) {
    maps.in[i] = static_cast<const int32_t*>(ins[i]);
    maps.out[i] = static_cast<int32_t*>(outs[i]);
  }
  dim3 grid(ceil_div(w2, kInterleaveThreads), 2 * h2, m * n);
  plane_interleave_kernel<<<grid, kInterleaveThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(maps, n, h2,
                                                                 w2);
  return (int)cudaGetLastError();
}
