// Pixel -> instance-center grouping: per pixel, the argmin over K centers
// of the squared distance between the pixel's voted position and each
// center; invalid centers count as 1e12.
//
// Replaces the TPU kernel `emsanet_tpu/ops/grouping.py::group_pixels_argmin`
// (`_grouping_kernel`, pl.pallas_call at grouping.py:99).
//
// What bounds it on the H100: per pixel it reads 8 bytes and writes 8
// bytes, and does ~5 K float operations (K = 64): about 40 operations per
// byte, under the f32 ridge of the card (67 TFLOP/s / 3.35 TB/s = 20), so
// it is close to balanced. The design keeps the (P, K) distance matrix
// out of device memory entirely: one thread per pixel, the K centers and
// their validity in shared memory (read as broadcasts), the running min in
// registers.
//
// Exactness: the index must equal the plain version bit for bit. The
// distance is formed as in the plain version, (v - c) per axis, then
// dy*dy + dx*dx, with __fmul_rn/__fadd_rn so that nvcc cannot contract it
// into an FMA (which rounds differently and can flip a near tie). A tie
// keeps the lowest index, as argmin does.
//
// Layouts: voted (N, P, 2) f32, centers (N, K, 2) f32, valid (N, K) bool
// (one byte each); outputs idx (N, P) int32, dist (N, P) f32.

#include "common.cuh"

namespace emsanet {

constexpr int kThreads = 256;
constexpr int kMaxK = 1024;

__global__ void __launch_bounds__(kThreads)
grouping_kernel(const float* __restrict__ voted,
                const float* __restrict__ centers,
                const unsigned char* __restrict__ valid,
                int* __restrict__ idx, float* __restrict__ dist, int p,
                int k) {
  __shared__ float cy[kMaxK], cx[kMaxK];
  __shared__ unsigned char cv[kMaxK];
  const int img = blockIdx.y;
  for (int j = threadIdx.x; j < k; j += kThreads) {
    cy[j] = centers[((size_t)img * k + j) * 2];
    cx[j] = centers[((size_t)img * k + j) * 2 + 1];
    cv[j] = valid[(size_t)img * k + j];
  }
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p) return;
  const float2 v =
      reinterpret_cast<const float2*>(voted)[(size_t)img * p + i];
  float best = 0.f;
  int best_j = 0;
  for (int j = 0; j < k; ++j) {
    const float dy = __fsub_rn(v.x, cy[j]);
    const float dx = __fsub_rn(v.y, cx[j]);
    float d = __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx));
    if (!cv[j]) d = 1e12f;
    if (j == 0 || d < best) {
      best = d;
      best_j = j;
    }
  }
  idx[(size_t)img * p + i] = best_j;
  dist[(size_t)img * p + i] = best;
}

}  // namespace emsanet

// k must be in [1, 1024]; the wrapper checks it.
extern "C" int group_pixels_argmin_launch(int n, int p, int k,
                                          const void* voted,
                                          const void* centers,
                                          const void* valid, void* idx,
                                          void* dist, void* stream) {
  using namespace emsanet;
  dim3 grid(ceil_div(p, kThreads), n);
  grouping_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      (const float*)voted, (const float*)centers,
      (const unsigned char*)valid, (int*)idx, (float*)dist, p, k);
  return (int)cudaGetLastError();
}
