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
// The histogram design: each block builds a private (S, C) histogram and
// (S, D) sum table in shared memory with shared-memory atomics over a
// grid-strided range of one image's pixels, then adds its non-zero
// entries to the output with global atomics. The outputs are zeroed with
// cudaMemsetAsync on the same stream first. Votes are 0/1, so the
// histogram counts are exact; the vector sums are f32 atomics whose order
// changes from run to run, so they match the plain version to rounding
// only. The lookup: one thread per pixel, the (D, S) table in shared
// memory.
//
// Layouts: inst, sem (N, P) int32; w (N, P) f32; vec (N, P, D) f32;
// hist (N, S, C) f32; sums (N, S, D) f32; tables (N, D, S) f32;
// out (N, D, P) f32.

#include "common.cuh"

namespace emsanet {

constexpr int kThreads = 256;
constexpr int kPixPerThread = 16;

__global__ void __launch_bounds__(kThreads)
hist_kernel(const int* __restrict__ inst, const int* __restrict__ sem,
            const float* __restrict__ w, const float* __restrict__ vec,
            float* __restrict__ hist, float* __restrict__ sums, int p,
            int s, int c, int d) {
  extern __shared__ float smem[];
  float* h_s = smem;          // [s][c]
  float* v_s = smem + s * c;  // [s][d]
  const int img = blockIdx.y;
  for (int i = threadIdx.x; i < s * (c + d); i += kThreads) smem[i] = 0.f;
  __syncthreads();
  const size_t base = (size_t)img * p;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < p;
       i += gridDim.x * kThreads) {
    const int k = inst[base + i];
    if (k < 0 || k >= s) continue;
    const int cls = sem[base + i];
    const float wv = w[base + i];
    if (cls >= 0 && cls < c && wv != 0.f) atomicAdd(&h_s[k * c + cls], wv);
    for (int dd = 0; dd < d; ++dd) {
      const float vv = vec[(base + i) * d + dd];
      if (vv != 0.f) atomicAdd(&v_s[k * d + dd], vv);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < s * c; i += kThreads)
    if (h_s[i] != 0.f) atomicAdd(&hist[(size_t)img * s * c + i], h_s[i]);
  for (int i = threadIdx.x; i < s * d; i += kThreads)
    if (v_s[i] != 0.f) atomicAdd(&sums[(size_t)img * s * d + i], v_s[i]);
}

__global__ void __launch_bounds__(kThreads)
lookup_kernel(const int* __restrict__ inst, const float* __restrict__ tables,
              float* __restrict__ out, int p, int d, int s) {
  extern __shared__ float t_s[];  // [d][s]
  const int img = blockIdx.y;
  for (int i = threadIdx.x; i < d * s; i += kThreads)
    t_s[i] = tables[(size_t)img * d * s + i];
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p) return;
  const int k = inst[(size_t)img * p + i];
  const bool ok = k >= 0 && k < s;
  for (int dd = 0; dd < d; ++dd)
    out[((size_t)img * d + dd) * p + i] = ok ? t_s[dd * s + k] : 0.f;
}

}  // namespace emsanet

extern "C" int segment_hist_and_sums_launch(int n, int p, int s, int c, int d,
                                            const void* inst, const void* sem,
                                            const void* w, const void* vec,
                                            void* hist, void* sums,
                                            void* stream) {
  using namespace emsanet;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(hist, 0, sizeof(float) * (size_t)n * s * c, st);
  cudaMemsetAsync(sums, 0, sizeof(float) * (size_t)n * s * d, st);
  const size_t smem = sizeof(float) * (size_t)s * (c + d);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(hist_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  dim3 grid(ceil_div(p, kThreads * kPixPerThread), n);
  hist_kernel<<<grid, kThreads, smem, st>>>(
      (const int*)inst, (const int*)sem, (const float*)w, (const float*)vec,
      (float*)hist, (float*)sums, p, s, c, d);
  return (int)cudaGetLastError();
}

extern "C" int segment_lookup_launch(int n, int p, int d, int s,
                                     const void* inst, const void* tables,
                                     void* out, void* stream) {
  using namespace emsanet;
  const size_t smem = sizeof(float) * (size_t)d * s;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(lookup_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  dim3 grid(ceil_div(p, kThreads), n);
  lookup_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      (const int*)inst, (const float*)tables, (float*)out, p, d, s);
  return (int)cudaGetLastError();
}
