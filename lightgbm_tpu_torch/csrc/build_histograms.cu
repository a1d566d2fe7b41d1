// build_histograms: per-slot (grad, hess, count) histograms keyed by
// row_slot; rows with slot < 0 or >= S are dropped.
//
// Replaces: lightgbm_tpu/learner/histogram_mxu.py, build_histograms_mxu
// (pallas_call in _hist_kernel; the v1 kernel the wide fix-up passes take)
// and is the port's counterpart for build_histograms_mxu_v2 (same
// function). The TPU kernels contract a slot one-hot against a bin one-hot
// on the MXU, with gradients split into bf16 hi/lo pairs; here each row
// adds f32 values straight into its cells.
//
// Bound on this card: bytes — row_slot for every row, then the bins and
// the gradient channels of the slotted rows, and one write of the
// histogram. Late fix-up passes park most rows (slot -1), so those cost a
// read of row_slot and little else. The float atomics limit it where many
// rows share few slots.
// Design: one thread per row over a grid-stride loop, accumulation code
// shared with fused_route_hist (route_hist.cuh); const-hessian objectives
// skip the hessian atomics.
#include "route_hist.cuh"

namespace {

__global__ void build_histograms_kernel(const uint8_t* __restrict__ bins,
                                        const float* __restrict__ grad,
                                        const float* __restrict__ hess,
                                        const float* __restrict__ cnt,
                                        const int* __restrict__ row_slot,
                                        float* __restrict__ hist, int n,
                                        int f, int b, int s,
                                        int const_hess) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int slot = row_slot[i];
    if (slot < 0 || slot >= s) continue;
    lgbt::hist_accumulate(hist, slot, bins + static_cast<size_t>(i) * f, f,
                          b, grad[i], const_hess ? 0.0f : hess[i], cnt[i],
                          const_hess);
  }
}

}  // namespace

extern "C" int lgbt_build_histograms(const void* bins, const void* grad,
                                     const void* hess, const void* cnt,
                                     const void* row_slot, void* hist, int n,
                                     int f, int b, int s, int const_hess,
                                     void* stream) {
  if (n == 0) return cudaSuccess;
  build_histograms_kernel<<<lgbt::grid_for(n), lgbt::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bins), static_cast<const float*>(grad),
      static_cast<const float*>(hess), static_cast<const float*>(cnt),
      static_cast<const int*>(row_slot), static_cast<float*>(hist), n, f, b,
      s, const_hess);
  return cudaGetLastError();
}
