// build_histograms: per-slot (grad, hess, count) histograms keyed by
// row_slot; rows with slot < 0 or >= S are dropped.
//
// Replaces: lightgbm_tpu/learner/histogram_mxu.py, build_histograms_mxu
// (pallas_call in _hist_kernel; the v1 kernel the wide fix-up passes take)
// and build_histograms_mxu_v2 (pallas_call in _hist_kernel_v2; the same
// function in one row pass, the one that reads 4-bit packed bins).
// build_histograms_auto picks between them as the JAX package's
// build_histograms_mxu_auto does; here both are this kernel. The TPU
// kernels contract a slot one-hot against a bin one-hot on the MXU, with
// gradients split into bf16 hi/lo pairs; here each row adds its values
// straight into its cells.
//
// Bound on this card: bytes — row_slot for every row, then the bins and
// the gradient channels of the slotted rows, and one write of the
// histogram. Late fix-up passes park most rows (slot -1), so those cost a
// read of row_slot and little else. The atomics limit it where many rows
// share few slots.
// Design: one thread per row over a grid-stride loop, accumulation code
// shared with fused_route_hist (route_hist.cuh), in its f32 (float64
// cells) or its integer (quantized int8 gradients, int32 cells) mode, on
// unpacked or 4-bit packed bins; const-hessian objectives skip the hessian
// atomics.
#include "route_hist.cuh"

namespace {

template <typename In, typename Acc, bool kPacked>
__global__ void build_histograms_kernel(const uint8_t* __restrict__ bins,
                                        const In* __restrict__ grad,
                                        const In* __restrict__ hess,
                                        const float* __restrict__ cnt,
                                        const int* __restrict__ row_slot,
                                        Acc* __restrict__ hist, int n, int f,
                                        int fh, int b, int s,
                                        int const_hess) {
  const int stride = gridDim.x * blockDim.x;
  const int rs = lgbt::row_stride(f, fh);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int slot = row_slot[i];
    if (slot < 0 || slot >= s) continue;
    lgbt::hist_accumulate<kPacked>(
        hist, slot, bins + static_cast<size_t>(i) * rs, f, fh, b,
        static_cast<Acc>(grad[i]),
        const_hess ? Acc(0) : static_cast<Acc>(hess[i]), cnt[i], const_hess);
  }
}

template <typename In, typename Acc, bool kPacked>
cudaError_t launch(const void* bins, const void* grad, const void* hess,
                   const void* cnt, const void* row_slot, void* hist, int n,
                   int f, int fh, int b, int s, int const_hess,
                   cudaStream_t stream) {
  build_histograms_kernel<In, Acc, kPacked>
      <<<lgbt::grid_for(n), lgbt::kThreads, 0, stream>>>(
          static_cast<const uint8_t*>(bins), static_cast<const In*>(grad),
          static_cast<const In*>(hess), static_cast<const float*>(cnt),
          static_cast<const int*>(row_slot), static_cast<Acc*>(hist), n, f,
          fh, b, s, const_hess);
  return cudaGetLastError();
}

}  // namespace

// quantized != 0: grad and hess are int8 and hist is int32 cells for the
// gradient channels, f32 bits for the count channel (route_hist.cuh);
// else hist is float64 cells. fh > 0: bins are 4-bit packed, fh bytes a
// row.
extern "C" int lgbt_build_histograms(const void* bins, const void* grad,
                                     const void* hess, const void* cnt,
                                     const void* row_slot, void* hist, int n,
                                     int f, int fh, int b, int s,
                                     int const_hess, int quantized,
                                     void* stream) {
  if (n == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
#define LGBT_HIST(In, Acc, P)                                              \
  return launch<In, Acc, P>(bins, grad, hess, cnt, row_slot, hist, n, f,   \
                            fh, b, s, const_hess, st)
  if (quantized) {
    if (fh > 0) LGBT_HIST(int8_t, int, true);
    LGBT_HIST(int8_t, int, false);
  }
  if (fh > 0) LGBT_HIST(float, double, true);
  LGBT_HIST(float, double, false);
#undef LGBT_HIST
}
