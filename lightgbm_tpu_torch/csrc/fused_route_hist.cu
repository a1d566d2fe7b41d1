// fused_route_hist: route every row one level through the previous pass's
// split tables, then add it into its new slot's histogram — one sweep over
// the binned matrix per growth pass.
//
// Replaces: lightgbm_tpu/learner/histogram_mxu.py, fused_route_hist_mxu
// (pallas_call in _fused_kernel; decision math _route_decide, accumulation
// _hist_accumulate). The TPU kernel gathers node-table rows and builds
// histograms with one-hot matmuls on the MXU because gathers and scatters
// are slow there; this kernel indexes the table and adds with atomics.
//
// Bound on this card: one read of the bin matrix (N x F bytes), the
// gradient channels and row_node, one write of row_node and the histogram;
// no arithmetic to speak of. In practice the F x 3 float atomics per
// slotted row limit it, worst at the root pass (S = 1: every row lands on
// the same 28 x 256 cells).
// Design: one thread per row over a grid-stride loop; the node and feature
// tables sit in shared memory (<= 1024 nodes x 8 int32 = 32 KB), loaded
// once per block; const-hessian objectives skip the hessian atomics. A
// privatised per-block shared-memory histogram (deterministic and with far
// less global contention) is later work.
#include "route_hist.cuh"

namespace {

__global__ void fused_route_hist_kernel(
    const uint8_t* __restrict__ bins, const float* __restrict__ grad,
    const float* __restrict__ hess, const float* __restrict__ cnt,
    const int* __restrict__ row_node_in, const int* __restrict__ tbl,
    const int* __restrict__ member, const int* __restrict__ feat_tbl,
    float* __restrict__ hist, int* __restrict__ row_node_out, int n, int f,
    int b, int s, int m, int w, int const_hess) {
  extern __shared__ int smem[];
  int* s_tbl = smem;
  int* s_feat = smem + m * lgbt::kTblCols;
  lgbt::load_tables(s_tbl, s_feat, tbl, feat_tbl, m, f);
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const uint8_t* row_bins = bins + static_cast<size_t>(i) * f;
    int node, slot;
    lgbt::route_decide(row_node_in[i], row_bins, s_tbl, s_feat, member, m,
                       w, &node, &slot);
    row_node_out[i] = node;
    if (slot >= 0 && slot < s) {
      lgbt::hist_accumulate(hist, slot, row_bins, f, b, grad[i],
                            const_hess ? 0.0f : hess[i], cnt[i], const_hess);
    }
  }
}

}  // namespace

extern "C" int lgbt_fused_route_hist(
    const void* bins, const void* grad, const void* hess, const void* cnt,
    const void* row_node_in, const void* tbl, const void* member,
    const void* feat_tbl, void* hist, void* row_node_out, int n, int f,
    int b, int s, int m, int w, int const_hess, void* stream) {
  if (n == 0) return cudaSuccess;
  const size_t smem = (static_cast<size_t>(m) * lgbt::kTblCols + 2 * f) *
                      sizeof(int);
  cudaError_t err = lgbt::allow_smem(fused_route_hist_kernel, smem);
  if (err != cudaSuccess) return err;
  fused_route_hist_kernel<<<lgbt::grid_for(n), lgbt::kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bins), static_cast<const float*>(grad),
      static_cast<const float*>(hess), static_cast<const float*>(cnt),
      static_cast<const int*>(row_node_in), static_cast<const int*>(tbl),
      static_cast<const int*>(member), static_cast<const int*>(feat_tbl),
      static_cast<float*>(hist), static_cast<int*>(row_node_out), n, f, b, s,
      m, w, const_hess);
  return cudaGetLastError();
}
