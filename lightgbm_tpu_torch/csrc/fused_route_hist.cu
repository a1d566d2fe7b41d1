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
// Bound on this card: one read of the bin matrix (N x F bytes, or N x
// ceil(F/2) packed), the gradient channels and row_node, one write of
// row_node and the histogram; no arithmetic to speak of. In practice the
// F x 3 atomics per slotted row limit it, worst at the root pass (S = 1:
// every row lands on the same F x bmax cells).
// Design: one thread per row over a grid-stride loop; the node and feature
// tables sit in shared memory (<= 1024 nodes x 8 int32 = 32 KB), loaded
// once per block; const-hessian objectives skip the hessian atomics. Two
// modes: f32 gradients into float64 cells, or quantized int8 gradients into
// int32 cells (integer sums: the same bits on every run, the TPU kernel's
// quantized=True); each on unpacked or 4-bit packed bins (the TPU
// kernel's num_features > 0). A privatised per-block shared-memory
// histogram (far less global contention) is later work.
#include "route_hist.cuh"

namespace {

// In: float (f32 mode) or int8_t (integer mode); Acc: the matching
// histogram cell type, double or int (route_hist.cuh).
template <typename In, typename Acc, bool kPacked>
__global__ void fused_route_hist_kernel(
    const uint8_t* __restrict__ bins, const In* __restrict__ grad,
    const In* __restrict__ hess, const float* __restrict__ cnt,
    const int* __restrict__ row_node_in, const int* __restrict__ tbl,
    const int* __restrict__ member, const int* __restrict__ feat_tbl,
    Acc* __restrict__ hist, int* __restrict__ row_node_out, int n, int f,
    int fh, int b, int s, int m, int w, int const_hess) {
  extern __shared__ int smem[];
  int* s_tbl = smem;
  int* s_feat = smem + m * lgbt::kTblCols;
  lgbt::load_tables(s_tbl, s_feat, tbl, feat_tbl, m, f);
  const int stride = gridDim.x * blockDim.x;
  const int rs = lgbt::row_stride(f, fh);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const uint8_t* row_bins = bins + static_cast<size_t>(i) * rs;
    int node, slot;
    lgbt::route_decide<kPacked>(row_node_in[i], row_bins, fh, s_tbl,
                                s_feat, member, m, w, &node, &slot);
    row_node_out[i] = node;
    if (slot >= 0 && slot < s) {
      lgbt::hist_accumulate<kPacked>(
          hist, slot, row_bins, f, fh, b, static_cast<Acc>(grad[i]),
          const_hess ? Acc(0) : static_cast<Acc>(hess[i]), cnt[i],
          const_hess);
    }
  }
}

template <typename In, typename Acc, bool kPacked>
cudaError_t launch(const void* bins, const void* grad, const void* hess,
                   const void* cnt, const void* row_node_in, const void* tbl,
                   const void* member, const void* feat_tbl, void* hist,
                   void* row_node_out, int n, int f, int fh, int b, int s,
                   int m, int w, int const_hess, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(m) * lgbt::kTblCols + 2 * f) *
                      sizeof(int);
  cudaError_t err =
      lgbt::allow_smem(fused_route_hist_kernel<In, Acc, kPacked>, smem);
  if (err != cudaSuccess) return err;
  fused_route_hist_kernel<In, Acc, kPacked>
      <<<lgbt::grid_for(n), lgbt::kThreads, smem, stream>>>(
          static_cast<const uint8_t*>(bins), static_cast<const In*>(grad),
          static_cast<const In*>(hess), static_cast<const float*>(cnt),
          static_cast<const int*>(row_node_in), static_cast<const int*>(tbl),
          static_cast<const int*>(member), static_cast<const int*>(feat_tbl),
          static_cast<Acc*>(hist), static_cast<int*>(row_node_out), n, f, fh,
          b, s, m, w, const_hess);
  return cudaGetLastError();
}

}  // namespace

// quantized != 0: grad and hess are int8 and hist is int32 cells for the
// gradient channels, f32 bits for the count channel (route_hist.cuh);
// else hist is float64 cells. fh > 0: bins are 4-bit packed, fh bytes a
// row.
extern "C" int lgbt_fused_route_hist(
    const void* bins, const void* grad, const void* hess, const void* cnt,
    const void* row_node_in, const void* tbl, const void* member,
    const void* feat_tbl, void* hist, void* row_node_out, int n, int f,
    int fh, int b, int s, int m, int w, int const_hess, int quantized,
    void* stream) {
  if (n == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
#define LGBT_FUSED(In, Acc, P)                                              \
  return launch<In, Acc, P>(bins, grad, hess, cnt, row_node_in, tbl, member, \
                            feat_tbl, hist, row_node_out, n, f, fh, b, s, m, \
                            w, const_hess, st)
  if (quantized) {
    if (fh > 0) LGBT_FUSED(int8_t, int, true);
    LGBT_FUSED(int8_t, int, false);
  }
  if (fh > 0) LGBT_FUSED(float, double, true);
  LGBT_FUSED(float, double, false);
#undef LGBT_FUSED
}
