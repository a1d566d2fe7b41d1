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
// modes: exact, f32 gradients as fixed-point int64 values (route_hist.cuh)
// into int64 cells, which a second kernel scales back into the f32
// histogram; or quantized int8 gradients into int32 cells (the TPU
// kernel's quantized=True). Both are integer sums: the same bits on every
// run and in every order. Each on unpacked or 4-bit packed bins (the TPU
// kernel's num_features > 0). A privatised per-block shared-memory
// histogram (far less global contention) is later work.
#include "route_hist.cuh"

namespace {

// In: float (exact mode) or int8_t (integer mode); Acc: the matching
// histogram cell type, unsigned long long or int (route_hist.cuh).
template <typename In, typename Acc, bool kPacked>
__global__ void fused_route_hist_kernel(
    const uint8_t* __restrict__ bins, const In* __restrict__ grad,
    const In* __restrict__ hess, const float* __restrict__ cnt,
    const int* __restrict__ row_node_in, const int* __restrict__ tbl,
    const int* __restrict__ member, const int* __restrict__ feat_tbl,
    const int* __restrict__ scale_k, Acc* __restrict__ hist,
    int* __restrict__ row_node_out, int n, int f, int fh, int b, int s,
    int m, int w, int const_hess) {
  constexpr bool kExact = sizeof(Acc) == 8;
  extern __shared__ int smem[];
  int* s_tbl = smem;
  int* s_feat = smem + m * lgbt::kTblCols;
  lgbt::load_tables(s_tbl, s_feat, tbl, feat_tbl, m, f);
  double mul[3];
  if (kExact) {
    for (int c = 0; c < 3; ++c) mul[c] = lgbt::fixed_mul(scale_k[c]);
  }
  const int stride = gridDim.x * blockDim.x;
  const int rs = lgbt::row_stride(f, fh);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const uint8_t* row_bins = bins + static_cast<size_t>(i) * rs;
    int node, slot;
    lgbt::route_decide<kPacked>(row_node_in[i], row_bins, fh, s_tbl,
                                s_feat, member, m, w, &node, &slot);
    row_node_out[i] = node;
    if (slot < 0 || slot >= s) continue;
    if constexpr (kExact) {
      const long long q[3] = {
          lgbt::fixed_point(grad[i], mul[0]),
          const_hess ? 0ll : lgbt::fixed_point(hess[i], mul[1]),
          lgbt::fixed_point(cnt[i], mul[2])};
      lgbt::hist_accumulate<kPacked>(hist, slot, row_bins, f, fh, b, q,
                                     const_hess);
    } else {
      lgbt::hist_accumulate<kPacked>(
          hist, slot, row_bins, f, fh, b, static_cast<int>(grad[i]),
          const_hess ? 0 : static_cast<int>(hess[i]), cnt[i], const_hess);
    }
  }
}

// Exact mode's last step: the int64 cell sums [ncell, 3] scaled back into
// f32, f32(float64(sum) x 2^-k) per channel (route_hist.cuh); with
// const_hess the hessian is const_hess x the f32 count.
__global__ void finish_kernel(const long long* __restrict__ cells,
                              const int* __restrict__ scale_k,
                              float* __restrict__ out, long long ncell,
                              float const_hess) {
  double inv[3];
  for (int c = 0; c < 3; ++c) inv[c] = lgbt::fixed_inv(scale_k[c]);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < ncell; t += stride) {
    const long long* c = cells + 3 * t;
    const float count = lgbt::fixed_result(c[2], inv[2]);
    out[3 * t] = lgbt::fixed_result(c[0], inv[0]);
    out[3 * t + 1] = const_hess != 0.0f ? count * const_hess
                                        : lgbt::fixed_result(c[1], inv[1]);
    out[3 * t + 2] = count;
  }
}

template <typename In, typename Acc, bool kPacked>
cudaError_t launch(const void* bins, const void* grad, const void* hess,
                   const void* cnt, const void* row_node_in, const void* tbl,
                   const void* member, const void* feat_tbl,
                   const void* scale_k, void* hist, void* out,
                   void* row_node_out, int n, int f, int fh, int b, int s,
                   int m, int w, float const_hess, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(m) * lgbt::kTblCols + 2 * f) *
                      sizeof(int);
  cudaError_t err =
      lgbt::allow_smem(fused_route_hist_kernel<In, Acc, kPacked>, smem);
  if (err != cudaSuccess) return err;
  if (n > 0) {
    fused_route_hist_kernel<In, Acc, kPacked>
        <<<lgbt::grid_for(n), lgbt::kThreads, smem, stream>>>(
            static_cast<const uint8_t*>(bins), static_cast<const In*>(grad),
            static_cast<const In*>(hess), static_cast<const float*>(cnt),
            static_cast<const int*>(row_node_in),
            static_cast<const int*>(tbl), static_cast<const int*>(member),
            static_cast<const int*>(feat_tbl),
            static_cast<const int*>(scale_k), static_cast<Acc*>(hist),
            static_cast<int*>(row_node_out), n, f, fh, b, s, m, w,
            const_hess != 0.0f);
  }
  const long long ncell = static_cast<long long>(s) * f * b;
  if (sizeof(Acc) == 8 && ncell > 0) {
    const int grid = lgbt::grid_for(
        static_cast<int>(ncell < (1ll << 30) ? ncell : (1ll << 30)));
    finish_kernel<<<grid, lgbt::kThreads, 0, stream>>>(
        static_cast<const long long*>(hist), static_cast<const int*>(scale_k),
        static_cast<float*>(out), ncell, const_hess);
  }
  return cudaGetLastError();
}

}  // namespace

// hist: zeroed [s, f, b, 3] cells. quantized != 0: grad and hess are int8
// and hist is int32 cells for the gradient channels, f32 bits for the
// count channel (route_hist.cuh); else hist is int64 cells of fixed-point
// sums under scale_k [3] i32 (histogram_mxu.exact_scale), scaled back into
// out [s, f, b, 3] f32. const_hess != 0: the hessian channel is skipped
// (exact mode: written as const_hess x count). fh > 0: bins are 4-bit
// packed, fh bytes a row.
extern "C" int lgbt_fused_route_hist(
    const void* bins, const void* grad, const void* hess, const void* cnt,
    const void* row_node_in, const void* tbl, const void* member,
    const void* feat_tbl, const void* scale_k, void* hist, void* out,
    void* row_node_out, int n, int f, int fh, int b, int s, int m, int w,
    float const_hess, int quantized, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define LGBT_FUSED(In, Acc, P)                                              \
  return launch<In, Acc, P>(bins, grad, hess, cnt, row_node_in, tbl, member, \
                            feat_tbl, scale_k, hist, out, row_node_out, n, f, \
                            fh, b, s, m, w, const_hess, st)
  if (quantized) {
    if (fh > 0) LGBT_FUSED(int8_t, int, true);
    LGBT_FUSED(int8_t, int, false);
  }
  if (fh > 0) LGBT_FUSED(float, unsigned long long, true);
  LGBT_FUSED(float, unsigned long long, false);
#undef LGBT_FUSED
}
