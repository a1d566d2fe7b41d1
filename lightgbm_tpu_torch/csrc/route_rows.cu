// route_rows: advance every row one level through the split tables and
// emit (row_node, row_slot) — the routing half of fused_route_hist.
//
// Replaces: lightgbm_tpu/learner/histogram_mxu.py, route_rows_mxu
// (pallas_call in _route_kernel; the emit_counts mode is not ported). The
// TPU kernel looks node-table rows up with a [rows, nodes] one-hot matmul;
// here a row is one shared-memory read.
//
// Bound on this card: bytes — row_node in, (row_node, row_slot) out, and
// one bin per routed row (12 bytes per row plus the bins it touches).
// Design: one thread per row, node and feature tables in shared memory,
// decision code shared with fused_route_hist (route_hist.cuh). Reading a
// row's split-feature bin is a scattered byte load; a column-major copy of
// the bins would coalesce it, which is later work.
#include "route_hist.cuh"

namespace {

__global__ void route_rows_kernel(const uint8_t* __restrict__ bins,
                                  const int* __restrict__ row_node_in,
                                  const int* __restrict__ tbl,
                                  const int* __restrict__ member,
                                  const int* __restrict__ feat_tbl,
                                  int* __restrict__ row_node_out,
                                  int* __restrict__ row_slot_out, int n,
                                  int f, int m, int w) {
  extern __shared__ int smem[];
  int* s_tbl = smem;
  int* s_feat = smem + m * lgbt::kTblCols;
  lgbt::load_tables(s_tbl, s_feat, tbl, feat_tbl, m, f);
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    int node, slot;
    lgbt::route_decide(row_node_in[i], bins + static_cast<size_t>(i) * f,
                       s_tbl, s_feat, member, m, w, &node, &slot);
    row_node_out[i] = node;
    row_slot_out[i] = slot;
  }
}

}  // namespace

extern "C" int lgbt_route_rows(const void* bins, const void* row_node_in,
                               const void* tbl, const void* member,
                               const void* feat_tbl, void* row_node_out,
                               void* row_slot_out, int n, int f, int m,
                               int w, void* stream) {
  if (n == 0) return cudaSuccess;
  const size_t smem = (static_cast<size_t>(m) * lgbt::kTblCols + 2 * f) *
                      sizeof(int);
  cudaError_t err = lgbt::allow_smem(route_rows_kernel, smem);
  if (err != cudaSuccess) return err;
  route_rows_kernel<<<lgbt::grid_for(n), lgbt::kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bins),
      static_cast<const int*>(row_node_in), static_cast<const int*>(tbl),
      static_cast<const int*>(member), static_cast<const int*>(feat_tbl),
      static_cast<int*>(row_node_out), static_cast<int*>(row_slot_out), n, f,
      m, w);
  return cudaGetLastError();
}
