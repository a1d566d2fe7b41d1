// route_rows: advance every row one level through the split tables and
// emit (row_node, row_slot) — the routing half of fused_route_hist — and,
// in its counts mode, the number of rows that land in each slot.
//
// Replaces: lightgbm_tpu/learner/histogram_mxu.py, route_rows_mxu
// (pallas_call in _route_kernel, with and without emit_counts). The TPU
// kernel looks node-table rows up with a [rows, nodes] one-hot matmul and
// counts slots with a second one-hot; here a row is one shared-memory
// read and its slot one shared-memory atomic.
//
// Bound on this card: bytes — row_node in, (row_node, row_slot) out, and
// one bin per routed row (12 bytes per row plus the bins it touches).
// Design: one thread per row, node and feature tables in shared memory,
// decision code shared with fused_route_hist (route_hist.cuh), unpacked or
// 4-bit packed bins. Counts mode: a per-block [S] int32 tally of the rows
// whose new slot lies in [0, S) (parked rows excluded), flushed with one
// global atomic per nonzero slot per block — exact integers. Reading a
// row's split-feature bin is a scattered byte load; a column-major copy of
// the bins would coalesce it, which is later work.
#include "route_hist.cuh"

namespace {

template <bool kPacked, bool kCounts>
__global__ void route_rows_kernel(const uint8_t* __restrict__ bins,
                                  const int* __restrict__ row_node_in,
                                  const int* __restrict__ tbl,
                                  const int* __restrict__ member,
                                  const int* __restrict__ feat_tbl,
                                  int* __restrict__ row_node_out,
                                  int* __restrict__ row_slot_out,
                                  int* __restrict__ counts, int n, int f,
                                  int fh, int m, int w, int s) {
  extern __shared__ int smem[];
  int* s_tbl = smem;
  int* s_feat = smem + m * lgbt::kTblCols;
  int* s_cnt = s_feat + 2 * f;
  if (kCounts) {
    for (int i = threadIdx.x; i < s; i += blockDim.x) s_cnt[i] = 0;
  }
  lgbt::load_tables(s_tbl, s_feat, tbl, feat_tbl, m, f);  // syncs
  const int stride = gridDim.x * blockDim.x;
  const int rs = lgbt::row_stride(f, fh);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    int node, slot;
    lgbt::route_decide<kPacked>(row_node_in[i],
                                bins + static_cast<size_t>(i) * rs, fh,
                                s_tbl, s_feat, member, m, w, &node, &slot);
    row_node_out[i] = node;
    row_slot_out[i] = slot;
    if (kCounts && slot >= 0 && slot < s) atomicAdd(s_cnt + slot, 1);
  }
  if (kCounts) {
    __syncthreads();
    for (int i = threadIdx.x; i < s; i += blockDim.x) {
      if (s_cnt[i]) atomicAdd(counts + i, s_cnt[i]);
    }
  }
}

template <bool kPacked, bool kCounts>
cudaError_t launch(const void* bins, const void* row_node_in,
                   const void* tbl, const void* member, const void* feat_tbl,
                   void* row_node_out, void* row_slot_out, void* counts,
                   int n, int f, int fh, int m, int w, int s,
                   cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(m) * lgbt::kTblCols + 2 * f +
                       (kCounts ? s : 0)) * sizeof(int);
  cudaError_t err =
      lgbt::allow_smem(route_rows_kernel<kPacked, kCounts>, smem);
  if (err != cudaSuccess) return err;
  route_rows_kernel<kPacked, kCounts>
      <<<lgbt::grid_for(n), lgbt::kThreads, smem, stream>>>(
          static_cast<const uint8_t*>(bins),
          static_cast<const int*>(row_node_in), static_cast<const int*>(tbl),
          static_cast<const int*>(member), static_cast<const int*>(feat_tbl),
          static_cast<int*>(row_node_out), static_cast<int*>(row_slot_out),
          static_cast<int*>(counts), n, f, fh, m, w, s);
  return cudaGetLastError();
}

}  // namespace

// fh > 0: bins are 4-bit packed, fh bytes a row (route_hist.cuh read_bin).
// counts != NULL: also tally rows per slot into counts[0, s) (zeroed by
// the caller).
extern "C" int lgbt_route_rows(const void* bins, const void* row_node_in,
                               const void* tbl, const void* member,
                               const void* feat_tbl, void* row_node_out,
                               void* row_slot_out, void* counts, int n,
                               int f, int fh, int m, int w, int s,
                               void* stream) {
  if (n == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
#define LGBT_ROUTE(P, C)                                                   \
  return launch<P, C>(bins, row_node_in, tbl, member, feat_tbl,            \
                      row_node_out, row_slot_out, counts, n, f, fh, m, w, s, \
                      st)
  if (fh > 0) {
    if (counts) LGBT_ROUTE(true, true);
    LGBT_ROUTE(true, false);
  }
  if (counts) LGBT_ROUTE(false, true);
  LGBT_ROUTE(false, false);
#undef LGBT_ROUTE
}
