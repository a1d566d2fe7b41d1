// Shared device code of the routing and histogram kernels
// (fused_route_hist.cu, route_rows.cu, build_histograms.cu,
// build_histograms_scatter.cu).
//
// Node table layout (pack_route_tables in learner/histogram_mxu.py): one
// row of kTblCols int32 per node id. The TPU kernels carried these values
// as base-256 digits so every entry stayed exact in bf16 on the MXU; here
// they are plain int32 columns, looked up by indexing.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lgbt {

constexpr int kTblCols = 8;
constexpr int kTblFlags = 0;   // bit 0 split this pass, bit 1 NaN goes left,
                               // bit 2 categorical decision
constexpr int kTblFeat = 1;    // split feature (used-feature index)
constexpr int kTblThr = 2;     // threshold bin: left iff bin <= thr
constexpr int kTblLeft = 3;    // left child id
constexpr int kTblRight = 4;   // right child id
constexpr int kTblSlot = 5;    // next-pass histogram slot of the node (-1)
constexpr int kTblSlotL = 6;   // next-pass slot of the left child (-1)
constexpr int kTblSlotR = 7;   // next-pass slot of the right child (-1)

constexpr int kFlagSplit = 1;
constexpr int kFlagDefaultLeft = 2;
constexpr int kFlagCat = 4;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;

// Bin of feature j in one row of the bin matrix. Unpacked: one byte per
// feature. Packed (pack_bins_4bit in learner/histogram_mxu.py, the
// reference's 4-bit DenseBin): fh = ceil(F/2) bytes a row in the
// split-nibble layout — feature j < fh is the low nibble of byte j,
// feature fh + j the high nibble of byte j.
template <bool kPacked>
__device__ __forceinline__ int read_bin(const uint8_t* row_bins, int j,
                                        int fh) {
  if (kPacked) {
    return j < fh ? (row_bins[j] & 15) : (row_bins[j - fh] >> 4);
  }
  return row_bins[j];
}

// Bytes per row of the bin matrix: fh when packed, else f.
__host__ __device__ __forceinline__ int row_stride(int f, int fh) {
  return fh > 0 ? fh : f;
}

// Copy the node table [m, kTblCols] and the feature table [f, 2]
// (num_bins, missing_is_nan) into shared memory; every thread of the block
// then routes rows from there.
__device__ __forceinline__ void load_tables(int* s_tbl, int* s_feat,
                                            const int* tbl,
                                            const int* feat_tbl, int m,
                                            int f) {
  for (int i = threadIdx.x; i < m * kTblCols; i += blockDim.x) {
    s_tbl[i] = tbl[i];
  }
  for (int i = threadIdx.x; i < 2 * f; i += blockDim.x) {
    s_feat[i] = feat_tbl[i];
  }
  __syncthreads();
}

// Advance one row through the splits of this pass: numerical threshold,
// NaN bin -> default direction, categorical left-set bitset (member:
// [m, w] words in global memory, read only for categorical nodes). Rows of
// nodes that did not split keep their node and their own slot.
template <bool kPacked>
__device__ __forceinline__ void route_decide(int node,
                                             const uint8_t* row_bins,
                                             int fh, const int* s_tbl,
                                             const int* s_feat,
                                             const int* member, int m, int w,
                                             int* new_node, int* new_slot) {
  if (node < 0 || node >= m) {
    *new_node = node;
    *new_slot = -1;
    return;
  }
  const int* row = s_tbl + node * kTblCols;
  const int flags = row[kTblFlags];
  if (!(flags & kFlagSplit)) {
    *new_node = node;
    *new_slot = row[kTblSlot];
    return;
  }
  const int feat = row[kTblFeat];
  const int binv = read_bin<kPacked>(row_bins, feat, fh);
  bool left;
  if (flags & kFlagCat) {
    const unsigned word =
        static_cast<unsigned>(__ldg(member + node * w + (binv >> 5)));
    left = (word >> (binv & 31)) & 1u;
  } else {
    const bool is_nan_bin =
        s_feat[2 * feat + 1] != 0 && binv == s_feat[2 * feat] - 1;
    left = is_nan_bin ? (flags & kFlagDefaultLeft) != 0
                      : binv <= row[kTblThr];
  }
  *new_node = left ? row[kTblLeft] : row[kTblRight];
  *new_slot = left ? row[kTblSlotL] : row[kTblSlotR];
}

// Add one row's (grad, hess, count) into hist[slot, j, bin, :] for every
// feature j. hist is [S, f, b, 3]. const_hess != 0 skips the hessian
// channel; the wrapper fills it as const x count afterwards.
//
// f32 mode: f32 values into three float64 cells, float64 atomics, rounded
// to f32 once by the wrapper (the reference's double hist_t). A cell takes
// one add per row of its bin, ~70k at 1M rows and 15 bins; f32 cells
// would round every add to the running sum's ulp, and sibling subtraction
// turns that error into leaf values off by orders of magnitude. The atomics'
// order still varies from run to run, now in float64's last bits.
template <bool kPacked>
__device__ __forceinline__ void hist_accumulate(double* hist, int slot,
                                                const uint8_t* row_bins,
                                                int f, int fh, int b,
                                                double g, double h, float c,
                                                int const_hess) {
  double* base = hist + static_cast<size_t>(slot) * f * b * 3;
  for (int j = 0; j < f; ++j) {
    const int bin = read_bin<kPacked>(row_bins, j, fh);
    if (bin >= b) continue;
    double* cell = base + (static_cast<size_t>(j) * b + bin) * 3;
    atomicAdd(cell, g);
    if (!const_hess) atomicAdd(cell + 1, h);
    atomicAdd(cell + 2, static_cast<double>(c));
  }
}

// Integer mode (quantized gradients): g and h are whole numbers in
// [-127, 127] and add into int32 cells, exact and independent of order
// (|sum| <= 127 x N < 2^31 for N < 16.9M rows). The count channel keeps
// float atomics, in the same 32-bit word of the cell; with whole-number
// count weights its sums are exact and order-free as well (below 2^24).
template <bool kPacked>
__device__ __forceinline__ void hist_accumulate(int* hist, int slot,
                                                const uint8_t* row_bins,
                                                int f, int fh, int b, int g,
                                                int h, float c,
                                                int const_hess) {
  int* base = hist + static_cast<size_t>(slot) * f * b * 3;
  for (int j = 0; j < f; ++j) {
    const int bin = read_bin<kPacked>(row_bins, j, fh);
    if (bin >= b) continue;
    int* cell = base + (static_cast<size_t>(j) * b + bin) * 3;
    atomicAdd(cell, g);
    if (!const_hess) atomicAdd(cell + 1, h);
    atomicAdd(reinterpret_cast<float*>(cell + 2), c);
  }
}

inline int grid_for(int n) {
  const int blocks = (n + kThreads - 1) / kThreads;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace lgbt
