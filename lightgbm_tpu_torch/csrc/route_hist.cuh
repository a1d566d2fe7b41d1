// Shared device code of the routing and histogram kernels (route_rows.cu,
// build_histograms_scatter.cu) and of node_sums.cu's fixed point.
//
// Node table layout (pack_route_tables in learner/histogram_mxu.py): one
// row of kTblCols int32 per node id. The TPU kernels carried these values
// as base-256 digits so every entry stayed exact in bf16 on the MXU; here
// they are plain int32 columns, looked up by indexing.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
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

// Exact (f32) mode sums fixed-point integers (histogram_mxu.exact_scale):
// channel c of a row adds q = rint(v x 2^k[c]) as an int64, and a cell's
// sum s comes out as f32(float64(s) x 2^-k[c]). The wrapper picks k[c] from
// the channel's max |v| over all n rows so that |q| <= 2^38 and |sum| <=
// 2^62; a channel with a non-finite value has k = kNonFinite and comes out
// NaN in every cell. Integer sums are exact, so every kernel and every
// order of the additions gives the same bits.
constexpr int kNonFinite = -32768;

// 2^k, the factor a channel's values are scaled by (0 for a non-finite
// channel, whose cells are NaN whatever they hold)
__device__ __forceinline__ double fixed_mul(int k) {
  return k == kNonFinite ? 0.0 : ldexp(1.0, k);
}

// 2^-k, the factor a cell's sum is scaled back by (NaN: non-finite channel)
__device__ __forceinline__ double fixed_inv(int k) {
  return k == kNonFinite ? __longlong_as_double(0x7ff8000000000000ll)
                         : ldexp(1.0, -k);
}

// rint(v x 2^k): the product is exact in float64, rounded once, half to even
__device__ __forceinline__ long long fixed_point(float v, double mul) {
  return __double2ll_rn(static_cast<double>(v) * mul);
}

__device__ __forceinline__ float fixed_result(long long sum, double inv) {
  return static_cast<float>(static_cast<double>(sum) * inv);
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
