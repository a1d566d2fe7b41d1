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

// EFB tables (exclusive feature bundling, learner/histogram_mxu.py
// TBL_COLS_EFB): 16 columns a row, the 8 above then the split feature's
// bundle column and, for the range mode, its segment, the threshold's last
// left position, the default bin's side and the NaN bin's position
constexpr int kTblColsEfb = 16;
constexpr int kTblBcol = 8;    // bundle column of the split feature
constexpr int kTblSegLo = 9;   // first position of the feature's segment
constexpr int kTblSegHi = 10;  // last position of the segment
constexpr int kTblPt = 11;     // last position that goes left
constexpr int kTblDbLeft = 12; // rows out of the segment go left (0/1)
constexpr int kTblPNan = 13;   // position of the NaN bin (-1: none)

// Routing modes: plain bins, EFB bundle columns decoded through the
// [F, Bb] loc table, or EFB bundle-range compares
constexpr int kRoutePlain = 0;
constexpr int kRouteLoc = 1;
constexpr int kRouteRange = 2;

constexpr int kFlagSplit = 1;
constexpr int kFlagDefaultLeft = 2;
constexpr int kFlagCat = 4;

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

// Rows a routing CTA takes, and the rows of a partition chunk: route_rows'
// tallies of rows per slot and chunk (route_rows.cu) are the partition's
// input (partition_rows.cu), so both cut the rows alike
// (histogram_mxu.CHUNK_ROWS keeps the same constant)
constexpr int kChunkRows = 2048;

// Advance one row through the splits of this pass: numerical threshold,
// NaN bin -> default direction, categorical left-set bitset (member:
// [m, w] words, read only for categorical nodes). Rows of nodes that did
// not split keep their node and their own slot; ids outside [0, m) keep
// their node and get slot -1. The node's table row is read whole, 32
// bytes, through the read-only cache: a = (flags, feature, threshold,
// left), b = (right, slot, left slot, right slot); binv is the row's bin
// of feature a.y, read by the caller where the node splits.
__device__ __forceinline__ void route_decide(int node, const int4& a,
                                             const int4& b, int binv,
                                             const int* __restrict__ feat_tbl,
                                             const int* __restrict__ member,
                                             int w, int* new_node,
                                             int* new_slot) {
  const int flags = a.x;
  if (!(flags & kFlagSplit)) {
    *new_node = node;
    *new_slot = b.y;
    return;
  }
  bool left;
  if (flags & kFlagCat) {
    const unsigned word = static_cast<unsigned>(
        __ldg(member + static_cast<size_t>(node) * w + (binv >> 5)));
    left = (word >> (binv & 31)) & 1u;
  } else {
    const int feat = a.y;
    const bool is_nan_bin = __ldg(feat_tbl + 2 * feat + 1) != 0 &&
                            binv == __ldg(feat_tbl + 2 * feat) - 1;
    left = is_nan_bin ? (flags & kFlagDefaultLeft) != 0 : binv <= a.z;
  }
  *new_node = left ? a.w : b.x;
  *new_slot = left ? b.z : b.w;
}

// The EFB range decision (the JAX package's _route_decide, efb_range):
// pos is the row's position in the split feature's bundle column, c =
// (bundle column, seg_lo, seg_hi, threshold position), d = (default side,
// NaN position, -, -). Categorical features sit alone in their column, so
// the position is their bin.
__device__ __forceinline__ void route_decide_range(
    int node, const int4& a, const int4& b, const int4& c, const int4& d,
    int pos, const int* __restrict__ member, int w, int* new_node,
    int* new_slot) {
  const int flags = a.x;
  if (!(flags & kFlagSplit)) {
    *new_node = node;
    *new_slot = b.y;
    return;
  }
  bool left;
  if (flags & kFlagCat) {
    const unsigned word = static_cast<unsigned>(
        __ldg(member + static_cast<size_t>(node) * w + (pos >> 5)));
    left = (word >> (pos & 31)) & 1u;
  } else if (pos >= c.y && pos <= c.z) {
    left = pos == d.y ? (flags & kFlagDefaultLeft) != 0 : pos <= c.w;
  } else {
    left = d.x != 0;
  }
  *new_node = left ? a.w : b.x;
  *new_slot = left ? b.z : b.w;
}

// The node table row of `node` as (a, b) (route_decide); an id outside
// [0, m) reads an unsplit row of slot -1.
__device__ __forceinline__ void table_row(const int* __restrict__ tbl,
                                          int node, int m, int4* a,
                                          int4* b) {
  if (node >= 0 && node < m) {
    const int4* row = reinterpret_cast<const int4*>(tbl) + 2 * node;
    *a = __ldg(row);
    *b = __ldg(row + 1);
  } else {
    *a = make_int4(0, 0, 0, 0);
    *b = make_int4(0, -1, -1, -1);
  }
}

// The EFB table row of `node` (kTblColsEfb columns) as (a, b) and its EFB
// columns (c, d); an id outside [0, m) reads an unsplit row of slot -1.
// Loc mode reads c only.
template <bool kRange>
__device__ __forceinline__ void table_row_efb(const int* __restrict__ tbl,
                                              int node, int m, int4* a,
                                              int4* b, int4* c, int4* d) {
  if (node >= 0 && node < m) {
    const int4* row = reinterpret_cast<const int4*>(tbl) + 4 * node;
    *a = __ldg(row);
    *b = __ldg(row + 1);
    *c = __ldg(row + 2);
    if (kRange) *d = __ldg(row + 3);
  } else {
    *a = make_int4(0, 0, 0, 0);
    *b = make_int4(0, -1, -1, -1);
    *c = make_int4(0, 0, 0, 0);
    *d = make_int4(0, -1, 0, 0);
  }
}

// The lanes of the warp whose key equals this lane's, for keys in
// [-1, 2^bits - 1): one ballot per bit of key + 1, a fixed cost, where
// __match_any_sync's grows with the number of distinct keys in the warp.
// Every lane of the warp takes part.
__device__ __forceinline__ unsigned peers_of(int key, int bits) {
  const unsigned v = static_cast<unsigned>(key + 1);
  unsigned peers = 0xffffffffu;
  for (int b = 0; b < bits; ++b) {
    const bool on = (v >> b) & 1u;
    const unsigned set = __ballot_sync(0xffffffffu, on);
    peers &= on ? set : ~set;
  }
  return peers;
}

// Bits of the keys [-1, s] that peers_of takes: those of s + 1.
__device__ __forceinline__ int key_bits(int s) { return 32 - __clz(s + 1); }

// Count each lane's key (in [-1, 2^bits - 1)) into counter[key] (key < 0:
// none) with the native 32-bit shared atomic. Keys of 6 bits and more
// seldom meet in a warp, so each lane adds its own; fewer keys would queue
// on one address, so the lanes of one key go together, the lowest of them
// adding their number. Every lane of the warp takes part.
__device__ __forceinline__ void tally_key(int* counter, int key, int bits) {
  if (bits >= 6) {
    if (key >= 0) atomicAdd(counter + key, 1);
    return;
  }
  const unsigned peers = peers_of(key, bits);
  if (key >= 0 && (__ffs(peers) - 1) == static_cast<int>(threadIdx.x & 31)) {
    atomicAdd(counter + key, __popc(peers));
  }
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

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace lgbt
