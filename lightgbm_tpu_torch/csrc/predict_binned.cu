// predict_binned: each row's leaf in each of K stacked trees, and the f32
// score after each tree (the valid-score trajectory of a block).
//
// Replaces: lightgbm_tpu/learner/predict.py, predict_binned_tree / _traverse
// (:25-73), and lightgbm_tpu/boosting/fused.py, stacked_score_traj
// (:54-79): XLA, no Pallas. The JAX function advances every row one tree
// level per step of a lax.while_loop whose predicate, `any` row still
// internal, is a host round trip per level in eager torch, and a CUDA
// graph cannot hold it. Here each thread walks its own row root to leaf,
// tree after tree: one launch, no host sync.
//
// The decisions are _traverse's: a categorical node sends a row left iff
// its bin's bit is set in the node's bitset (word bin / 32, clamped to the
// last word as the JAX gather clamps; int64 words of 32 bits); a numerical
// node sends the NaN bin (num_bins - 1 of a missing_is_nan feature) the
// node's default_left way, any other bin left iff bin <= threshold_bin;
// a node is internal iff split_feature >= 0 (clamped to F - 1, as the JAX
// function clips it). The score adds each tree's leaf value to the
// running f32 score in tree order from score0 (one IEEE add a tree, the
// JAX package's `score + vals`), so every trajectory point is bit for bit
// what K per-iteration valid updates leave; without score0 the first
// point is the leaf value itself (predict_binned_tree).
//
// Class mode (num_class C > 1; lightgbm_tpu/boosting/fused.py
// stacked_score_traj(num_class=C), :53-79): the score is [N, C] f32 and
// the trees come G a step (G = C for a multiclass block, whose step t
// holds its iteration's C class trees; G = 1 for one tree onto class
// column cls0). Tree g of a step adds its leaf value into column cls0 + g,
// one IEEE add a tree in tree order within a class, and every point of the
// [K, N, C] trajectory holds all C columns: a thread a row copies the
// previous point's C scores (score0 at the first step) into the new point,
// then adds the step's trees into it. The scores live in the trajectory
// itself, so any C works; the row's C floats are contiguous.
//
// Bundled-matrix mode (EFB; the JAX package's _traverse(efb=), which
// decodes through efb.route_bins): the bins are the bundled [N, Fb]
// training matrix, rs bytes a row. A node of feature f reads the byte of
// f's bundle column col_of_feat[f] and decodes it through the [F, Bb] loc
// table to f's original local bin (the default bin out of f's segment);
// the decision is then the plain one. A compile-time mode: the unbundled
// walk is unchanged.
//
// Wide mode (another compile-time mode; max_bin > 256, the JAX package's
// int32 bin values at any width): the bins are uint16, rs words a row,
// unbundled or bundled; the decisions are the same integer compares.
//
// Bound on this card: bytes, and those are few (the rows' bins on their
// paths, the trees, K x N f32 out); the walk is latency-bound, a chain of
// dependent loads a level. Design: a thread a row with a grid-stride
// loop; node fields are read through the read-only cache (a tree is a few
// KB and stays in L1/L2 across the CTA's rows); a row's bins are one or
// two 32-byte sectors, read byte by byte as the path needs them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCtasPerSm = 16;
constexpr int kMaxDevices = 64;

// The original local bin of feature feat in row rb (Bin: uint8 or uint16
// words): its word, or under EFB its bundle column's word decoded through
// the loc table.
template <bool kEfb, typename Bin>
__device__ __forceinline__ int bin_of(const Bin* rb, int feat,
                                      const int* __restrict__ col_of_feat,
                                      const int* __restrict__ loc, int bb) {
  if (!kEfb) return rb[feat];
  return __ldg(loc + static_cast<size_t>(feat) * bb +
               rb[__ldg(col_of_feat + feat)]);
}

// The leaf node id of one row in tree `base` (node arrays offset by base).
template <bool kEfb, typename Bin>
__device__ __forceinline__ int walk(
    const Bin* rb, int f, int base, int m1,
    const int* __restrict__ split_feature,
    const int* __restrict__ threshold_bin,
    const uint8_t* __restrict__ default_left,
    const uint8_t* __restrict__ is_cat,
    const long long* __restrict__ cat_bitset, int words,
    const int* __restrict__ left, const int* __restrict__ right,
    const int* __restrict__ num_bins,
    const uint8_t* __restrict__ missing_is_nan,
    const int* __restrict__ col_of_feat, const int* __restrict__ loc,
    int bb) {
  int node = 0;
  // a path visits at most m1 nodes; the cap only stops a malformed
  // (cyclic) tree
  for (int step = 0; step < m1; ++step) {
    int feat = __ldg(split_feature + base + node);
    if (feat < 0) break;
    if (feat > f - 1) feat = f - 1;
    const int b = bin_of<kEfb, Bin>(rb, feat, col_of_feat, loc, bb);
    bool go_left;
    if (__ldg(is_cat + base + node)) {
      int word = b >> 5;
      if (word > words - 1) word = words - 1;
      const long long bits = __ldg(
          cat_bitset + static_cast<size_t>(base + node) * words + word);
      go_left = ((bits >> (b & 31)) & 1) != 0;
    } else if (__ldg(missing_is_nan + feat) &&
               b == __ldg(num_bins + feat) - 1) {
      go_left = __ldg(default_left + base + node) != 0;
    } else {
      go_left = b <= __ldg(threshold_bin + base + node);
    }
    node = go_left ? __ldg(left + base + node) : __ldg(right + base + node);
  }
  return node;
}

template <bool kScore0, bool kLeaf, bool kEfb, typename Bin>
__global__ void predict_binned_kernel(
    const Bin* __restrict__ bins, int n, int f, int rs,
    const int* __restrict__ split_feature,
    const int* __restrict__ threshold_bin,
    const uint8_t* __restrict__ default_left,
    const uint8_t* __restrict__ is_cat,
    const long long* __restrict__ cat_bitset, int words,
    const int* __restrict__ left, const int* __restrict__ right,
    const float* __restrict__ leaf_value, int k, int m1,
    const int* __restrict__ num_bins,
    const uint8_t* __restrict__ missing_is_nan,
    const float* __restrict__ score0, float* __restrict__ traj,
    int* __restrict__ leaf_out, const int* __restrict__ col_of_feat,
    const int* __restrict__ loc, int bb) {
  const int stride = gridDim.x * blockDim.x;
  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < n;
       row += stride) {
    const Bin* rb = bins + static_cast<size_t>(row) * rs;
    float s = kScore0 ? score0[row] : 0.0f;
    for (int t = 0; t < k; ++t) {
      const int base = t * m1;
      const int node = walk<kEfb, Bin>(rb, f, base, m1, split_feature,
                                  threshold_bin, default_left, is_cat,
                                  cat_bitset, words, left, right, num_bins,
                                  missing_is_nan, col_of_feat, loc, bb);
      const float v = __ldg(leaf_value + base + node);
      s = (kScore0 || t > 0) ? __fadd_rn(s, v) : v;
      const size_t at = static_cast<size_t>(t) * n + row;
      traj[at] = s;
      if (kLeaf) leaf_out[at] = node;
    }
  }
}

// Class mode: k steps of g trees each (k * g stacked trees), score0 and
// traj [N, C] a point.
template <bool kEfb, typename Bin>
__global__ void predict_binned_class_kernel(
    const Bin* __restrict__ bins, int n, int f, int rs,
    const int* __restrict__ split_feature,
    const int* __restrict__ threshold_bin,
    const uint8_t* __restrict__ default_left,
    const uint8_t* __restrict__ is_cat,
    const long long* __restrict__ cat_bitset, int words,
    const int* __restrict__ left, const int* __restrict__ right,
    const float* __restrict__ leaf_value, int k, int m1,
    const int* __restrict__ num_bins,
    const uint8_t* __restrict__ missing_is_nan,
    const float* __restrict__ score0, float* __restrict__ traj,
    int num_class, int group, int cls0, const int* __restrict__ col_of_feat,
    const int* __restrict__ loc, int bb) {
  const int stride = gridDim.x * blockDim.x;
  const size_t point = static_cast<size_t>(n) * num_class;
  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < n;
       row += stride) {
    const Bin* rb = bins + static_cast<size_t>(row) * rs;
    const size_t at = static_cast<size_t>(row) * num_class;
    const float* prev = score0 + at;
    for (int t = 0; t < k; ++t) {
      float* out = traj + t * point + at;
      for (int c = 0; c < num_class; ++c) out[c] = prev[c];
      for (int g = 0; g < group; ++g) {
        const int base = (t * group + g) * m1;
        const int node = walk<kEfb, Bin>(rb, f, base, m1, split_feature,
                                         threshold_bin, default_left, is_cat,
                                         cat_bitset, words, left, right,
                                         num_bins, missing_is_nan,
                                         col_of_feat, loc, bb);
        out[cls0 + g] = __fadd_rn(out[cls0 + g],
                                  __ldg(leaf_value + base + node));
      }
      prev = out;
    }
  }
}

// The kernel's arguments past its template choice.
struct Args {
  const void* bins;
  int n, f, rs;
  const int *sf, *thr;
  const uint8_t *dl, *ic;
  const long long* cb;
  int words;
  const int *l, *r;
  const float* lv;
  int k, m1;
  const int* nb;
  const uint8_t* nan;
  const float* s0;
  float* traj;
  int* leaf;
  const int *col, *loc;
  int bb;
};

template <bool kScore0, bool kLeaf, bool kEfb, typename Bin>
void launch(int blocks, cudaStream_t st, const Args& a) {
  predict_binned_kernel<kScore0, kLeaf, kEfb, Bin>
      <<<blocks, kThreads, 0, st>>>(
      static_cast<const Bin*>(a.bins), a.n, a.f, a.rs, a.sf, a.thr, a.dl,
      a.ic, a.cb, a.words, a.l, a.r, a.lv, a.k, a.m1, a.nb, a.nan, a.s0,
      a.traj, a.leaf, a.col, a.loc, a.bb);
}

template <bool kEfb, typename Bin>
void launch_all(int blocks, cudaStream_t st, const Args& a, int num_class,
                int group, int cls0) {
  if (num_class > 1) {
    predict_binned_class_kernel<kEfb, Bin><<<blocks, kThreads, 0, st>>>(
        static_cast<const Bin*>(a.bins), a.n, a.f, a.rs, a.sf, a.thr, a.dl,
        a.ic, a.cb, a.words, a.l, a.r, a.lv, a.k, a.m1, a.nb, a.nan, a.s0,
        a.traj, num_class, group, cls0, a.col, a.loc, a.bb);
  } else if (a.s0 != nullptr) {
    if (a.leaf != nullptr) launch<true, true, kEfb, Bin>(blocks, st, a);
    else launch<true, false, kEfb, Bin>(blocks, st, a);
  } else {
    if (a.leaf != nullptr) launch<false, true, kEfb, Bin>(blocks, st, a);
    else launch<false, false, kEfb, Bin>(blocks, st, a);
  }
}

}  // namespace

// score0 and leaf_out may be null: no score0 starts the score at the first
// tree's leaf value; no leaf_out writes no leaf ids. num_class > 1 is the
// class mode: k steps of `group` trees into columns cls0.., score0 given,
// no leaf ids. col_of_feat ([f] i32) and loc ([f, bb] i32) given: the
// bundled-matrix mode, rs words a row (else rs = f). wide != 0: the bins
// are uint16 words, else uint8.
extern "C" int lgbt_predict_binned(
    const void* bins, const void* split_feature, const void* threshold_bin,
    const void* default_left, const void* is_cat, const void* cat_bitset,
    const void* left, const void* right, const void* leaf_value,
    const void* num_bins, const void* missing_is_nan, const void* score0,
    void* traj, void* leaf_out, const void* col_of_feat, const void* loc,
    int n, int f, int rs, int bb, int k, int m1, int words, int num_class,
    int group, int cls0, int wide, void* stream) {
  if (n == 0 || k == 0) return cudaSuccess;
  if (num_class > 1 && (score0 == nullptr || leaf_out != nullptr ||
                        group < 1 || cls0 < 0 || cls0 + group > num_class))
    return cudaErrorInvalidValue;
  const bool efb = col_of_feat != nullptr;
  if (efb != (loc != nullptr) || (!efb && rs != f))
    return cudaErrorInvalidValue;
  static int sm_count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > sm_count[dev] * kCtasPerSm) blocks = sm_count[dev] * kCtasPerSm;
  auto st = static_cast<cudaStream_t>(stream);
  const Args a{bins, n, f, rs,
               static_cast<const int*>(split_feature),
               static_cast<const int*>(threshold_bin),
               static_cast<const uint8_t*>(default_left),
               static_cast<const uint8_t*>(is_cat),
               static_cast<const long long*>(cat_bitset), words,
               static_cast<const int*>(left), static_cast<const int*>(right),
               static_cast<const float*>(leaf_value), k, m1,
               static_cast<const int*>(num_bins),
               static_cast<const uint8_t*>(missing_is_nan),
               static_cast<const float*>(score0), static_cast<float*>(traj),
               static_cast<int*>(leaf_out),
               static_cast<const int*>(col_of_feat),
               static_cast<const int*>(loc), bb};
  if (wide) {
    if (efb) launch_all<true, uint16_t>(blocks, st, a, num_class, group, cls0);
    else launch_all<false, uint16_t>(blocks, st, a, num_class, group, cls0);
  } else {
    if (efb) launch_all<true, uint8_t>(blocks, st, a, num_class, group, cls0);
    else launch_all<false, uint8_t>(blocks, st, a, num_class, group, cls0);
  }
  return cudaGetLastError();
}
