// serve_forest: the serving engine's forest sum (kernel V's forest-sum
// mode) and its packed multi-model mode.
//
// Replaces: lightgbm_tpu/learner/predict.py, predict_binned_forest
// (:104-130), and lightgbm_tpu/serving/multimodel.py,
// _predict_packed_impl / predict_packed_forest (:226-298): XLA, no Pallas.
// The JAX functions loop over the stacked trees (lax.fori_loop), walk every
// row of the batch through tree i (_traverse: a lax.while_loop, one level a
// step) and add the leaf values into column tree_class[i] of an
// [N, num_outputs] f32 score that starts at +0.0.
//
// Forest sum (lgbt_serve_forest). Every tree t of [0, T) adds its leaf
// value into column tree_class[t] of each row, in tree order, one IEEE add
// from +0.0 (the JAX package's acc.at[:, c].add(vals)); a column index out
// of [0, K) adds nothing (the scatter drops it). A pad row (index >= rows,
// or row_valid false) walks nothing and comes out 0.0 in every column,
// which is what the JAX function's row_valid leaves (+0.0 plus 0.0 adds).
// A real row's score is the same f32 sequence whatever the pad, so a
// bucket-padded batch is bit-equal to an unpadded one on its real rows.
//
// Packed (lgbt_serve_packed). The rows are slot blocks: slot s owns rows
// [s * row_block, (s + 1) * row_block). Slot s's trees are the contiguous
// range [tree_off[s], tree_off[s + 1]) of the packed trees (the pack is
// built member after member, so the range is known on the host and no CTA
// scans tree_model), and its rows are walked against slot s's binning
// tables num_bins[s, :] and missing_is_nan[s, :]. Trees past the last
// slot's range (the JAX package's pad trees, i >= t_real) are never read,
// so they add nothing at all, not +0.0. Each member's rows therefore get
// exactly the adds of the member's solo forest sum.
//
// The decisions are _traverse's (lightgbm_tpu/learner/predict.py:25-58):
// a node is internal iff split_feature >= 0, the feature clamped to F - 1;
// a categorical node sends a row left iff its bin's bit is set (word
// bin / 32, clamped to the last word as the JAX gather clamps; int64 words
// of 32 bits); a numerical node sends the NaN bin (num_bins - 1 of a
// missing_is_nan feature) the default_left way, any other bin left iff
// bin <= threshold_bin. Bins are uint8, uint16 or int32 (a template), in
// [0, num_bins).
//
// Design. A CTA takes a tile of R rows (R a power of two, never across a
// slot's block) and its slot's trees in chunks of kThreads / R trees:
//   1. one thread walks one (tree, row) pair of the chunk from root to
//      leaf over the node arrays in global memory (a forest of 100
//      255-leaf trees is 1 MB: it stays in L2 and the hot nodes in L1),
//      and writes the leaf value into a shared [chunk, R] tile;
//   2. a thread a row then adds the chunk's values in tree order into the
//      row's K scores, which it keeps in shared memory;
//   3. after the last chunk the tile's [R, K] scores are written out.
// A tile with no real row writes its zeros and walks nothing. R is chosen
// so that the grid holds about two CTAs an SM (a serving batch of 1024
// rows: R = 4, 256 CTAs, 128 trees a chunk). Bound: bytes (the rows' bins
// once, the forest's nodes once, the [N, K] f32 scores out); the walk is
// latency-bound, a chain of dependent loads a level.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxR = 32;
constexpr int kMaxDevices = 64;
// the static shared-memory limit of a CTA without an opt-in
constexpr size_t kSmemBytes = 48 * 1024;

struct Args {
  const void* bins;
  int n, f;               // bins [n, f]
  int rows;               // rows from `rows` on are pad
  const uint8_t* valid;   // [n] bool or null
  const int *sf, *thr;
  const uint8_t *dl, *ic;
  const long long* cb;
  int words;
  const int *l, *r;
  const float* lv;
  int m1;
  const int* tree_class;  // [T]
  const int* tree_off;    // [slots + 1], or null: trees [0, num_trees)
  int num_trees;
  const int* nb;          // [slots, f]
  const uint8_t* nan;     // [slots, f]
  int row_block;          // rows a slot (the forest sum: n)
  int k;
  float* out;             // [n, k]
  int tile;               // R
  int log_tile;
};

template <typename Bin>
__device__ __forceinline__ float walk(const Args& a, const Bin* rb,
                                      size_t base, const int* nb,
                                      const uint8_t* nan) {
  int node = 0;
  // a path visits at most m1 nodes; the cap only stops a malformed
  // (cyclic) tree
  for (int step = 0; step < a.m1; ++step) {
    int feat = __ldg(a.sf + base + node);
    if (feat < 0) break;
    if (feat > a.f - 1) feat = a.f - 1;
    const int b = static_cast<int>(rb[feat]);
    bool go_left;
    if (__ldg(a.ic + base + node)) {
      int word = b >> 5;
      if (word > a.words - 1) word = a.words - 1;
      const long long bits = __ldg(a.cb + (base + node) * a.words + word);
      go_left = ((bits >> (b & 31)) & 1) != 0;
    } else if (__ldg(nan + feat) && b == __ldg(nb + feat) - 1) {
      go_left = __ldg(a.dl + base + node) != 0;
    } else {
      go_left = b <= __ldg(a.thr + base + node);
    }
    node = go_left ? __ldg(a.l + base + node) : __ldg(a.r + base + node);
  }
  return __ldg(a.lv + base + node);
}

template <typename Bin>
__global__ void __launch_bounds__(kThreads) serve_forest_kernel(const Args a) {
  extern __shared__ float smem[];
  const int R = a.tile;
  const int t = threadIdx.x;
  float* acc = smem;                 // [R, k] the tile's scores
  float* vals = smem + R * a.k;      // [kThreads / R, R] a chunk's values
  const int r0 = blockIdx.x * R;
  const int slot = r0 / a.row_block;
  const int lo = a.tree_off ? __ldg(a.tree_off + slot) : 0;
  const int hi = a.tree_off ? __ldg(a.tree_off + slot + 1) : a.num_trees;
  const int* nb = a.nb + static_cast<size_t>(slot) * a.f;
  const uint8_t* nan = a.nan + static_cast<size_t>(slot) * a.f;
  const Bin* bins = static_cast<const Bin*>(a.bins);

  const int rr = t & (R - 1);        // this thread's row of the tile
  const int row = r0 + rr;
  const bool real = row < a.n && row < a.rows &&
                    (a.valid == nullptr || a.valid[row] != 0);
  for (int i = t; i < R * a.k; i += kThreads) acc[i] = 0.0f;
  // a tile without a real row (a pad slot, the pad tail) walks nothing
  const bool any = __syncthreads_or(t < R && real);
  if (any) {
    const int chunk = kThreads >> a.log_tile;
    const int tt = t >> a.log_tile;
    const Bin* rb = bins + static_cast<size_t>(row) * a.f;
    for (int t0 = lo; t0 < hi; t0 += chunk) {
      const int nt = min(chunk, hi - t0);
      if (tt < nt && real)
        vals[tt * R + rr] =
            walk<Bin>(a, rb, static_cast<size_t>(t0 + tt) * a.m1, nb, nan);
      __syncthreads();
      // a thread a row adds the chunk's leaf values in tree order
      if (t < R && real) {
        float* s = acc + rr * a.k;
        for (int j = 0; j < nt; ++j) {
          const int c = __ldg(a.tree_class + t0 + j);
          if (c >= 0 && c < a.k) s[c] = __fadd_rn(s[c], vals[j * R + rr]);
        }
      }
      __syncthreads();
    }
  }
  // pad rows keep their 0.0 (acc is only added to for real rows)
  for (int i = t; i < R * a.k; i += kThreads) {
    const int q = i / a.k;
    if (r0 + q < a.n)
      a.out[static_cast<size_t>(r0 + q) * a.k + (i - q * a.k)] = acc[i];
  }
}

// Rows a tile: the smallest power of two (at most kMaxR and row_block)
// that leaves at most about two tiles an SM, cut while the [R, k] scores
// do not fit shared memory; 0 if one row's do not.
int tile_rows(int n, int row_block, int k, int sms) {
  int r = 1;
  while (r < kMaxR && r < row_block && (n + r - 1) / r > 2 * sms) r <<= 1;
  while (r > 1 && (static_cast<size_t>(r) * k + kThreads) * 4 > kSmemBytes)
    r >>= 1;
  return (static_cast<size_t>(r) * k + kThreads) * 4 <= kSmemBytes ? r : 0;
}

cudaError_t launch(Args a, int bin_bytes, cudaStream_t st) {
  static int sm_count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    int c = 0;
    err = cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sm_count[dev] = c;
  }
  const int R = tile_rows(a.n, a.row_block, a.k, sm_count[dev]);
  if (R == 0) return cudaErrorInvalidValue;
  a.tile = R;
  a.log_tile = 0;
  while ((1 << a.log_tile) < R) ++a.log_tile;
  const int blocks = (a.n + R - 1) / R;
  const size_t smem = (static_cast<size_t>(R) * a.k + kThreads) * 4;
  if (bin_bytes == 1)
    serve_forest_kernel<uint8_t><<<blocks, kThreads, smem, st>>>(a);
  else if (bin_bytes == 2)
    serve_forest_kernel<uint16_t><<<blocks, kThreads, smem, st>>>(a);
  else
    serve_forest_kernel<int32_t><<<blocks, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The forest sum: bins [n, f] (bin_bytes 1, 2 or 4: uint8, uint16, int32),
// the [T, m1] stacked tree arrays (cat_bitset [T, m1, words] int64),
// tree_class [T], num_bins / missing_is_nan [f], out [n, k] f32. Rows from
// `rows` on, and rows whose row_valid byte is 0 (row_valid may be null),
// are pad rows.
extern "C" int lgbt_serve_forest(
    const void* bins, const void* split_feature, const void* threshold_bin,
    const void* default_left, const void* is_cat, const void* cat_bitset,
    const void* left, const void* right, const void* leaf_value,
    const void* tree_class, const void* num_bins, const void* missing_is_nan,
    const void* row_valid, void* out, int n, int f, int rows, int num_trees,
    int m1, int words, int k, int bin_bytes, void* stream) {
  if (n == 0) return cudaSuccess;
  if (f < 1 || k < 1 || m1 < 1 || words < 1 || num_trees < 0 ||
      (bin_bytes != 1 && bin_bytes != 2 && bin_bytes != 4))
    return cudaErrorInvalidValue;
  const Args a{bins, n, f, rows, static_cast<const uint8_t*>(row_valid),
               static_cast<const int*>(split_feature),
               static_cast<const int*>(threshold_bin),
               static_cast<const uint8_t*>(default_left),
               static_cast<const uint8_t*>(is_cat),
               static_cast<const long long*>(cat_bitset), words,
               static_cast<const int*>(left), static_cast<const int*>(right),
               static_cast<const float*>(leaf_value), m1,
               static_cast<const int*>(tree_class), nullptr, num_trees,
               static_cast<const int*>(num_bins),
               static_cast<const uint8_t*>(missing_is_nan), n, k,
               static_cast<float*>(out), 0, 0};
  return launch(a, bin_bytes, static_cast<cudaStream_t>(stream));
}

// The packed sum: bins [slots * row_block, f], the packed [Tp, m1] trees,
// tree_class [Tp], tree_off [slots + 1] (slot s's trees: [tree_off[s],
// tree_off[s + 1]), non-decreasing, at most Tp), num_bins / missing_is_nan
// [slots, f], row_valid [slots * row_block] (or null), out
// [slots * row_block, k] f32. row_block is a power of two.
extern "C" int lgbt_serve_packed(
    const void* bins, const void* split_feature, const void* threshold_bin,
    const void* default_left, const void* is_cat, const void* cat_bitset,
    const void* left, const void* right, const void* leaf_value,
    const void* tree_class, const void* tree_off, const void* num_bins,
    const void* missing_is_nan, const void* row_valid, void* out, int slots,
    int row_block, int f, int m1, int words, int k, int bin_bytes,
    void* stream) {
  if (slots == 0 || row_block == 0) return cudaSuccess;
  if (f < 1 || k < 1 || m1 < 1 || words < 1 || slots < 0 ||
      row_block < 0 || (row_block & (row_block - 1)) != 0 ||
      (bin_bytes != 1 && bin_bytes != 2 && bin_bytes != 4))
    return cudaErrorInvalidValue;
  const int n = slots * row_block;
  const Args a{bins, n, f, n, static_cast<const uint8_t*>(row_valid),
               static_cast<const int*>(split_feature),
               static_cast<const int*>(threshold_bin),
               static_cast<const uint8_t*>(default_left),
               static_cast<const uint8_t*>(is_cat),
               static_cast<const long long*>(cat_bitset), words,
               static_cast<const int*>(left), static_cast<const int*>(right),
               static_cast<const float*>(leaf_value), m1,
               static_cast<const int*>(tree_class),
               static_cast<const int*>(tree_off), 0,
               static_cast<const int*>(num_bins),
               static_cast<const uint8_t*>(missing_is_nan), row_block, k,
               static_cast<float*>(out), 0, 0};
  return launch(a, bin_bytes, static_cast<cudaStream_t>(stream));
}
