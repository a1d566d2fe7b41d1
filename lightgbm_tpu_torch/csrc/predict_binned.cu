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
// Design. A level of a walk is a chain of dependent loads, so the kernel
// makes each level one shared-memory record load and keeps R x K walks in
// flight at once. A CTA of 1024 threads takes a tile of R rows at a time
// and a chunk of trees (whole steps in class mode):
//   1. the chunk's nodes are packed, once per CTA, into 16-byte records
//      in shared memory: the feature (clamped as the walk clamps it) with
//      the flags is_cat and default_left, the threshold bin, the node's
//      NaN bin (num_bins - 1 of a missing_is_nan feature, else -1) and
//      left/right as 16-bit ids; a leaf's record holds -1 and its leaf
//      value. A level of the walk is one 16-byte shared load, the row's
//      bin and the compare. Categorical bitsets stay in global memory;
//   2. the tile's bins are copied into shared memory with 16-byte loads
//      (the rows are contiguous);
//   3. one thread walks one (row, tree) pair, for all R x chunk pairs, and
//      writes the leaf value (and node id) into a shared [chunk, R] tile
//      (two pairs interleaved level by level in one thread measured
//      slower on an H100: 0.015 against 0.013 device ms at the valid row);
//   4. a thread a row then adds the chunk's values in tree order onto the
//      previous point (score0, or the trajectory point before the chunk),
//      one IEEE add a tree, and writes the points: every trajectory point
//      is bit for bit the plain version's.
// A tile of rows too wide for shared memory beside one step's records
// takes fewer rows; a step whose trees do not fit at all (about 12,000
// nodes, or m1 > 32768, or more than 8192 features) walks the node arrays
// and the rows' bins in global memory instead (kSmem false), pairs and
// adds as above. Bound: bytes (the rows' bins once, the trees once, K x N f32
// out); the walk is latency-bound, so the design puts the R x K walks of
// a tile in flight together, 32 warps a CTA.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxDevices = 64;
// shared memory a CTA may take (dynamic), set once a device
constexpr int kSmemBytes = 200 * 1024;

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

__device__ __forceinline__ bool cat_left(const long long* __restrict__ cb,
                                         size_t node, int words, int b) {
  int word = b >> 5;
  if (word > words - 1) word = words - 1;
  const long long bits = __ldg(cb + node * words + word);
  return ((bits >> (b & 31)) & 1) != 0;
}

// The kernel's arguments.
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
  int num_class, group, cls0;
  int rows;    // R: rows a tile
  int chunk;   // steps a chunk
};

// Node i (a global index into the stacked node arrays) as a record: its
// fields are loaded together, before any is used, so a thread's loads of
// several nodes are in flight at once; nan_tab is the features' NaN bins
// (-1: none).
__device__ __forceinline__ int4 pack_node(const Args& a, size_t i,
                                          const int* nan_tab) {
  int feat = __ldg(a.sf + i);
  const int thr = __ldg(a.thr + i);
  const int l = __ldg(a.l + i), r = __ldg(a.r + i);
  const float lv = __ldg(a.lv + i);
  const bool ic = __ldg(a.ic + i) != 0, dl = __ldg(a.dl + i) != 0;
  if (feat < 0) return make_int4(-1, __float_as_int(lv), -1, 0);
  if (feat > a.f - 1) feat = a.f - 1;
  const int flags = (ic ? 1 << 29 : 0) | (dl ? 1 << 30 : 0);
  const int ch = static_cast<int>((static_cast<unsigned>(l) & 0xffffu) |
                                  (static_cast<unsigned>(r) << 16));
  return make_int4(feat | flags, thr, nan_tab[feat], ch);
}

// The leaf one row reaches in a tree from its records (shared memory,
// tree-local ids): (node id, leaf value).
template <bool kEfb, typename Bin>
__device__ __forceinline__ int walk_rec(const int4* rec, const Bin* rb,
                                        const Args& a, size_t base,
                                        float* value) {
  int node = 0;
  // a path visits at most m1 nodes; the cap only stops a malformed
  // (cyclic) tree
  for (int step = 0; step < a.m1; ++step) {
    const int4 v = rec[node];
    if (v.x < 0) {
      *value = __int_as_float(v.y);
      return node;
    }
    const int feat = v.x & ((1 << 29) - 1);
    const int b = bin_of<kEfb, Bin>(rb, feat, a.col, a.loc, a.bb);
    bool go_left;
    if (v.x & (1 << 29)) {
      go_left = cat_left(a.cb, base + node, a.words, b);
    } else if (b == v.z) {
      go_left = (v.x & (1 << 30)) != 0;
    } else {
      go_left = b <= v.y;
    }
    node = go_left ? static_cast<short>(v.w & 0xffff) : (v.w >> 16);
  }
  *value = __ldg(a.lv + base + node);
  return node;
}

// The same walk over the node arrays in global memory (a step too large
// for shared memory).
template <bool kEfb, typename Bin>
__device__ __forceinline__ int walk_soa(const Bin* rb, const Args& a,
                                        size_t base, float* value) {
  int node = 0;
  for (int step = 0; step < a.m1; ++step) {
    int feat = __ldg(a.sf + base + node);
    if (feat < 0) break;
    if (feat > a.f - 1) feat = a.f - 1;
    const int b = bin_of<kEfb, Bin>(rb, feat, a.col, a.loc, a.bb);
    bool go_left;
    if (__ldg(a.ic + base + node)) {
      go_left = cat_left(a.cb, base + node, a.words, b);
    } else if (__ldg(a.nan + feat) && b == __ldg(a.nb + feat) - 1) {
      go_left = __ldg(a.dl + base + node) != 0;
    } else {
      go_left = b <= __ldg(a.thr + base + node);
    }
    node = go_left ? __ldg(a.l + base + node) : __ldg(a.r + base + node);
  }
  *value = __ldg(a.lv + base + node);
  return node;
}

// Copy nbytes from global to shared memory, 16 bytes a thread where both
// ends allow it.
__device__ __forceinline__ void stage_bytes(uint8_t* dst, const uint8_t* src,
                                            int nbytes) {
  const int t = threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = nbytes >> 4;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int i = t; i < nv; i += kThreads) d4[i] = __ldg(s4 + i);
    for (int i = (nv << 4) + t; i < nbytes; i += kThreads) dst[i] = src[i];
  } else {
    for (int i = t; i < nbytes; i += kThreads) dst[i] = src[i];
  }
}

// kSmem: the chunk's records in shared memory, else the global walk.
// kScore0/kLeaf: plain mode with a score0 / with leaf ids; kClass: class
// mode (k steps of `group` trees, score0 and traj [N, C] a point).
template <bool kSmem, bool kScore0, bool kLeaf, bool kClass, bool kEfb,
          typename Bin>
__global__ void __launch_bounds__(kThreads)
    predict_binned_kernel(const Args a) {
  extern __shared__ int4 smem4[];
  const int t = threadIdx.x;
  const int g = kClass ? a.group : 1;
  const int R = a.rows;
  const int ctrees = a.chunk * g;   // trees a chunk
  // [ctrees * m1] records | [ctrees, R] values | [ctrees, R] nodes | bins
  // | the features' NaN bins (with the records)
  int4* rec = smem4;
  float* vals = reinterpret_cast<float*>(
      rec + (kSmem ? static_cast<size_t>(ctrees) * a.m1 : 0));
  int* nodes = reinterpret_cast<int*>(vals + ctrees * R);
  uint8_t* tile = reinterpret_cast<uint8_t*>(
      nodes + (kLeaf ? ctrees * R : 0));
  int* nan_tab = reinterpret_cast<int*>(
      tile + ((static_cast<size_t>(R) * a.rs * sizeof(Bin) + 15) & ~15));
  if (kSmem) {
    for (int i = t; i < a.f; i += kThreads)
      nan_tab[i] = __ldg(a.nan + i) ? __ldg(a.nb + i) - 1 : -1;
  }
  const int row_bytes = a.rs * static_cast<int>(sizeof(Bin));
  const Bin* bins = static_cast<const Bin*>(a.bins);
  const int tiles = (a.n + R - 1) / R;
  const size_t point = static_cast<size_t>(a.n) * (kClass ? a.num_class : 1);

  for (int s0 = 0; s0 < a.k; s0 += a.chunk) {
    const int steps = min(a.chunk, a.k - s0);
    const int nt = steps * g;
    const size_t tree0 = static_cast<size_t>(s0) * g;
    if (kSmem) {
      __syncthreads();   // the NaN bins are in; the last chunk's walks over
      const int nrec = nt * a.m1;
#pragma unroll 4
      for (int i = t; i < nrec; i += kThreads)
        rec[i] = pack_node(a, tree0 * a.m1 + i, nan_tab);
    }
    for (int tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
      const int r0 = tl * R;
      const int nr = min(R, a.n - r0);
      __syncthreads();   // records staged; the last tile's adds are over
      if (kSmem) {
        stage_bytes(tile, reinterpret_cast<const uint8_t*>(bins) +
                              static_cast<size_t>(r0) * row_bytes,
                    nr * row_bytes);
        __syncthreads();
      }
      // one (row, tree) pair a thread: consecutive threads take
      // consecutive rows of one tree
      const Bin* rows0 = kSmem ? reinterpret_cast<const Bin*>(tile)
                               : bins + static_cast<size_t>(r0) * a.rs;
      for (int p = t; p < nt * nr; p += kThreads) {
        const int tt = p / nr, rr = p - tt * nr;
        const size_t base = (tree0 + tt) * a.m1;
        // the row's bins: in the staged tile, or (the global walk) in
        // global memory
        const Bin* rb = rows0 + static_cast<size_t>(rr) * a.rs;
        float v;
        const int node =
            kSmem ? walk_rec<kEfb, Bin>(rec + static_cast<size_t>(tt) * a.m1,
                                        rb, a, base, &v)
                  : walk_soa<kEfb, Bin>(rb, a, base, &v);
        vals[tt * R + rr] = v;
        if (kLeaf) nodes[tt * R + rr] = node;
      }
      __syncthreads();
      // a thread a row adds the chunk's trees in tree order
      if (t < nr) {
        const int row = r0 + t;
        if (!kClass) {
          float s = 0.0f;
          if (s0 > 0) s = a.traj[static_cast<size_t>(s0 - 1) * a.n + row];
          else if (kScore0) s = a.s0[row];
          for (int j = 0; j < steps; ++j) {
            const float v = vals[j * R + t];
            s = (kScore0 || s0 + j > 0) ? __fadd_rn(s, v) : v;
            const size_t at = static_cast<size_t>(s0 + j) * a.n + row;
            a.traj[at] = s;
            if (kLeaf) a.leaf[at] = nodes[j * R + t];
          }
        } else {
          const size_t at = static_cast<size_t>(row) * a.num_class;
          const float* prev =
              s0 > 0 ? a.traj + static_cast<size_t>(s0 - 1) * point + at
                     : a.s0 + at;
          for (int j = 0; j < steps; ++j) {
            float* out = a.traj + static_cast<size_t>(s0 + j) * point + at;
            for (int c = 0; c < a.num_class; ++c) out[c] = prev[c];
            for (int q = 0; q < g; ++q) {
              out[a.cls0 + q] =
                  __fadd_rn(out[a.cls0 + q], vals[(j * g + q) * R + t]);
            }
            prev = out;
          }
        }
      }
    }
  }
}

template <bool kSmem, bool kScore0, bool kLeaf, bool kClass, bool kEfb,
          typename Bin>
cudaError_t launch(int blocks, size_t smem, cudaStream_t st, const Args& a) {
  auto kern = predict_binned_kernel<kSmem, kScore0, kLeaf, kClass, kEfb, Bin>;
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    // once a device, at the first launch (the fused trainer runs every
    // program eagerly before it captures)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  kern<<<blocks, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool kSmem, bool kEfb, typename Bin>
cudaError_t launch_mode(int blocks, size_t smem, cudaStream_t st,
                        const Args& a) {
  if (a.num_class > 1)
    return launch<kSmem, true, false, true, kEfb, Bin>(blocks, smem, st, a);
  if (a.s0 != nullptr) {
    if (a.leaf != nullptr)
      return launch<kSmem, true, true, false, kEfb, Bin>(blocks, smem, st, a);
    return launch<kSmem, true, false, false, kEfb, Bin>(blocks, smem, st, a);
  }
  if (a.leaf != nullptr)
    return launch<kSmem, false, true, false, kEfb, Bin>(blocks, smem, st, a);
  return launch<kSmem, false, false, false, kEfb, Bin>(blocks, smem, st, a);
}

template <bool kEfb, typename Bin>
cudaError_t launch_all(bool smem_trees, int blocks, size_t smem,
                       cudaStream_t st, const Args& a) {
  if (smem_trees) return launch_mode<true, kEfb, Bin>(blocks, smem, st, a);
  return launch_mode<false, kEfb, Bin>(blocks, smem, st, a);
}

// Rows a tile for a chunk of `trees` trees over n rows: at least about
// two pairs a thread, and at least n over the SMs (one tile a CTA, so
// each CTA stages its chunk's records once where n allows); at most a
// thread a row in the adds; a multiple of 32 (of 4 below 32).
int tile_rows(int trees, int n, int sms) {
  int r = (2 * kThreads + trees - 1) / trees;
  const int spread = (n + sms - 1) / sms;
  if (r < spread) r = spread;
  r = (r + 31) / 32 * 32;
  return r < 32 ? 32 : (r > kThreads ? kThreads : r);
}

// Dynamic shared memory of a chunk of `steps` steps (f features: the NaN
// bins beside the records; the global walk stages neither records nor
// bins).
size_t smem_bytes(bool smem_trees, int steps, int group, int m1, int rows,
                  int row_bytes, bool leaf, int f) {
  const size_t trees = static_cast<size_t>(steps) * group;
  size_t b = smem_trees ? trees * m1 * 16 : 0;
  b += trees * rows * 4 * (leaf ? 2 : 1);
  b = (b + 15) / 16 * 16;
  if (!smem_trees) return b;
  b += (static_cast<size_t>(rows) * row_bytes + 15) / 16 * 16;
  return b + static_cast<size_t>(f) * 4;
}

// The largest rows a tile, at most `rows` and a multiple of 4 (of 32 from
// 32 up), whose chunk fits kSmemBytes; 0 if not even 4 rows fit.
int fit_rows(bool smem_trees, int steps, int group, int m1, int rows,
             int row_bytes, bool leaf, int f) {
  while (rows >= 4 && smem_bytes(smem_trees, steps, group, m1, rows,
                                 row_bytes, leaf, f) >
                          static_cast<size_t>(kSmemBytes))
    rows = rows > 32 ? rows - 32 : rows - 4;
  return rows >= 4 ? rows : 0;
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
  if (num_class <= 1) group = 1;
  const bool efb = col_of_feat != nullptr;
  if (efb != (loc != nullptr) || (!efb && rs != f) || f >= (1 << 29) ||
      m1 <= 0)
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
  const int row_bytes = rs * (wide ? 2 : 1);
  const bool leaf = leaf_out != nullptr;
  const int sms = sm_count[dev];
  // the most steps a chunk whose records and a tile of rows' bins fit
  // shared memory at tile_rows' rows (16-bit child ids: m1 <= 32768 there;
  // the features' NaN bins beside them); where none fits, one step at
  // fewer rows (wide rows); else the global walk, chunks sized by the
  // value tiles alone
  bool smem_trees = m1 <= 32768 && f <= 8192;
  int chunk = 0, rows = 0;
  for (int s = k; s >= 1 && smem_trees && chunk == 0; --s) {
    rows = tile_rows(s * group, n, sms);
    if (smem_bytes(true, s, group, m1, rows, row_bytes, leaf, f) <=
        static_cast<size_t>(kSmemBytes))
      chunk = s;
  }
  if (chunk == 0 && smem_trees) {
    rows = fit_rows(true, 1, group, m1, tile_rows(group, n, sms), row_bytes,
                    leaf, f);
    if (rows > 0) chunk = 1;
  }
  if (chunk == 0) {
    smem_trees = false;
    for (int s = k; s >= 1 && chunk == 0; --s) {
      rows = fit_rows(false, s, group, m1, tile_rows(s * group, n, sms),
                      row_bytes, leaf, f);
      if (rows > 0) chunk = s;
    }
    if (chunk == 0) return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(smem_trees, chunk, group, m1, rows,
                                 row_bytes, leaf, f);
  // CTAs an SM by shared memory (228 KB an SM, 1 KB reserved a CTA) and
  // threads (2048 an SM)
  int per_sm = static_cast<int>((228 * 1024) / (smem + 1024));
  if (per_sm > 2048 / kThreads) per_sm = 2048 / kThreads;
  if (per_sm < 1) per_sm = 1;
  const int tiles = (n + rows - 1) / rows;
  int blocks = sm_count[dev] * per_sm;
  if (blocks > tiles) blocks = tiles;
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
               static_cast<const int*>(loc), bb, num_class, group, cls0,
               rows, chunk};
  if (wide) {
    if (efb)
      return launch_all<true, uint16_t>(smem_trees, blocks, smem, st, a);
    return launch_all<false, uint16_t>(smem_trees, blocks, smem, st, a);
  }
  if (efb) return launch_all<true, uint8_t>(smem_trees, blocks, smem, st, a);
  return launch_all<false, uint8_t>(smem_trees, blocks, smem, st, a);
}
