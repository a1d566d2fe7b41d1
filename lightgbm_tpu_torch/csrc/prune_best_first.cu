// Best-first prune of an overgrown tree: the JAX package's
// _prune_to_best_first (lightgbm_tpu/learner/grower_mxu.py:57-170), whose
// replay and pointer doubling are XLA there, as one CTA.
//
// The grower overgrows a tree to ~overshoot x num_leaves leaves in batched
// passes, recording every split's gain; the reference grows strictly best
// first (serial_tree_learner.cpp:159-210). The replay pops the available
// node of largest gain num_leaves - 1 times (the first index on ties and
// NaN above everything, as lax.argmax), marks it selected and makes its
// children available. Then a node is kept iff every proper ancestor was
// selected, rows move to their nearest kept-leaf ancestor, and kept nodes
// are renumbered densely in id order. Outputs, each [m1] over the grown
// tree's node ids (m1 = m_grow + 1, the last id the scratch node):
//   sel       u8   selected by the replay
//   kept      u8   every proper ancestor selected (and the node in the tree)
//   new_id    i32  inclusive count of kept ids up to here, minus one
//   composed  f32  new_id of the node's nearest kept-leaf ancestor: the
//                  row map's table (a row in node i goes to composed[i])
//
// Design. The replay is a chain of dependent argmax steps, so it runs in
// one warp, a tournament of two levels in shared memory: the best of each
// 32-id chunk of the availability vector, and over the chunk bests. A
// step is one butterfly argmax over the chunk bests (a lane takes every
// 32nd chunk), lane 0's three writes (the node popped, its children made
// available), then the three changed chunks reduced again by three
// butterflies side by side: ten dependent shuffle rounds a step, where a
// lane rescanning its range in turn took 32 dependent reads (0.60 ms for
// the main path's 254 steps on an H100). Children and masked gains are
// staged in shared memory first, so a step touches no global memory. The closure and the row map are
// ceil(log2 m1) pointer-doubling rounds over all m1 nodes, by the whole
// CTA, in ping-pong buffers that reuse the replay's shared memory; the
// renumbering is one block scan.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

#include "route_hist.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// 32-id chunks of the availability vector: m1 <= 32 * kMaxChunks
constexpr int kMaxChunks = 320;

// Whether (a, ia) comes before (b, ib) in lax.argmax's order: NaN above
// every number, then the larger value, ties (NaN with NaN too) to the
// lower index.
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an != bn) return an;
  if (!an && a != b) return a > b;
  return ia < ib;
}

__global__ void __launch_bounds__(kThreads)
    prune_kernel(const int* __restrict__ left, const int* __restrict__ right,
                 const int* __restrict__ parent,
                 const float* __restrict__ gain, int m1, int steps,
                 int rounds, uint8_t* __restrict__ sel_out,
                 uint8_t* __restrict__ kept_out, int* __restrict__ new_id_out,
                 float* __restrict__ composed_out) {
  extern __shared__ int smem[];
  // four [m1] words arrays, each reused once the replay is over
  float* avail = reinterpret_cast<float*>(smem);   // later ptr ping
  float* gains = avail + m1;                       // later ptr pong
  int* lch = reinterpret_cast<int*>(gains + m1);   // later parent (clipped)
  int* rch = lch + m1;                             // later new_id
  uint8_t* sel = reinterpret_cast<uint8_t*>(rch + m1);
  uint8_t* acc0 = sel + m1;
  uint8_t* acc1 = acc0 + m1;
  uint8_t* kept = acc1 + m1;
  __shared__ int warp_total[kWarps];
  __shared__ float chbv[kMaxChunks];   // best of each 32-id chunk
  __shared__ int chbi[kMaxChunks];

  const int t = threadIdx.x;
  const int m_grow = m1 - 1;
  for (int i = t; i < m1; i += kThreads) {
    const int l = left[i];
    lch[i] = l;
    rch[i] = right[i];
    gains[i] = l >= 0 ? gain[i] : -INFINITY;
    avail[i] = -INFINITY;
    sel[i] = 0;
  }
  __syncthreads();

  // ---- the replay, in warp 0: the best of each 32-id chunk of `avail`
  // is kept in chbv/chbi; a step is one warp argmax over the chunk bests,
  // lane 0's three writes, then one warp argmax over each changed chunk
  if (t < 32) {
    const int lane = t;
    const int nch = (m1 + 31) / 32;
    for (int c = lane; c < nch; c += 32) {
      // every entry -inf but avail[0]: the first index of each chunk
      chbv[c] = c == 0 ? gains[0] : -INFINITY;
      chbi[c] = c * 32;
    }
    if (lane == 0) avail[0] = gains[0];
    __syncwarp();
    for (int step = 0; step < steps; ++step) {
      float v = -INFINITY;
      int j = INT_MAX;   // a lane with no chunk loses to every real index
      for (int c = lane; c < nch; c += 32) {
        if (beats(chbv[c], chbi[c], v, j)) {
          v = chbv[c];
          j = chbi[c];
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, v, off);
        const int oj = __shfl_xor_sync(kFull, j, off);
        if (beats(ov, oj, v, j)) {
          v = ov;
          j = oj;
        }
      }
      // every lane holds the same (v, j), a real index
      const bool ok = v > -INFINITY;
      const int cl = ok ? min(max(lch[j], 0), m_grow) : m_grow;
      const int cr = ok ? min(max(rch[j], 0), m_grow) : m_grow;
      if (lane == 0) {
        if (ok) sel[j] = 1;
        avail[j] = -INFINITY;
        avail[cl] = cl < m_grow ? gains[cl] : -INFINITY;
        avail[cr] = cr < m_grow ? gains[cr] : -INFINITY;
      }
      __syncwarp();
      // the three changed chunks, reduced side by side (scalars, so they
      // stay in registers)
      const int c0 = j >> 5, c1 = cl >> 5, c2 = cr >> 5;
      const int i0 = c0 * 32 + lane, i1 = c1 * 32 + lane;
      const int i2 = c2 * 32 + lane;
      float v0 = i0 < m1 ? avail[i0] : -INFINITY;
      float v1 = i1 < m1 ? avail[i1] : -INFINITY;
      float v2 = i2 < m1 ? avail[i2] : -INFINITY;
      int j0 = i0 < m1 ? i0 : INT_MAX;
      int j1 = i1 < m1 ? i1 : INT_MAX;
      int j2 = i2 < m1 ? i2 : INT_MAX;
      for (int off = 16; off > 0; off >>= 1) {
        const float w0 = __shfl_xor_sync(kFull, v0, off);
        const float w1 = __shfl_xor_sync(kFull, v1, off);
        const float w2 = __shfl_xor_sync(kFull, v2, off);
        const int k0 = __shfl_xor_sync(kFull, j0, off);
        const int k1 = __shfl_xor_sync(kFull, j1, off);
        const int k2 = __shfl_xor_sync(kFull, j2, off);
        if (beats(w0, k0, v0, j0)) {
          v0 = w0;
          j0 = k0;
        }
        if (beats(w1, k1, v1, j1)) {
          v1 = w1;
          j1 = k1;
        }
        if (beats(w2, k2, v2, j2)) {
          v2 = w2;
          j2 = k2;
        }
      }
      if (lane == 0) {
        chbv[c0] = v0;
        chbi[c0] = j0;
        chbv[c1] = v1;
        chbi[c1] = j1;
        chbv[c2] = v2;
        chbi[c2] = j2;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- kept iff every proper ancestor was selected: pointer doubling
  int* par = lch;
  int* const ptr0 = reinterpret_cast<int*>(avail);
  int* const ptr1 = reinterpret_cast<int*>(gains);
  for (int i = t; i < m1; i += kThreads) {
    par[i] = min(max(parent[i], 0), m_grow);
  }
  __syncthreads();
  for (int i = t; i < m1; i += kThreads) {
    ptr0[i] = i == 0 ? 0 : par[i];
    acc0[i] = i == 0 ? 1 : sel[par[i]];
  }
  __syncthreads();
  int cur = 0;
  for (int r = 0; r < rounds; ++r) {
    const int* pc = cur ? ptr1 : ptr0;
    int* pn = cur ? ptr0 : ptr1;
    const uint8_t* ac = cur ? acc1 : acc0;
    uint8_t* an = cur ? acc0 : acc1;
    for (int i = t; i < m1; i += kThreads) {
      const int p = pc[i];
      an[i] = ac[i] & ac[p];
      pn[i] = pc[p];
    }
    __syncthreads();
    cur ^= 1;
  }
  const uint8_t* acc = cur ? acc1 : acc0;
  for (int i = t; i < m1; i += kThreads) {
    const uint8_t k = acc[i] & (i == 0 || parent[i] >= 0);
    kept[i] = k;
    kept_out[i] = k;
    sel_out[i] = sel[i];
    // rows ascend to the nearest kept-leaf ancestor (kept and not selected)
    ptr0[i] = ((k && !sel[i]) || i == 0) ? i : par[i];
  }
  __syncthreads();
  cur = 0;
  for (int r = 0; r < rounds; ++r) {
    const int* pc = cur ? ptr1 : ptr0;
    int* pn = cur ? ptr0 : ptr1;
    for (int i = t; i < m1; i += kThreads) pn[i] = pc[pc[i]];
    __syncthreads();
    cur ^= 1;
  }
  const int* nxt = cur ? ptr1 : ptr0;

  // ---- new_id = inclusive count of kept ids - 1: a thread counts a
  // contiguous chunk, then a block scan of the chunk counts
  int* new_id = rch;
  const int chunk = (m1 + kThreads - 1) / kThreads;
  const int c0 = min(t * chunk, m1);
  const int c1 = min(c0 + chunk, m1);
  int own = 0;
  for (int i = c0; i < c1; ++i) own += kept[i];
  const int lane = t & 31;
  const int warp = t >> 5;
  int incl = own;
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_total[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += o;
    }
    warp_total[lane] = w;   // inclusive over warps
  }
  __syncthreads();
  int run = incl - own + (warp > 0 ? warp_total[warp - 1] : 0);
  for (int i = c0; i < c1; ++i) {
    run += kept[i];
    new_id[i] = run - 1;
    new_id_out[i] = run - 1;
  }
  __syncthreads();
  for (int i = t; i < m1; i += kThreads) {
    composed_out[i] = static_cast<float>(new_id[nxt[i]]);
  }
}

}  // namespace

// bytes of shared memory a node takes (four words, four flags)
constexpr int kBytesPerNode = 20;

extern "C" int lgbt_prune_best_first(const void* left, const void* right,
                                     const void* parent, const void* gain,
                                     void* sel, void* kept, void* new_id,
                                     void* composed, int m1, int steps,
                                     int rounds, void* stream) {
  if (m1 <= 0) return cudaSuccess;
  if (m1 > 32 * kMaxChunks) return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(m1) * kBytesPerNode;
  cudaError_t err = lgbt::allow_smem(prune_kernel, bytes);
  if (err != cudaSuccess) return err;
  prune_kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(left), static_cast<const int*>(right),
      static_cast<const int*>(parent), static_cast<const float*>(gain), m1,
      steps, rounds, static_cast<uint8_t*>(sel), static_cast<uint8_t*>(kept),
      static_cast<int*>(new_id), static_cast<float*>(composed));
  return cudaGetLastError();
}
