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
// Design. Replayed step by step, the prune is a chain of dependent argmax
// steps (~1.2 us a step in one warp on an H100); its result has a
// parallel form. Let key(v) = (gain, id) in
// lax.argmax's order and E(v) the least key on the path root..v, v
// included. The replay pops the nodes in groups of equal E, in falling E:
// a group is its head h (E(h) = key(h)) and the connected part of h's
// subtree whose keys beat h's, popped best first from h. A popped NaN node
// uses a step, is not selected and its children are never reached; once
// the best available key is -inf every step does nothing. So the kernel
//   1. finds each node's parent from the children arrays and computes E
//      and "reached" (no proper ancestor NaN) by ceil(log2 m1) rounds of
//      pointer doubling, each node's new values staged in registers;
//   2. finds the key T of rank steps (0-based, from the top) among the
//      reached nodes whose E is above -inf: a radix select of six 8-bit
//      digits over the 48-bit keys (order-preserving gain bits, then
//      0xffff - id), which also leaves r, T's rank inside its own group;
//   3. selects every reached non-NaN node whose E beats T, then replays r
//      steps from T's node alone, the boundary group's head, as a warp
//      tournament (two levels in shared memory: the best of each 32-id
//      chunk of the availability vector and the best over chunks, ten
//      dependent shuffle rounds a step). A group's nodes beat every key
//      outside it that the replay can reach, so r < |group| steps stay
//      inside the group. A tree whose boundary group is the whole tree (a
//      chain of rising gains) replays every step.
// The kernel takes the grower's trees (an id is at most one node's child,
// the root no node's); the plain version takes any arrays.
// The closure and the row map are ceil(log2 m1) pointer-doubling rounds
// over all m1 nodes, by the whole CTA, in ping-pong buffers that reuse the
// earlier phases' shared memory; the renumbering is one block scan.
// Bound: the replay's dependent latency where r is large; else the CTA's
// ~50 barriers.

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
// nodes a thread holds in the doubling (its new values in registers)
constexpr int kPer = 32 * kMaxChunks / kThreads;

// Whether (a, ia) comes before (b, ib) in lax.argmax's order: NaN above
// every number, then the larger value, ties (NaN with NaN too) to the
// lower index.
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an != bn) return an;
  if (!an && a != b) return a > b;
  return ia < ib;
}

// The node's 48-bit key in lax.argmax's order: the gain's order-preserving
// bits (-0 as +0, every NaN on top), then 0xffff - id (the lower id first).
__device__ __forceinline__ unsigned long long key48(float g, int id) {
  const unsigned b = __float_as_uint(g == 0.0f ? 0.0f : g);
  const unsigned o = isnan(g) ? 0xffffffffu
                     : (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(o) << 16) |
         static_cast<unsigned>(0xffff - id);
}

__global__ void __launch_bounds__(kThreads)
    prune_kernel(const int* __restrict__ left, const int* __restrict__ right,
                 const int* __restrict__ parent,
                 const float* __restrict__ gain, int m1, int steps,
                 int rounds, uint8_t* __restrict__ sel_out,
                 uint8_t* __restrict__ kept_out, int* __restrict__ new_id_out,
                 float* __restrict__ composed_out) {
  extern __shared__ int smem[];
  // four [m1] word arrays, each reused once its phase is over
  float* avail = reinterpret_cast<float*>(smem);   // first E and ptr,
                                                   // later ptr ping
  float* gains = avail + m1;                       // later ptr pong
  int* lch = reinterpret_cast<int*>(gains + m1);   // later parent (clipped)
  int* rch = lch + m1;                             // later new_id
  uint8_t* sel = reinterpret_cast<uint8_t*>(rch + m1);
  uint8_t* acc0 = sel + m1;                        // first "reached"
  uint8_t* acc1 = acc0 + m1;
  uint8_t* kept = acc1 + m1;
  uint16_t* eptr = reinterpret_cast<uint16_t*>(avail);  // parent pointer
  uint16_t* ehead = eptr + m1;                     // the node of E
  uint8_t* reach = acc0;
  __shared__ int warp_total[kWarps];
  __shared__ float chbv[kMaxChunks];   // best of each 32-id chunk
  __shared__ int chbi[kMaxChunks];
  __shared__ int hist[2][256];
  __shared__ int s_digit, s_k, s_total;

  const int t = threadIdx.x;
  const int m_grow = m1 - 1;
  for (int i = t; i < m1; i += kThreads) {
    const int l = left[i];
    lch[i] = l;
    rch[i] = right[i];
    gains[i] = l >= 0 ? gain[i] : -INFINITY;
    sel[i] = 0;
    eptr[i] = static_cast<uint16_t>(i);
    ehead[i] = static_cast<uint16_t>(i);
    reach[i] = i == 0;
  }
  for (int i = t; i < 2 * 256; i += kThreads) (&hist[0][0])[i] = 0;
  __syncthreads();

  // ---- 1. parents from the children (a node the replay can never make
  // available keeps itself and stays unreached), then E and "reached" by
  // pointer doubling
  for (int j = t; j < m1; j += kThreads) {
    if (lch[j] < 0) continue;
    const bool ok = !isnan(gains[j]);
    const int cl = min(max(lch[j], 0), m_grow);
    const int cr = min(max(rch[j], 0), m_grow);
    if (cl > 0 && cl < m_grow) {
      eptr[cl] = static_cast<uint16_t>(j);
      reach[cl] = ok;
    }
    if (cr > 0 && cr < m_grow) {
      eptr[cr] = static_cast<uint16_t>(j);
      reach[cr] = ok;
    }
  }
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    // each node's new (ptr, E) packed in one word and its flag in a mask:
    // registers stay few at 1024 threads
    unsigned st[kPer];
    unsigned rmask = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = t + q * kThreads;
      if (i < m1) {
        const int p = eptr[i], e = ehead[i], pe = ehead[p];
        // the lesser key of the two: E is the least on the path
        const int ne = beats(gains[pe], pe, gains[e], e) ? e : pe;
        st[q] = static_cast<unsigned>(eptr[p]) |
                (static_cast<unsigned>(ne) << 16);
        if (reach[i] & reach[p]) rmask |= 1u << q;
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = t + q * kThreads;
      if (i < m1) {
        eptr[i] = static_cast<uint16_t>(st[q] & 0xffff);
        ehead[i] = static_cast<uint16_t>(st[q] >> 16);
        reach[i] = (rmask >> q) & 1;
      }
    }
    __syncthreads();
  }

  // ---- 2. the boundary: the key of rank `steps` among the valid nodes'
  // E keys (valid: reached, E above -inf), by a radix select from the top;
  // each pass recomputes a node's key from E in shared memory
  unsigned long long prefix = 0;
  int k = steps;
  bool all = false;   // every valid node is popped: no boundary group
  for (int pass = 0; pass < 6; ++pass) {
    const int shift = 40 - 8 * pass;
    int* h = hist[pass & 1];
    for (int i = t; i < m1; i += kThreads) {
      const int e = ehead[i];
      if (!reach[i] || gains[e] == -INFINITY) continue;
      const unsigned long long key = key48(gains[e], e);
      if ((key >> (shift + 8)) == (prefix >> (shift + 8)))
        atomicAdd(&h[(key >> shift) & 255], 1);
    }
    __syncthreads();
    if (t < 32) {
      // lane L holds digits 255 - 8L .. 248 - 8L, from the top
      int c[8];
      int own = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        c[q] = h[255 - 8 * t - q];
        own += c[q];
      }
      int incl = own;
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(kFull, incl, off);
        if (t >= off) incl += o;
      }
      const int ex = incl - own;
      if (ex <= k && k < incl) {
        int kk = k - ex, q = 0;
        while (kk >= c[q]) kk -= c[q++];
        s_digit = 255 - 8 * t - q;
        s_k = kk;
      }
      if (t == 31) s_total = incl;
    }
    __syncthreads();
    if (pass == 0 && s_total <= steps) {
      all = true;
      break;
    }
    prefix |= static_cast<unsigned long long>(s_digit) << shift;
    k = s_k;
    for (int i = t; i < 256; i += kThreads) h[i] = 0;
  }

  // ---- 3. the groups above the boundary whole, then r = k replay steps
  // from the boundary group's head
  for (int i = t; i < m1; i += kThreads) {
    const int e = ehead[i];
    if (reach[i] && !(gains[e] == -INFINITY) && !isnan(gains[i]) &&
        (all || key48(gains[e], e) > prefix))
      sel[i] = 1;
  }
  const int head = 0xffff - static_cast<int>(prefix & 0xffff);
  const int r_steps = all ? 0 : k;
  __syncthreads();   // E and ptr are dead: their words become `avail`
  if (r_steps > 0) {
    for (int i = t; i < m1; i += kThreads) avail[i] = -INFINITY;
    __syncthreads();
  }
  if (t < 32 && r_steps > 0) {
    const int lane = t;
    const int nch = (m1 + 31) / 32;
    for (int c = lane; c < nch; c += 32) {
      // every entry -inf but avail[head]: the first index of each chunk,
      // the head in its own (its gain is above -inf)
      const bool hc = c == (head >> 5);
      chbv[c] = hc ? gains[head] : -INFINITY;
      chbi[c] = hc ? head : c * 32;
    }
    if (lane == 0) avail[head] = gains[head];
    __syncwarp();
    for (int step = 0; step < r_steps; ++step) {
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
constexpr int kMaxDevices = 64;

extern "C" int lgbt_prune_best_first(const void* left, const void* right,
                                     const void* parent, const void* gain,
                                     void* sel, void* kept, void* new_id,
                                     void* composed, int m1, int steps,
                                     int rounds, void* stream) {
  if (m1 <= 0) return cudaSuccess;
  if (m1 > 32 * kMaxChunks) return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(m1) * kBytesPerNode;
  // the largest tree's shared memory, allowed once a device at the first
  // launch (the fused trainer runs every program eagerly before it
  // captures, so this never falls inside a capture)
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = lgbt::allow_smem(prune_kernel,
                           static_cast<size_t>(32 * kMaxChunks) *
                               kBytesPerNode);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  prune_kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(left), static_cast<const int*>(right),
      static_cast<const int*>(parent), static_cast<const float*>(gain), m1,
      steps, rounds, static_cast<uint8_t*>(sel), static_cast<uint8_t*>(kept),
      static_cast<int*>(new_id), static_cast<float*>(composed));
  return cudaGetLastError();
}
