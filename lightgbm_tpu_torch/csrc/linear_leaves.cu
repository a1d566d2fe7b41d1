// linear_leaves: the two device kernels of linear trees (linear_tree=true).
//
// Replaces: lightgbm_tpu/learner/linear.py (XLA, no Pallas kernel there):
// fit_linear_leaves' lax.scan over 8192-row chunks of [C, D+1, D+1]
// outer products scatter-added per leaf (L1, lgbt_linear_gram), and
// linear_leaf_values' per-row gather and dot (L2, lgbt_linear_values).
// The plain versions are linear_gram_ref and linear_leaf_values_ref in
// learner/linear.py; each kernel equals its plain version bit for bit.
//
// L1 sums, for every leaf l, over its usable rows (node in range, cnt > 0,
// no NaN in the leaf's features): X'HX[l, i, j] of h x_i x_j, X'g[l, i]
// of g x_i, over the leaf's D feature slots feat[l, :] (-1: empty, x = 0)
// and the intercept slot D (x = 1), and the usable rows' count. Every
// product is formed in float64 in one order, v = (h x_i) x_j and g x_i,
// with explicit __dmul_rn (no contraction), and added as the int64
// q = rint(v x 2^k). One power-of-two scale per (leaf, entry): with
// max |h| < 2^eh, max |x_i| < 2^ei over the leaf's usable rows (frexp) and
// c <= 2^lg of them, k = 61 - lg - eh - ei - ej (61 - lg - eg - ei for
// X'g), so |q| <= 2^(61 - lg) and every sum is within 2^61. Integer sums
// are exact in any order, so the result does not depend on the order of
// the rows or the atomics; each sum comes out as f32(float64(sum) x 2^-k),
// NaN where a maximum is not finite.
//
// L1's bound on this card: bytes. Each row's leaf features are ~4.5 of
// the 28 floats of its 112-byte row of raw, but raw is row-major, so the
// least the card reads is the 32-byte sectors that hold them (the sector
// floor: ~1.5 sectors a row at the main path, 47 MB of raw's 112, against
// the features' own ~18 MB) plus row_node, g, h and cnt. The float64 products (~25 a row) and their
// int64 conversions are ~0.01 ms at the card's float64 rate. Gathering a
// leaf's rows from raw is a random access a row (a design that gathered
// them twice, for the maxima and for the sums, took 0.75 ms in all; one
// gather into a packed scratch took 0.21 ms alone), so this design reads
// raw once in row order, at the streaming rate, and moves each row's
// values to its leaf there. Six launches and a memset on the caller's
// stream:
//  1. count: the rows of each node (shared-memory tallies, then one
//     atomic a node and CTA; two CTAs an SM).
//  2. leaves, one CTA: each node's active columns, its records' width w
//     (its nf features, h, g and a usable flag, padded to a power of two:
//     8 floats for nf <= 5), the first float of its records (a scan of
//     rows x w) and its chunks of kChunk records (the chunk table).
//  3. pack, a CTA a run of kPackRows rows: each row's rank among the run's
//     rows of its node (shared-memory counters), one global reservation a
//     node and run (no atomic a row; past kMaxFastNodes node ids a global
//     counter a row), then tiles of kPackThreads rows staged whole with
//     16-byte loads, a thread a row: usable (cnt > 0, no NaN among its
//     node's features) and its record, stored 16 bytes at a time, zeros
//     for a row that is not usable (it adds 0 to every sum).
//  4. maxima, a CTA a chunk: the records read contiguously, each thread
//     one plane (w divides the CTA), the maxima of the |x| bit patterns (a
//     non-negative float's bits order as its value, a NaN's above +inf)
//     and the usable flags reduced by shuffles, one atomic a plane.
//  5. sums, a CTA a chunk: total = nact (nact + 1) / 2 + nact entries
//     (nact = nf + 1 with the intercept), G = the largest power of two
//     <= 512 / total lanes an entry, so every thread is live whenever
//     total <= 512. Batches of kStageFloats record floats, loaded a batch
//     ahead into registers, staged in shared memory as float64 planes;
//     each lane sums its share in int64; the G lanes combine with shuffles
//     and one global atomicAdd goes out per entry, chunk and warp.
//  6. finish: every [D+1, D+1] and [D+1] entry of every node scaled back
//     to f32, the upper triangle mirrored, and the usable-row counts.
// Sizes from chip_parts.py --linear --variants on the card: runs of 2048
// rows and chunks of 1024 records beat 1024/4096 and 2048; two sums CTAs
// an SM beat three.
//
// L2 evaluates the models row by row: acc = const[leaf], then for each of
// the D slots in ascending order acc = acc + coeff x x (x = 0 in an empty
// slot), each f32 op rounded on its own (__fmul_rn, __fadd_rn);
// leaf_value[leaf] where a model feature is NaN; 0 for a node out of
// range. Bound on this card: bytes, and again the sectors of raw: the
// least is leaf and out (8 bytes a row) and each row's sectors that hold
// its model features, ~1.5 of a row's ~3.5. Those sectors are a random
// access a row, so the design reads raw whole in row order (2.3x the
// sector floor's bytes, at the streaming rate) and runs only the active
// slots, in two launches and a memset:
//  1. model: a warp a leaf compacts its D slots into the active ones,
//     (column, coefficient) in slot order, reserving its entries in a
//     compact table. An empty slot adds coeff x 0, a signed zero (NaN for
//     an infinite or NaN coeff), to acc: the sum of a run of such adds is
//     acc + z for one z (NaN if any is NaN, else +0 if any is +0, else -0,
//     which adds nothing), so each active slot carries the code of the run
//     before it and the leaf that of the run after its last one (a -0.0
//     const turns +0 there as in the plain version).
//  2. values, persistent CTAs: the headers and the compact entries of all
//     leaves staged in shared memory where they fit in kModelBytes, else
//     read from the global table; then tile by tile of kTileRows rows,
//     staged whole where F <= kMaxTileCols, loaded a tile ahead into
//     registers with 16-byte loads (the first while the models are
//     staged), a thread a row over its leaf's active slots.
#include "route_hist.cuh"

namespace {

constexpr int kChunk = 1024;         // records a maxima / sums CTA takes
constexpr int kPackRows = 2048;      // rows a pack CTA takes: one
                                     // reservation a node and run
constexpr int kPackThreads = 256;    // pack, maxima: a thread a row
constexpr int kPackSteps = kPackRows / kPackThreads;
constexpr int kMaxFastNodes = 8192;  // pack: rank counters in shared memory
constexpr int kSumThreads = 512;
constexpr int kStageFloats = 2048;   // record floats a sums batch stages
constexpr int kMaxSlots = 32;        // 31 features and the intercept
constexpr int kMaxWidth = 64;        // record_width(31)
constexpr int kEntries = 2;          // entries a sums thread owns (<= 560)
constexpr int kPre = kStageFloats / kSumThreads;   // floats a thread loads
constexpr int kThreads = 256;        // count, finish, model, values
constexpr int kGramBits = 61;
constexpr int kMaxSharedNodes = 12288;   // count tallies: 48 KB a CTA
constexpr int kTileRows = kThreads;  // values: rows a tile, a thread a row
constexpr int kMaxTileCols = 48;     // values: rows staged whole up to this
constexpr int kVec = kTileRows * kMaxTileCols / 4 / kThreads;   // float4s
constexpr int kModelBytes = 40 * 1024;   // values: the staged models
constexpr int kCodeShift = 30;       // a run's code above a column / count
constexpr int kLowMask = (1 << kCodeShift) - 1;
static_assert(kPackThreads % kMaxWidth == 0, "a maxima thread reads one plane");

__device__ __forceinline__ unsigned abs_bits(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}

// frexp exponent of a maximum's bits (|x| < 2^e; 0 at 0), kNonFinite for
// NaN or inf
__device__ __forceinline__ int exponent_of(unsigned bits) {
  const float a = __uint_as_float(bits);
  if (!isfinite(a)) return lgbt::kNonFinite;
  int e = 0;
  frexpf(a, &e);
  return e;
}

// ceil(log2(c)): c <= 2^lg
__device__ __forceinline__ int lg_of(int c) {
  return c > 1 ? 32 - __clz(c - 1) : 0;
}

__device__ __forceinline__ int scale_of(int lg, int a, int b, int c) {
  if (a == lgbt::kNonFinite || b == lgbt::kNonFinite ||
      c == lgbt::kNonFinite) {
    return lgbt::kNonFinite;
  }
  return kGramBits - lg - a - b - c;
}

// index of the (i <= j) entry in the row-major upper triangle of d1 slots
__host__ __device__ __forceinline__ int tri(int i, int j, int d1) {
  return i * d1 - i * (i - 1) / 2 + (j - i);
}

__host__ __device__ inline size_t up8(size_t b) { return (b + 7) / 8 * 8; }

// floats of a leaf's records: its nf features, h, g and the usable flag,
// padded to a power of two (learner/linear.py _record_width)
__host__ __device__ inline int record_width(int nf) {
  int w = 4;
  while (w < nf + 3) w <<= 1;
  return w;
}

// CTAs of the maxima and sums kernels: every leaf's records in chunks of
// kChunk, ceil(n / kChunk) + m1 bound them all
__host__ __device__ inline int gram_chunks(int n, int m1) {
  return (n + kChunk - 1) / kChunk + m1;
}

// The scratch's layout (learner/linear.py gram_scratch_bytes): the zeroed
// part first, then the part every call writes before it reads.
struct Scratch {
  int* ncount;      // [m1] rows of each node
  int* cursor;      // [m1] each node's next record (the pack's reservations)
  int* counts;      // [m1] usable rows of each node
  unsigned* xmax;   // [m1, d1] max |x| bits of each slot
  unsigned* hmax;   // [m1]
  unsigned* gmax;   // [m1]
  unsigned long long* sums;   // [m1, w] int64: the triangle, then X'g
  long long* lbase; // [m1] each node's first record float
  int* lnf;         // [m1] each node's active features
  int* ecol;        // [m1, d] their columns, in slot order
  int2* chunk_at;   // [gram_chunks] each chunk's node (-1: none) and its
                    // index within the node
  float* pack;      // [<= n record_width(d)] the records
  size_t zero_bytes;
  size_t bytes;
};

Scratch carve(void* base, int n, int m1, int d) {
  const size_t d1 = d + 1;
  const size_t w = d1 * (d1 + 1) / 2 + d1;
  char* p = static_cast<char*>(base);
  Scratch s;
  s.ncount = reinterpret_cast<int*>(p);
  s.cursor = s.ncount + m1;
  s.counts = s.cursor + m1;
  s.xmax = reinterpret_cast<unsigned*>(s.counts + m1);
  s.hmax = s.xmax + m1 * d1;
  s.gmax = s.hmax + m1;
  size_t off = up8(4 * static_cast<size_t>(m1) * (d1 + 5));
  s.sums = reinterpret_cast<unsigned long long*>(p + off);
  off += 8 * static_cast<size_t>(m1) * w;
  s.zero_bytes = off;
  off = (off + 15) / 16 * 16;
  s.lbase = reinterpret_cast<long long*>(p + off);
  off += 8 * static_cast<size_t>(m1);
  s.lnf = reinterpret_cast<int*>(p + off);
  s.ecol = s.lnf + m1;
  off = (off + 4 * static_cast<size_t>(m1) * (d + 1) + 15) / 16 * 16;
  s.chunk_at = reinterpret_cast<int2*>(p + off);
  off += 8 * static_cast<size_t>(gram_chunks(n, m1));
  off = (off + 15) / 16 * 16;
  s.pack = reinterpret_cast<float*>(p + off);   // 16-byte aligned
  off += 4 * static_cast<size_t>(n) * record_width(d);
  s.bytes = off;
  return s;
}

// rows of each node (shared-memory tallies a CTA where m1 fits)
__global__ void count_kernel(const int* __restrict__ row_node,
                             int* __restrict__ counts, int n, int m1,
                             bool shared) {
  extern __shared__ int tally[];
  if (shared) {
    for (int j = threadIdx.x; j < m1; j += blockDim.x) tally[j] = 0;
    __syncthreads();
  }
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int node = row_node[i];
    if (node < 0 || node >= m1) continue;
    atomicAdd((shared ? tally : counts) + node, 1);
  }
  if (shared) {
    __syncthreads();
    for (int j = threadIdx.x; j < m1; j += blockDim.x) {
      if (tally[j] != 0) atomicAdd(counts + j, tally[j]);
    }
  }
}

// Exclusive scan of v over the CTA's 1024 threads (warp shuffles, then
// the warps' totals): returns the exclusive prefix, *total the sum. Syncs.
template <typename T>
__device__ __forceinline__ T block_scan_1024(T v, T* wsum, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const T w = wsum[lane];
    T z = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, z, o);
      if (lane >= o) z += y;
    }
    wsum[lane] = z - w;
    if (lane == 31) *total = z;
  }
  __syncthreads();
  const T out = x - v + wsum[warp];
  __syncthreads();
  return out;
}

// One CTA of 1024 threads, a thread a node: its active features' columns
// (ecol, lnf), and two exclusive scans tile by tile with a carry: the
// first float of its records (lbase: rows x record_width) and its first
// chunk, whose table (chunk_at) it writes
__global__ void __launch_bounds__(1024)
leaves_kernel(const int* __restrict__ feat, Scratch sc, int m1, int d,
              int chunks_bound) {
  __shared__ long long wa[32];
  __shared__ int wb[32];
  __shared__ long long tot_a;
  __shared__ int tot_b;
  const int t = threadIdx.x;
  long long carry_a = 0;
  int carry_b = 0;
  for (int base = 0; base < m1; base += 1024) {
    const int k = base + t;
    long long words = 0;
    int chunks = 0;
    if (k < m1) {
      const int* fr = feat + static_cast<size_t>(k) * d;
      int* ec = sc.ecol + static_cast<size_t>(k) * d;
      int nf = 0;
      for (int s = 0; s < d; ++s) {
        const int fc = fr[s];
        if (fc >= 0) ec[nf++] = fc;
      }
      sc.lnf[k] = nf;
      const int c = sc.ncount[k];
      words = static_cast<long long>(c) * record_width(nf);
      chunks = (c + kChunk - 1) / kChunk;
    }
    const long long a0 = block_scan_1024(words, wa, &tot_a);
    const int b0 = block_scan_1024(chunks, wb, &tot_b);
    if (k < m1) {
      const int c0 = carry_b + b0;
      sc.lbase[k] = carry_a + a0;
      for (int c = 0; c < chunks; ++c) sc.chunk_at[c0 + c] = make_int2(k, c);
    }
    carry_a += tot_a;
    carry_b += tot_b;
  }
  for (int b = carry_b + t; b < chunks_bound; b += 1024) {
    sc.chunk_at[b] = make_int2(-1, 0);
  }
}

// A CTA a run of kPackRows rows in row order. Each row's rank among the
// run's rows of its node (a shared-memory counter a node where m1 <=
// kMaxFastNodes, then one global reservation a node and run; past that a
// global counter a row), then tile by tile of kPackThreads rows (raw
// staged whole where `staged`), a thread a row: usable (cnt > 0, no NaN
// among its node's features), and its record at its node's lbase + its
// index x record_width: the features, h, g and 1 if usable, else zeros.
__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const float* __restrict__ raw, const float* __restrict__ grad,
            const float* __restrict__ hess, const float* __restrict__ cnt,
            const int* __restrict__ row_node, Scratch sc, int n, int f,
            int m1, int d, int fast, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);   // [kPackThreads, f]
  int* tcount = reinterpret_cast<int*>(
      smem + (staged ? static_cast<size_t>(kPackThreads) * f * 4 : 0));
  int* first = tcount + m1;                       // the run's reservation
  const int t = threadIdx.x;
  const int c0 = blockIdx.x * kPackRows;
  if (fast) {
    for (int k = t; k < m1; k += kPackThreads) tcount[k] = 0;
    __syncthreads();
  }
  int node[kPackSteps], rank[kPackSteps];
#pragma unroll
  for (int s = 0; s < kPackSteps; ++s) {
    const int r = c0 + s * kPackThreads + t;
    const int k = r < n ? row_node[r] : -1;
    const bool in = k >= 0 && k < m1;
    node[s] = in ? k : -1;
    rank[s] = in ? atomicAdd((fast ? tcount : sc.cursor) + k, 1) : 0;
  }
  if (fast) {
    __syncthreads();
    for (int k = t; k < m1; k += kPackThreads) {
      const int c = tcount[k];
      first[k] = c != 0 ? atomicAdd(sc.cursor + k, c) : 0;
    }
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < kPackSteps; ++s) {
    const int r0 = c0 + s * kPackThreads;
    if (r0 >= n) break;
    const int rows = min(kPackThreads, n - r0);
    if (staged) {    // rows r0.. are contiguous, r0 f a multiple of 4
      const int words = rows * f;
      const float* b = raw + static_cast<size_t>(r0) * f;
      const float4* b4 = reinterpret_cast<const float4*>(b);
      float4* t4 = reinterpret_cast<float4*>(tile);
      for (int i = t; i < words / 4; i += kPackThreads) {
        t4[i] = __ldcs(b4 + i);
      }
      for (int i = words / 4 * 4 + t; i < words; i += kPackThreads) {
        tile[i] = __ldcs(b + i);
      }
      __syncthreads();
    }
    const int k = node[s];
    if (k >= 0) {
      const int r = r0 + t;
      const float* x =
          staged ? tile + t * f : raw + static_cast<size_t>(r) * f;
      const int nf = sc.lnf[k];
      const int w = record_width(nf);
      const int* cols = sc.ecol + static_cast<size_t>(k) * d;
      const float h = hess[r], g = grad[r];
      bool ok = cnt[r] > 0.f;
      for (int a = 0; a < nf; ++a) ok = ok && !isnan(x[cols[a]]);
      const int idx = (fast ? first[k] : 0) + rank[s];
      float4* rec = reinterpret_cast<float4*>(
          sc.pack + sc.lbase[k] + static_cast<long long>(idx) * w);
      for (int a0 = 0; a0 < w; a0 += 4) {
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int a = a0 + q;
          v[q] = !ok ? 0.f
                 : a < nf ? x[cols[a]]
                 : a == nf ? h
                 : a == nf + 1 ? g
                 : a == nf + 2 ? 1.f : 0.f;
        }
        rec[a0 / 4] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    if (staged) __syncthreads();
  }
}

// Node k's active slots in slot order (slot[a], a < nf), from feat[k, :]
// (d < 32); returns nf. Run by one whole warp.
__device__ __forceinline__ int active_slots(const int* __restrict__ feat,
                                            int k, int d, int* slot) {
  const int lane = threadIdx.x & 31;
  const int fc = lane < d ? feat[static_cast<size_t>(k) * d + lane] : -1;
  const unsigned act = __ballot_sync(0xffffffffu, fc >= 0);
  if (fc >= 0) slot[__popc(act & ((1u << lane) - 1u))] = lane;
  return __popc(act);
}

// A CTA a chunk: its records' maxima plane by plane (|x| bit patterns: a
// non-negative float's bits order as its value, a NaN's above +inf; an
// unusable row's record is zeros) and its usable rows (the flags), one
// atomic a plane and chunk. A record width divides kPackThreads, so each
// thread reads one plane.
__global__ void __launch_bounds__(kPackThreads)
maxima_kernel(const int* __restrict__ feat, Scratch sc, int d) {
  __shared__ int slot[kMaxSlots];
  __shared__ unsigned smax[kMaxWidth];
  __shared__ int scount;
  const int t = threadIdx.x;
  const int2 ck = sc.chunk_at[blockIdx.x];
  const int k = ck.x;
  if (k < 0) return;
  if (t == 0) scount = 0;
  if (t < kMaxWidth) smax[t] = 0u;
  if (t < 32) active_slots(feat, k, d, slot);
  const int nf = sc.lnf[k];
  const int w = record_width(nf);
  const int lo = ck.y * kChunk;
  const int u = min(kChunk, sc.ncount[k] - lo);
  const float* rec = sc.pack + sc.lbase[k] + static_cast<long long>(lo) * w;
  const int a = t & (w - 1);
  unsigned mx = 0u;
  int usable = 0;
  __syncthreads();
  for (int e = t; e < u * w; e += kPackThreads) {
    const float v = rec[e];
    mx = max(mx, abs_bits(v));
    usable += v != 0.f ? 1 : 0;
  }
  if (a != nf + 2) usable = 0;
  // lanes of one plane: lane, lane ^ w, ... within a warp (w <= 32)
  for (int o = 16; o >= w; o >>= 1) {
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    usable += __shfl_xor_sync(0xffffffffu, usable, o);
  }
  if ((t & 31) < w) {
    if (mx != 0u) atomicMax(smax + a, mx);
    if (usable != 0) atomicAdd(&scount, usable);
  }
  __syncthreads();
  const int d1 = d + 1;
  unsigned* xm = sc.xmax + static_cast<size_t>(k) * d1;
  if (t < nf && smax[t] != 0u) atomicMax(xm + slot[t], smax[t]);
  if (t == 32 && scount != 0) {
    atomicMax(xm + d, __float_as_uint(1.0f));
    atomicAdd(sc.counts + k, scount);
  }
  if (t == 33 && smax[nf] != 0u) atomicMax(sc.hmax + k, smax[nf]);
  if (t == 34 && smax[nf + 1] != 0u) atomicMax(sc.gmax + k, smax[nf + 1]);
}

__global__ void __launch_bounds__(kSumThreads, 2)
sums_kernel(const int* __restrict__ feat, Scratch sc, int d) {
  // a batch of nbmax = kStageFloats / w records staged as float64 planes
  // [plane, nbmax]: features 0..nf-1, the intercept (1.0) at nf, h at
  // nf + 1, g at nf + 2 (nf + 3 <= w planes)
  __shared__ double xs[kStageFloats];
  __shared__ int slot[kMaxSlots];   // active slots in order, then d
  __shared__ unsigned sxm[kMaxSlots];
  const int2 ck = sc.chunk_at[blockIdx.x];
  const int k = ck.x;
  if (k < 0) return;
  const int nf = sc.lnf[k];
  const int w = record_width(nf);
  const int shift = 31 - __clz(w);
  const int nbmax = kStageFloats >> shift;
  const int lo = ck.y * kChunk;
  const int u = min(kChunk, sc.ncount[k] - lo);
  const float* rec = sc.pack + sc.lbase[k] + static_cast<long long>(lo) * w;
  // a batch's kStageFloats record floats, loaded a batch ahead: element e
  // is plane e & (w - 1) of record e >> shift
  float pre[kPre];
  auto fetch = [&](int b0) {
    const int words = min(nbmax, u - b0) << shift;
#pragma unroll
    for (int s = 0; s < kPre; ++s) {
      const int e = threadIdx.x + s * kSumThreads;
      pre[s] = e < words ? rec[(static_cast<size_t>(b0) << shift) + e] : 0.f;
    }
  };
  fetch(0);     // in flight while the scales are worked out
  const int d1 = d + 1;
  if (threadIdx.x < 32) {
    active_slots(feat, k, d, slot);
    if (threadIdx.x == 0) slot[nf] = d;
  } else if (threadIdx.x < 32 + d1) {
    sxm[threadIdx.x - 32] =
        sc.xmax[static_cast<size_t>(k) * d1 + threadIdx.x - 32];
  }
  const int lg = lg_of(sc.counts[k]);
  const int eh = exponent_of(sc.hmax[k]);
  const int eg = exponent_of(sc.gmax[k]);
  for (int i = threadIdx.x; i < nbmax; i += kSumThreads) {
    xs[nf * nbmax + i] = 1.0;
  }
  __syncthreads();
  const int nact = nf + 1;
  const int pairs = nact * (nact + 1) / 2;
  const int total = pairs + nact;
  const int wsum = d1 * (d1 + 1) / 2 + d1;
  // G lanes an entry, a power of two; npar entries side by side
  const int per = kSumThreads / total;
  const int G = per >= 1 ? 1 << (31 - __clz(per)) : 1;
  const int npar = kSumThreads / G;
  const int l = threadIdx.x & (G - 1);
  // the owned entries: v = (p0 x pa) x pb over staged planes; an (a <= b)
  // pair is (h x_a) x_b, an X'g entry (g x_a) x 1
  int p0[kEntries], pa[kEntries], pb[kEntries], widx[kEntries];
  double mul[kEntries];
  long long acc[kEntries];
  bool live[kEntries];
#pragma unroll
  for (int q = 0; q < kEntries; ++q) {
    const int e = threadIdx.x / G + q * npar;
    live[q] = false;
    acc[q] = 0;
    p0[q] = pa[q] = pb[q] = widx[q] = 0;
    mul[q] = 0.0;
    if (e >= total) continue;
    int kk;
    if (e < pairs) {
      int a = 0, rem = e;
      while (rem >= nact - a) {
        rem -= nact - a;
        ++a;
      }
      const int b = a + rem;
      p0[q] = nf + 1;
      pa[q] = a;
      pb[q] = b;
      widx[q] = tri(slot[a], slot[b], d1);
      kk = scale_of(lg, eh, exponent_of(sxm[slot[a]]),
                    exponent_of(sxm[slot[b]]));
    } else {
      const int a = e - pairs;
      p0[q] = nf + 2;
      pa[q] = a;
      pb[q] = nf;
      widx[q] = d1 * (d1 + 1) / 2 + slot[a];
      kk = scale_of(lg, eg, exponent_of(sxm[slot[a]]), 0);
    }
    if (kk == lgbt::kNonFinite) continue;   // the result is NaN anyway
    live[q] = true;
    mul[q] = ldexp(1.0, kk);
  }
  for (int b0 = 0; b0 < u; b0 += nbmax) {
    const int nb = min(nbmax, u - b0);
#pragma unroll
    for (int s = 0; s < kPre; ++s) {
      const int e = threadIdx.x + s * kSumThreads;
      const int i = e >> shift, a = e & (w - 1);
      if (i < nb && a < nf + 2) {
        xs[(a < nf ? a : a + 1) * nbmax + i] = static_cast<double>(pre[s]);
      }
    }
    __syncthreads();
    if (b0 + nbmax < u) fetch(b0 + nbmax);
#pragma unroll
    for (int q = 0; q < kEntries; ++q) {
      if (!live[q]) continue;
      const double* x0 = xs + p0[q] * nbmax;
      const double* xa = xs + pa[q] * nbmax;
      const double* xb = xs + pb[q] * nbmax;
      const double m = mul[q];
      long long s = acc[q];
      for (int i = l; i < nb; i += G) {
        const double v = __dmul_rn(__dmul_rn(x0[i], xa[i]), xb[i]);
        s += __double2ll_rn(__dmul_rn(v, m));
      }
      acc[q] = s;
    }
    __syncthreads();
  }
  // the G lanes of an entry are aligned lanes of one warp (G <= 32) or
  // whole warps: shuffles, then a global add a group
  const int width = G < 32 ? G : 32;
#pragma unroll
  for (int q = 0; q < kEntries; ++q) {
    long long s = acc[q];
    for (int o = width >> 1; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
    }
    if (live[q] && (threadIdx.x & (width - 1)) == 0 && s != 0) {
      atomicAdd(sc.sums + static_cast<size_t>(k) * wsum + widx[q],
                static_cast<unsigned long long>(s));
    }
  }
}

__global__ void finish_kernel(Scratch sc, int* __restrict__ count_out,
                              float* __restrict__ xthx,
                              float* __restrict__ xtg, int m1, int d) {
  const int d1 = d + 1;
  const int per = d1 * d1 + d1;
  const int w = d1 * (d1 + 1) / 2 + d1;
  const size_t total = static_cast<size_t>(m1) * per;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       idx < total; idx += stride) {
    const int node = static_cast<int>(idx / per);
    const int rem = static_cast<int>(idx - static_cast<size_t>(node) * per);
    const int count = sc.counts[node];
    const int lg = lg_of(count);
    const unsigned* xm = sc.xmax + static_cast<size_t>(node) * d1;
    const unsigned long long* sums = sc.sums + static_cast<size_t>(node) * w;
    if (rem == 0) count_out[node] = count;
    if (rem < d1 * d1) {
      const int i = rem / d1, j = rem - i * d1;
      const int a = min(i, j), b = max(i, j);
      const int k = scale_of(lg, exponent_of(sc.hmax[node]),
                             exponent_of(xm[a]), exponent_of(xm[b]));
      xthx[static_cast<size_t>(node) * d1 * d1 + rem] = lgbt::fixed_result(
          static_cast<long long>(sums[tri(a, b, d1)]), lgbt::fixed_inv(k));
    } else {
      const int i = rem - d1 * d1;
      const int k = scale_of(lg, exponent_of(sc.gmax[node]),
                             exponent_of(xm[i]), 0);
      xtg[static_cast<size_t>(node) * d1 + i] = lgbt::fixed_result(
          static_cast<long long>(sums[d1 * (d1 + 1) / 2 + i]),
          lgbt::fixed_inv(k));
    }
  }
}

// ---- L2

// the z that one add stands for, by code: 0 -> -0 (adds nothing), 1 -> +0,
// 2 -> NaN
__device__ __forceinline__ float zero_of(unsigned code) {
  return code == 0u ? -0.0f
                    : code == 1u ? 0.0f : __uint_as_float(0x7fc00000u);
}

// A warp a leaf: hdr[k] = (const bits, leaf_value bits, nf | tail code <<
// kCodeShift, first entry); ent[first + a] = (column | run code <<
// kCodeShift, coeff bits) of its a-th active slot, in slot order, its nf
// entries reserved from *used (the leaves' runs in any order). A run's
// code: 2 if an empty slot's coeff x 0 is NaN, else 1 if one is +0, else 0.
__global__ void __launch_bounds__(kThreads)
model_kernel(const float* __restrict__ leaf_value,
             const float* __restrict__ lconst,
             const float* __restrict__ coeff, const int* __restrict__ feat,
             int4* __restrict__ hdr, int2* __restrict__ ent,
             int* __restrict__ used, int m1, int d) {
  const int k = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (k >= m1) return;
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(k) * d;
  int nf = 0;
  for (int s = lane; s < d; s += 32) nf += feat[row + s] >= 0 ? 1 : 0;
  nf = __reduce_add_sync(0xffffffffu, nf);
  int first = lane == 0 && nf > 0 ? atomicAdd(used, nf) : 0;
  first = __shfl_sync(0xffffffffu, first, 0);
  int done = 0;
  bool run_plus = false, run_nan = false;   // since the last active slot
  for (int s0 = 0; s0 < d; s0 += 32) {
    const int s = s0 + lane;
    const bool in = s < d;
    const int fc = in ? feat[row + s] : -1;
    const float c = in ? coeff[row + s] : 0.f;
    const bool act = in && fc >= 0;
    const float z = __fmul_rn(c, 0.0f);    // an empty slot's product
    const unsigned am = __ballot_sync(0xffffffffu, act);
    const unsigned pm = __ballot_sync(
        0xffffffffu, in && !act && !isnan(z) && !signbit(z));
    const unsigned nm = __ballot_sync(0xffffffffu, in && !act && isnan(z));
    if (act) {
      const unsigned below = (1u << lane) - 1u;
      const unsigned prev = am & below;
      // the empty slots since the previous active one of this group
      const unsigned run =
          prev ? below & ~((2u << (31 - __clz(prev))) - 1u) : below;
      const bool nan = (nm & run) != 0u || (prev == 0u && run_nan);
      const bool plus = (pm & run) != 0u || (prev == 0u && run_plus);
      const int code = nan ? 2 : plus ? 1 : 0;
      ent[first + done + __popc(prev)] =
          make_int2(fc | (code << kCodeShift), __float_as_int(c));
    }
    if (am != 0u) {
      const unsigned after = ~((2u << (31 - __clz(am))) - 1u);
      run_nan = (nm & after) != 0u;
      run_plus = (pm & after) != 0u;
    } else {
      run_nan = run_nan || nm != 0u;
      run_plus = run_plus || pm != 0u;
    }
    done += __popc(am);
  }
  if (lane == 0) {
    const int code = run_nan ? 2 : run_plus ? 1 : 0;
    hdr[k] = make_int4(__float_as_int(lconst[k]),
                       __float_as_int(leaf_value[k]),
                       nf | (code << kCodeShift), first);
  }
}

__global__ void __launch_bounds__(kThreads)
values_kernel(const float* __restrict__ raw, const int* __restrict__ leaf,
              const int4* __restrict__ hdr_g, const int2* __restrict__ ent_g,
              const int* __restrict__ used, float* __restrict__ out, int n,
              int f, int m1, int model_bytes, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  // [model_bytes: headers [m1] int4, then the compact entries] [tile]
  int4* hdr_s = reinterpret_cast<int4*>(smem);
  const int hdr_bytes = m1 * 16;
  int2* ent_s = reinterpret_cast<int2*>(smem + hdr_bytes);
  float* tile = reinterpret_cast<float*>(smem + model_bytes);
  const bool hdr_here = hdr_bytes <= model_bytes;
  bool ent_here = false;
  // tile t: rows t kTileRows.., contiguous words of raw, loaded a tile
  // ahead into registers, 16 bytes a load (r0 f is a multiple of 4)
  const int ntiles = (n + kTileRows - 1) / kTileRows;
  float4 pre[kVec];
  float tail = 0.f;
  int pleaf = -1;
  auto fetch = [&](int t) {
    const int r0 = t * kTileRows;
    const int rows = min(kTileRows, n - r0);
    pleaf = threadIdx.x < rows ? leaf[r0 + threadIdx.x] : -1;
    if (!staged) return;
    const int words = rows * f;
    const float* base = raw + static_cast<size_t>(r0) * f;
    const float4* b4 = reinterpret_cast<const float4*>(base);
#pragma unroll
    for (int s = 0; s < kVec; ++s) {
      const int i = threadIdx.x + s * kThreads;
      pre[s] = i < words / 4 ? __ldcs(b4 + i) : make_float4(0, 0, 0, 0);
    }
    tail = threadIdx.x < words % 4 ? __ldcs(base + words / 4 * 4 +
                                              threadIdx.x) : 0.f;
  };
  if (blockIdx.x < ntiles) fetch(blockIdx.x);   // in flight meanwhile
  if (hdr_here) {   // the headers and the entries, both contiguous
    for (int k = threadIdx.x; k < m1; k += kThreads) hdr_s[k] = hdr_g[k];
    const int total = *used;
    ent_here = hdr_bytes + 8 * total <= model_bytes;
    if (ent_here) {
      for (int i = threadIdx.x; i < total; i += kThreads) ent_s[i] = ent_g[i];
    }
    __syncthreads();
  }
  const int4* H = hdr_here ? hdr_s : hdr_g;
  const int2* E = ent_here ? ent_s : ent_g;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int r0 = t * kTileRows;
    const int rows = min(kTileRows, n - r0);
    const int node = pleaf;
    if (staged) {
      const int words = rows * f;
      float4* t4 = reinterpret_cast<float4*>(tile);
#pragma unroll
      for (int s = 0; s < kVec; ++s) {
        const int i = threadIdx.x + s * kThreads;
        if (i < words / 4) t4[i] = pre[s];
      }
      if (threadIdx.x < words % 4) tile[words / 4 * 4 + threadIdx.x] = tail;
      __syncthreads();
    }
    if (t + gridDim.x < ntiles) fetch(t + gridDim.x);
    const int i = threadIdx.x;
    if (i < rows) {
      const int r = r0 + i;
      float res = 0.f;
      if (node >= 0 && node < m1) {
        const int4 h = H[node];
        const float* x =
            staged ? tile + i * f : raw + static_cast<size_t>(r) * f;
        const int nf = h.z & kLowMask;
        const int2* e = E + h.w;
        float acc = __int_as_float(h.x);
        bool nan = false;
        for (int a = 0; a < nf; ++a) {
          const int2 ea = e[a];
          const float v = x[ea.x & kLowMask];
          nan = nan || isnan(v);
          acc = __fadd_rn(acc, zero_of(static_cast<unsigned>(ea.x) >>
                                       kCodeShift));
          acc = __fadd_rn(acc, __fmul_rn(__int_as_float(ea.y), v));
        }
        acc = __fadd_rn(acc, zero_of(static_cast<unsigned>(h.z) >>
                                     kCodeShift));
        res = nan ? __int_as_float(h.y) : acc;
      }
      out[r] = res;
    }
    if (staged) __syncthreads();
  }
}

}  // namespace

// raw [n, f] f32, row_node [n] i32, grad/hess/cnt [n] f32, feat [m1, d]
// i32; scratch: scratch_bytes >= the layout's (carve), 16-byte aligned;
// out: xthx [m1, d+1, d+1] f32, xtg [m1, d+1] f32, count [m1] i32, every
// entry written.
extern "C" int lgbt_linear_gram(const void* raw, const void* row_node,
                                const void* grad, const void* hess,
                                const void* cnt, const void* feat,
                                void* scratch, void* xthx, void* xtg,
                                void* count, int n, int f, int m1, int d,
                                long long scratch_bytes, void* stream) {
  if (m1 <= 0) return cudaSuccess;
  if (d < 1 || d >= kMaxSlots) return cudaErrorInvalidValue;
  Scratch sc = carve(scratch, n, m1, d);
  if (static_cast<size_t>(scratch_bytes) < sc.bytes) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0, sc.zero_bytes, st);
  if (err != cudaSuccess) return err;
  const auto* rn = static_cast<const int*>(row_node);
  const auto* fe = static_cast<const int*>(feat);
  if (n > 0) {
    // two count CTAs an SM: each flushes its tallies with m1 atomics
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    int blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 2 * sms) blocks = 2 * sms;
    const bool shared = m1 <= kMaxSharedNodes;
    count_kernel<<<blocks, kThreads,
                   shared ? static_cast<size_t>(m1) * sizeof(int) : 0,
                   st>>>(rn, sc.ncount, n, m1, shared);
    const int chunks = gram_chunks(n, m1);
    leaves_kernel<<<1, 1024, 0, st>>>(fe, sc, m1, d, chunks);
    // rows staged whole where they are narrow and raw is 16-byte aligned
    const bool staged = f <= kMaxTileCols &&
                        reinterpret_cast<uintptr_t>(raw) % 16 == 0;
    const bool fast = m1 <= kMaxFastNodes;
    const size_t smem =
        (staged ? static_cast<size_t>(kPackThreads) * f * 4 : 0) +
        (fast ? static_cast<size_t>(m1) * 8 : 0);
    err = lgbt::allow_smem(pack_kernel, smem);
    if (err != cudaSuccess) return err;
    pack_kernel<<<(n + kPackRows - 1) / kPackRows, kPackThreads, smem, st>>>(
        static_cast<const float*>(raw), static_cast<const float*>(grad),
        static_cast<const float*>(hess), static_cast<const float*>(cnt), rn,
        sc, n, f, m1, d, fast ? 1 : 0, staged ? 1 : 0);
    maxima_kernel<<<chunks, kPackThreads, 0, st>>>(fe, sc, d);
    sums_kernel<<<chunks, kSumThreads, 0, st>>>(fe, sc, d);
  }
  const size_t total = static_cast<size_t>(m1) * ((d + 1) * (d + 1) + d + 1);
  size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  finish_kernel<<<static_cast<int>(blocks), kThreads, 0, st>>>(
      sc, static_cast<int*>(count), static_cast<float*>(xthx),
      static_cast<float*>(xtg), m1, d);
  return cudaGetLastError();
}

// raw [n, f] f32, leaf [n] i32, leaf_value/lconst [m1] f32, coeff [m1, d]
// f32, feat [m1, d] i32; model: scratch of 16 + m1 (16 + 8 d) bytes,
// 16-byte aligned (the entries' count, the headers, the entries); out [n]
// f32.
extern "C" int lgbt_linear_values(const void* raw, const void* leaf,
                                  const void* leaf_value, const void* lconst,
                                  const void* coeff, const void* feat,
                                  void* model, void* out, int n, int f,
                                  int m1, int d, void* stream) {
  if (n <= 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  auto* used = static_cast<int*>(model);
  auto* hdr = reinterpret_cast<int4*>(static_cast<char*>(model) + 16);
  auto* ent = reinterpret_cast<int2*>(hdr + (m1 > 0 ? m1 : 0));
  cudaError_t err = cudaMemsetAsync(used, 0, sizeof(int), st);
  if (err != cudaSuccess) return err;
  if (m1 > 0) {
    const int per = kThreads / 32;
    model_kernel<<<(m1 + per - 1) / per, kThreads, 0, st>>>(
        static_cast<const float*>(leaf_value),
        static_cast<const float*>(lconst), static_cast<const float*>(coeff),
        static_cast<const int*>(feat), hdr, ent, used, m1, d);
  }
  // rows staged whole where they are narrow and raw is 16-byte aligned
  const bool staged = f <= kMaxTileCols &&
                      reinterpret_cast<uintptr_t>(raw) % 16 == 0;
  const size_t want = static_cast<size_t>(m1 > 0 ? m1 : 0) * (16 + 8 * d);
  const size_t model_bytes =
      (want < static_cast<size_t>(kModelBytes) ? want : kModelBytes) / 16 *
      16;
  const size_t smem =
      model_bytes + (staged ? static_cast<size_t>(kTileRows) * f * 4 : 0);
  err = lgbt::allow_smem(values_kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, values_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (n + kTileRows - 1) / kTileRows;
  int grid = (per_sm > 0 ? per_sm : 1) * sms;
  if (grid > ntiles) grid = ntiles;
  values_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(raw), static_cast<const int*>(leaf), hdr,
      ent, used, static_cast<float*>(out), n, f, m1,
      static_cast<int>(model_bytes), staged ? 1 : 0);
  return cudaGetLastError();
}
