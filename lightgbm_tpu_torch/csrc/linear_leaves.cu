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
// Design (one C entry, seven launches on the caller's stream):
//  0. cudaMemsetAsync of the scratch and the count output;
//  1. count the rows of each node (shared-memory tallies a CTA);
//  2. one CTA scans the counts into row offsets and chunk offsets (a chunk
//     is kChunk rows of one node);
//  3. place each row's index at its node's next position (atomicAdd on a
//     cursor: the order within a node varies, the sums do not);
//  4. maxima: a CTA a chunk of one leaf, each warp reduces its rows'
//     |x| bit patterns slot by slot (a non-negative float's bits order as
//     its value, a NaN's above +inf), then one atomicMax a slot;
//  5. sums: a CTA a chunk of one leaf, kSumThreads threads each owning up
//     to two (i <= j) entries of the leaf's active slots (or an X'g
//     entry), rows staged kBatch at a time in shared memory, each entry
//     summed in a register, one int64 atomicAdd an entry a CTA;
//  6. finish: every [D+1, D+1] and [D+1] entry of every node scaled back
//     to f32, the upper triangle mirrored.
// Bound on this card: bytes (raw read once for the maxima and once for the
// sums, 112 MB at 1M x 28, plus the row vectors); the float64 products,
// 1M rows x 464 entries at the main path's 28 slots, are ~0.03 ms at the
// card's float64 rate.
//
// L2: a thread a row: acc = const[leaf], then for each of the D slots in
// ascending order acc = acc + coeff x x (x = 0 in an empty slot), each f32
// op rounded on its own (__fmul_rn, __fadd_rn); leaf_value[leaf] where a
// model feature is NaN; 0 for a node out of range.
#include "route_hist.cuh"

namespace {

constexpr int kChunk = 1024;        // rows of one node a CTA of 4 and 5 takes
constexpr int kThreads = 256;       // count, place, maxima, finish, values
constexpr int kSumThreads = 512;
constexpr int kBatch = 64;          // rows staged at once by the sums kernel
constexpr int kMaxSlots = 32;       // 31 features and the intercept
constexpr int kEntries = 2;         // entries a sums thread owns
constexpr int kGramBits = 61;
constexpr int kMaxSharedNodes = 12288;   // count tallies: 48 KB a CTA

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

// The scratch's layout (learner/linear.py gram_scratch_bytes)
struct Scratch {
  int* counts;      // [m1] rows of each node
  int* cursor;      // [m1]
  int* offsets;     // [m1 + 1] first position of each node's rows
  int* chunk_off;   // [m1 + 1] first chunk of each node
  int* perm;        // [n] row indices grouped by node
  unsigned* xmax;   // [m1, d1] max |x| bits of each slot
  unsigned* hmax;   // [m1]
  unsigned* gmax;   // [m1]
  unsigned long long* sums;   // [m1, w] int64: the triangle, then X'g
  size_t bytes;
};

__host__ __device__ inline size_t gram_bytes(int n, int m1, int d) {
  const size_t d1 = d + 1;
  const size_t words32 = 4 * (size_t)m1 + 2 + n + m1 * d1 + 2 * (size_t)m1;
  const size_t head = (words32 * 4 + 7) / 8 * 8;
  return head + (size_t)m1 * (d1 * (d1 + 1) / 2 + d1) * 8;
}

Scratch carve(void* base, int n, int m1, int d) {
  Scratch s;
  int* p = static_cast<int*>(base);
  s.counts = p;
  s.cursor = p + m1;
  s.offsets = p + 2 * m1;
  s.chunk_off = p + 3 * m1 + 1;
  s.perm = p + 4 * m1 + 2;
  s.xmax = reinterpret_cast<unsigned*>(s.perm + n);
  s.hmax = s.xmax + (size_t)m1 * (d + 1);
  s.gmax = s.hmax + m1;
  const size_t words32 =
      4 * (size_t)m1 + 2 + n + (size_t)m1 * (d + 1) + 2 * (size_t)m1;
  const size_t head = (words32 * 4 + 7) / 8 * 8;
  s.sums = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(base) + head);
  s.bytes = gram_bytes(n, m1, d);
  return s;
}

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

// one CTA of 1024 threads: exclusive scans of the counts and of the
// chunks of each node, tile by tile with a carry
__global__ void scan_kernel(const int* __restrict__ counts,
                            int* __restrict__ offsets,
                            int* __restrict__ chunk_off, int m1) {
  __shared__ int sa[1024];
  __shared__ int sb[1024];
  __shared__ int carry[2];
  const int t = threadIdx.x;
  if (t == 0) carry[0] = carry[1] = 0;
  __syncthreads();
  for (int base = 0; base < m1; base += 1024) {
    const int j = base + t;
    const int c = j < m1 ? counts[j] : 0;
    const int ch = (c + kChunk - 1) / kChunk;
    sa[t] = c;
    sb[t] = ch;
    __syncthreads();
    for (int off = 1; off < 1024; off <<= 1) {
      const int a = t >= off ? sa[t - off] : 0;
      const int b = t >= off ? sb[t - off] : 0;
      __syncthreads();
      sa[t] += a;
      sb[t] += b;
      __syncthreads();
    }
    if (j < m1) {
      offsets[j] = carry[0] + sa[t] - c;
      chunk_off[j] = carry[1] + sb[t] - ch;
    }
    __syncthreads();
    if (t == 1023) {
      carry[0] += sa[t];
      carry[1] += sb[t];
    }
    __syncthreads();
  }
  if (t == 0) {
    offsets[m1] = carry[0];
    chunk_off[m1] = carry[1];
  }
}

__global__ void place_kernel(const int* __restrict__ row_node,
                             const int* __restrict__ offsets,
                             int* __restrict__ cursor, int* __restrict__ perm,
                             int n, int m1) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int node = row_node[i];
    if (node < 0 || node >= m1) continue;
    perm[offsets[node] + atomicAdd(cursor + node, 1)] = i;
  }
}

// the node and row range [lo, hi) of chunk b; node -1 past the last chunk
__device__ void chunk_rows(const int* __restrict__ offsets,
                           const int* __restrict__ chunk_off, int m1, int b,
                           int* node, int* lo, int* hi) {
  if (b >= chunk_off[m1]) {
    *node = -1;
    return;
  }
  int a = 0, z = m1 - 1;   // the last node whose first chunk is <= b
  while (a < z) {
    const int mid = (a + z + 1) / 2;
    if (chunk_off[mid] <= b) {
      a = mid;
    } else {
      z = mid - 1;
    }
  }
  *node = a;
  *lo = offsets[a] + (b - chunk_off[a]) * kChunk;
  *hi = min(*lo + kChunk, offsets[a + 1]);
}

// whether row r enters its leaf's fit (feature columns of the leaf's d
// slots in fcol, -1 empty), and its slots' values
__device__ __forceinline__ bool usable_row(const float* __restrict__ raw,
                                           const float* __restrict__ cnt,
                                           const int* fcol, int d, int f,
                                           int r) {
  if (!(cnt[r] > 0.f)) return false;
  const float* row = raw + static_cast<size_t>(r) * f;
  for (int s = 0; s < d; ++s) {
    if (fcol[s] >= 0 && isnan(row[fcol[s]])) return false;
  }
  return true;
}

__global__ void maxima_kernel(const float* __restrict__ raw,
                              const float* __restrict__ grad,
                              const float* __restrict__ hess,
                              const float* __restrict__ cnt,
                              const int* __restrict__ feat, Scratch sc,
                              int* __restrict__ count_out, int f, int m1,
                              int d) {
  __shared__ int fcol[kMaxSlots];
  __shared__ unsigned smax[kMaxSlots + 2];   // d slots, intercept, h, g
  __shared__ int sn;
  __shared__ int range[3];
  if (threadIdx.x == 0) {
    chunk_rows(sc.offsets, sc.chunk_off, m1, blockIdx.x, range, range + 1,
               range + 2);
    sn = 0;
  }
  if (threadIdx.x < kMaxSlots + 2) smax[threadIdx.x] = 0u;
  __syncthreads();
  const int node = range[0];
  if (node < 0) return;
  if (threadIdx.x < d) fcol[threadIdx.x] = feat[node * d + threadIdx.x];
  __syncthreads();
  const int lo = range[1], hi = range[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int base = lo + warp * 32; base < hi; base += warps * 32) {
    const int p = base + lane;
    int r = -1;
    bool ok = false;
    if (p < hi) {
      r = sc.perm[p];
      ok = usable_row(raw, cnt, fcol, d, f, r);
    }
    const unsigned okm = __ballot_sync(0xffffffffu, ok);
    if (okm == 0u) continue;
    const float* row = raw + static_cast<size_t>(ok ? r : 0) * f;
    for (int s = 0; s < d; ++s) {
      if (fcol[s] < 0) continue;       // uniform across the warp
      const unsigned w =
          __reduce_max_sync(0xffffffffu, ok ? abs_bits(row[fcol[s]]) : 0u);
      if (lane == 0 && w != 0u) atomicMax(smax + s, w);
    }
    const unsigned wh =
        __reduce_max_sync(0xffffffffu, ok ? abs_bits(hess[r]) : 0u);
    const unsigned wg =
        __reduce_max_sync(0xffffffffu, ok ? abs_bits(grad[r]) : 0u);
    if (lane == 0) {
      atomicMax(smax + d, __float_as_uint(1.0f));
      if (wh != 0u) atomicMax(smax + d + 1, wh);
      if (wg != 0u) atomicMax(smax + d + 2, wg);
      atomicAdd(&sn, __popc(okm));
    }
  }
  __syncthreads();
  const int d1 = d + 1;
  if (threadIdx.x < d1 && smax[threadIdx.x] != 0u) {
    atomicMax(sc.xmax + static_cast<size_t>(node) * d1 + threadIdx.x,
              smax[threadIdx.x]);
  }
  if (threadIdx.x == d1 && smax[d1] != 0u) atomicMax(sc.hmax + node, smax[d1]);
  if (threadIdx.x == d1 + 1 && smax[d1 + 1] != 0u) {
    atomicMax(sc.gmax + node, smax[d1 + 1]);
  }
  if (threadIdx.x == 0 && sn != 0) atomicAdd(count_out + node, sn);
}

__global__ void __launch_bounds__(kSumThreads)
sums_kernel(const float* __restrict__ raw, const float* __restrict__ grad,
            const float* __restrict__ hess, const float* __restrict__ cnt,
            const int* __restrict__ feat, Scratch sc,
            const int* __restrict__ count_out, int f, int m1, int d) {
  __shared__ int slot[kMaxSlots];   // active slots in order, then d
  __shared__ int fcol[kMaxSlots];   // their feature columns (-1: intercept)
  __shared__ int dcol[kMaxSlots];   // feat[node, :] as it is
  __shared__ int nact_s;
  __shared__ int range[3];
  __shared__ float xs[kBatch][kMaxSlots + 1];
  __shared__ float hs[kBatch], gs[kBatch];
  __shared__ unsigned char oks[kBatch];
  if (threadIdx.x == 0) {
    chunk_rows(sc.offsets, sc.chunk_off, m1, blockIdx.x, range, range + 1,
               range + 2);
  }
  __syncthreads();
  const int node = range[0];
  if (node < 0) return;
  if (threadIdx.x < d) dcol[threadIdx.x] = feat[node * d + threadIdx.x];
  __syncthreads();
  if (threadIdx.x == 0) {
    int a = 0;
    for (int s = 0; s < d; ++s) {
      if (dcol[s] >= 0) {
        slot[a] = s;
        fcol[a] = dcol[s];
        ++a;
      }
    }
    slot[a] = d;
    fcol[a] = -1;
    nact_s = a + 1;
  }
  __syncthreads();
  const int nact = nact_s;
  const int d1 = d + 1;
  const int pairs = nact * (nact + 1) / 2;
  const int total = pairs + nact;
  const int w = d1 * (d1 + 1) / 2 + d1;
  const int lg = lg_of(count_out[node]);
  const int eh = exponent_of(sc.hmax[node]);
  const int eg = exponent_of(sc.gmax[node]);
  const unsigned* xm = sc.xmax + static_cast<size_t>(node) * d1;
  // the owned entries: compact slots (a, b), a <= b, or an X'g entry (a,
  // b = -1); their sums' index, scale factor and accumulator
  int ea[kEntries], eb[kEntries], widx[kEntries];
  double mul[kEntries];
  long long acc[kEntries];
  bool live[kEntries];
  for (int q = 0; q < kEntries; ++q) {
    const int e = threadIdx.x + q * kSumThreads;
    live[q] = false;
    acc[q] = 0;
    ea[q] = eb[q] = widx[q] = 0;
    mul[q] = 0.0;
    if (e >= total) continue;
    int k;
    if (e < pairs) {
      int a = 0, rem = e;
      while (rem >= nact - a) {
        rem -= nact - a;
        ++a;
      }
      const int b = a + rem;
      ea[q] = a;
      eb[q] = b;
      widx[q] = tri(slot[a], slot[b], d1);
      k = scale_of(lg, eh, exponent_of(xm[slot[a]]),
                   exponent_of(xm[slot[b]]));
    } else {
      const int a = e - pairs;
      ea[q] = a;
      eb[q] = -1;
      widx[q] = d1 * (d1 + 1) / 2 + slot[a];
      k = scale_of(lg, eg, exponent_of(xm[slot[a]]), 0);
    }
    if (k == lgbt::kNonFinite) continue;   // the result is NaN anyway
    live[q] = true;
    mul[q] = ldexp(1.0, k);
  }
  const int lo = range[1], hi = range[2];
  for (int base = lo; base < hi; base += kBatch) {
    const int nb = min(kBatch, hi - base);
    for (int t = threadIdx.x; t < nb * nact; t += blockDim.x) {
      const int rr = t / nact, a = t - rr * nact;
      const int r = sc.perm[base + rr];
      xs[rr][a] = fcol[a] >= 0 ? raw[static_cast<size_t>(r) * f + fcol[a]]
                               : 1.0f;
    }
    for (int t = threadIdx.x; t < nb; t += blockDim.x) {
      const int r = sc.perm[base + t];
      hs[t] = hess[r];
      gs[t] = grad[r];
      oks[t] = cnt[r] > 0.f;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < nb; t += blockDim.x) {
      bool ok = oks[t] != 0;
      for (int a = 0; a + 1 < nact; ++a) ok = ok && !isnan(xs[t][a]);
      oks[t] = ok;
    }
    __syncthreads();
    for (int q = 0; q < kEntries; ++q) {
      if (!live[q]) continue;
      const int a = ea[q], b = eb[q];
      long long s = acc[q];
      const double m = mul[q];
      for (int rr = 0; rr < nb; ++rr) {
        if (!oks[rr]) continue;
        const double xa = static_cast<double>(xs[rr][a]);
        const double v =
            b >= 0 ? __dmul_rn(__dmul_rn(static_cast<double>(hs[rr]), xa),
                               static_cast<double>(xs[rr][b]))
                   : __dmul_rn(static_cast<double>(gs[rr]), xa);
        s += __double2ll_rn(__dmul_rn(v, m));
      }
      acc[q] = s;
    }
    __syncthreads();
  }
  for (int q = 0; q < kEntries; ++q) {
    if (live[q] && acc[q] != 0) {
      atomicAdd(sc.sums + static_cast<size_t>(node) * w + widx[q],
                static_cast<unsigned long long>(acc[q]));
    }
  }
}

__global__ void finish_kernel(Scratch sc, const int* __restrict__ count_out,
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
    const int lg = lg_of(count_out[node]);
    const unsigned* xm = sc.xmax + static_cast<size_t>(node) * d1;
    const unsigned long long* sums = sc.sums + static_cast<size_t>(node) * w;
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

__global__ void values_kernel(const float* __restrict__ raw,
                              const int* __restrict__ leaf,
                              const float* __restrict__ leaf_value,
                              const float* __restrict__ lconst,
                              const float* __restrict__ coeff,
                              const int* __restrict__ feat,
                              float* __restrict__ out, int n, int f, int m1,
                              int d) {
  const int stride = gridDim.x * blockDim.x;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n; r += stride) {
    const int node = leaf[r];
    if (node < 0 || node >= m1) {
      out[r] = 0.f;
      continue;
    }
    const float* row = raw + static_cast<size_t>(r) * f;
    const int* fr = feat + static_cast<size_t>(node) * d;
    const float* cr = coeff + static_cast<size_t>(node) * d;
    float acc = lconst[node];
    bool nan = false;
    for (int s = 0; s < d; ++s) {
      const int fi = __ldg(fr + s);
      float x = 0.f;
      if (fi >= 0) {
        x = row[fi];
        nan = nan || isnan(x);
      }
      acc = __fadd_rn(acc, __fmul_rn(__ldg(cr + s), x));
    }
    out[r] = nan ? leaf_value[node] : acc;
  }
}

}  // namespace

// raw [n, f] f32, row_node [n] i32, grad/hess/cnt [n] f32, feat [m1, d]
// i32; scratch: scratch_bytes >= gram_bytes(n, m1, d), 8-byte aligned,
// zeroed here; out: xthx [m1, d+1, d+1] f32, xtg [m1, d+1] f32, count
// [m1] i32, every entry written.
extern "C" int lgbt_linear_gram(const void* raw, const void* row_node,
                                const void* grad, const void* hess,
                                const void* cnt, const void* feat,
                                void* scratch, void* xthx, void* xtg,
                                void* count, int n, int f, int m1, int d,
                                long long scratch_bytes, void* stream) {
  if (m1 <= 0) return cudaSuccess;
  if (d < 1 || d >= kMaxSlots) return cudaErrorInvalidValue;
  if (static_cast<size_t>(scratch_bytes) < gram_bytes(n, m1, d)) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  Scratch sc = carve(scratch, n, m1, d);
  cudaError_t err = cudaMemsetAsync(scratch, 0, sc.bytes, st);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(count, 0, static_cast<size_t>(m1) * sizeof(int), st);
  if (err != cudaSuccess) return err;
  const auto* rn = static_cast<const int*>(row_node);
  const auto* x = static_cast<const float*>(raw);
  const auto* g = static_cast<const float*>(grad);
  const auto* h = static_cast<const float*>(hess);
  const auto* c = static_cast<const float*>(cnt);
  const auto* fe = static_cast<const int*>(feat);
  auto* cnt_out = static_cast<int*>(count);
  if (n > 0) {
    int blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 1056) blocks = 1056;
    const bool shared = m1 <= kMaxSharedNodes;
    count_kernel<<<blocks, kThreads,
                   shared ? static_cast<size_t>(m1) * sizeof(int) : 0, st>>>(
        rn, sc.counts, n, m1, shared);
    scan_kernel<<<1, 1024, 0, st>>>(sc.counts, sc.offsets, sc.chunk_off, m1);
    place_kernel<<<blocks, kThreads, 0, st>>>(rn, sc.offsets, sc.cursor,
                                              sc.perm, n, m1);
    // every node's chunks: at most n / kChunk + m1 of them
    const int chunks = n / kChunk + m1 + 1;
    maxima_kernel<<<chunks, kThreads, 0, st>>>(x, g, h, c, fe, sc, cnt_out,
                                               f, m1, d);
    sums_kernel<<<chunks, kSumThreads, 0, st>>>(x, g, h, c, fe, sc, cnt_out,
                                                f, m1, d);
  }
  const size_t total = static_cast<size_t>(m1) * ((d + 1) * (d + 1) + d + 1);
  size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  finish_kernel<<<static_cast<int>(blocks), kThreads, 0, st>>>(
      sc, cnt_out, static_cast<float*>(xthx), static_cast<float*>(xtg), m1, d);
  return cudaGetLastError();
}

// raw [n, f] f32, leaf [n] i32, leaf_value/lconst [m1] f32, coeff [m1, d]
// f32, feat [m1, d] i32; out [n] f32.
extern "C" int lgbt_linear_values(const void* raw, const void* leaf,
                                  const void* leaf_value, const void* lconst,
                                  const void* coeff, const void* feat,
                                  void* out, int n, int f, int m1, int d,
                                  void* stream) {
  if (n <= 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 8192) blocks = 8192;
  values_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(raw), static_cast<const int*>(leaf),
      static_cast<const float*>(leaf_value), static_cast<const float*>(lconst),
      static_cast<const float*>(coeff), static_cast<const int*>(feat),
      static_cast<float*>(out), n, f, m1, d);
  return cudaGetLastError();
}
