// partition_rows: the padded partition of rows by frontier slot that the
// slot-grouped scatter histogram (build_histograms_scatter.cu) reads.
// Every row_block consecutive positions hold rows of one slot, rows in row
// order within a slot; slot s (the trash slot) takes the rows whose slot is
// < 0 or >= s, and the layout's tail. src[p] is the row at position p, n
// where p is padding; block_slot[j] the slot of block j; bounds[k] the
// first block of slot k (bounds[s + 1]: the end of the trash slot's
// blocks). Slot k has max(1, ceil(count_k / row_block)) blocks; TB =
// ceil(n / row_block) + s + 1 blocks bound them all.
//
// Replaces: the partition of lightgbm_tpu/learner/histogram_pallas.py
// (partition_rows, XLA glue before the pallas_call of
// build_histograms_scatter: a stable argsort or blocked prefix sums), and
// the torch version of it (partition_rows_ref in
// learner/histogram_pallas.py: a stable radix sort plus ~15 launches).
// The layout is the same element for element.
//
// Bound on this card: bytes — row_slot read (4 bytes a row), src written
// (4 bytes a position, TB x row_block positions), block_slot and bounds.
// Design: a stable counting sort in three kernels, all sizes from the
// static bound TB, no host sync.
//  1. count: one CTA per chunk of 8 warps x 1024 rows. Each lane loads
//     its 32 rows' slots up front (the loads overlap), then each warp
//     tallies its rows by slot in its own row of shared counters, 32 rows
//     a step:
//     __match_any_sync groups the lanes of one slot and the lowest lane
//     adds the group's size, so no two lanes write one counter and no
//     atomics are needed. The CTA writes its per-slot totals
//     (chunk-major [C, S+1]) and fills its share of src with n (padding).
//  2. plan: one CTA. Per-slot totals (given counts, or the sum of the
//     chunks' tallies), blocks per slot, their exclusive scan (bounds),
//     block_slot, and each chunk's first position per slot: the slot's
//     first position plus the earlier chunks' tallies, a scan in chunk
//     order per slot.
//  3. scatter: one CTA per chunk again. Each warp recounts its rows, the
//     CTA turns the counts into each warp's first position per slot (the
//     chunk's base plus the earlier warps' counts), and each warp walks
//     its rows in order, 32 at a time: a row's rank among the lanes of its
//     slot is the popcount of its group's lanes below it. Rows land in row
//     order within their slot: warps, steps and lanes are all in row
//     order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpRows = 1024;                 // rows a warp takes
constexpr int kChunkRows = kWarps * kWarpRows;  // rows a CTA takes
constexpr int kSteps = kWarpRows / 32;          // 32-row steps a warp takes
constexpr int kPlanThreads = 1024;

// The slots of a warp's rows, 32 rows a step (lane l holds row
// r0 + 32 t + l at step t): all loads issued before any is used. Rows past
// n read -1.
__device__ __forceinline__ void warp_keys(const int* __restrict__ row_slot,
                                          int n, int s, int r0,
                                          int (&keys)[kSteps]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    const int i = r0 + t * 32 + lane;
    int key = -1;
    if (i < n) {
      const int v = row_slot[i];
      key = (v < 0 || v >= s) ? s : v;
    }
    keys[t] = key;
  }
}

// Each warp's per-slot count of its rows, into wcnt[kWarps][s1].
__device__ __forceinline__ void warp_counts(const int (&keys)[kSteps],
                                            int s1, int* wcnt) {
  for (int i = threadIdx.x; i < kWarps * s1; i += blockDim.x) wcnt[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int* mine = wcnt + (threadIdx.x >> 5) * s1;
#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    const unsigned peers = __match_any_sync(0xffffffffu, keys[t]);
    if (keys[t] >= 0 && (__ffs(peers) - 1) == lane) {
      mine[keys[t]] += __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
}

__device__ __forceinline__ int warp_first_row() {
  return blockIdx.x * kChunkRows + (threadIdx.x >> 5) * kWarpRows;
}

__global__ void count_kernel(const int* __restrict__ row_slot, int n, int s,
                             int* __restrict__ chunk_cnt, int* __restrict__ src,
                             long long total) {
  extern __shared__ int wcnt[];
  const int s1 = s + 1;
  int keys[kSteps];
  warp_keys(row_slot, n, s, warp_first_row(), keys);
  warp_counts(keys, s1, wcnt);
  int* row = chunk_cnt + static_cast<size_t>(blockIdx.x) * s1;
  for (int k = threadIdx.x; k < s1; k += blockDim.x) {
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += wcnt[w * s1 + k];
    row[k] = sum;
  }
  // padding everywhere; the scatter overwrites the rows' positions
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  const long long n4 = total / 4;
  const int4 pad = make_int4(n, n, n, n);
  for (long long q = t0; q < n4; q += stride) {
    reinterpret_cast<int4*>(src)[q] = pad;
  }
  for (long long p = n4 * 4 + t0; p < total; p += stride) src[p] = n;
}

// Exclusive scan of x[0..len) in place with one CTA; returns the total.
__device__ int block_exclusive_scan(int* x, int len, int* scratch) {
  const int t = threadIdx.x;
  const int per = (len + blockDim.x - 1) / blockDim.x;
  const int k0 = min(t * per, len);
  const int k1 = min(k0 + per, len);
  int local = 0;
  for (int k = k0; k < k1; ++k) local += x[k];
  scratch[t] = local;
  __syncthreads();
  for (int off = 1; off < blockDim.x; off <<= 1) {
    const int v = t >= off ? scratch[t - off] : 0;
    __syncthreads();
    scratch[t] += v;
    __syncthreads();
  }
  int run = scratch[t] - local;
  const int total = scratch[blockDim.x - 1];
  for (int k = k0; k < k1; ++k) {
    const int c = x[k];
    x[k] = run;
    run += c;
  }
  __syncthreads();
  return total;
}

__global__ void plan_kernel(const int* __restrict__ counts, int* chunk_cnt,
                            int nchunks, int n, int s, int nb, int tb,
                            int* __restrict__ block_slot,
                            int* __restrict__ bounds) {
  extern __shared__ int sh[];
  const int s1 = s + 1;
  int* tot = sh;                       // [s1] rows per slot
  int* start = tot + s1;               // [s1 + 1] first block per slot
  int* scratch = start + s1 + 1;       // [blockDim.x]
  __shared__ int live;
  if (threadIdx.x == 0) live = 0;
  __syncthreads();
  for (int k = threadIdx.x; k < s1; k += blockDim.x) {
    int t = 0;
    if (counts == nullptr) {
#pragma unroll 8
      for (int c = 0; c < nchunks; ++c) t += chunk_cnt[c * s1 + k];
    } else if (k < s) {
      t = counts[k];
      atomicAdd(&live, t);
    }
    tot[k] = t;
  }
  __syncthreads();
  if (counts != nullptr && threadIdx.x == 0) tot[s] = n - live;
  __syncthreads();
  for (int k = threadIdx.x; k < s1; k += blockDim.x) {
    const int caps = (tot[k] + nb - 1) / nb;
    start[k] = caps > 1 ? caps : 1;
  }
  __syncthreads();
  const int end = block_exclusive_scan(start, s1, scratch);
  if (threadIdx.x == 0) start[s1] = end;
  __syncthreads();
  for (int k = threadIdx.x; k <= s1; k += blockDim.x) bounds[k] = start[k];
  // block j: the last slot whose first block is <= j; past the end, s
  for (int j = threadIdx.x; j < tb; j += blockDim.x) {
    int lo = 0, hi = s1;               // start[lo] <= j < start[hi]
    if (j >= end) {
      lo = s;
    } else {
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (start[mid] <= j) lo = mid; else hi = mid;
      }
    }
    block_slot[j] = lo;
  }
  // each chunk's first position per slot, chunks in row order
  for (int k = threadIdx.x; k < s1; k += blockDim.x) {
    int run = start[k] * nb;
#pragma unroll 8
    for (int c = 0; c < nchunks; ++c) {
      const int v = chunk_cnt[c * s1 + k];
      chunk_cnt[c * s1 + k] = run;
      run += v;
    }
  }
}

__global__ void scatter_kernel(const int* __restrict__ row_slot, int n, int s,
                               const int* __restrict__ chunk_base,
                               int* __restrict__ src, long long total) {
  extern __shared__ int wcnt[];
  const int s1 = s + 1;
  int keys[kSteps];
  const int r0 = warp_first_row();
  warp_keys(row_slot, n, s, r0, keys);
  warp_counts(keys, s1, wcnt);
  const int* base = chunk_base + static_cast<size_t>(blockIdx.x) * s1;
  for (int k = threadIdx.x; k < s1; k += blockDim.x) {
    int run = base[k];
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcnt[w * s1 + k];
      wcnt[w * s1 + k] = run;
      run += c;
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int* next = wcnt + (threadIdx.x >> 5) * s1;  // this warp's next position
#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    const int key = keys[t];
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0) {
      const long long pos = static_cast<long long>(next[key]) +
                            __popc(peers & ((1u << lane) - 1u));
      if (pos < total) src[pos] = r0 + t * 32 + lane;
    }
    __syncwarp();
    if (key >= 0 && (__ffs(peers) - 1) == lane) next[key] += __popc(peers);
    __syncwarp();
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// row_slot [n] i32; counts [>= s] i32 rows per slot (parked rows
// excluded) or null (counted here); block_slot [tb] i32, src [tb * nb]
// i32, bounds [s + 2] i32 out; scratch [(ceil(n / 8192) or 1) x (s + 1)]
// i32. tb = ceil(n / nb) + s + 1.
extern "C" int lgbt_partition_rows(const void* row_slot, const void* counts,
                                   void* block_slot, void* src, void* bounds,
                                   void* scratch, int n, int s, int nb,
                                   int tb, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int s1 = s + 1;
  const int nchunks = n > 0 ? (n + kChunkRows - 1) / kChunkRows : 1;
  const long long total = static_cast<long long>(tb) * nb;
  const size_t wbytes = static_cast<size_t>(kWarps) * s1 * sizeof(int);
  const size_t pbytes = (2 * static_cast<size_t>(s1) + 1 + kPlanThreads) *
                        sizeof(int);
  cudaError_t err = allow_smem(count_kernel, wbytes);
  if (err == cudaSuccess) err = allow_smem(scatter_kernel, wbytes);
  if (err == cudaSuccess) err = allow_smem(plan_kernel, pbytes);
  if (err != cudaSuccess) return err;
  int* cnt = static_cast<int*>(scratch);
  count_kernel<<<nchunks, kThreads, wbytes, st>>>(
      static_cast<const int*>(row_slot), n, s, cnt, static_cast<int*>(src),
      total);
  plan_kernel<<<1, kPlanThreads, pbytes, st>>>(
      static_cast<const int*>(counts), cnt, nchunks, n, s, nb, tb,
      static_cast<int*>(block_slot), static_cast<int*>(bounds));
  scatter_kernel<<<nchunks, kThreads, wbytes, st>>>(
      static_cast<const int*>(row_slot), n, s, cnt, static_cast<int*>(src),
      total);
  return cudaGetLastError();
}
