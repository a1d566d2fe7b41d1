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
// Measured on the first version (PERF.md): 123 CTAs for 132 SMs, a plan
// on one CTA (0.015 ms at every width) and the padding written twice.
// Design: a stable counting sort over chunks of kChunkRows rows
// (route_hist.cuh), all sizes from the static bound TB, no host sync:
//  1. count (only without tallies): a CTA per chunk counts its rows per
//     slot in shared memory (route_hist.cuh tally_key) and writes the
//     chunk's column of the slot-major [s + 1, C] tallies. Given the
//     tallies route_rows.cu writes in the same sweep as the routing, this
//     launch does not run.
//  2. plan: a warp per slot scans its row of the tallies with shuffles:
//     each chunk's first position within the slot (an exclusive prefix)
//     and the slot's total. Slot-major tallies make each warp's reads
//     contiguous, and no CTA walks more than its own slots' chunks.
//  3. scatter: a CTA per chunk (or per slot where slots outnumber chunks),
//     in two phases. First, with no result of the plan: 8 warps of 256
//     rows count their rows per slot (route_hist.cuh peers_of groups the
//     lanes of one slot with a ballot per key bit, once a step for both
//     passes; the lowest lane adds the group's size: no atomics), and the
//     CTA stages its rows in shared memory in slot order (a scan of its
//     per-slot counts, each warp's place after the earlier warps', a
//     row's rank among its step's lanes of one slot the popcount of its
//     group's lanes below it). Then, from the plan: the slots' first
//     blocks (each CTA scans the s + 1 totals in shared memory, as cheap
//     as one more read of them); a chunk's rows of one slot are one run of
//     the layout (the slot's first position + the chunk's prefix), so the
//     staged rows go out with neighbouring threads on neighbouring
//     positions. Rows land in row order within their slot: chunks, warps,
//     steps and lanes are all in row order. The same CTAs write block_slot
//     (a binary search of the first blocks), bounds, and n at exactly the
//     positions no row takes: the tail of each slot's last block and the
//     blocks past the end. Every position is written once.
// The plan and the scatter launch behind the kernel before them
// (programmatic dependent launch, griddepcontrol): the plan lets the
// scatter start once the tallies are complete, and the scatter's first
// phase runs while the plan does. Shared memory: count (s + 1) x 4
// bytes, scatter (12 (s + 1) + 4106) x 4 (29 KB at 263 slots); registers
// (ptxas): scatter 63, count 32, plan 30.
#include "route_hist.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpRows = lgbt::kChunkRows / kWarps;  // rows a warp takes
constexpr int kSteps = kWarpRows / 32;                // 32-row steps
constexpr int kScanLoads = 4;                         // plan: loads a lane
                                                      // issues at once
constexpr int kSlotsPerThread = 4;  // scatter: slots a thread keeps, so at
                                    // most 1024 with the trash slot

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

__device__ __forceinline__ int warp_first_row() {
  return blockIdx.x * lgbt::kChunkRows + (threadIdx.x >> 5) * kWarpRows;
}

__global__ void __launch_bounds__(kThreads)
    count_kernel(const int* __restrict__ row_slot, int n, int s, int nchunks,
                 int* __restrict__ tallies) {
  extern __shared__ int cnt[];  // [s + 1]
  for (int k = threadIdx.x; k <= s; k += kThreads) cnt[k] = 0;
  __syncthreads();
  int keys[kSteps];
  warp_keys(row_slot, n, s, warp_first_row(), keys);
  const int bits = lgbt::key_bits(s);
#pragma unroll
  for (int t = 0; t < kSteps; ++t) lgbt::tally_key(cnt, keys[t], bits);
  __syncthreads();
  for (int k = threadIdx.x; k <= s; k += kThreads) {
    tallies[static_cast<size_t>(k) * nchunks + blockIdx.x] = cnt[k];
  }
}

// A warp per slot k <= s: base[k][c] = the rows of slot k in chunks
// before c, totals[k] = all of them.
__global__ void __launch_bounds__(kThreads)
    plan_kernel(const int* __restrict__ tallies, int nchunks, int s,
                int* __restrict__ base, int* __restrict__ totals) {
  // launched behind the tallies' writer: wait for it, then let the scatter
  // kernel start its first phase (its rows' keys, written before that)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;");
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k > s) return;
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(k) * nchunks;
  int carry = 0;
  for (int c0 = 0; c0 < nchunks; c0 += 32 * kScanLoads) {
    int v[kScanLoads];
#pragma unroll
    for (int j = 0; j < kScanLoads; ++j) {
      const int c = c0 + j * 32 + lane;
      v[j] = c < nchunks ? tallies[row + c] : 0;
    }
#pragma unroll
    for (int j = 0; j < kScanLoads; ++j) {
      int x = v[j];  // inclusive scan over the lanes
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      const int c = c0 + j * 32 + lane;
      if (c < nchunks) base[row + c] = carry + x - v[j];
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
  }
  if (lane == 0) totals[k] = carry;
}

// Exclusive scan of x[0, len) in shared memory by the CTA, in place, and
// x[len] = the total: each thread scans a run of consecutive entries, the
// warps' sums meet in wsum (kWarps ints). Syncs.
__device__ __forceinline__ void block_scan(int* x, int len, int* wsum) {
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int per = (len + kThreads - 1) / kThreads;
  const int k0 = min(t * per, len);
  const int k1 = min(k0 + per, len);
  int local = 0;
  for (int k = k0; k < k1; ++k) local += x[k];
  int v = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += y;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  int run = v - local;
  for (int i = 0; i < warp; ++i) run += wsum[i];
  for (int k = k0; k < k1; ++k) {
    const int c = x[k];
    x[k] = run;
    run += c;
  }
  if (t == kThreads - 1) x[len] = run;
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const int* __restrict__ row_slot, int n, int s, int nb,
                   int tb, int nchunks, const int* __restrict__ base,
                   const int* __restrict__ totals, int* __restrict__ src,
                   int* __restrict__ block_slot, int* __restrict__ bounds) {
  extern __shared__ int sh[];
  const int s1 = s + 1;
  int* start = sh;                       // [s1 + 1] first block per slot
  int* tot = start + s1 + 1;             // [s1] rows per slot
  int* loc = tot + s1;                   // [s1 + 1] the chunk's rows, by slot
  int* shift = loc + s1 + 1;             // [s1] position - staged position
  int* wsum = shift + s1;                // [kWarps]
  int* wcnt = wsum + kWarps;             // [kWarps][s1]
  int* stage_row = wcnt + kWarps * s1;   // [kChunkRows]
  int* stage_key = stage_row + lgbt::kChunkRows;  // [kChunkRows]
  const bool rows_here = blockIdx.x < nchunks;
  const int rows = rows_here ? min(lgbt::kChunkRows,
                                   n - blockIdx.x * lgbt::kChunkRows) : 0;

  // 1. before the plan's results: the chunk staged in slot order. Its
  // rows of one slot are one run of the layout, shifted by the slot's
  // first position + the chunk's prefix (known after the plan).
  if (rows_here) {
    const int lane = threadIdx.x & 31;
    const int r0 = warp_first_row();
    int keys[kSteps];
    warp_keys(row_slot, n, s, r0, keys);
    int* mine = wcnt + (threadIdx.x >> 5) * s1;
    for (int i = threadIdx.x; i < kWarps * s1; i += kThreads) wcnt[i] = 0;
    const int bits = lgbt::key_bits(s);
    unsigned peers[kSteps];
#pragma unroll
    for (int t = 0; t < kSteps; ++t) peers[t] = lgbt::peers_of(keys[t], bits);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      if (keys[t] >= 0 && (__ffs(peers[t]) - 1) == lane) {
        mine[keys[t]] += __popc(peers[t]);
      }
      __syncwarp();
    }
    __syncthreads();
    for (int k = threadIdx.x; k < s1; k += kThreads) {
      int c = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) c += wcnt[w * s1 + k];
      loc[k] = c;
    }
    __syncthreads();
    block_scan(loc, s1, wsum);
    for (int k = threadIdx.x; k < s1; k += kThreads) {
      int run = loc[k];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {  // each warp's first staged place
        const int c = wcnt[w * s1 + k];
        wcnt[w * s1 + k] = run;
        run += c;
      }
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      const int key = keys[t];
      if (key >= 0) {
        const int q = mine[key] + __popc(peers[t] & ((1u << lane) - 1u));
        stage_row[q] = r0 + t * 32 + lane;
        stage_key[q] = key;
      }
      __syncwarp();
      if (key >= 0 && (__ffs(peers[t]) - 1) == lane) {
        mine[key] += __popc(peers[t]);
      }
      __syncwarp();
    }
  }

  // 2. the plan's results (launched behind the plan: wait for it here)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  int prefix[kSlotsPerThread];  // the chunk's prefix of slot tid + 256 j
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {
    const int k = threadIdx.x + j * kThreads;
    prefix[j] = rows_here && k < s1
                    ? base[static_cast<size_t>(k) * nchunks + blockIdx.x]
                    : 0;
  }
  // the slots' first blocks: an exclusive scan of max(1, ceil(total / nb))
  for (int k = threadIdx.x; k < s1; k += kThreads) {
    const int c = totals[k];
    const int caps = (c + nb - 1) / nb;
    tot[k] = c;
    start[k] = caps > 1 ? caps : 1;
  }
  __syncthreads();
  block_scan(start, s1, wsum);
  const int end = start[s1];
  if (rows_here) {
#pragma unroll
    for (int j = 0; j < kSlotsPerThread; ++j) {
      const int k = threadIdx.x + j * kThreads;
      if (k < s1) shift[k] = start[k] * nb + prefix[j] - loc[k];
    }
    __syncthreads();
    // runs written together: neighbouring threads, neighbouring positions
    for (int i = threadIdx.x; i < rows; i += kThreads) {
      src[i + shift[stage_key[i]]] = stage_row[i];
    }
  }

  // block j: the last slot whose first block is <= j; past the end, s
  const int gt = blockIdx.x * kThreads + threadIdx.x;
  const int gstride = gridDim.x * kThreads;
  for (int j = gt; j < tb; j += gstride) {
    int lo = s;
    if (j < end) {
      lo = 0;
      int hi = s1;                   // start[lo] <= j < start[hi]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (start[mid] <= j) lo = mid; else hi = mid;
      }
    }
    block_slot[j] = lo;
  }
  if (blockIdx.x == 0) {
    for (int k = threadIdx.x; k <= s1; k += kThreads) bounds[k] = start[k];
  }
  // padding: the tail of each slot's last block, then past the end
  for (int k = blockIdx.x; k < s1; k += gridDim.x) {
    const int p1 = start[k + 1] * nb;
    for (int p = start[k] * nb + tot[k] + threadIdx.x; p < p1; p += kThreads) {
      src[p] = n;
    }
  }
  const int total = tb * nb;
  for (int p = end * nb + gt; p < total; p += gstride) src[p] = n;
}

}  // namespace

// row_slot [n] i32; tallies [s + 1, C] i32, C = max(1, ceil(n /
// kChunkRows)): the rows of each slot in each chunk (route_rows.cu's
// tally mode; slot s: rows whose slot is < 0 or >= s), or null: counted
// here; block_slot [tb] i32, src [tb * nb] i32, bounds [s + 2] i32 out;
// scratch [(s + 1) (2 C + 1)] i32: the chunks' first positions per slot,
// the slots' totals and the tallies counted here. tb = ceil(n / nb) +
// s + 1, tb * nb < 2^31.
extern "C" int lgbt_partition_rows(const void* row_slot, const void* tallies,
                                   void* block_slot, void* src, void* bounds,
                                   void* scratch, int n, int s, int nb,
                                   int tb, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int s1 = s + 1;
  if (s1 > kThreads * kSlotsPerThread) return cudaErrorInvalidValue;
  const int nchunks =
      n > 0 ? (n + lgbt::kChunkRows - 1) / lgbt::kChunkRows : 1;
  const size_t cells = static_cast<size_t>(s1) * nchunks;
  int* base = static_cast<int*>(scratch);
  int* totals = base + cells;
  const int* tally = static_cast<const int*>(tallies);
  cudaError_t err;
  if (tally == nullptr) {
    int* own = totals + s1;
    const size_t cbytes = static_cast<size_t>(s1) * sizeof(int);
    err = lgbt::allow_smem(count_kernel, cbytes);
    if (err != cudaSuccess) return err;
    count_kernel<<<nchunks, kThreads, cbytes, st>>>(
        static_cast<const int*>(row_slot), n, s, nchunks, own);
    tally = own;
  }
  // the plan and the scatter kernel launch behind the kernel before each
  // (programmatic dependent launch) and wait for it where they read its
  // results: their launch and the scatter's first phase overlap it
  cudaLaunchAttribute behind;
  behind.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  behind.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = &behind;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3((s1 + kWarps - 1) / kWarps);
  err = cudaLaunchKernelEx(&cfg, plan_kernel, tally, nchunks, s, base,
                           totals);
  if (err != cudaSuccess) return err;
  const size_t sbytes = (static_cast<size_t>(kWarps + 4) * s1 + 2 + kWarps +
                        2 * lgbt::kChunkRows) * sizeof(int);
  err = lgbt::allow_smem(scatter_kernel, sbytes);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3(nchunks > s1 ? nchunks : s1);
  cfg.dynamicSmemBytes = sbytes;
  err = cudaLaunchKernelEx(&cfg, scatter_kernel,
                           static_cast<const int*>(row_slot), n, s, nb, tb,
                           nchunks, static_cast<const int*>(base),
                           static_cast<const int*>(totals),
                           static_cast<int*>(src),
                           static_cast<int*>(block_slot),
                           static_cast<int*>(bounds));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
