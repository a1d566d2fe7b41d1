// build_histograms_scatter: per-slot (grad, hess, count) histograms over
// rows partitioned by slot — every row_block consecutive positions of the
// partition (partition_rows.cu) hold rows of one slot, so a block of them
// adds into one slot's cells only.
//
// Replaces: lightgbm_tpu/learner/histogram_pallas.py,
// build_histograms_scatter (pallas_call in _scatter_kernel). The TPU
// kernel gathers the partitioned rows into a padded copy of the bin matrix
// and contracts each block's [8, row_block] channel matrix with its
// (feature, bin) one-hots on the MXU, accumulating a slot's [8, F*B] block
// in VMEM across its consecutive blocks. This kernel keeps that shape:
// a CTA walks consecutive blocks of one slot and owns the cells it writes.
//
// Bound on this card: bytes — the partition (src, 4 bytes a position) and,
// for every slotted row, its bins and gradient channels, read through src
// straight from the bin matrix (no padded copy is written); one write of
// the [S, F, B, 3] f32 histogram.
// Design: runs. Slot k's blocks [bounds[k], bounds[k+1]) are cut from the
// slot's first block into runs of at most run_blocks blocks (the rule of
// scatter_runs in learner/histogram_pallas.py). Grid (block, feature
// group): the CTA of a run's first block takes the run and a group of
// features whose cells fit a shared-memory budget (several CTAs an SM);
// every other CTA returns at once. It zeroes its cells and adds each
// block's rows with shared-memory atomics, a thread a row: the row's
// gradient channels are read once, its bins feature after feature from a
// start that differs from lane to lane, so the lanes of a warp seldom add
// into one cell at the same step; then:
//  - a run that is its whole slot writes the final f32 cells of the
//    output with plain stores (no zeroed buffer, no global atomics);
//  - a run of a split slot (more than run_blocks blocks) writes its cells
//    to a partial; a second kernel adds a split slot's partials in run
//    order, so the sums do not depend on scheduling, and writes the slot.
// f32 mode: a block's rows add into f32 cells (at most row_block rows a
// cell), which are added into float64 cells after every block and zeroed;
// the float64 sums are rounded to f32 once (the reference's double
// hist_t). Within a block the f32 atomics' order varies, so the last bits
// may vary from run to run. Integer mode: int8 gradients into int32 cells
// and the count's f32 bits in the same cell word, across the whole run,
// exact and order-free. const_hess != 0: the hessian channel is skipped
// and written as const x count. Unpacked or 4-bit packed bins.
#include "route_hist.cuh"

namespace {

constexpr int kHistThreads = 1024;               // a row a thread a block
constexpr size_t kGroupSmemBytes = 100 * 1024;  // two CTAs an SM
constexpr int kReduceThreads = 256;

// Final f32 value of channel chan of a cell from its raw sums: float64
// rounded once, or an integer sum (gradient channels) and f32 bits
// (count); with const_hess, the hessian is const_hess x the f32 count.
__device__ __forceinline__ float finish(const double* cell, int chan,
                                        float const_hess) {
  if (chan == 1 && const_hess != 0.0f) {
    return static_cast<float>(cell[2]) * const_hess;
  }
  return static_cast<float>(cell[chan]);
}
__device__ __forceinline__ float finish(const int* cell, int chan,
                                        float const_hess) {
  if (chan == 1 && const_hess != 0.0f) {
    return __int_as_float(cell[2]) * const_hess;
  }
  return chan == 2 ? __int_as_float(cell[2]) : static_cast<float>(cell[chan]);
}

// Acc: the block cell type (float or int); Run: the run cell type (double
// or int; int mode keeps one set of cells).
template <typename In, typename Acc, typename Run, bool kPacked>
__global__ void scatter_hist_kernel(
    const uint8_t* __restrict__ bins, const In* __restrict__ grad,
    const In* __restrict__ hess, const float* __restrict__ cnt,
    const int* __restrict__ block_slot, const int* __restrict__ src,
    const int* __restrict__ bounds, float* __restrict__ out,
    Run* __restrict__ part, int n, int f, int fh, int b, int s, int nb,
    int run_blocks, int fgroup, float const_hess) {
  constexpr bool kF32 = sizeof(Run) == 8;
  const int j0 = blockIdx.x;
  const int slot = block_slot[j0];
  if (slot >= s) return;                          // trash slot
  const int first = bounds[slot];
  const int last = bounds[slot + 1];
  if ((j0 - first) % run_blocks != 0) return;     // not a run's first block
  const int j1 = min(j0 + run_blocks, last);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int f0 = blockIdx.y * fgroup;
  const int fc = min(fgroup, f - f0);
  const int ncell = fc * b * 3;
  Run* run = reinterpret_cast<Run*>(smem_raw);              // [fc, b, 3]
  Acc* cells = kF32 ? reinterpret_cast<Acc*>(run + ncell)
                    : reinterpret_cast<Acc*>(run);
  for (int i = threadIdx.x; i < ncell; i += blockDim.x) {
    cells[i] = Acc(0);
    if (kF32) run[i] = Run(0);
  }
  __syncthreads();

  const int rs = lgbt::row_stride(f, fh);
  const bool skip_hess = const_hess != 0.0f;
  // each lane starts at its own feature: the lanes of a warp add into
  // different features' cells at a step (bins repeat across rows)
  const int jstart = (threadIdx.x & 31) % fc;
  for (int j = j0; j < j1; ++j) {
    const int* blk_src = src + static_cast<size_t>(j) * nb;
    for (int p = threadIdx.x; p < nb; p += blockDim.x) {
      const int r = blk_src[p];
      if (r >= n) continue;                       // layout padding
      const Acc g = static_cast<Acc>(grad[r]);
      const Acc h = skip_hess ? Acc(0) : static_cast<Acc>(hess[r]);
      const float c = cnt[r];
      const uint8_t* row = bins + static_cast<size_t>(r) * rs;
      int jf = jstart;
      for (int t = 0; t < fc; ++t) {
        const int bin = lgbt::read_bin<kPacked>(row, f0 + jf, fh);
        if (bin < b) {
          Acc* cell = cells + (jf * b + bin) * 3;
          atomicAdd(cell, g);
          if (!skip_hess) atomicAdd(cell + 1, h);
          atomicAdd(reinterpret_cast<float*>(cell + 2), c);
        }
        jf = jf + 1 == fc ? 0 : jf + 1;
      }
    }
    __syncthreads();
    if (kF32) {                                   // f32 block -> float64 run
      for (int i = threadIdx.x; i < ncell; i += blockDim.x) {
        run[i] += static_cast<Run>(cells[i]);
        cells[i] = Acc(0);
      }
      __syncthreads();
    }
  }

  const size_t off = (static_cast<size_t>(slot) * f + f0) * b * 3;
  if (j0 == first && j1 == last) {                // the whole slot
    for (int i = threadIdx.x; i < ncell; i += blockDim.x) {
      out[off + i] = finish(run + (i - i % 3), i % 3, const_hess);
    }
    return;
  }
  // partial of a split slot: the slot's first run at 2 (j0 / W) + 1, each
  // later run at 2 (j0 / W) (no two runs of split slots share an index)
  const int pidx = 2 * (j0 / run_blocks) + (j0 == first ? 1 : 0);
  Run* dst = part + static_cast<size_t>(pidx) * f * b * 3 +
             static_cast<size_t>(f0) * b * 3;
  for (int i = threadIdx.x; i < ncell; i += blockDim.x) dst[i] = run[i];
}

// Adds each split slot's partials in run order and writes its cells.
template <typename Run>
__global__ void reduce_kernel(const int* __restrict__ bounds,
                              const Run* __restrict__ part,
                              float* __restrict__ out, int f, int b,
                              int run_blocks, float const_hess) {
  const int slot = blockIdx.x;
  const int first = bounds[slot];
  const int last = bounds[slot + 1];
  if (last - first <= run_blocks) return;         // written by its run
  const int ncell = f * b * 3;
  const size_t stride = static_cast<size_t>(ncell);
  for (int t = blockIdx.y * blockDim.x + threadIdx.x; 3 * t < ncell;
       t += gridDim.y * blockDim.x) {
    // one thread per cell triple: the hessian may read the count
    Run acc[3];
    const Run* p = part + (2 * static_cast<size_t>(first / run_blocks) + 1) *
                              stride + 3 * t;
    for (int c = 0; c < 3; ++c) acc[c] = p[c];
    for (int j = first + run_blocks; j < last; j += run_blocks) {
      p = part + 2 * static_cast<size_t>(j / run_blocks) * stride + 3 * t;
      acc[0] += p[0];
      acc[1] += p[1];
      if constexpr (sizeof(Run) == 8) {
        acc[2] += p[2];
      } else {                                    // count: f32 bits
        acc[2] = __float_as_int(__int_as_float(acc[2]) +
                                __int_as_float(p[2]));
      }
    }
    float* o = out + static_cast<size_t>(slot) * ncell + 3 * t;
    for (int c = 0; c < 3; ++c) {
      o[c] = finish(acc, c, const_hess);
    }
  }
}

template <typename In, typename Acc, typename Run, bool kPacked>
cudaError_t launch(const void* bins, const void* grad, const void* hess,
                   const void* cnt, const void* block_slot, const void* src,
                   const void* bounds, void* out, void* part, int n, int f,
                   int fh, int b, int s, int nb, int tb, int run_blocks,
                   float const_hess, cudaStream_t stream) {
  constexpr bool kF32 = sizeof(Run) == 8;
  const size_t per_feature =
      static_cast<size_t>(b) * 3 * (sizeof(Acc) + (kF32 ? sizeof(Run) : 0));
  // the widest feature group under the budget, then balanced over groups
  int fgroup = static_cast<int>(kGroupSmemBytes / per_feature);
  fgroup = fgroup < 1 ? 1 : (fgroup > f ? f : fgroup);
  const int groups = (f + fgroup - 1) / fgroup;
  fgroup = (f + groups - 1) / groups;
  const size_t smem = fgroup * per_feature;
  auto hist_k = scatter_hist_kernel<In, Acc, Run, kPacked>;
  cudaError_t err = lgbt::allow_smem(hist_k, smem);
  if (err != cudaSuccess) return err;
  hist_k<<<dim3(tb, groups), kHistThreads, smem, stream>>>(
      static_cast<const uint8_t*>(bins), static_cast<const In*>(grad),
      static_cast<const In*>(hess), static_cast<const float*>(cnt),
      static_cast<const int*>(block_slot), static_cast<const int*>(src),
      static_cast<const int*>(bounds), static_cast<float*>(out),
      static_cast<Run*>(part), n, f, fh, b, s, nb, run_blocks, fgroup,
      const_hess);
  const int triples = f * b;
  int ychunks = (triples + kReduceThreads - 1) / kReduceThreads;
  ychunks = ychunks > 32 ? 32 : ychunks;
  reduce_kernel<Run><<<dim3(s, ychunks), kReduceThreads, 0, stream>>>(
      static_cast<const int*>(bounds), static_cast<const Run*>(part),
      static_cast<float*>(out), f, b, run_blocks, const_hess);
  return cudaGetLastError();
}

}  // namespace

// block_slot [tb], src [tb * nb], bounds [s + 2]: partition_rows.cu's
// layout (src == n marks padding). out [s, f, b, 3] f32, every cell
// written. part: scratch for the runs of split slots, 2 ceil(tb /
// run_blocks) x f x b x 3 cells of float64 (f32 mode) or int32
// (quantized). quantized != 0: grad and hess are int8 and the gradient
// channels hold their integer sums. fh > 0: bins are 4-bit packed, fh
// bytes a row. const_hess != 0: hessians are const_hess x count.
extern "C" int lgbt_build_histograms_scatter(
    const void* bins, const void* grad, const void* hess, const void* cnt,
    const void* block_slot, const void* src, const void* bounds, void* out,
    void* part, int n, int f, int fh, int b, int s, int nb, int tb,
    int run_blocks, float const_hess, int quantized, void* stream) {
  if (s == 0 || tb == 0 || f == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
#define LGBT_SCATTER(In, Acc, Run, P)                                        \
  return launch<In, Acc, Run, P>(bins, grad, hess, cnt, block_slot, src,     \
                                 bounds, out, part, n, f, fh, b, s, nb, tb,  \
                                 run_blocks, const_hess, st)
  if (quantized) {
    if (fh > 0) LGBT_SCATTER(int8_t, int, int, true);
    LGBT_SCATTER(int8_t, int, int, false);
  }
  if (fh > 0) LGBT_SCATTER(float, float, double, true);
  LGBT_SCATTER(float, float, double, false);
#undef LGBT_SCATTER
}
