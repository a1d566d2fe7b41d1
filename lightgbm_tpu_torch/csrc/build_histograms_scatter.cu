// build_histograms_scatter: per-slot (grad, hess, count) histograms over
// rows partitioned by slot — every row_block consecutive positions of the
// partition (partition_rows in learner/histogram_pallas.py) hold rows of
// one slot, so a block of them adds into one slot's cells only.
//
// Replaces: lightgbm_tpu/learner/histogram_pallas.py,
// build_histograms_scatter (pallas_call in _scatter_kernel). The TPU
// kernel gathers the partitioned rows into a padded copy of the bin matrix
// and contracts each block's [8, row_block] channel matrix with its
// (feature, bin) one-hots on the MXU, accumulating a slot's [8, F*B] block
// in VMEM across its consecutive blocks. This kernel computes the same
// function the way the reference's cuda_histogram_constructor.cu does: a
// histogram privatised in shared memory per block, flushed once.
//
// Bound on this card: bytes — the partition (src, 4 bytes a position) and,
// for every slotted row, its bins and gradient channels, read through src
// straight from the bin matrix (no padded copy is written); one write of
// the histogram. The flush adds up to F x bmax x 3 cells per block to
// global memory.
// Design: grid (partition blocks, feature chunks). A CTA takes one block of
// row_block positions and a chunk of features whose [Fchunk, bmax, 3]
// cells fit kSmemBytes of shared memory (all 28 features at 256 bins; 200
// features take 7 chunks), zeroes them, adds its rows with shared-memory
// atomics — threads walk (row, feature) pairs so a warp reads consecutive
// bytes of a row — and adds every nonzero cell into the slot's global
// cells with one atomic. Blocks of the trash slot S (parked rows, layout
// padding) return at once; positions past the slot's rows point at the
// dummy row n and are skipped. f32 mode: f32 cells in shared memory (a
// block's sums of at most row_block rows), flushed into float64 global
// cells (route_hist.cuh: cell_add), rounded to f32 once by the
// wrapper; the atomics' order varies the sums' last bits from run to run.
// Integer mode: int8 gradients into int32 cells with the count's f32 bits
// in the same cell word, exact and order-free. Unpacked or 4-bit packed
// bins.
#include "route_hist.cuh"

namespace {

constexpr size_t kSmemBytes = 96 * 1024;   // two CTAs per SM at 86 KB

// Acc: the shared-memory cell type (float or int); Out: the global one
// (double or int).
template <typename In, typename Acc, typename Out, bool kPacked>
__global__ void scatter_hist_kernel(const uint8_t* __restrict__ bins,
                                    const In* __restrict__ grad,
                                    const In* __restrict__ hess,
                                    const float* __restrict__ cnt,
                                    const int* __restrict__ block_slot,
                                    const int* __restrict__ src,
                                    Out* __restrict__ hist, int n, int f,
                                    int fh, int b, int s, int nb, int fchunk,
                                    int const_hess) {
  extern __shared__ int smem[];
  Acc* cells = reinterpret_cast<Acc*>(smem);      // [fc, b, 3]
  const int slot = block_slot[blockIdx.x];
  if (slot >= s) return;                          // trash slot
  const int f0 = blockIdx.y * fchunk;
  const int fc = min(fchunk, f - f0);
  const int ncell = fc * b * 3;
  for (int i = threadIdx.x; i < ncell; i += blockDim.x) cells[i] = Acc(0);
  __syncthreads();

  const int rs = lgbt::row_stride(f, fh);
  const int* blk_src = src + static_cast<size_t>(blockIdx.x) * nb;
  for (int k = threadIdx.x; k < nb * fc; k += blockDim.x) {
    const int p = k / fc;
    const int j = k - p * fc;
    const int r = blk_src[p];
    if (r >= n) continue;                         // layout padding
    const int bin =
        lgbt::read_bin<kPacked>(bins + static_cast<size_t>(r) * rs, f0 + j,
                                fh);
    if (bin >= b) continue;
    Acc* cell = cells + (j * b + bin) * 3;
    atomicAdd(cell, static_cast<Acc>(grad[r]));
    if (!const_hess) atomicAdd(cell + 1, static_cast<Acc>(hess[r]));
    atomicAdd(reinterpret_cast<float*>(cell + 2), cnt[r]);
  }
  __syncthreads();

  Out* out = hist + (static_cast<size_t>(slot) * f + f0) * b * 3;
  for (int i = threadIdx.x; i < ncell; i += blockDim.x) {
    const Acc v = cells[i];
    if (v != Acc(0)) lgbt::cell_add(out + i, v, i % 3);
  }
}

template <typename In, typename Acc, typename Out, bool kPacked>
cudaError_t launch(const void* bins, const void* grad, const void* hess,
                   const void* cnt, const void* block_slot, const void* src,
                   void* hist, int n, int f, int fh, int b, int s, int nb,
                   int tb, int const_hess, cudaStream_t stream) {
  const size_t cell_bytes = static_cast<size_t>(b) * 3 * sizeof(Acc);
  int fchunk = static_cast<int>(kSmemBytes / cell_bytes);
  fchunk = fchunk < 1 ? 1 : (fchunk > f ? f : fchunk);
  const size_t smem = fchunk * cell_bytes;
  cudaError_t err =
      lgbt::allow_smem(scatter_hist_kernel<In, Acc, Out, kPacked>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(tb, (f + fchunk - 1) / fchunk);
  scatter_hist_kernel<In, Acc, Out, kPacked>
      <<<grid, lgbt::kThreads, smem, stream>>>(
          static_cast<const uint8_t*>(bins), static_cast<const In*>(grad),
          static_cast<const In*>(hess), static_cast<const float*>(cnt),
          static_cast<const int*>(block_slot), static_cast<const int*>(src),
          static_cast<Out*>(hist), n, f, fh, b, s, nb, fchunk, const_hess);
  return cudaGetLastError();
}

}  // namespace

// block_slot [tb] and src [tb * nb]: partition_rows' layout (src == n
// marks padding). quantized != 0: grad and hess are int8 and hist is int32
// cells for the gradient channels, f32 bits for the count channel; else
// hist is float64 cells. fh > 0: bins are 4-bit packed, fh bytes a row.
// hist [s, f, b, 3] is zeroed by the caller.
extern "C" int lgbt_build_histograms_scatter(
    const void* bins, const void* grad, const void* hess, const void* cnt,
    const void* block_slot, const void* src, void* hist, int n, int f,
    int fh, int b, int s, int nb, int tb, int const_hess, int quantized,
    void* stream) {
  if (n == 0 || tb == 0 || f == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
#define LGBT_SCATTER(In, Acc, Out, P)                                       \
  return launch<In, Acc, Out, P>(bins, grad, hess, cnt, block_slot, src,    \
                                 hist, n, f, fh, b, s, nb, tb, const_hess,  \
                                 st)
  if (quantized) {
    if (fh > 0) LGBT_SCATTER(int8_t, int, int, true);
    LGBT_SCATTER(int8_t, int, int, false);
  }
  if (fh > 0) LGBT_SCATTER(float, float, double, true);
  LGBT_SCATTER(float, float, double, false);
#undef LGBT_SCATTER
}
