// build_histograms_scatter: per-slot (grad, hess, count) histograms over
// rows partitioned by slot — every row_block consecutive positions of the
// partition (partition_rows.cu) hold rows of one slot, so a block of them
// adds into one slot's cells only.
//
// Replaces: lightgbm_tpu/learner/histogram_pallas.py,
// build_histograms_scatter (pallas_call in _scatter_kernel), and — behind
// the partition of the rows by row_slot — build_histograms_mxu and
// build_histograms_mxu_v2 of lightgbm_tpu/learner/histogram_mxu.py (the
// same function keyed by row_slot; histogram_mxu.build_histograms), and,
// behind route_rows.cu's counts mode and the partition, the histogram half
// of fused_route_hist_mxu there (histogram_mxu.fused_route_hist). The TPU
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
// every other CTA returns at once. It zeroes its cells and adds the run's
// rows with shared-memory atomics, a thread a row: the row's gradient
// channels are read once, its bins feature after feature from a start
// that differs from lane to lane, so the lanes of a warp seldom add into
// one cell at the same step; then:
//  - a run that is its whole slot writes the final f32 cells of the
//    output with plain stores (no zeroed buffer, no global atomics);
//  - a run of a split slot (more than run_blocks blocks) writes its cells
//    to a partial; a second kernel adds a split slot's partials and
//    writes the slot.
// Every sum is an integer sum, exact and order-free. Exact (f32) mode: each
// row's fixed-point values q (|q| <= 2^38, route_hist.cuh) split into two
// 32-bit words, the low 20 bits (unsigned) and q >> 20, each added with
// the native 32-bit shared atomic (64-bit and float shared atomics are
// CAS loops on this card); a run holds at most kWordRows rows, so the low
// word stays below 2^32 and the high one within +-2^30. The words join
// into int64 sums (partials and the reduce are int64), scaled back once.
// Integer mode: int8 gradients into int32 cells and the count's f32 bits
// in the same cell word, the count added with float atomics (whole-number
// counts below 2^24 are exact). const_hess != 0: the hessian channel is
// skipped and written as const x count. Unpacked or 4-bit packed uint8
// bins, or (a compile-time mode) unpacked uint16 bins: max_bin > 256, the
// portable grower's histograms (lightgbm_tpu/learner/histogram_pallas.py
// build_histograms_pallas, :276-290), whose TPU kernel pads the bin axis
// to 128 lanes; here the bin axis goes up to the widest at which one
// feature's cells fit kGroupSmemBytes (4266 exact, 8533 integer), which
// the wrapper checks. Single-precision mode (another compile-time mode;
// the JAX kernels' double_prec=False, gpu_use_dp=false): each row's
// hessian is rounded to bf16, to nearest even as the TPU kernel's bf16
// operand cast, before it becomes a fixed-point value; the rest is the
// exact mode.
#include <cuda_bf16.h>

#include <type_traits>

#include "route_hist.cuh"

namespace {

constexpr int kHistThreads = 1024;               // a row a thread a block
constexpr size_t kGroupSmemBytes = 100 * 1024;  // two CTAs an SM
constexpr int kReduceThreads = 256;
constexpr int kLoBits = 20;                     // exact mode's low word
constexpr int kWordRows = 4096;                 // rows a run holds at most

// Raw sums of a cell (the run's value type): int64 fixed-point sums
// (exact) or int32 integer sums with the count's f32 bits (integer).
template <bool kExact>
using Sum = typename std::conditional<kExact, long long, int>::type;

// Final f32 value of channel chan of a cell from its three raw sums; with
// const_hess, the hessian is const_hess x the f32 count.
__device__ __forceinline__ float finish(const long long (&v)[3], int chan,
                                        float const_hess,
                                        const double (&inv)[3]) {
  if (chan == 1 && const_hess != 0.0f) {
    return lgbt::fixed_result(v[2], inv[2]) * const_hess;
  }
  return lgbt::fixed_result(v[chan], inv[chan]);
}
__device__ __forceinline__ float finish(const int (&v)[3], int chan,
                                        float const_hess,
                                        const double (&)[3]) {
  if (chan == 1 && const_hess != 0.0f) {
    return __int_as_float(v[2]) * const_hess;
  }
  return chan == 2 ? __int_as_float(v[2]) : static_cast<float>(v[chan]);
}

// Shared words a cell takes: (lo, hi) x 3 channels, or 3 int32 cells.
template <bool kExact>
__host__ __device__ constexpr int cell_words() { return kExact ? 6 : 3; }

// The raw sums of cell `cell` from its shared words.
template <bool kExact>
__device__ __forceinline__ void cell_sums(const unsigned* words, int cell,
                                          Sum<kExact> (&v)[3]) {
  const unsigned* w = words + cell * cell_words<kExact>();
  for (int c = 0; c < 3; ++c) {
    if constexpr (kExact) {
      v[c] = static_cast<long long>(static_cast<int>(w[3 + c])) *
                 (1ll << kLoBits) +
             static_cast<long long>(w[c]);
    } else {
      v[c] = static_cast<int>(w[c]);
    }
  }
}

// Bin of feature j in a row of Bin words: uint8 (unpacked or packed) or
// unpacked uint16.
template <typename Bin, bool kPacked>
__device__ __forceinline__ int bin_at(const Bin* row, int j, int fh) {
  if constexpr (kPacked) {
    return lgbt::read_bin<true>(row, j, fh);
  } else {
    return row[j];
  }
}

// The hessian a row adds: as it is, or rounded to bf16 (single precision).
template <bool kSingle>
__device__ __forceinline__ float hess_value(float h) {
  if constexpr (kSingle) {
    return __bfloat162float(__float2bfloat16_rn(h));
  } else {
    return h;
  }
}

template <typename In, typename Bin, bool kExact, bool kPacked, bool kSingle>
__global__ void scatter_hist_kernel(
    const Bin* __restrict__ bins, const In* __restrict__ grad,
    const In* __restrict__ hess, const float* __restrict__ cnt,
    const int* __restrict__ block_slot, const int* __restrict__ src,
    const int* __restrict__ bounds, const int* __restrict__ scale_k,
    float* __restrict__ out, Sum<kExact>* __restrict__ part, int n, int f,
    int fh, int b, int s, int nb, int run_blocks, int fgroup,
    float const_hess) {
  constexpr int kWords = cell_words<kExact>();
  const int j0 = blockIdx.x;
  const int slot = block_slot[j0];
  if (slot >= s) return;                          // trash slot
  const int first = bounds[slot];
  const int last = bounds[slot + 1];
  if ((j0 - first) % run_blocks != 0) return;     // not a run's first block
  const int j1 = min(j0 + run_blocks, last);

  extern __shared__ __align__(16) unsigned words[];  // [fc, b, kWords]
  const int f0 = blockIdx.y * fgroup;
  const int fc = min(fgroup, f - f0);
  const int ncell = fc * b;
  for (int i = threadIdx.x; i < ncell * kWords; i += blockDim.x) {
    words[i] = 0u;
  }
  double mul[3], inv[3];
  for (int c = 0; c < 3; ++c) {
    mul[c] = kExact ? lgbt::fixed_mul(scale_k[c]) : 0.0;
    inv[c] = kExact ? lgbt::fixed_inv(scale_k[c]) : 0.0;
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
      // the row's words: exact (lo, hi) x 3 channels; integer g, h, count
      unsigned add[kWords];
      if constexpr (kExact) {
        const long long q[3] = {
            lgbt::fixed_point(grad[r], mul[0]),
            skip_hess ? 0ll
                      : lgbt::fixed_point(hess_value<kSingle>(hess[r]),
                                          mul[1]),
            lgbt::fixed_point(cnt[r], mul[2])};
        for (int c = 0; c < 3; ++c) {
          add[c] = static_cast<unsigned>(q[c]) & ((1u << kLoBits) - 1u);
          add[3 + c] = static_cast<unsigned>(q[c] >> kLoBits);
        }
      } else {
        add[0] = static_cast<unsigned>(static_cast<int>(grad[r]));
        add[1] = skip_hess ? 0u : static_cast<unsigned>(
                                      static_cast<int>(hess[r]));
        add[2] = __float_as_uint(cnt[r]);
      }
      const Bin* row = bins + static_cast<size_t>(r) * rs;
      int jf = jstart;
      for (int t = 0; t < fc; ++t) {
        const int bin = bin_at<Bin, kPacked>(row, f0 + jf, fh);
        if (bin < b) {
          unsigned* cell = words + (jf * b + bin) * kWords;
          if constexpr (kExact) {
            // a zero word adds nothing (whole-number counts: the low words)
            for (int w = 0; w < kWords; ++w) {
              if (add[w] != 0u) atomicAdd(cell + w, add[w]);
            }
          } else {
            atomicAdd(cell, add[0]);
            if (!skip_hess) atomicAdd(cell + 1, add[1]);
            atomicAdd(reinterpret_cast<float*>(cell + 2),
                      __uint_as_float(add[2]));
          }
        }
        jf = jf + 1 == fc ? 0 : jf + 1;
      }
    }
  }
  __syncthreads();

  const size_t off = (static_cast<size_t>(slot) * f + f0) * b * 3;
  if (j0 == first && j1 == last) {                // the whole slot
    for (int cell = threadIdx.x; cell < ncell; cell += blockDim.x) {
      Sum<kExact> v[3];
      cell_sums<kExact>(words, cell, v);
      for (int c = 0; c < 3; ++c) {
        out[off + 3 * cell + c] = finish(v, c, const_hess, inv);
      }
    }
    return;
  }
  // partial of a split slot: the slot's first run at 2 (j0 / W) + 1, each
  // later run at 2 (j0 / W) (no two runs of split slots share an index)
  const int pidx = 2 * (j0 / run_blocks) + (j0 == first ? 1 : 0);
  Sum<kExact>* dst = part + static_cast<size_t>(pidx) * f * b * 3 +
                     static_cast<size_t>(f0) * b * 3;
  for (int cell = threadIdx.x; cell < ncell; cell += blockDim.x) {
    Sum<kExact> v[3];
    cell_sums<kExact>(words, cell, v);
    for (int c = 0; c < 3; ++c) dst[3 * cell + c] = v[c];
  }
}

// Adds each split slot's partials in run order and writes its cells.
template <bool kExact>
__global__ void reduce_kernel(const int* __restrict__ bounds,
                              const Sum<kExact>* __restrict__ part,
                              const int* __restrict__ scale_k,
                              float* __restrict__ out, int f, int b,
                              int run_blocks, float const_hess) {
  const int slot = blockIdx.x;
  const int first = bounds[slot];
  const int last = bounds[slot + 1];
  if (last - first <= run_blocks) return;         // written by its run
  double inv[3];
  for (int c = 0; c < 3; ++c) {
    inv[c] = kExact ? lgbt::fixed_inv(scale_k[c]) : 0.0;
  }
  const int ncell = f * b * 3;
  const size_t stride = static_cast<size_t>(ncell);
  for (int t = blockIdx.y * blockDim.x + threadIdx.x; 3 * t < ncell;
       t += gridDim.y * blockDim.x) {
    // one thread per cell triple: the hessian may read the count
    Sum<kExact> acc[3];
    const Sum<kExact>* p =
        part + (2 * static_cast<size_t>(first / run_blocks) + 1) * stride +
        3 * t;
    for (int c = 0; c < 3; ++c) acc[c] = p[c];
    for (int j = first + run_blocks; j < last; j += run_blocks) {
      p = part + 2 * static_cast<size_t>(j / run_blocks) * stride + 3 * t;
      acc[0] += p[0];
      acc[1] += p[1];
      if constexpr (kExact) {
        acc[2] += p[2];
      } else {                                    // count: f32 bits
        acc[2] = __float_as_int(__int_as_float(acc[2]) +
                                __int_as_float(p[2]));
      }
    }
    float* o = out + static_cast<size_t>(slot) * ncell + 3 * t;
    for (int c = 0; c < 3; ++c) {
      o[c] = finish(acc, c, const_hess, inv);
    }
  }
}

template <typename In, typename Bin, bool kExact, bool kPacked,
          bool kSingle>
cudaError_t launch(const void* bins, const void* grad, const void* hess,
                   const void* cnt, const void* block_slot, const void* src,
                   const void* bounds, const void* scale_k, void* out,
                   void* part, int n, int f, int fh, int b, int s, int nb,
                   int tb, int run_blocks, float const_hess,
                   cudaStream_t stream) {
  const size_t per_feature =
      static_cast<size_t>(b) * cell_words<kExact>() * sizeof(unsigned);
  // the widest feature group under the budget, then balanced over groups
  int fgroup = static_cast<int>(kGroupSmemBytes / per_feature);
  fgroup = fgroup < 1 ? 1 : (fgroup > f ? f : fgroup);
  const int groups = (f + fgroup - 1) / fgroup;
  fgroup = (f + groups - 1) / groups;
  const size_t smem = fgroup * per_feature;
  if (smem > kGroupSmemBytes) return cudaErrorInvalidValue;  // bins > cap
  auto hist_k = scatter_hist_kernel<In, Bin, kExact, kPacked, kSingle>;
  cudaError_t err = lgbt::allow_smem(hist_k, smem);
  if (err != cudaSuccess) return err;
  hist_k<<<dim3(tb, groups), kHistThreads, smem, stream>>>(
      static_cast<const Bin*>(bins), static_cast<const In*>(grad),
      static_cast<const In*>(hess), static_cast<const float*>(cnt),
      static_cast<const int*>(block_slot), static_cast<const int*>(src),
      static_cast<const int*>(bounds), static_cast<const int*>(scale_k),
      static_cast<float*>(out), static_cast<Sum<kExact>*>(part), n, f, fh, b,
      s, nb, run_blocks, fgroup, const_hess);
  const int triples = f * b;
  int ychunks = (triples + kReduceThreads - 1) / kReduceThreads;
  ychunks = ychunks > 32 ? 32 : ychunks;
  reduce_kernel<kExact><<<dim3(s, ychunks), kReduceThreads, 0, stream>>>(
      static_cast<const int*>(bounds), static_cast<const Sum<kExact>*>(part),
      static_cast<const int*>(scale_k), static_cast<float*>(out), f, b,
      run_blocks, const_hess);
  return cudaGetLastError();
}

}  // namespace

// block_slot [tb], src [tb * nb], bounds [s + 2]: partition_rows.cu's
// layout (src == n marks padding). out [s, f, b, 3] f32, every cell
// written. part: scratch for the runs of split slots, 2 ceil(tb /
// run_blocks) x f x b x 3 cells of int64 (exact mode) or int32
// (quantized). quantized != 0: grad and hess are int8 and the gradient
// channels hold their integer sums; else scale_k [3] i32 is the
// fixed-point scale (histogram_mxu.exact_scale) and a run may hold at most
// kWordRows rows (run_blocks x nb). fh > 0: bins are 4-bit packed, fh
// bytes a row. wide != 0: bins are unpacked uint16 (f words a row), b at
// most the bins whose cells fit kGroupSmemBytes. const_hess != 0:
// hessians are const_hess x count. single != 0 (exact mode with a per-row
// hessian): each hessian is rounded to bf16 before its fixed point.
extern "C" int lgbt_build_histograms_scatter(
    const void* bins, const void* grad, const void* hess, const void* cnt,
    const void* block_slot, const void* src, const void* bounds,
    const void* scale_k, void* out, void* part, int n, int f, int fh, int b,
    int s, int nb, int tb, int run_blocks, float const_hess, int quantized,
    int single, int wide, void* stream) {
  if (s == 0 || tb == 0 || f == 0) return cudaSuccess;
  if (!quantized && static_cast<long long>(run_blocks) * nb > kWordRows) {
    return cudaErrorInvalidValue;
  }
  if ((wide && fh > 0) || (single && (quantized || const_hess != 0.0f))) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
#define LGBT_SCATTER(In, B, E, P, S)                                         \
  return launch<In, B, E, P, S>(bins, grad, hess, cnt, block_slot, src,      \
                                bounds, scale_k, out, part, n, f, fh, b, s,  \
                                nb, tb, run_blocks, const_hess, st)
  if (quantized) {
    if (fh > 0) LGBT_SCATTER(int8_t, uint8_t, false, true, false);
    if (wide) LGBT_SCATTER(int8_t, uint16_t, false, false, false);
    LGBT_SCATTER(int8_t, uint8_t, false, false, false);
  }
  if (single) {
    if (fh > 0) LGBT_SCATTER(float, uint8_t, true, true, true);
    if (wide) LGBT_SCATTER(float, uint16_t, true, false, true);
    LGBT_SCATTER(float, uint8_t, true, false, true);
  }
  if (fh > 0) LGBT_SCATTER(float, uint8_t, true, true, false);
  if (wide) LGBT_SCATTER(float, uint16_t, true, false, false);
  LGBT_SCATTER(float, uint8_t, true, false, false);
#undef LGBT_SCATTER
}
