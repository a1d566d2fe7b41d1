// node_sums: per-node (sum grad, sum hess, sum count) over the rows'
// final node ids, for the exact leaf refit after quantized growth; rows
// whose node is < 0 or >= m are ignored. Output [m, 3] f32.
//
// Replaces: lightgbm_tpu/learner/histogram_mxu.py, node_sums_mxu
// (pallas_call over _node_sums_kernel), which sums a full-f32 one-hot
// [rows, nodes] contraction on the MXU — the TPU's way around a scatter.
//
// Bound on this card: bytes — the three f32 channels are read twice (once
// for their maxima, once to sum) and row_node once (28 bytes a row); the
// [m, 3] output is a few KB.
//
// The sum is a fixed-point integer sum, exact and independent of the order
// of the additions, so every launch gives the same bits as the plain
// version (node_sums_ref in learner/histogram_mxu.py). Per channel c, with
// amax[c] = max |x| over all n rows < 2^e (frexp) and n <= 2^lg, the scale
// is k = 61 - e - lg: every row adds q = rint(x x 2^k) as an int64, |q| <=
// 2^(61 - lg), so the sum of any set of rows is at most n x 2^(61 - lg) <=
// 2^61 in magnitude. A node's sum s comes out as f32(float64(s) x 2^-k). A
// channel whose max is not finite comes out NaN in every node.
//
// Design: one C entry, three launches on the caller's stream, no host work
// beyond them. The entry zeroes a scratch buffer (three words for the
// maxima, then the [m, 3] int64 sums) with cudaMemsetAsync.
//  1. maxima: each warp takes the max of the bit patterns of |x| (ordered
//     as the values are for non-negative floats; a NaN orders above +inf)
//     and adds it into the scratch words with one atomicMax per channel.
//  2. sums: a CTA keeps a shared copy of the [m, 3] sums as two 32-bit
//     words a value, added with native 32-bit shared atomics (a 64-bit
//     shared atomicAdd compiles to a CAS loop on this card): the low word
//     takes the low 32 bits of q modulo 2^32, and a thread whose add wraps
//     it (its atomicAdd's old value plus its addend passes 2^32) carries
//     one into the high word, which takes q >> 32. So the low word loses
//     no bit, whatever the number of rows; the high word ends at
//     floor(S / 2^32) for the CTA's sum S of that value, within +-2^29
//     since |S| <= 2^61 (it may wrap on the way; the end value is exact
//     modulo 2^32 and fits). Each CTA then adds its sums into the global
//     int64 sums with native 64-bit global atomics. With more than
//     kMaxSharedNodes nodes the rows add straight into the global sums.
//  3. finish: the sums scaled back to f32.
#include "route_hist.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxBlocks = 528;          // 4 CTAs an SM on 132 SMs
constexpr int kMaxSharedNodes = 4096;    // 4096 x 3 x 2 words = 96 KB a CTA
constexpr int kFinishThreads = 256;
// scratch: kMaxWords u32 of channel maxima (3 used), then [m, 3] int64
constexpr int kMaxWords = 4;

// |x|'s bit pattern: a non-negative float's bits order as its value, a
// NaN's above +inf
__device__ __forceinline__ unsigned abs_bits(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}

__global__ void maxima_kernel(const float* __restrict__ grad,
                              const float* __restrict__ hess,
                              const float* __restrict__ cnt,
                              unsigned* __restrict__ amax, int n) {
  unsigned mx[3] = {0u, 0u, 0u};
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    mx[0] = max(mx[0], abs_bits(grad[i]));
    mx[1] = max(mx[1], abs_bits(hess[i]));
    mx[2] = max(mx[2], abs_bits(cnt[i]));
  }
  for (int c = 0; c < 3; ++c) {
    const unsigned w = __reduce_max_sync(0xffffffffu, mx[c]);
    if ((threadIdx.x & 31) == 0 && w != 0u) atomicMax(amax + c, w);
  }
}

// k of a channel from its max |x| bits and n (kNonFinite: NaN or inf)
__device__ __forceinline__ int scale_of(unsigned bits, int n) {
  const float a = __uint_as_float(bits);
  if (!isfinite(a)) return lgbt::kNonFinite;
  int e = 0;
  frexpf(a, &e);                         // a < 2^e (a = 0: e = 0)
  const int lg = n > 1 ? 32 - __clz(n - 1) : 0;   // n <= 2^lg
  return 61 - e - lg;
}

template <bool kShared>
__global__ void sums_kernel(const int* __restrict__ row_node,
                            const float* __restrict__ grad,
                            const float* __restrict__ hess,
                            const float* __restrict__ cnt,
                            const unsigned* __restrict__ amax,
                            unsigned long long* __restrict__ acc, int n,
                            int m) {
  // [m, 3] low words, then [m, 3] high words
  extern __shared__ unsigned words[];
  double mul[3];
  for (int c = 0; c < 3; ++c) {
    mul[c] = lgbt::fixed_mul(scale_of(amax[c], n));
  }
  if (kShared) {
    for (int j = threadIdx.x; j < 6 * m; j += blockDim.x) words[j] = 0u;
    __syncthreads();
  }
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int node = row_node[i];
    if (node < 0 || node >= m) continue;
    const float x[3] = {grad[i], hess[i], cnt[i]};
    for (int c = 0; c < 3; ++c) {
      const long long q = lgbt::fixed_point(x[c], mul[c]);
      const int cell = 3 * node + c;
      if (!kShared) {
        // two's complement: the unsigned add of a negative q subtracts it
        if (q != 0) {
          atomicAdd(acc + cell, static_cast<unsigned long long>(q));
        }
        continue;
      }
      const unsigned lo = static_cast<unsigned>(q);
      unsigned hi = static_cast<unsigned>(q >> 32);
      if (lo != 0u) {
        const unsigned old = atomicAdd(words + cell, lo);
        hi += old + lo < old ? 1u : 0u;              // the wrap's carry
      }
      if (hi != 0u) atomicAdd(words + 3 * m + cell, hi);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int j = threadIdx.x; j < 3 * m; j += blockDim.x) {
      const long long v =
          static_cast<long long>(static_cast<int>(words[3 * m + j])) *
              (1ll << 32) +
          static_cast<long long>(words[j]);
      if (v != 0) atomicAdd(acc + j, static_cast<unsigned long long>(v));
    }
  }
}

__global__ void finish_kernel(const unsigned long long* __restrict__ acc,
                              const unsigned* __restrict__ amax,
                              float* __restrict__ out, int n, int m) {
  double inv[3];
  for (int c = 0; c < 3; ++c) {
    inv[c] = lgbt::fixed_inv(scale_of(amax[c], n));
  }
  const int stride = gridDim.x * blockDim.x;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < 3 * m;
       j += stride) {
    out[j] =
        lgbt::fixed_result(static_cast<long long>(acc[j]), inv[j % 3]);
  }
}

template <bool kShared>
cudaError_t launch_sums(const int* row_node, const float* grad,
                        const float* hess, const float* cnt,
                        const unsigned* amax, unsigned long long* acc, int n,
                        int m, int blocks, cudaStream_t st) {
  const size_t smem = kShared ? static_cast<size_t>(6) * m * sizeof(unsigned)
                              : 0;
  cudaError_t err = lgbt::allow_smem(sums_kernel<kShared>, smem);
  if (err != cudaSuccess) return err;
  sums_kernel<kShared><<<blocks, kThreads, smem, st>>>(
      row_node, grad, hess, cnt, amax, acc, n, m);
  return cudaGetLastError();
}

}  // namespace

// scratch: kMaxWords x 4 + m x 24 bytes, 8-byte aligned (the wrapper's
// cached buffer; node_sums in learner/histogram_mxu.py), zeroed here. out:
// [m, 3] f32, every entry written.
extern "C" int lgbt_node_sums(const void* row_node, const void* grad,
                              const void* hess, const void* cnt,
                              void* scratch, void* out, int n, int m,
                              void* stream) {
  if (m == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  unsigned* amax = static_cast<unsigned*>(scratch);
  unsigned long long* acc =
      reinterpret_cast<unsigned long long*>(amax + kMaxWords);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, kMaxWords * sizeof(unsigned) +
                      static_cast<size_t>(3) * m * sizeof(unsigned long long),
      st);
  if (err != cudaSuccess) return err;
  const auto* g = static_cast<const float*>(grad);
  const auto* h = static_cast<const float*>(hess);
  const auto* c = static_cast<const float*>(cnt);
  if (n > 0) {
    int blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    maxima_kernel<<<blocks, kThreads, 0, st>>>(g, h, c, amax, n);
    const auto* rn = static_cast<const int*>(row_node);
    err = m <= kMaxSharedNodes
              ? launch_sums<true>(rn, g, h, c, amax, acc, n, m, blocks, st)
              : launch_sums<false>(rn, g, h, c, amax, acc, n, m, blocks, st);
    if (err != cudaSuccess) return err;
  }
  int blocks = (3 * m + kFinishThreads - 1) / kFinishThreads;
  if (blocks > 1024) blocks = 1024;
  finish_kernel<<<blocks, kFinishThreads, 0, st>>>(
      acc, amax, static_cast<float*>(out), n, m);
  return cudaGetLastError();
}
