// node_sums: per-node (sum grad, sum hess, sum count) over the rows'
// final node ids, for the exact leaf refit after quantized growth; rows
// whose node is < 0 or >= m are ignored. Output [m, 3] f32.
//
// Replaces: lightgbm_tpu/learner/histogram_mxu.py, node_sums_mxu
// (pallas_call over _node_sums_kernel), which sums a full-f32 one-hot
// [rows, nodes] contraction on the MXU — the TPU's way around a scatter.
//
// Bound on this card: bytes — row_node and the three f32 channels are read
// once (16 bytes a row); the [m, 3] output is a few KB.
// Design: deterministic fixed-point accumulation, so two launches on the
// same inputs give the same bits (f32 or f64 atomics would add in a
// different order every run, and the quantized model would differ from
// run to run). Per channel c the wrapper passes amax[c] = max |x| (a
// device tensor, no host sync); with amax < 2^e and n <= 2^lg rows the
// kernel takes k = 61 - e - lg, so every row's x * 2^k is below
// 2^(61 - lg) and any node's sum below 2^61. Each row adds
// llrintf(ldexpf(x, k)) — exact scaling, one rounding of at most
// 2^-(k+1) in the units of x (~1e-13 of amax at 1M rows), none for
// whole-number counts — as a 64-bit integer atomicAdd, first into a
// per-block shared-memory copy of the [m, 3] sums (m <= kMaxSharedNodes),
// then once per block and cell into global memory. Integer addition is
// exact and order-free. A second launch converts each sum with one f64
// multiply by 2^-k and one rounding to f32. Inputs must be finite: a
// channel whose amax is not finite comes out NaN.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxBlocks = 528;          // 4 blocks per SM on 132 SMs
constexpr int kMaxSharedNodes = 4096;    // 4096 x 3 x 8 B = 96 KB per block

__device__ __forceinline__ int fixed_exp(float amax, int n) {
  int e = 0;
  frexpf(amax, &e);                      // amax < 2^e (amax = 0: e = 0)
  const int lg = n > 1 ? 32 - __clz(n - 1) : 0;   // n <= 2^lg
  return 61 - e - lg;
}

__global__ void node_sums_kernel(const int* __restrict__ row_node,
                                 const float* __restrict__ grad,
                                 const float* __restrict__ hess,
                                 const float* __restrict__ cnt,
                                 const float* __restrict__ amax,
                                 unsigned long long* __restrict__ acc, int n,
                                 int m, int use_shared) {
  extern __shared__ unsigned long long s_acc[];
  const int kg = fixed_exp(amax[0], n);
  const int kh = fixed_exp(amax[1], n);
  const int kc = fixed_exp(amax[2], n);
  unsigned long long* dst = acc;
  if (use_shared) {
    for (int j = threadIdx.x; j < 3 * m; j += blockDim.x) s_acc[j] = 0ull;
    __syncthreads();
    dst = s_acc;
  }
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int node = row_node[i];
    if (node < 0 || node >= m) continue;
    unsigned long long* cell = dst + 3 * node;
    // two's complement: adding the unsigned image of a negative int64
    // subtracts it
    atomicAdd(cell, static_cast<unsigned long long>(
                        llrintf(ldexpf(grad[i], kg))));
    atomicAdd(cell + 1, static_cast<unsigned long long>(
                            llrintf(ldexpf(hess[i], kh))));
    atomicAdd(cell + 2, static_cast<unsigned long long>(
                            llrintf(ldexpf(cnt[i], kc))));
  }
  if (use_shared) {
    __syncthreads();
    for (int j = threadIdx.x; j < 3 * m; j += blockDim.x) {
      const unsigned long long v = s_acc[j];
      if (v != 0ull) atomicAdd(acc + j, v);
    }
  }
}

__global__ void node_sums_finish(const unsigned long long* __restrict__ acc,
                                 const float* __restrict__ amax,
                                 float* __restrict__ out, int n, int m) {
  const int stride = gridDim.x * blockDim.x;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < 3 * m;
       j += stride) {
    const float a = amax[j % 3];
    const double v = static_cast<double>(static_cast<long long>(acc[j]));
    out[j] = isfinite(a)
                 ? static_cast<float>(v * ldexp(1.0, -fixed_exp(a, n)))
                 : NAN;
  }
}

}  // namespace

// acc: [m, 3] uint64 scratch, zeroed by the caller; out: [m, 3] f32.
extern "C" int lgbt_node_sums(const void* row_node, const void* grad,
                              const void* hess, const void* cnt,
                              const void* amax, void* acc, void* out, int n,
                              int m, void* stream) {
  if (m == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  const float* amax_f = static_cast<const float*>(amax);
  unsigned long long* acc_u = static_cast<unsigned long long*>(acc);
  if (n > 0) {
    const int use_shared = m <= kMaxSharedNodes;
    const size_t smem =
        use_shared ? static_cast<size_t>(3) * m * sizeof(unsigned long long)
                   : 0;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          node_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    int blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    node_sums_kernel<<<blocks, kThreads, smem, st>>>(
        static_cast<const int*>(row_node), static_cast<const float*>(grad),
        static_cast<const float*>(hess), static_cast<const float*>(cnt),
        amax_f, acc_u, n, m, use_shared);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  int blocks = (3 * m + 255) / 256;
  if (blocks > 1024) blocks = 1024;
  node_sums_finish<<<blocks, 256, 0, st>>>(acc_u, amax_f,
                                           static_cast<float*>(out), n, m);
  return cudaGetLastError();
}
