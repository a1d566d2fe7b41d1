// node_values: out[i] = values[row_node[i]], with non-finite table entries
// and out-of-range node ids reading 0.
//
// Replaces: lightgbm_tpu/learner/histogram_mxu.py, node_values_mxu
// (pallas_call in _values_kernel), which looks values up with a one-hot
// matmul against a bf16 hi/lo split table — the TPU's way around slow
// gathers. The zero for non-finite entries and out-of-range ids is what
// that formulation gives, kept here so both agree bit for bit.
//
// Bound on this card: bytes — 4 bytes of row_node in and 4 bytes of value
// out per row; the table (<= a few KB) stays in L1/L2.
// Design: one thread per row, coalesced loads and stores, a cached table
// read (__ldg).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;

__global__ void node_values_kernel(const int* __restrict__ row_node,
                                   const float* __restrict__ values,
                                   float* __restrict__ out, int n, int m) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int node = row_node[i];
    float v = 0.0f;
    if (node >= 0 && node < m) {
      const float t = __ldg(values + node);
      // exponent all ones: inf or NaN
      const bool finite = (__float_as_uint(t) & 0x7f800000u) != 0x7f800000u;
      v = finite ? t : 0.0f;
    }
    out[i] = v;
  }
}

}  // namespace

extern "C" int lgbt_node_values(const void* row_node, const void* values,
                                void* out, int n, int m, void* stream) {
  if (n == 0) return cudaSuccess;
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  node_values_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_node), static_cast<const float*>(values),
      static_cast<float*>(out), n, m);
  return cudaGetLastError();
}
