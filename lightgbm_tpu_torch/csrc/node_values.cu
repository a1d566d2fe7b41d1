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
// out per row; the table (<= a few KB) is read once per CTA.
// Design: a grid sized to the SM count, each thread taking 4 rows at a
// time with 16-byte accesses (an int4 of ids in, a float4 of values out;
// a scalar tail, and scalar accesses where a pointer is not 16-byte
// aligned). A table of up to kStage entries is staged once per CTA into
// shared memory with its non-finite entries made 0, so a lookup is one
// shared load; a larger table is read through the read-only cache (__ldg)
// and tested per lookup. Both give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 4;
constexpr int kStage = 1024;            // table entries staged in shared
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float finite_or_zero(float t) {
  // exponent all ones: inf or NaN
  return (__float_as_uint(t) & 0x7f800000u) != 0x7f800000u ? t : 0.0f;
}

template <bool kStaged>
__device__ __forceinline__ float lookup(const float* table,
                                        const float* __restrict__ values,
                                        int node, int m) {
  if (node < 0 || node >= m) return 0.0f;
  return kStaged ? table[node] : finite_or_zero(__ldg(values + node));
}

template <bool kStaged, bool kVec>
__global__ void node_values_kernel(const int* __restrict__ row_node,
                                   const float* __restrict__ values,
                                   float* __restrict__ out, int n, int m) {
  __shared__ float table[kStaged ? kStage : 1];
  if (kStaged) {
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      table[i] = finite_or_zero(values[i]);
    }
    __syncthreads();
  }
  const int stride = gridDim.x * blockDim.x;
  const int t0 = blockIdx.x * blockDim.x + threadIdx.x;
  int tail = 0;
  if (kVec) {
    const int n4 = n / 4;
    for (int q = t0; q < n4; q += stride) {
      const int4 id = reinterpret_cast<const int4*>(row_node)[q];
      reinterpret_cast<float4*>(out)[q] = make_float4(
          lookup<kStaged>(table, values, id.x, m),
          lookup<kStaged>(table, values, id.y, m),
          lookup<kStaged>(table, values, id.z, m),
          lookup<kStaged>(table, values, id.w, m));
    }
    tail = n4 * 4;
  }
  for (int i = tail + t0; i < n; i += stride) {
    out[i] = lookup<kStaged>(table, values, row_node[i], m);
  }
}

template <bool kStaged, bool kVec>
void launch(const int* row_node, const float* values, float* out, int n,
            int m, int blocks, cudaStream_t stream) {
  node_values_kernel<kStaged, kVec><<<blocks, kThreads, 0, stream>>>(
      row_node, values, out, n, m);
}

}  // namespace

extern "C" int lgbt_node_values(const void* row_node, const void* values,
                                void* out, int n, int m, void* stream) {
  if (n == 0) return cudaSuccess;
  // SM count per device, asked once
  static int sm_count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int sms = sm_count[dev];
  const bool vec = ((reinterpret_cast<uintptr_t>(row_node) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int per_block = kThreads * (vec ? 4 : 1);
  int blocks = (n + per_block - 1) / per_block;
  if (blocks > sms * kCtasPerSm) blocks = sms * kCtasPerSm;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* rn = static_cast<const int*>(row_node);
  const auto* v = static_cast<const float*>(values);
  auto* o = static_cast<float*>(out);
  if (m <= kStage) {
    if (vec) launch<true, true>(rn, v, o, n, m, blocks, st);
    else launch<true, false>(rn, v, o, n, m, blocks, st);
  } else {
    if (vec) launch<false, true>(rn, v, o, n, m, blocks, st);
    else launch<false, false>(rn, v, o, n, m, blocks, st);
  }
  return cudaGetLastError();
}
