// route_rows: advance every row one level through the split tables and
// emit (row_node, row_slot); in its tally mode also the rows that land in
// each slot, per partition chunk — on the card the routing step of
// fused_route_hist, whose tallies feed the partition (partition_rows.cu) —
// and in its counts mode their sums over the chunks.
//
// Replaces: lightgbm_tpu/learner/histogram_mxu.py, route_rows_mxu
// (pallas_call in _route_kernel, with and without emit_counts). The TPU
// kernel looks node-table rows up with a [rows, nodes] one-hot matmul and
// counts slots with a second one-hot; here a row is one 32-byte read of
// its node's table row and its slot one shared-memory add.
//
// Bound on this card: bytes — row_node in, (row_node, row_slot) out, one
// bin per routed row (12 bytes per row plus the bins it touches), the
// tallies out. Measured on the first version (PERF.md): a copy of the
// whole node table into shared memory per CTA of 1024 rows was half the
// time (32 MB read from L2 at 1024 nodes), the bin read about a fifth.
// Design: one CTA per chunk of kChunkRows rows (route_hist.cuh), 256
// threads, each routing 8 rows as two runs of 4 consecutive rows, whose
// node ids load and results store as int4 (16-byte aligned vectors, the
// row count's tail row by row). A row reads only its node's table row, 32
// bytes through the read-only cache (the table stays in L1), then its
// bin where the node splits: the table rows of a run's 4 rows are loaded
// before their bins. Tally mode: the CTA counts its rows per slot in
// shared memory (lanes of one slot added together, route_hist.cuh
// tally_key), the trash slot s taking the rows parked at a slot < 0 or
// >= s, and writes the chunk's column of the slot-major [s + 1, C] tallies
// with plain stores: no zeroed buffer, no global atomics. Counts mode
// adds a warp per slot that sums its row of the tallies.
//
// EFB modes (the JAX kernels' loc_table and efb_range; bins hold bundle
// columns, the node table is kTblColsEfb wide): a row reads its node's
// third int4 too (and the fourth in range mode), then the byte of the split
// feature's bundle column. Loc mode decodes the original local bin through
// the [F, Bb] loc table (a gather the read-only cache holds: F x Bb x 4
// bytes, about 1 MB at 1000 x 256) and runs the plain decision; range mode
// compares the bundle position with the node's segment, threshold position
// and NaN position. A compile-time mode: the plain kernel is unchanged.
#include "route_hist.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRuns = lgbt::kChunkRows / (4 * kThreads);  // runs of 4 rows
constexpr int kSumWarps = 8;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool kPacked, bool kTally, int kMode>
__global__ void __launch_bounds__(kThreads) route_rows_kernel(
    const uint8_t* __restrict__ bins, const int* __restrict__ row_node_in,
    const int* __restrict__ tbl, const int* __restrict__ member,
    const int* __restrict__ feat_tbl, const int* __restrict__ loc,
    int* __restrict__ row_node_out, int* __restrict__ row_slot_out,
    int* __restrict__ tallies, int n, int f, int fh, int m, int w, int s,
    int nchunks, int bb) {
  extern __shared__ int s_cnt[];  // tally mode: [s + 1] rows of the chunk
  if (kTally) {
    for (int k = threadIdx.x; k <= s; k += kThreads) s_cnt[k] = 0;
    __syncthreads();
  }
  const int rs = lgbt::row_stride(f, fh);
  const int bits = lgbt::key_bits(s);
  const bool vec = aligned16(row_node_in) && aligned16(row_node_out) &&
                   aligned16(row_slot_out);
#pragma unroll
  for (int run = 0; run < kRuns; ++run) {
    const int i0 = blockIdx.x * lgbt::kChunkRows +
                   (run * kThreads + threadIdx.x) * 4;
    const bool whole = vec && i0 + 4 <= n;
    int node[4];
    if (whole) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(row_node_in + i0));
      node[0] = v.x; node[1] = v.y; node[2] = v.z; node[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        node[e] = i0 + e < n ? row_node_in[i0 + e] : -1;
      }
    }
    int4 a[4], b[4], c[4], d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kMode == lgbt::kRoutePlain) {
        lgbt::table_row(tbl, node[e], m, &a[e], &b[e]);
      } else {
        lgbt::table_row_efb<kMode == lgbt::kRouteRange>(
            tbl, node[e], m, &a[e], &b[e], &c[e], &d[e]);
      }
    }
    int binv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // rows past n carry node -1: unsplit, no bin read. EFB: the byte of
      // the split feature's bundle column
      const int col = kMode == lgbt::kRoutePlain ? a[e].y : c[e].x;
      binv[e] = (a[e].x & lgbt::kFlagSplit)
                    ? lgbt::read_bin<kPacked>(
                          bins + static_cast<size_t>(i0 + e) * rs, col, fh)
                    : 0;
    }
    int out_node[4], out_slot[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kMode == lgbt::kRouteRange) {
        lgbt::route_decide_range(node[e], a[e], b[e], c[e], d[e], binv[e],
                                 member, w, &out_node[e], &out_slot[e]);
      } else {
        // loc mode: the original local bin of the split feature
        const int v = kMode == lgbt::kRouteLoc && (a[e].x & lgbt::kFlagSplit)
                          ? __ldg(loc + static_cast<size_t>(a[e].y) * bb +
                                  binv[e])
                          : binv[e];
        lgbt::route_decide(node[e], a[e], b[e], v, feat_tbl, member, w,
                           &out_node[e], &out_slot[e]);
      }
    }
    if (whole) {
      *reinterpret_cast<int4*>(row_node_out + i0) =
          make_int4(out_node[0], out_node[1], out_node[2], out_node[3]);
      *reinterpret_cast<int4*>(row_slot_out + i0) =
          make_int4(out_slot[0], out_slot[1], out_slot[2], out_slot[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (i0 + e < n) {
          row_node_out[i0 + e] = out_node[e];
          row_slot_out[i0 + e] = out_slot[e];
        }
      }
    }
    if (kTally) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int v = out_slot[e];
        lgbt::tally_key(s_cnt, i0 + e >= n ? -1 : (v < 0 || v >= s) ? s : v,
                        bits);
      }
    }
  }
  if (kTally) {
    __syncthreads();
    for (int k = threadIdx.x; k <= s; k += kThreads) {
      tallies[static_cast<size_t>(k) * nchunks + blockIdx.x] = s_cnt[k];
    }
  }
}

// counts[k] = slot k's row of the tallies summed over the chunks, k < s
__global__ void __launch_bounds__(kSumWarps * 32) tally_sums_kernel(
    const int* __restrict__ tallies, int nchunks, int s,
    int* __restrict__ counts) {
  const int k = blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  if (k >= s) return;
  const int lane = threadIdx.x & 31;
  const int* row = tallies + static_cast<size_t>(k) * nchunks;
  int sum = 0;
  for (int c = lane; c < nchunks; c += 32) sum += row[c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if (lane == 0) counts[k] = sum;
}

template <bool kPacked, bool kTally, int kMode>
cudaError_t launch(const void* bins, const void* row_node_in,
                   const void* tbl, const void* member, const void* feat_tbl,
                   const void* loc, void* row_node_out, void* row_slot_out,
                   void* tallies, int n, int f, int fh, int m, int w, int s,
                   int nchunks, int bb, cudaStream_t stream) {
  const size_t smem = kTally ? (static_cast<size_t>(s) + 1) * sizeof(int)
                             : 0;
  cudaError_t err =
      lgbt::allow_smem(route_rows_kernel<kPacked, kTally, kMode>, smem);
  if (err != cudaSuccess) return err;
  route_rows_kernel<kPacked, kTally, kMode>
      <<<nchunks, kThreads, smem, stream>>>(
          static_cast<const uint8_t*>(bins),
          static_cast<const int*>(row_node_in), static_cast<const int*>(tbl),
          static_cast<const int*>(member), static_cast<const int*>(feat_tbl),
          static_cast<const int*>(loc), static_cast<int*>(row_node_out),
          static_cast<int*>(row_slot_out), static_cast<int*>(tallies), n, f,
          fh, m, w, s, nchunks, bb);
  return cudaGetLastError();
}

}  // namespace

// fh > 0: bins are 4-bit packed, fh bytes a row (route_hist.cuh read_bin);
// tbl 16-byte aligned. tallies != NULL: also the rows per slot and chunk,
// [s + 1, C] i32 slot-major, C = max(1, ceil(n / kChunkRows)) (slot s:
// rows whose slot is < 0 or >= s); counts != NULL (with tallies): also
// counts[k], k < s, the rows of slot k. mode: kRoutePlain, kRouteLoc (loc
// the [F, bb] i32 loc table) or kRouteRange; both EFB modes take unpacked
// bundle columns (f of them a row) and a kTblColsEfb-wide table.
extern "C" int lgbt_route_rows(const void* bins, const void* row_node_in,
                               const void* tbl, const void* member,
                               const void* feat_tbl, void* row_node_out,
                               void* row_slot_out, void* tallies,
                               void* counts, const void* loc, int n, int f,
                               int fh, int m, int w, int s, int bb, int mode,
                               void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int nchunks =
      n > 0 ? (n + lgbt::kChunkRows - 1) / lgbt::kChunkRows : 1;
  if (n == 0 && tallies == nullptr) return cudaSuccess;
  if (mode != lgbt::kRoutePlain && (fh > 0 || mode > lgbt::kRouteRange ||
                                    (mode == lgbt::kRouteLoc && !loc)))
    return cudaErrorInvalidValue;
  cudaError_t err;
#define LGBT_ROUTE(P, T, M)                                               \
  err = launch<P, T, M>(bins, row_node_in, tbl, member, feat_tbl, loc,    \
                        row_node_out, row_slot_out, tallies, n, f, fh, m, \
                        w, s, nchunks, bb, st)
  if (fh > 0) {
    if (tallies) LGBT_ROUTE(true, true, 0); else LGBT_ROUTE(true, false, 0);
  } else if (mode == lgbt::kRouteLoc) {
    if (tallies) LGBT_ROUTE(false, true, 1); else LGBT_ROUTE(false, false, 1);
  } else if (mode == lgbt::kRouteRange) {
    if (tallies) LGBT_ROUTE(false, true, 2); else LGBT_ROUTE(false, false, 2);
  } else {
    if (tallies) LGBT_ROUTE(false, true, 0); else LGBT_ROUTE(false, false, 0);
  }
#undef LGBT_ROUTE
  if (err != cudaSuccess || counts == nullptr || s == 0) return err;
  tally_sums_kernel<<<(s + kSumWarps - 1) / kSumWarps, kSumWarps * 32, 0,
                      st>>>(static_cast<const int*>(tallies), nchunks, s,
                            static_cast<int*>(counts));
  return cudaGetLastError();
}
