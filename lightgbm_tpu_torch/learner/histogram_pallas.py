"""Slot-grouped scatter histogram (hist_backend="pallas").

Port of lightgbm_tpu/learner/histogram_pallas.py. Rows are partitioned by
frontier slot on the device (`partition_rows`, torch ops as the JAX
version is XLA glue), padded so that every `row_block` consecutive
positions hold rows of one slot; the kernel (csrc/build_histograms_scatter
.cu) then accumulates each block into a histogram privatised in shared
memory and adds it into its slot's cells once — the reference's
cuda_histogram_constructor.cu design, where the TPU kernel contracts each
block with its bin one-hots on the MXU. The per-slot row counts can come
straight from `route_rows(emit_counts=True)`, so routing, counting and
partition metadata are one sweep.

Quantized mode (int8 gradients, int32 cells) gives integer sums, equal bit
for bit to the other histogram backends', so trees and model text do not
depend on the backend; exact mode sums each block in f32 and the blocks
in float64, with atomics.

`build_histograms_scatter` runs its kernel for CUDA tensors and its plain
version `build_histograms_scatter_ref` (the same partition, then index_add_
over the partitioned positions) for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _cuda
from .histogram_mxu import (_check, _check_hist_args, _hist_buffer,
                            _hist_result, _on_cpu, _unpacked,
                            build_histograms_ref, count_launch)

__all__ = ["build_histograms_scatter", "build_histograms_scatter_ref",
           "partition_rows"]

def partition_rows(row_slot: torch.Tensor, *, num_slots: int,
                   row_block: int, counts: torch.Tensor = None,
                   impl: str = "auto"):
    """Padded partition of rows by frontier slot, on the tensors' device.

    Every `row_block` consecutive positions of the layout hold rows of ONE
    slot, in row order within the slot; the trash slot `num_slots` takes
    parked rows (slot < 0 or >= num_slots) and the layout's tail. counts:
    optional per-slot row counts ([num_slots] or longer, e.g.
    route_rows(emit_counts=True)'s) — skips counting here. impl: the
    JAX package's names ("auto", "argsort", "scan"), which all give the
    one layout; every one ranks rows by a stable sort here, since on the
    card the radix sort beats the JAX package's blocked prefix sums
    (PERF.md).

    Returns (block_slot [TB] i32, src [TB * row_block] i32): src indexes
    the rows, n marking padding; TB = ceil(n / row_block) + num_slots + 1,
    the static bound of the JAX package's layout, which this one equals."""
    if impl not in ("auto", "argsort", "scan"):
        raise ValueError(f"unknown partition impl {impl!r}")
    n = row_slot.shape[0]
    s = num_slots
    nb = row_block
    dev = row_slot.device
    slot_full = torch.where((row_slot < 0) | (row_slot >= s), s,
                            row_slot).to(torch.int64)
    if counts is None:
        counts = torch.bincount(slot_full, minlength=s + 1)
    else:
        live = counts[:s].to(torch.int64)
        counts = torch.cat([live, (n - live.sum())[None]])
    sort_start = torch.cumsum(counts, 0) - counts
    order = torch.sort(slot_full, stable=True).indices

    # ceil(count / nb) blocks per slot, at least one
    caps = torch.clamp((counts + nb - 1) // nb, min=1)
    tb_max = (n + nb - 1) // nb + s + 1
    blk_start = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                           torch.cumsum(caps, 0)])
    j = torch.arange(tb_max, dtype=torch.int64, device=dev)
    block_slot = torch.clamp(
        torch.searchsorted(blk_start, j, right=True) - 1, 0, s)
    block_slot = torch.where(j >= blk_start[-1], s, block_slot)

    # source row of each position (n: padding)
    p = torch.arange(tb_max * nb, dtype=torch.int64, device=dev)
    pslot = block_slot[p // nb]
    r = p - blk_start[pslot] * nb                        # offset in slot
    take = (r >= 0) & (r < counts[pslot])
    src_sorted = torch.clamp(sort_start[pslot] + r, 0, max(n - 1, 0))
    src = torch.where(take, order[src_sorted], n)
    return block_slot.to(torch.int32), src.to(torch.int32)


def build_histograms_scatter_ref(bins, grad, hess, cnt, row_slot, *,
                                 num_slots: int, bmax: int,
                                 row_block: int = 1024,
                                 num_features: int = 0,
                                 const_hess: float = 0.0,
                                 quantized: bool = False,
                                 slot_counts: torch.Tensor = None,
                                 partition_impl: str = "auto"
                                 ) -> torch.Tensor:
    """Plain version of build_histograms_scatter: the same partition, then
    each slotted position's row added into its block's slot by
    index_add_ (build_histograms_ref over the partitioned positions)."""
    block_slot, src = partition_rows(row_slot, num_slots=num_slots,
                                     row_block=row_block, counts=slot_counts,
                                     impl=partition_impl)
    n = row_slot.shape[0]
    pos_slot = block_slot.to(torch.int64).repeat_interleave(row_block)
    keep = (src < n) & (pos_slot < num_slots)
    rows = src[keep].to(torch.int64)
    return build_histograms_ref(
        _unpacked(bins, num_features)[rows], grad[rows], hess[rows],
        cnt[rows], pos_slot[keep].to(torch.int32), num_slots=num_slots,
        bmax=bmax, const_hess=const_hess, quantized=quantized)


def build_histograms_scatter(bins, grad, hess, cnt, row_slot, *,
                             num_slots: int, bmax: int,
                             row_block: int = 1024, num_features: int = 0,
                             const_hess: float = 0.0,
                             quantized: bool = False,
                             slot_counts: torch.Tensor = None,
                             partition_impl: str = "auto") -> torch.Tensor:
    """Per-slot histograms [num_slots, F, bmax, 3] f32 (grad, hess, count)
    through the slot-grouped scatter kernel; rows with slot < 0 or >=
    num_slots are dropped. num_features > 0: bins are 4-bit packed with
    that many features. quantized: grad and hess are int8 and the gradient
    channels hold their unscaled integer sums. slot_counts: per-slot row
    counts from route_rows(emit_counts=True), so the partition skips its
    own count. partition_impl: partition_rows' impl."""
    kw = dict(num_slots=num_slots, bmax=bmax, row_block=row_block,
              num_features=num_features, const_hess=const_hess,
              quantized=quantized, slot_counts=slot_counts,
              partition_impl=partition_impl)
    if _on_cpu(bins, grad, hess, cnt, row_slot):
        return build_histograms_scatter_ref(bins, grad, hess, cnt, row_slot,
                                            **kw)
    f, fh = _check_hist_args(bins, grad, hess, cnt, bmax, quantized,
                            num_features)
    n = bins.shape[0]
    _check(row_slot, "row_slot", torch.int32, (n,))
    block_slot, src = partition_rows(row_slot, num_slots=num_slots,
                                     row_block=row_block, counts=slot_counts,
                                     impl=partition_impl)
    hist = _hist_buffer(num_slots, f, bmax, quantized, bins.device)
    _cuda.call("build_histograms_scatter", bins.device, bins, grad, hess, cnt,
               block_slot, src, hist, n, f, fh, bmax, num_slots, row_block,
               block_slot.shape[0], int(bool(const_hess)), int(quantized))
    count_launch("build_histograms_scatter", quantized=quantized,
                 packed=fh > 0)
    return _hist_result(hist, quantized, const_hess)
