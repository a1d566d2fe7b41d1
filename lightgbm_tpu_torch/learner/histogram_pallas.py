"""Slot-grouped scatter histogram (hist_backend="pallas").

Port of lightgbm_tpu/learner/histogram_pallas.py. Rows are partitioned by
frontier slot on the device (`partition_rows`: the kernel
csrc/partition_rows.cu, a stable counting sort; `partition_rows_ref` is
its torch version), padded so that every `row_block` consecutive
positions hold rows of one slot. The histogram kernel
(csrc/build_histograms_scatter.cu) then walks each slot's blocks in runs
of at most RUN_BLOCKS blocks (`scatter_runs`), a CTA per run and feature
group with its cells in shared memory; a run that is its whole slot
writes the slot's cells once, the runs of a larger slot write partials
that a second kernel adds in run order. The TPU kernel contracts each
block with its bin one-hots on the MXU instead. The per-slot row counts
can come straight from `route_rows(emit_counts=True)`, so routing,
counting and partition metadata are one sweep.

Quantized mode (int8 gradients, int32 cells) gives integer sums, equal bit
for bit to the other histogram backends', so trees and model text do not
depend on the backend; exact mode sums each block in f32 and the blocks
in float64, rounded to f32 once.

`partition_rows` and `build_histograms_scatter` run their kernels for CUDA
tensors and their plain versions (`partition_rows_ref`, and
`build_histograms_scatter_ref`: the same partition and runs, then
index_add_) for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _cuda
from .histogram_mxu import (_check, _check_hist_args, _on_cpu, _unpacked,
                            _fill_const_hess, count_launch)

__all__ = ["build_histograms_scatter", "build_histograms_scatter_ref",
           "partition_rows", "partition_rows_ref", "scatter_runs",
           "slot_bounds", "RUN_BLOCKS"]

# partition blocks a histogram run takes at most: the root pass (one slot,
# ~1000 blocks at 1M rows) spreads over every SM, and large slots do not
# hold up the end of a pass (2, 4, 8 and 16 measured on the card, PERF.md)
RUN_BLOCKS = 4
# the partition kernel keeps 8 warps' per-slot counters in shared memory
_PARTITION_MAX_SLOTS = 232448 // (8 * 4) - 1
_PARTITION_CHUNK_ROWS = 8192
_IMPLS = ("auto", "argsort", "scan")


def partition_rows_ref(row_slot: torch.Tensor, *, num_slots: int,
                       row_block: int, counts: torch.Tensor = None,
                       impl: str = "auto"):
    """Plain version of partition_rows, in torch ops on the tensors'
    device: the padded partition of rows by frontier slot.

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
    if impl not in _IMPLS:
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


def _partition(row_slot, num_slots: int, row_block: int, counts, impl):
    """The partition kernel: (block_slot [TB], src [TB * row_block],
    bounds [num_slots + 2], the first block of every slot and the end of
    the trash slot's blocks), all i32, with no host sync."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown partition impl {impl!r}")
    n = row_slot.shape[0]
    _check(row_slot, "row_slot", torch.int32, (n,))
    if counts is not None:
        if counts.dim() != 1 or counts.shape[0] < num_slots:
            raise ValueError(f"counts: shape {tuple(counts.shape)}, need "
                             f"[>= {num_slots}]")
        _check(counts, "counts", torch.int32, (counts.shape[0],))
    if not 0 < num_slots <= _PARTITION_MAX_SLOTS:
        raise ValueError(f"num_slots {num_slots} outside (0, "
                         f"{_PARTITION_MAX_SLOTS}] (the partition kernel's "
                         "shared-memory counters)")
    dev = row_slot.device
    tb = -(-n // row_block) + num_slots + 1
    block_slot = torch.empty(tb, dtype=torch.int32, device=dev)
    src = torch.empty(tb * row_block, dtype=torch.int32, device=dev)
    bounds = torch.empty(num_slots + 2, dtype=torch.int32, device=dev)
    chunks = max(1, -(-n // _PARTITION_CHUNK_ROWS))
    scratch = torch.empty(chunks * (num_slots + 1), dtype=torch.int32,
                          device=dev)
    _cuda.call("partition_rows", dev, row_slot, counts, block_slot, src,
               bounds, scratch, n, num_slots, row_block, tb)
    count_launch("partition_rows")
    return block_slot, src, bounds


def partition_rows(row_slot: torch.Tensor, *, num_slots: int,
                   row_block: int, counts: torch.Tensor = None,
                   impl: str = "auto"):
    """Padded partition of rows by frontier slot: (block_slot [TB] i32,
    src [TB * row_block] i32), the layout of partition_rows_ref, through
    the partition kernel for CUDA tensors (counts: i32, [num_slots] or
    longer) and partition_rows_ref for CPU tensors."""
    if _on_cpu(row_slot):
        return partition_rows_ref(row_slot, num_slots=num_slots,
                                  row_block=row_block, counts=counts,
                                  impl=impl)
    block_slot, src, _ = _partition(row_slot, num_slots, row_block, counts,
                                    impl)
    return block_slot, src


def slot_bounds(block_slot: torch.Tensor, num_slots: int) -> torch.Tensor:
    """[num_slots + 1] i64: slot k < num_slots holds blocks [bounds[k],
    bounds[k + 1]) of a partition (block_slot is non-decreasing)."""
    ids = torch.arange(num_slots + 1, dtype=block_slot.dtype,
                       device=block_slot.device)
    return torch.searchsorted(block_slot, ids)


def scatter_runs(bounds: torch.Tensor, *, num_slots: int,
                 run_blocks: int = RUN_BLOCKS) -> torch.Tensor:
    """The histogram kernel's runs: [R, 4] i64 rows (first block, blocks,
    slot, partial), slot by slot and in block order. Each slot's blocks
    [bounds[k], bounds[k + 1]) are cut from its first block into runs of
    run_blocks (the last may be shorter). A slot of at most run_blocks
    blocks is one run, which writes the slot (partial -1); the runs of a
    larger slot write partials, the first at 2 (first // run_blocks) + 1,
    each later one at 2 (first // run_blocks), which no two runs share;
    the partials are added in run order. R <= ceil(TB / run_blocks) +
    num_slots."""
    first = bounds[:num_slots].to(torch.int64)
    last = bounds[1:num_slots + 1].to(torch.int64)
    nblk = last - first
    nrun = (nblk + run_blocks - 1) // run_blocks
    slot = torch.repeat_interleave(
        torch.arange(num_slots, device=bounds.device), nrun)
    i = torch.arange(slot.shape[0], device=bounds.device) - \
        torch.repeat_interleave(torch.cumsum(nrun, 0) - nrun, nrun)
    start = first[slot] + i * run_blocks
    blocks = torch.clamp(last[slot] - start, max=run_blocks)
    part = torch.where(nblk[slot] > run_blocks,
                       2 * (start // run_blocks) + (i == 0).to(torch.int64),
                       -1)
    return torch.stack([start, blocks, slot, part], dim=1)


def build_histograms_scatter_ref(bins, grad, hess, cnt, row_slot, *,
                                 num_slots: int, bmax: int,
                                 row_block: int = 1024,
                                 num_features: int = 0,
                                 const_hess: float = 0.0,
                                 quantized: bool = False,
                                 slot_counts: torch.Tensor = None,
                                 partition_impl: str = "auto"
                                 ) -> torch.Tensor:
    """Plain version of build_histograms_scatter: the same partition and
    runs; each run's rows summed into its (feature, bin) cells by
    index_add_ (float64, or int64 gradients and f32 counts when
    quantized), the runs added into their slots in run order, rounded to
    f32 once."""
    block_slot, src = partition_rows_ref(row_slot, num_slots=num_slots,
                                         row_block=row_block,
                                         counts=slot_counts,
                                         impl=partition_impl)
    runs = scatter_runs(slot_bounds(block_slot, num_slots),
                        num_slots=num_slots)
    n = row_slot.shape[0]
    dev = row_slot.device
    # the run of every block: the runs cover the slots' blocks in order
    # from block 0; the trash slot's blocks and the tail have none (-1)
    block_run = torch.repeat_interleave(
        torch.arange(runs.shape[0], device=dev), runs[:, 1])
    run_of_block = torch.full((block_slot.shape[0],), -1, dtype=torch.int64,
                              device=dev)
    run_of_block[:block_run.shape[0]] = block_run
    pos_run = run_of_block.repeat_interleave(row_block)
    keep = (src < n) & (pos_run >= 0)
    rows = src[keep].to(torch.int64)
    ub = _unpacked(bins, num_features)[rows]
    f = ub.shape[1]
    run_cells = ((pos_run[keep][:, None] * f +
                  torch.arange(f, device=dev)[None, :]) * bmax +
                 ub.to(torch.int64)).reshape(-1)
    g = grad[rows]
    h = torch.zeros_like(g) if const_hess else hess[rows]
    nr = runs.shape[0] * f * bmax
    # each run's cells added into its slot's, runs in order
    slot_cells = (runs[:, 2, None] * (f * bmax) +
                  torch.arange(f * bmax, device=dev)[None, :]).reshape(-1)

    def sums(data):
        c = data.shape[1]
        per_run = torch.zeros((nr, c), dtype=data.dtype, device=dev) \
            .index_add_(0, run_cells,
                        data[:, None, :].expand(-1, f, c).reshape(-1, c))
        return torch.zeros((num_slots * f * bmax, c), dtype=data.dtype,
                           device=dev).index_add_(0, slot_cells, per_run)

    if quantized:
        hist = torch.cat([sums(torch.stack([g, h], 1).to(torch.int64))
                          .to(torch.float32), sums(cnt[rows][:, None])], 1)
    else:
        hist = sums(torch.stack([g, h, cnt[rows]], 1).to(torch.float64)) \
            .to(torch.float32)
    return _fill_const_hess(hist.view(num_slots, f, bmax, 3), const_hess)


def build_histograms_scatter(bins, grad, hess, cnt, row_slot, *,
                             num_slots: int, bmax: int,
                             row_block: int = 1024, num_features: int = 0,
                             const_hess: float = 0.0,
                             quantized: bool = False,
                             slot_counts: torch.Tensor = None,
                             partition_impl: str = "auto") -> torch.Tensor:
    """Per-slot histograms [num_slots, F, bmax, 3] f32 (grad, hess, count)
    through the partition kernel and the slot-grouped scatter kernel; rows
    with slot < 0 or >= num_slots are dropped. num_features > 0: bins are
    4-bit packed with that many features. quantized: grad and hess are
    int8 and the gradient channels hold their unscaled integer sums.
    slot_counts: per-slot row counts from route_rows(emit_counts=True), so
    the partition skips its own count. partition_impl: partition_rows'
    impl."""
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
    dev = bins.device
    _check(row_slot, "row_slot", torch.int32, (n,))
    block_slot, src, bounds = _partition(row_slot, num_slots, row_block,
                                         slot_counts, partition_impl)
    tb = block_slot.shape[0]
    out = torch.empty((num_slots, f, bmax, 3), dtype=torch.float32,
                      device=dev)
    part = torch.empty((2 * -(-tb // RUN_BLOCKS), f * bmax * 3), device=dev,
                       dtype=torch.int32 if quantized else torch.float64)
    _cuda.call("build_histograms_scatter", dev, bins, grad, hess, cnt,
               block_slot, src, bounds, out, part, n, f, fh, bmax,
               num_slots, row_block, tb, RUN_BLOCKS, float(const_hess),
               int(quantized))
    count_launch("build_histograms_scatter", quantized=quantized,
                 packed=fh > 0)
    return out
