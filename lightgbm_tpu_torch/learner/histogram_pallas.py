"""Slot-grouped scatter histogram (hist_backend="pallas").

Port of lightgbm_tpu/learner/histogram_pallas.py. Rows are partitioned by
frontier slot on the device (`partition_rows`: the kernel
csrc/partition_rows.cu, a stable counting sort over chunks of
histogram_mxu.CHUNK_ROWS rows; `partition_rows_ref` is its torch
version), padded so that every `row_block` consecutive positions hold
rows of one slot. The histogram kernel
(csrc/build_histograms_scatter.cu) then walks each slot's blocks in runs
of at most RUN_BLOCKS blocks (`scatter_runs`), a CTA per run and feature
group with its cells in shared memory; a run that is its whole slot
writes the slot's cells once, the runs of a larger slot write partials
that a second kernel adds in run order. The TPU kernel contracts each
block with its bin one-hots on the MXU instead. The rows per slot and
chunk can come straight from `route_rows(emit_counts=True,
chunk_tallies=True)`, so routing and counting are one sweep and the
partition runs no count pass of its own. The same partition and
kernel serve histogram_mxu.build_histograms (the JAX package's
build_histograms_mxu and _v2) and, after route_rows with chunk tallies,
histogram_mxu.fused_route_hist on the card: `scatter_histograms` launches
both for each of these wrappers.

The kernel also reads [N, F] uint16 bins at a bin axis up to
histogram_mxu.wide_bin_limit (max_bin > 256: the portable grower's
histograms, where the JAX package calls its compat wrapper
`build_histograms_pallas`),
and rounds each hessian to bf16 in the single-precision mode
(double_prec=False, histogram_mxu's module docstring).

Both modes give integer sums, equal bit for bit to the other histogram
kernels' (histogram_mxu's fused_route_hist and build_histograms), so
trees and model text do not depend on the backend: quantized mode adds
int8 gradients into int32 cells, exact mode adds each f32 value as a
fixed-point int64 (histogram_mxu.exact_scale) and scales the sums back
once.

`partition_rows` and `build_histograms_scatter` run their kernels for CUDA
tensors and their plain versions (`partition_rows_ref`, and
`build_histograms_scatter_ref`: the same partition and runs, then
index_add_) for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _cuda
from .histogram_mxu import (_check, _check_hist_args, _exact_result,
                            _fill_const_hess, _fixed_point, _on_cpu,
                            _scale_of, _single, _unpacked, count_launch,
                            exact_scale, num_chunks, rows_int64, scratch,
                            single_prec_hess)

__all__ = ["build_histograms_scatter", "build_histograms_scatter_ref",
           "partition_rows", "partition_rows_ref", "scatter_histograms",
           "scatter_runs",
           "slot_bounds", "RUN_BLOCKS"]

# partition blocks a histogram run takes at most: the root pass (one slot,
# ~1000 blocks at 1M rows) spreads over every SM, and large slots do not
# hold up the end of a pass (2, 4, 8 and 16 measured on the card, PERF.md)
RUN_BLOCKS = 4
# exact mode: rows a run may hold (row_block x RUN_BLOCKS), so that its
# 32-bit shared-memory words cannot overflow (csrc kWordRows)
_WORD_ROWS = 4096
# slots a partition launch takes, twice the widest frontier of the growth
# plan at num_leaves 255: its scatter kernel keeps 8 warps' per-slot
# counters and a staged chunk in shared memory (64 KB at 1023 slots)
_PARTITION_MAX_SLOTS = 1023
_IMPLS = ("auto", "argsort", "scan")


def partition_rows_ref(row_slot: torch.Tensor, *, num_slots: int,
                       row_block: int, counts: torch.Tensor = None,
                       impl: str = "auto", tallies: torch.Tensor = None):
    """Plain version of partition_rows, in torch ops on the tensors'
    device: the padded partition of rows by frontier slot.

    Every `row_block` consecutive positions of the layout hold rows of ONE
    slot, in row order within the slot; the trash slot `num_slots` takes
    parked rows (slot < 0 or >= num_slots) and the layout's tail. counts:
    optional per-slot row counts ([num_slots] or longer, e.g.
    route_rows(emit_counts=True)'s) — skips counting here; or tallies:
    the [num_slots + 1, C] rows per slot and chunk
    (route_rows(emit_counts=True, chunk_tallies=True)'s, trash slot
    included), whose row sums are the counts. impl: the
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
    if tallies is not None:
        if counts is not None:
            raise ValueError("give counts or tallies, not both")
        counts = tallies.to(torch.int64).sum(1)
    elif counts is None:
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
    # no rows: every position is padding (and `order` is empty)
    src = torch.where(take, order[src_sorted], n) if n else \
        torch.zeros_like(p)
    return block_slot.to(torch.int32), src.to(torch.int32)


def _partition(row_slot, num_slots: int, row_block: int, counts, impl,
               tallies=None, reuse: bool = False):
    """The partition kernel: (block_slot [TB], src [TB * row_block],
    bounds [num_slots + 2], the first block of every slot and the end of
    the trash slot's blocks), all i32, with no host sync. tallies
    ([num_slots + 1, C] i32, route_rows' chunk tallies of row_slot): the
    kernel runs no count pass. Without them it counts per chunk itself,
    so counts (checked, [>= num_slots] i32) that agree with row_slot give
    the same layout as none. reuse: the outputs live in the device's
    scratch buffer, valid until the next partition on the device."""
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
    chunks = num_chunks(n)
    if tallies is not None:
        if counts is not None:
            raise ValueError("give counts or tallies, not both")
        _check(tallies, "tallies", torch.int32, (num_slots + 1, chunks))
    tb = -(-n // row_block) + num_slots + 1
    if tb * row_block >= 2 ** 31:
        raise ValueError(f"{tb * row_block} partition positions: the "
                         "kernel indexes them with int32")
    dev = row_slot.device
    work = (num_slots + 1) * (2 * chunks + 1)
    if reuse:
        size = tb * row_block
        buf = scratch(dev, "partition", size + tb + num_slots + 2 + work)
        src = buf[:size]
        block_slot = buf[size:size + tb]
        bounds = buf[size + tb:size + tb + num_slots + 2]
        work = buf[size + tb + num_slots + 2:]
    else:
        block_slot = torch.empty(tb, dtype=torch.int32, device=dev)
        src = torch.empty(tb * row_block, dtype=torch.int32, device=dev)
        bounds = torch.empty(num_slots + 2, dtype=torch.int32, device=dev)
        work = scratch(dev, "partition_work", work)
    _cuda.call("partition_rows", dev, row_slot, tallies, block_slot, src,
               bounds, work, n, num_slots, row_block, tb)
    count_launch("partition_rows")
    return block_slot, src, bounds


def partition_rows(row_slot: torch.Tensor, *, num_slots: int,
                   row_block: int, counts: torch.Tensor = None,
                   impl: str = "auto", tallies: torch.Tensor = None):
    """Padded partition of rows by frontier slot: (block_slot [TB] i32,
    src [TB * row_block] i32), the layout of partition_rows_ref, through
    the partition kernel for CUDA tensors (counts: i32, [num_slots] or
    longer; tallies: route_rows' [num_slots + 1, C] i32 chunk tallies) and
    partition_rows_ref for CPU tensors."""
    if _on_cpu(row_slot):
        return partition_rows_ref(row_slot, num_slots=num_slots,
                                  row_block=row_block, counts=counts,
                                  impl=impl, tallies=tallies)
    block_slot, src, _ = _partition(row_slot, num_slots, row_block, counts,
                                    impl, tallies)
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
                                 partition_impl: str = "auto",
                                 scale: torch.Tensor = None,
                                 slot_tallies: torch.Tensor = None,
                                 double_prec: bool = True
                                 ) -> torch.Tensor:
    """Plain version of build_histograms_scatter: the same partition and
    runs; each run's rows summed into its (feature, bin) cells by
    index_add_ (int64 fixed-point values under `scale`, exact_scale of
    grad, hess, cnt when None; or int64 gradients and f32 counts when
    quantized), the runs added into their slots in run order, scaled back
    once; double_prec=False rounds each hessian to bf16 first. Integer
    sums: the result is build_histograms_ref's bit for bit, NaN channels
    included."""
    if _single(double_prec, quantized, const_hess):
        hess = single_prec_hess(hess)
    block_slot, src = partition_rows_ref(row_slot, num_slots=num_slots,
                                         row_block=row_block,
                                         counts=slot_counts,
                                         impl=partition_impl,
                                         tallies=slot_tallies)
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
    ub = rows_int64(_unpacked(bins, num_features), rows)
    f = ub.shape[1]
    run_cells = ((pos_run[keep][:, None] * f +
                  torch.arange(f, device=dev)[None, :]) * bmax +
                 ub).reshape(-1)
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
        k = exact_scale(grad, hess, cnt) if scale is None else scale
        hist = _exact_result(
            sums(_fixed_point(torch.stack([g, h, cnt[rows]], 1), k)), k)
    return _fill_const_hess(hist.view(num_slots, f, bmax, 3), const_hess)


def build_histograms_scatter(bins, grad, hess, cnt, row_slot, *,
                             num_slots: int, bmax: int,
                             row_block: int = 1024, num_features: int = 0,
                             const_hess: float = 0.0,
                             quantized: bool = False,
                             slot_counts: torch.Tensor = None,
                             partition_impl: str = "auto",
                             scale: torch.Tensor = None,
                             slot_tallies: torch.Tensor = None,
                             double_prec: bool = True
                             ) -> torch.Tensor:
    """Per-slot histograms [num_slots, F, bmax, 3] f32 (grad, hess, count)
    through the partition kernel and the slot-grouped scatter kernel; rows
    with slot < 0 or >= num_slots are dropped. num_features > 0: bins are
    4-bit packed with that many features; uint16 bins (max_bin > 256) are
    read at bmax up to histogram_mxu.wide_bin_limit, counted with "_wide";
    double_prec=False: single-precision hessians, counted with "_sp".
    quantized: grad and hess are
    int8 and the gradient channels hold their unscaled integer sums; else
    scale ([3] i32, exact_scale of grad, hess, cnt when None) is the fixed
    point of the sums. slot_counts: per-slot row counts from
    route_rows(emit_counts=True); slot_tallies: its chunk tallies
    (chunk_tallies=True), so the partition skips its own count.
    partition_impl: partition_rows' impl."""
    kw = dict(num_slots=num_slots, bmax=bmax, row_block=row_block,
              num_features=num_features, const_hess=const_hess,
              quantized=quantized, slot_counts=slot_counts,
              partition_impl=partition_impl, scale=scale,
              slot_tallies=slot_tallies, double_prec=double_prec)
    if _on_cpu(bins, grad, hess, cnt, row_slot):
        return build_histograms_scatter_ref(bins, grad, hess, cnt, row_slot,
                                            **kw)
    return scatter_histograms("build_histograms_scatter", bins, grad, hess,
                              cnt, row_slot, **kw)


def scatter_histograms(name, bins, grad, hess, cnt, row_slot, *,
                       num_slots: int, bmax: int, row_block: int = 1024,
                       num_features: int = 0, const_hess: float = 0.0,
                       quantized: bool = False,
                       slot_counts: torch.Tensor = None,
                       partition_impl: str = "auto",
                       scale: torch.Tensor = None,
                       slot_tallies: torch.Tensor = None,
                       double_prec: bool = True) -> torch.Tensor:
    """The card's per-slot histograms for CUDA tensors, behind
    build_histograms_scatter, histogram_mxu.build_histograms and
    histogram_mxu.fused_route_hist (`name`:
    the wrapper whose launch count the scatter kernel adds to; the
    partition counts as partition_rows): the partition kernel, then the
    scatter kernel, one launch of each per at most _PARTITION_MAX_SLOTS
    slots (wider frontiers go in slot ranges, the others' rows parked, and
    the partition counts each range itself: slot_tallies serve one range
    only). The partition and the scatter kernel's partials live in the
    device's scratch buffers: only the output is allocated. Arguments as
    build_histograms_scatter's."""
    f, fh = _check_hist_args(bins, grad, hess, cnt, bmax, quantized,
                            num_features, wide_ok=True)
    wide = bins.dtype == torch.uint16
    n = bins.shape[0]
    dev = bins.device
    _check(row_slot, "row_slot", torch.int32, (n,))
    single = _single(double_prec, quantized, const_hess)
    scale = _scale_of(scale, grad, hess, cnt, quantized, single)
    if not quantized and row_block * RUN_BLOCKS > _WORD_ROWS:
        raise ValueError(f"row_block {row_block}: exact mode holds at most "
                         f"{_WORD_ROWS // RUN_BLOCKS} rows a block")
    out = torch.empty((num_slots, f, bmax, 3), dtype=torch.float32,
                      device=dev)
    one_range = num_slots <= _PARTITION_MAX_SLOTS
    for s0 in range(0, num_slots, _PARTITION_MAX_SLOTS):
        s = min(_PARTITION_MAX_SLOTS, num_slots - s0)
        sl = row_slot if s0 == 0 else row_slot - s0
        if one_range and slot_tallies is not None:
            block_slot, src, bounds = _partition(
                sl, s, row_block, None, partition_impl, slot_tallies, True)
        else:
            counts = None if slot_counts is None else \
                slot_counts[s0:s0 + s]
            block_slot, src, bounds = _partition(sl, s, row_block, counts,
                                                 partition_impl, None, True)
        tb = block_slot.shape[0]
        part = scratch(dev, "scatter_part" + "_int" * quantized,
                       2 * -(-tb // RUN_BLOCKS) * f * bmax * 3,
                       torch.int32 if quantized else torch.int64)
        _cuda.call("build_histograms_scatter", dev, bins, grad, hess, cnt,
                   block_slot, src, bounds, scale, out[s0:s0 + s], part, n,
                   f, fh, bmax, s, row_block, tb, RUN_BLOCKS,
                   float(const_hess), int(quantized), int(single), int(wide))
        count_launch(name, quantized=quantized, packed=fh > 0,
                     single=single, wide=wide)
    return out

