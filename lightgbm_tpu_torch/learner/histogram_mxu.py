"""Routing, histogram and node-value kernels of the growth path.

Port of lightgbm_tpu/learner/histogram_mxu.py. The TPU kernels there turn
every per-row gather and scatter into one-hot matmuls on the MXU; on the
card those become plain indexing and atomics in hand-written CUDA kernels
(csrc/):

  fused_route_hist  <- fused_route_hist_mxu   (route + histogram, one sweep)
  route_rows        <- route_rows_mxu         (route only; with
                                               emit_counts, rows per slot)
  build_histograms  <- build_histograms_mxu and build_histograms_mxu_v2
                       (histogram keyed by row_slot; build_histograms_auto
                       is the JAX package's build_histograms_mxu_auto)
  node_values       <- node_values_mxu        (values[row_node])
  node_sums         <- node_sums_mxu          (exact per-node sums, refit)

The slot-grouped scatter histogram and its partition (histogram_pallas.py)
are the sixth and seventh.

The histogram kernels have two modes. Exact: f32 gradients into float64
cells, rounded to f32 once (the reference's double hist_t: in f32 cells,
~70k adds into one cell at 15 bins and sibling subtraction would put leaf
values off by orders of magnitude). Quantized (`quantized=True`, the JAX
kernels' flag of that name): int8 gradients from `quantize_gradients` into
int32 cells, returned as f32 integer sums that the caller scales; integer
sums are exact and do not depend on the order of the additions. The
routing and histogram kernels read the bin matrix unpacked ([N, F] uint8)
or 4-bit packed (`pack_bins_4bit`, [N, ceil(F/2)] uint8, `num_features=F`).

Each wrapper runs its kernel for CUDA tensors and its plain PyTorch version
(`<name>_ref`, same module) for CPU tensors — chosen by the device of the
tensors it is given, nothing else; a tensor on any other device raises.
Each wrapper counts its kernel launches per mode (`launch_counts`).

Route tables (`pack_route_tables`) are int32 columns, one row per node id:
the TPU layout's base-256 digit pairs existed only to stay exact in bf16.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .. import rng
from ..utils.log import Log
from . import _cuda

__all__ = ["fused_route_hist", "route_rows", "build_histograms",
           "build_histograms_auto", "node_values", "node_sums",
           "fused_route_hist_ref", "route_rows_ref", "build_histograms_ref",
           "node_values_ref", "node_sums_ref", "quantize_gradients",
           "pack_route_tables", "pack_bins_4bit", "unpack_bins_4bit",
           "fits_v2", "fused_row_block", "launch_counts",
           "reset_launch_counts"]

# node table columns (csrc/route_hist.cuh keeps the same constants)
TBL_FLAGS, TBL_FEAT, TBL_THR, TBL_LEFT, TBL_RIGHT = 0, 1, 2, 3, 4
TBL_SLOT, TBL_SLOTL, TBL_SLOTR = 5, 6, 7
TBL_COLS = 8
FLAG_SPLIT, FLAG_DEFAULT_LEFT, FLAG_CAT = 1, 2, 4


def _round_up(x: int, k: int) -> int:
    return ((x + k - 1) // k) * k


# ---------------------------------------------------------------------------
# 4-bit packed bin storage (reference 4-bit DenseBin, src/io/dense_bin.hpp:42)
# ---------------------------------------------------------------------------

def pack_bins_4bit(bins: np.ndarray):
    """Pack a [N, F] numpy bin matrix whose values all fit 4 bits (max_bin
    <= 15 incl. the NaN bin) into [N, ceil(F/2)] uint8 on the host, the
    JAX package's split-nibble layout: feature j < Fh rides column j's low
    nibble, feature Fh + j its high nibble (Fh = ceil(F/2)). Exact:
    training on packed storage grows the same trees. A bin id above 15
    would be truncated, so packing is refused: None, with a logged
    warning, and the caller keeps uint8 storage."""
    vmax = int(bins.max()) if bins.size else 0
    if vmax > 15:
        Log.warning(
            "pack_bins_4bit: bin id %d exceeds the 4-bit limit of 15 "
            "(max_bin incl. the NaN bin must be <= 15); keeping uint8 "
            "bin storage", vmax)
        return None
    n, f = bins.shape
    fh = (f + 1) // 2
    lo = bins[:, :fh].astype(np.uint8)
    hi = np.zeros((n, fh), np.uint8)
    hi[:, :f - fh] = bins[:, fh:].astype(np.uint8)
    return lo | (hi << 4)


def unpack_bins_4bit(packed: torch.Tensor,
                     num_features: int) -> torch.Tensor:
    """Inverse of pack_bins_4bit -> [N, num_features] uint8."""
    return torch.cat([packed & 15, packed >> 4],
                     dim=1)[:, :num_features].contiguous()


def _unpacked(bins, num_features: int):
    return unpack_bins_4bit(bins, num_features) if num_features else bins


# ---------------------------------------------------------------------------
# dispatch: which branch of the growth sweep a pass takes
# ---------------------------------------------------------------------------

_V2_BUDGET_BYTES = 80 * 1024 * 1024
_V2_ROW_BLOCK = 4096
_FGROUP = 4


def fits_v2(num_slots: int, num_features: int, bmax: int,
            quantized: bool = False, route_width: int = 0,
            row_block: int = _V2_ROW_BLOCK, const_hess: float = 0.0) -> bool:
    """The JAX package's fits_v2 (double-bf16 or quantized channels):
    whether the TPU's fused and v2 kernels fit their VMEM budget at this
    shape. The port routes each growth pass down the branch the JAX
    package takes at the same shape — fused kernel or route_rows +
    build_histograms, v2 or v1 histogram, packed storage or not — so the
    same passes run the same kernels and a parity failure can be found
    pass by pass. route_width: the routing table's feature width where it
    differs from the bins' (EFB in the JAX package)."""
    b = _round_up(bmax, 128)
    if const_hess:
        nchan = 2 if quantized else 3     # [g, cnt] / [g_hi, g_lo, cnt]
    else:
        nchan = 3 if quantized else 5
    out = nchan * num_slots * num_features * b * 4
    plane = _round_up(num_features, 128)
    flane_r = _round_up(max(route_width, num_features), 128)
    route_cost = 36 if route_width and route_width != num_features else 24
    inputs = row_block * (12 * plane + route_cost * flane_r +
                          2 * _FGROUP * b)
    return out + inputs <= _V2_BUDGET_BYTES


def fused_row_block(num_slots: int, num_features: int, bmax: int,
                    const_hess: float, quantized: bool = False) -> int:
    """The row block the reference's sweep sizes its fused kernel with
    (2048 at small frontiers; else the widest of 8192/4096/2048 whose
    working set fits) — an input of `fits_v2`."""
    if num_slots <= 64:
        return 2048
    for rb in (8192, 4096, 2048):
        if fits_v2(num_slots, num_features, bmax, quantized, row_block=rb,
                   const_hess=const_hess):
            break
    return rb


# ---------------------------------------------------------------------------
# gradient quantization (plain torch: the JAX function is no Pallas kernel)
# ---------------------------------------------------------------------------

def quantize_gradients(grad, hess, key):
    """Stochastically rounded integer gradients, as the JAX package's
    quantize_gradients: g_q = clip(floor(g / gscale + u), -127, 127) with
    gscale = max(max|g|, 1e-30) / 127 and u ~ U[0, 1) from split(key)[0]
    (hessians likewise from split(key)[1]). Returns (g_q, h_q, gscale,
    hscale): g_q, h_q integer-valued f32 [N], the scales f32 scalars, all
    on the device of `grad`. hess=None (constant hessian): h_q is None and
    hscale 1."""
    ku, kv = rng.split(key)
    g = grad.to(torch.float32)
    gscale = torch.clamp(torch.amax(torch.abs(g)), min=1e-30) / 127.0
    ug = rng.uniform(ku, g.shape[0])
    # clip: f32 rounding at the band edge (127 + u -> 128.0) can escape
    # the [-127, 127] band
    g_q = torch.clamp(torch.floor(g / gscale + ug), -127.0, 127.0)
    if hess is None:
        return g_q, None, gscale, torch.ones((), device=g.device)
    h = hess.to(torch.float32)
    hscale = torch.clamp(torch.amax(torch.abs(h)), min=1e-30) / 127.0
    uh = rng.uniform(kv, h.shape[0])
    h_q = torch.clamp(torch.floor(h / hscale + uh), -127.0, 127.0)
    return g_q, h_q, gscale, hscale


# ---------------------------------------------------------------------------
# route tables
# ---------------------------------------------------------------------------

def pack_route_tables(split_mask, feat, thr, default_left, is_cat, child_l,
                      child_r, slot_of_node, cat_bitset, m_pad: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Node tables for the routing kernels: ([m_pad, TBL_COLS] int32,
    [m_pad, W] int32 categorical left-set words). Each node row carries its
    children's next-pass slots, so routing picks the destination slot
    without a second lookup. Rows past the tree are unsplit, slot -1."""
    m1 = split_mask.shape[0]
    dev = split_mask.device
    cl_i = child_l.to(torch.int64).clamp(0, m1 - 1)
    cr_i = child_r.to(torch.int64).clamp(0, m1 - 1)
    neg1 = torch.full((), -1, dtype=torch.int32, device=dev)
    slot_of_node = slot_of_node.to(torch.int32)
    slot_l = torch.where(split_mask, slot_of_node[cl_i], neg1)
    slot_r = torch.where(split_mask, slot_of_node[cr_i], neg1)
    flags = (split_mask.to(torch.int32) * FLAG_SPLIT +
             default_left.to(torch.int32) * FLAG_DEFAULT_LEFT +
             is_cat.to(torch.int32) * FLAG_CAT)
    cols = [flags, feat, thr, child_l, child_r, slot_of_node, slot_l, slot_r]
    tbl = torch.zeros((m_pad, TBL_COLS), dtype=torch.int32, device=dev)
    tbl[:, TBL_SLOT:] = -1
    tbl[:m1] = torch.stack([c.to(torch.int32) for c in cols], dim=1)
    member = torch.zeros((m_pad, cat_bitset.shape[1]), dtype=torch.int32,
                         device=dev)
    # int64 words hold 32 bits; the cast keeps the low 32 (two's complement)
    member[:m1] = cat_bitset.to(torch.int32)
    return tbl, member


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the yardstick the kernels are held to)
# ---------------------------------------------------------------------------

def route_rows_ref(bins, row_node, tbl, member, feat_tbl, *,
                   num_features: int = 0, emit_counts: bool = False,
                   num_slots: int = 0):
    """(new row_node, new row_slot) after one level of routing; with
    emit_counts also the [num_slots] i32 count of rows whose new slot is
    in [0, num_slots). num_features > 0: bins are 4-bit packed."""
    bins = _unpacked(bins, num_features)
    m = tbl.shape[0]
    f = bins.shape[1]
    node = row_node.to(torch.int64)
    in_range = (node >= 0) & (node < m)
    row = tbl[node.clamp(0, m - 1)]                              # [N, 8]
    flags = torch.where(in_range, row[:, TBL_FLAGS], 0)
    feat = row[:, TBL_FEAT].to(torch.int64).clamp(0, f - 1)
    binv = torch.gather(bins, 1, feat[:, None])[:, 0].to(torch.int64)
    nb = feat_tbl[feat, 0].to(torch.int64)
    is_nan_bin = (feat_tbl[feat, 1] != 0) & (binv == nb - 1)
    num_left = torch.where(is_nan_bin, (flags & FLAG_DEFAULT_LEFT) != 0,
                           binv <= row[:, TBL_THR])
    w = member.shape[1]
    word = member[node.clamp(0, m - 1), (binv >> 5).clamp(0, w - 1)]
    cat_left = ((word.to(torch.int64) >> (binv & 31)) & 1) != 0
    left = torch.where((flags & FLAG_CAT) != 0, cat_left, num_left)
    split = (flags & FLAG_SPLIT) != 0
    child = torch.where(left, row[:, TBL_LEFT], row[:, TBL_RIGHT])
    slot_child = torch.where(left, row[:, TBL_SLOTL], row[:, TBL_SLOTR])
    own_slot = torch.where(in_range, row[:, TBL_SLOT], -1)
    new_node = torch.where(split, child, row_node.to(torch.int32)) \
        .to(torch.int32)
    new_slot = torch.where(split, slot_child, own_slot).to(torch.int32)
    if not emit_counts:
        return new_node, new_slot
    live = new_slot[(new_slot >= 0) & (new_slot < num_slots)]
    counts = torch.bincount(live.to(torch.int64), minlength=num_slots)
    return new_node, new_slot, counts.to(torch.int32)


def build_histograms_ref(bins, grad, hess, cnt, row_slot, *, num_slots: int,
                         bmax: int, const_hess: float = 0.0,
                         quantized: bool = False,
                         num_features: int = 0) -> torch.Tensor:
    """[num_slots, F, bmax, 3] f32 (grad, hess, count) per-slot histograms
    by index_add_ over flattened (slot, feature, bin) cells, summed in
    float64 and rounded once as the kernels' f32 mode does; rows with slot
    < 0 or >= num_slots are dropped. const_hess != 0: hessian sums are
    const x count. quantized: grad and hess hold whole numbers (int8 from
    quantize_gradients), summed exactly in int64; the result holds the
    unscaled integer sums. num_features > 0: bins are 4-bit packed."""
    bins = _unpacked(bins, num_features)
    n, f = bins.shape
    dev = bins.device
    rows = torch.nonzero((row_slot >= 0) & (row_slot < num_slots))[:, 0]
    slot = row_slot[rows].to(torch.int64)
    cells = ((slot[:, None] * f + torch.arange(f, device=dev)[None, :])
             * bmax + bins[rows].to(torch.int64)).reshape(-1)   # [Nv*F]
    g = grad[rows]
    h = torch.zeros_like(g) if const_hess else hess[rows]
    ncell = num_slots * f * bmax

    def cell_sums(data):                                          # [Nv, C]
        c = data.shape[1]
        out = torch.zeros((ncell, c), dtype=data.dtype, device=dev)
        return out.index_add_(0, cells,
                              data[:, None, :].expand(-1, f, c)
                              .reshape(-1, c))

    if quantized:
        gh = cell_sums(torch.stack([g, h], dim=1).to(torch.int64))
        hist = torch.cat([gh.to(torch.float32),
                          cell_sums(cnt[rows][:, None])], dim=1)
    else:
        hist = cell_sums(torch.stack([g, h, cnt[rows]], dim=1)
                         .to(torch.float64)).to(torch.float32)
    return _fill_const_hess(hist.view(num_slots, f, bmax, 3), const_hess)


def fused_route_hist_ref(bins, grad, hess, cnt, row_node, tbl, member,
                         feat_tbl, *, num_slots: int, bmax: int,
                         const_hess: float = 0.0, quantized: bool = False,
                         num_features: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hist [num_slots, F, bmax, 3], new row_node): route one level, then
    histogram the rows by their new slot."""
    bins = _unpacked(bins, num_features)
    new_node, new_slot = route_rows_ref(bins, row_node, tbl, member,
                                        feat_tbl)
    hist = build_histograms_ref(bins, grad, hess, cnt, new_slot,
                                num_slots=num_slots, bmax=bmax,
                                const_hess=const_hess, quantized=quantized)
    return hist, new_node


def node_values_ref(row_node, values) -> torch.Tensor:
    """values[row_node]; non-finite entries and out-of-range ids read 0."""
    m = values.shape[0]
    node = row_node.to(torch.int64)
    v = torch.where(torch.isfinite(values), values,
                    torch.zeros((), dtype=values.dtype, device=values.device))
    got = v[node.clamp(0, m - 1)]
    return torch.where((node >= 0) & (node < m), got,
                       torch.zeros((), dtype=got.dtype, device=got.device))


def node_sums_ref(row_node, grad, hess, cnt, *, num_nodes: int
                  ) -> torch.Tensor:
    """[num_nodes, 3] f32 per-node (sum grad, sum hess, sum count), summed
    in float64 and rounded once; rows whose node is < 0 or >= num_nodes
    are ignored."""
    node = row_node.to(torch.int64)
    keep = (node >= 0) & (node < num_nodes)
    data = torch.stack([grad, hess, cnt], dim=1)[keep].to(torch.float64)
    out = torch.zeros((num_nodes, 3), dtype=torch.float64,
                      device=row_node.device)
    return out.index_add_(0, node[keep], data).to(torch.float32)


def _fill_const_hess(hist: torch.Tensor, const_hess: float) -> torch.Tensor:
    """The kernels skip the hessian channel for constant-hessian
    objectives; it is exactly const x count (the reference's
    IsConstantHessian fast path, objective_function.h:42)."""
    if const_hess:
        hist[..., 1] = hist[..., 2] * const_hess
    return hist


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _on_cpu(*tensors) -> bool:
    """True for CPU tensors (plain version), False for CUDA tensors of one
    device (kernel); anything else raises."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} "
                             f"and {dev}")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _bin_dims(bins: torch.Tensor, num_features: int) -> Tuple[int, int]:
    """(logical feature count F, packed bytes a row fh or 0 if unpacked) of
    a bin matrix; checks its dtype, layout and packed width."""
    n, fcols = bins.shape
    _check(bins, "bins", torch.uint8, (n, fcols))
    if not num_features:
        return fcols, 0
    if fcols != (num_features + 1) // 2:
        raise ValueError(f"packed bins: {fcols} columns for {num_features} "
                         "features, expected ceil(F/2)")
    return num_features, fcols


def _check_route_args(bins, row_node, tbl, member, feat_tbl,
                      num_features) -> Tuple[int, int]:
    f, fh = _bin_dims(bins, num_features)
    _check(row_node, "row_node", torch.int32, (bins.shape[0],))
    _check(tbl, "tbl", torch.int32, (tbl.shape[0], TBL_COLS))
    _check(member, "member", torch.int32, (tbl.shape[0], member.shape[1]))
    _check(feat_tbl, "feat_tbl", torch.int32, (f, 2))
    return f, fh


def _check_hist_args(bins, grad, hess, cnt, bmax, quantized,
                    num_features) -> Tuple[int, int]:
    """Checks the histogram kernels' inputs; returns _bin_dims."""
    f, fh = _bin_dims(bins, num_features)
    n = bins.shape[0]
    gdt = torch.int8 if quantized else torch.float32
    for t, name, dt in ((grad, "grad", gdt), (hess, "hess", gdt),
                        (cnt, "cnt", torch.float32)):
        _check(t, name, dt, (n,))
    if not 0 < bmax <= 256:
        raise ValueError(f"bmax {bmax} outside (0, 256] (uint8 bins)")
    return f, fh


def _hist_buffer(num_slots, f, bmax, quantized, device) -> torch.Tensor:
    """Zeroed [S, F, bmax, 3] cells the histogram kernels add into: float64
    (f32 mode; the reference's double hist_t, rounded to f32 once by
    _hist_result), or (quantized) int32 gradient cells beside f32 count
    bits."""
    return torch.zeros((num_slots, f, bmax, 3), device=device,
                       dtype=torch.int32 if quantized else torch.float64)


def _hist_result(hist, quantized, const_hess) -> torch.Tensor:
    """The kernels' cells as [S, F, bmax, 3] f32 (float64 sums rounded,
    integer gradient sums converted, count bits reinterpreted), hessians
    filled for const_hess."""
    raw = hist
    hist = raw.to(torch.float32)
    if quantized:
        hist[..., 2] = raw.view(torch.float32)[..., 2]
    return _fill_const_hess(hist, const_hess)


def fused_route_hist(bins, grad, hess, cnt, row_node, tbl, member, feat_tbl,
                     *, num_slots: int, bmax: int, const_hess: float = 0.0,
                     quantized: bool = False, num_features: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route rows through the previous pass's tables and build the new
    frontier's histograms in one sweep. Returns (hist [S, F, bmax, 3],
    new row_node [N] i32). quantized: grad and hess are int8 and the
    gradient channels hold their unscaled integer sums. num_features > 0:
    bins are 4-bit packed (pack_bins_4bit) with that many features."""
    args = (bins, grad, hess, cnt, row_node, tbl, member, feat_tbl)
    if _on_cpu(*args):
        return fused_route_hist_ref(*args, num_slots=num_slots, bmax=bmax,
                                    const_hess=const_hess,
                                    quantized=quantized,
                                    num_features=num_features)
    f, fh = _check_route_args(bins, row_node, tbl, member, feat_tbl,
                              num_features)
    _check_hist_args(bins, grad, hess, cnt, bmax, quantized, num_features)
    n = bins.shape[0]
    hist = _hist_buffer(num_slots, f, bmax, quantized, bins.device)
    out = torch.empty(n, dtype=torch.int32, device=bins.device)
    _cuda.call("fused_route_hist", bins.device, bins, grad, hess, cnt,
               row_node, tbl, member, feat_tbl, hist, out, n, f, fh, bmax,
               num_slots, tbl.shape[0], member.shape[1], int(bool(const_hess)),
               int(quantized))
    count_launch("fused_route_hist", quantized=quantized, packed=fh > 0)
    return _hist_result(hist, quantized, const_hess), out


def route_rows(bins, row_node, tbl, member, feat_tbl, *,
               num_features: int = 0, emit_counts: bool = False,
               num_slots: int = 0):
    """Advance rows one level: (new row_node, new row_slot), both [N] i32.
    emit_counts (needs num_slots > 0): also the [num_slots] i32 count of
    rows whose new slot is in [0, num_slots), parked rows excluded — the
    metadata of the scatter histogram's partition, from the same sweep.
    num_features > 0: bins are 4-bit packed."""
    if emit_counts and num_slots <= 0:
        raise ValueError("emit_counts needs num_slots > 0")
    kw = dict(num_features=num_features, emit_counts=emit_counts,
              num_slots=num_slots)
    if _on_cpu(bins, row_node, tbl, member, feat_tbl):
        return route_rows_ref(bins, row_node, tbl, member, feat_tbl, **kw)
    f, fh = _check_route_args(bins, row_node, tbl, member, feat_tbl,
                              num_features)
    n = bins.shape[0]
    dev = bins.device
    node_out = torch.empty(n, dtype=torch.int32, device=dev)
    slot_out = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.zeros(num_slots, dtype=torch.int32, device=dev) \
        if emit_counts else None
    _cuda.call("route_rows", dev, bins, row_node, tbl, member, feat_tbl,
               node_out, slot_out, counts, n, f, fh, tbl.shape[0],
               member.shape[1], num_slots if emit_counts else 0)
    count_launch("route_rows", counts=emit_counts, packed=fh > 0)
    if emit_counts:
        return node_out, slot_out, counts
    return node_out, slot_out


def build_histograms(bins, grad, hess, cnt, row_slot, *, num_slots: int,
                     bmax: int, const_hess: float = 0.0,
                     quantized: bool = False,
                     num_features: int = 0) -> torch.Tensor:
    """Per-slot histograms [S, F, bmax, 3] keyed by row_slot (rows with
    slot < 0 or >= S dropped). quantized, num_features: as in
    fused_route_hist."""
    if _on_cpu(bins, grad, hess, cnt, row_slot):
        return build_histograms_ref(bins, grad, hess, cnt, row_slot,
                                    num_slots=num_slots, bmax=bmax,
                                    const_hess=const_hess,
                                    quantized=quantized,
                                    num_features=num_features)
    f, fh = _check_hist_args(bins, grad, hess, cnt, bmax, quantized,
                            num_features)
    n = bins.shape[0]
    _check(row_slot, "row_slot", torch.int32, (n,))
    hist = _hist_buffer(num_slots, f, bmax, quantized, bins.device)
    _cuda.call("build_histograms", bins.device, bins, grad, hess, cnt,
               row_slot, hist, n, f, fh, bmax, num_slots,
               int(bool(const_hess)), int(quantized))
    count_launch("build_histograms", quantized=quantized, packed=fh > 0)
    return _hist_result(hist, quantized, const_hess)


def build_histograms_auto(bins, grad, hess, cnt, row_slot, *,
                          num_slots: int, bmax: int, const_hess: float = 0.0,
                          quantized: bool = False,
                          num_features: int = 0) -> torch.Tensor:
    """The JAX package's build_histograms_mxu_auto: the v2 kernel's
    function (one row pass, reads packed bins) where fits_v2 holds at its
    default row block, else the v1 kernel's, on bins unpacked first (the
    JAX v1 kernel cannot read nibbles; packed storage targets small-bmax
    shapes, which always fit v2). Both are build_histograms here."""
    f = num_features or bins.shape[1]
    if not fits_v2(num_slots, f, bmax, quantized, const_hess=const_hess):
        bins, num_features = _unpacked(bins, num_features), 0
    return build_histograms(bins, grad, hess, cnt, row_slot,
                            num_slots=num_slots, bmax=bmax,
                            const_hess=const_hess, quantized=quantized,
                            num_features=num_features)


def node_values(row_node, values) -> torch.Tensor:
    """values[row_node] as [N] f32; non-finite table entries and
    out-of-range ids read 0 (score updates, reference
    score_updater.hpp:21-110)."""
    if _on_cpu(row_node, values):
        return node_values_ref(row_node, values)
    n = row_node.shape[0]
    _check(row_node, "row_node", torch.int32, (n,))
    _check(values, "values", torch.float32, (values.shape[0],))
    out = torch.empty(n, dtype=torch.float32, device=row_node.device)
    _cuda.call("node_values", row_node.device, row_node, values, out, n,
               values.shape[0])
    count_launch("node_values")
    return out


def node_sums(row_node, grad, hess, cnt, *, num_nodes: int) -> torch.Tensor:
    """Exact per-node (sum grad, sum hess, sum count) as [num_nodes, 3]
    f32; rows whose node is < 0 or >= num_nodes are ignored. The kernel's
    sums are deterministic: fixed-point int64 accumulation (csrc/
    node_sums.cu), within ~1e-13 of max|x| per row of the float64 sum.
    Inputs must be finite."""
    if _on_cpu(row_node, grad, hess, cnt):
        return node_sums_ref(row_node, grad, hess, cnt, num_nodes=num_nodes)
    n = row_node.shape[0]
    _check(row_node, "row_node", torch.int32, (n,))
    for t, name in ((grad, "grad"), (hess, "hess"), (cnt, "cnt")):
        _check(t, name, torch.float32, (n,))
    dev = row_node.device
    out = torch.empty((num_nodes, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return out.zero_()
    amax = torch.stack([torch.amax(torch.abs(t)) for t in (grad, hess, cnt)])
    acc = torch.zeros((num_nodes, 3), dtype=torch.int64, device=dev)
    _cuda.call("node_sums", dev, row_node, grad, hess, cnt, amax, acc, out,
               n, num_nodes)
    count_launch("node_sums")
    return out


# ---------------------------------------------------------------------------
# launch counts
# ---------------------------------------------------------------------------

# each kernel's modes, as suffixes of its launch-count keys: "_int"
# quantized (int8 gradients, int32 cells), "_counts" route_rows'
# emit_counts, "_packed" 4-bit packed bins; a launch counts under its
# wrapper's name plus the suffixes of the modes it ran in, in this order
_MODES = {"fused_route_hist": ("_int", "_packed"),
          "route_rows": ("_counts", "_packed"),
          "build_histograms": ("_int", "_packed"),
          "build_histograms_scatter": ("_int", "_packed"),
          # histogram_pallas: the partition inside build_histograms_scatter
          "partition_rows": (),
          "node_values": (), "node_sums": (),
          # split_kernel.find_best_splits_kernel: plain and monotone modes
          "find_best_splits": (), "find_best_splits_mono": ()}
_LAUNCHES: Dict[str, int] = {}


def count_launch(name: str, *, quantized: bool = False, packed: bool = False,
                 counts: bool = False) -> None:
    """Count one kernel launch of wrapper `name` in the given modes."""
    key = name + "_int" * quantized + "_counts" * counts + "_packed" * packed
    _LAUNCHES[key] += 1


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, one key per kernel and mode:
    the wrapper's name for its plain mode, suffixed "_int" (quantized),
    "_counts" (emit_counts) and "_packed" (4-bit bins) for the others."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()
    for name, suffixes in _MODES.items():
        keys = [name]
        for suf in suffixes:
            keys += [k + suf for k in keys]
        _LAUNCHES.update(dict.fromkeys(keys, 0))


reset_launch_counts()
