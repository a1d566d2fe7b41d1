"""Routing, histogram and node-value kernels of the growth path.

Port of lightgbm_tpu/learner/histogram_mxu.py. The TPU kernels there turn
every per-row gather and scatter into one-hot matmuls on the MXU; on the
card those become plain indexing and atomics in four hand-written CUDA
kernels (csrc/):

  fused_route_hist  <- fused_route_hist_mxu   (route + histogram, one sweep)
  route_rows        <- route_rows_mxu         (route only)
  build_histograms  <- build_histograms_mxu   (histogram keyed by row_slot)
  node_values       <- node_values_mxu        (values[row_node])

Each wrapper runs its kernel for CUDA tensors and its plain PyTorch version
(`<name>_ref`, same module) for CPU tensors — chosen by the device of the
tensors it is given, nothing else; a tensor on any other device raises.
Each wrapper counts its kernel launches in a plain integer attribute,
`<wrapper>.launches` (see `launch_counts`).

Route tables (`pack_route_tables`) are int32 columns, one row per node id:
the TPU layout's base-256 digit pairs existed only to stay exact in bf16.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import _cuda

__all__ = ["fused_route_hist", "route_rows", "build_histograms",
           "node_values", "fused_route_hist_ref", "route_rows_ref",
           "build_histograms_ref", "node_values_ref", "pack_route_tables",
           "fused_fits", "fused_row_block", "launch_counts",
           "reset_launch_counts"]

# node table columns (csrc/route_hist.cuh keeps the same constants)
TBL_FLAGS, TBL_FEAT, TBL_THR, TBL_LEFT, TBL_RIGHT = 0, 1, 2, 3, 4
TBL_SLOT, TBL_SLOTL, TBL_SLOTR = 5, 6, 7
TBL_COLS = 8
FLAG_SPLIT, FLAG_DEFAULT_LEFT, FLAG_CAT = 1, 2, 4


def _round_up(x: int, k: int) -> int:
    return ((x + k - 1) // k) * k


# ---------------------------------------------------------------------------
# dispatch: which branch of the growth sweep a pass takes
# ---------------------------------------------------------------------------

_V2_BUDGET_BYTES = 80 * 1024 * 1024
_FGROUP = 4


def fused_fits(num_slots: int, num_features: int, bmax: int,
               row_block: int = 4096, const_hess: float = 0.0) -> bool:
    """Mirror of the reference's dispatch predicate (JAX package,
    histogram_mxu.fits_v2, exact double-bf16 channels, unquantized and
    unbundled): whether the TPU's fused kernel fits its VMEM budget at
    this shape. The port routes each growth pass down the branch the JAX
    package takes at the same shape — fused kernel or route_rows +
    build_histograms — so the same passes run the same kernels and a
    parity failure can be found pass by pass."""
    b = _round_up(bmax, 128)
    nchan = 3 if const_hess else 5
    out = nchan * num_slots * num_features * b * 4
    plane = _round_up(num_features, 128)
    inputs = row_block * (12 * plane + 24 * plane + 2 * _FGROUP * b)
    return out + inputs <= _V2_BUDGET_BYTES


def fused_row_block(num_slots: int, num_features: int, bmax: int,
                    const_hess: float) -> int:
    """The row block the reference's sweep sizes its fused kernel with
    (2048 at small frontiers; else the widest of 8192/4096/2048 whose
    working set fits) — an input of `fused_fits`."""
    if num_slots <= 64:
        return 2048
    for rb in (8192, 4096, 2048):
        if fused_fits(num_slots, num_features, bmax, rb, const_hess):
            break
    return rb


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

def route_rows_ref(bins, row_node, tbl, member, feat_tbl
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(new row_node, new row_slot) after one level of routing."""
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
    new_node = torch.where(split, child, row_node.to(torch.int32))
    new_slot = torch.where(split, slot_child, own_slot)
    return new_node.to(torch.int32), new_slot.to(torch.int32)


def build_histograms_ref(bins, grad, hess, cnt, row_slot, *, num_slots: int,
                         bmax: int, const_hess: float = 0.0) -> torch.Tensor:
    """[num_slots, F, bmax, 3] f32 (grad, hess, count) per-slot histograms
    by index_add_ over flattened (slot, feature, bin) cells; rows with slot
    < 0 or >= num_slots are dropped. const_hess != 0: hessian sums are
    const x count."""
    n, f = bins.shape
    dev = bins.device
    rows = torch.nonzero((row_slot >= 0) & (row_slot < num_slots))[:, 0]
    slot = row_slot[rows].to(torch.int64)
    cells = ((slot[:, None] * f + torch.arange(f, device=dev)[None, :])
             * bmax + bins[rows].to(torch.int64))               # [Nv, F]
    h = torch.zeros_like(grad[rows]) if const_hess else hess[rows]
    data = torch.stack([grad[rows], h, cnt[rows]], dim=1)        # [Nv, 3]
    hist = torch.zeros((num_slots * f * bmax, 3), dtype=torch.float32,
                       device=dev)
    hist.index_add_(0, cells.reshape(-1),
                    data[:, None, :].expand(-1, f, 3).reshape(-1, 3))
    return _fill_const_hess(hist.view(num_slots, f, bmax, 3), const_hess)


def fused_route_hist_ref(bins, grad, hess, cnt, row_node, tbl, member,
                         feat_tbl, *, num_slots: int, bmax: int,
                         const_hess: float = 0.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hist [num_slots, F, bmax, 3], new row_node): route one level, then
    histogram the rows by their new slot."""
    new_node, new_slot = route_rows_ref(bins, row_node, tbl, member,
                                        feat_tbl)
    hist = build_histograms_ref(bins, grad, hess, cnt, new_slot,
                                num_slots=num_slots, bmax=bmax,
                                const_hess=const_hess)
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


def _check_route_args(bins, row_node, tbl, member, feat_tbl) -> None:
    n, f = bins.shape
    _check(bins, "bins", torch.uint8, (n, f))
    _check(row_node, "row_node", torch.int32, (n,))
    _check(tbl, "tbl", torch.int32, (tbl.shape[0], TBL_COLS))
    _check(member, "member", torch.int32, (tbl.shape[0], member.shape[1]))
    _check(feat_tbl, "feat_tbl", torch.int32, (f, 2))


def _check_hist_args(bins, grad, hess, cnt, bmax) -> None:
    n, f = bins.shape
    _check(bins, "bins", torch.uint8, (n, f))
    for t, name in ((grad, "grad"), (hess, "hess"), (cnt, "cnt")):
        _check(t, name, torch.float32, (n,))
    if not 0 < bmax <= 256:
        raise ValueError(f"bmax {bmax} outside (0, 256] (uint8 bins)")


def fused_route_hist(bins, grad, hess, cnt, row_node, tbl, member, feat_tbl,
                     *, num_slots: int, bmax: int, const_hess: float = 0.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route rows through the previous pass's tables and build the new
    frontier's histograms in one sweep. Returns (hist [S, F, bmax, 3],
    new row_node [N] i32)."""
    args = (bins, grad, hess, cnt, row_node, tbl, member, feat_tbl)
    if _on_cpu(*args):
        return fused_route_hist_ref(*args, num_slots=num_slots, bmax=bmax,
                                    const_hess=const_hess)
    _check_route_args(bins, row_node, tbl, member, feat_tbl)
    _check_hist_args(bins, grad, hess, cnt, bmax)
    n, f = bins.shape
    hist = torch.zeros((num_slots, f, bmax, 3), dtype=torch.float32,
                       device=bins.device)
    out = torch.empty(n, dtype=torch.int32, device=bins.device)
    _cuda.call("fused_route_hist", bins.device, bins, grad, hess, cnt,
               row_node, tbl, member, feat_tbl, hist, out, n, f, bmax,
               num_slots, tbl.shape[0], member.shape[1], int(bool(const_hess)))
    fused_route_hist.launches += 1
    return _fill_const_hess(hist, const_hess), out


def route_rows(bins, row_node, tbl, member, feat_tbl
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance rows one level: (new row_node, new row_slot), both [N] i32."""
    if _on_cpu(bins, row_node, tbl, member, feat_tbl):
        return route_rows_ref(bins, row_node, tbl, member, feat_tbl)
    _check_route_args(bins, row_node, tbl, member, feat_tbl)
    n, f = bins.shape
    node_out = torch.empty(n, dtype=torch.int32, device=bins.device)
    slot_out = torch.empty(n, dtype=torch.int32, device=bins.device)
    _cuda.call("route_rows", bins.device, bins, row_node, tbl, member,
               feat_tbl, node_out, slot_out, n, f, tbl.shape[0],
               member.shape[1])
    route_rows.launches += 1
    return node_out, slot_out


def build_histograms(bins, grad, hess, cnt, row_slot, *, num_slots: int,
                     bmax: int, const_hess: float = 0.0) -> torch.Tensor:
    """Per-slot histograms [S, F, bmax, 3] keyed by row_slot (rows with
    slot < 0 or >= S dropped)."""
    if _on_cpu(bins, grad, hess, cnt, row_slot):
        return build_histograms_ref(bins, grad, hess, cnt, row_slot,
                                    num_slots=num_slots, bmax=bmax,
                                    const_hess=const_hess)
    _check_hist_args(bins, grad, hess, cnt, bmax)
    n, f = bins.shape
    _check(row_slot, "row_slot", torch.int32, (n,))
    hist = torch.zeros((num_slots, f, bmax, 3), dtype=torch.float32,
                       device=bins.device)
    _cuda.call("build_histograms", bins.device, bins, grad, hess, cnt,
               row_slot, hist, n, f, bmax, num_slots, int(bool(const_hess)))
    build_histograms.launches += 1
    return _fill_const_hess(hist, const_hess)


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
    node_values.launches += 1
    return out


_WRAPPERS = (fused_route_hist, route_rows, build_histograms, node_values)
for _w in _WRAPPERS:
    _w.launches = 0


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {w.__name__: w.launches for w in _WRAPPERS}


def reset_launch_counts() -> None:
    for w in _WRAPPERS:
        w.launches = 0
