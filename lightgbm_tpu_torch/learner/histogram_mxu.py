"""Routing, histogram and node-value kernels of the growth path.

Port of lightgbm_tpu/learner/histogram_mxu.py. The TPU kernels there turn
every per-row gather and scatter into one-hot matmuls on the MXU; on the
card those become plain indexing and atomics in hand-written CUDA kernels
(csrc/):

  fused_route_hist  <- fused_route_hist_mxu   (route + histogram; on the
                                               card route_rows with chunk
                                               tallies, then the partition
                                               and the scatter kernel)
  route_rows        <- route_rows_mxu         (route only; with
                                               emit_counts, rows per slot,
                                               or per slot and partition
                                               chunk)
  build_histograms  <- build_histograms_mxu and build_histograms_mxu_v2
                       (histogram keyed by row_slot; build_histograms_auto
                       is the JAX package's build_histograms_mxu_auto; on
                       the card the rows are partitioned by slot and summed
                       by the scatter kernel of histogram_pallas)
  node_values       <- node_values_mxu        (values[row_node])
  node_sums         <- node_sums_mxu          (exact per-node sums, refit)

The slot-grouped scatter histogram and its partition (histogram_pallas.py)
are the sixth and seventh.

The histogram kernels have two modes, both integer sums, exact and
independent of the order of the additions: every kernel, its plain
version and every run give the same bits. Exact: each f32 value becomes a
fixed-point int64, rint(v x 2^k) with one power-of-two scale per channel
(`exact_scale`: from the channel's max |v| and the row count, so no sum
can overflow), summed exactly and scaled back to f32 once — finer than the
reference's double hist_t needs (in f32 cells, ~70k adds into one cell at
15 bins and sibling subtraction would put leaf values off by orders of
magnitude). Quantized (`quantized=True`, the JAX kernels' flag of that
name): int8 gradients from `quantize_gradients` into int32 cells, returned
as f32 integer sums that the caller scales. The
routing and histogram kernels read the bin matrix unpacked ([N, F] uint8)
or 4-bit packed (`pack_bins_4bit`, [N, ceil(F/2)] uint8, `num_features=F`);
the scatter kernel behind build_histograms also reads [N, F] uint16 bins
(max_bin > 256, the portable grower's; `wide_bin_limit`), and
`bins_int64` widens either for the torch glue (torch's uint16 has few
operators).

Single-precision hessians (`double_prec=False`, the reference's
gpu_use_dp=false; the JAX kernels' flag of that name): in exact mode
with a per-row hessian, each row's hessian is rounded to bf16 (round to
nearest even, as the TPU kernels' bf16 operand cast) before it becomes a
fixed-point value (`single_prec_hess`); gradient sums and counts are
unchanged, and the sums stay integer sums, order-free. Quantized and
constant-hessian modes ignore the flag, as in the JAX package. Launches
in this mode count with "_sp", those over uint16 bins with "_wide".

Each wrapper runs its kernel for CUDA tensors and its plain PyTorch version
(`<name>_ref`, same module) for CPU tensors — chosen by the device of the
tensors it is given, nothing else; a tensor on any other device raises.
Each wrapper counts its kernel launches per mode (`launch_counts`).

Route tables (`pack_route_tables`) are int32 columns, one row per node id:
the TPU layout's base-256 digit pairs existed only to stay exact in bf16.

EFB (exclusive feature bundling, efb.py): the bin matrix holds bundle
columns [N, Fb], the histograms build in bundle space ([S, Fb, Bb, 3]),
and the routing modes of route_rows and fused_route_hist read the split
feature's bundle column from the node table's EFB columns (TBL_BCOL..,
a table of TBL_COLS_EFB columns): with `loc_table` ([F, Bb] i32) the
row's original local bin is decoded through it and the decision is the
plain one; with `efb_range` the decision is position compares against the
node's segment, threshold position, default side and NaN position
(pack_route_tables(efb=) fills them from the plan's scan tables).
feat_tbl stays original-feature-indexed in both.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import rng
from ..utils.log import Log
from . import _cuda

__all__ = ["fused_route_hist", "route_rows", "build_histograms",
           "build_histograms_auto", "node_values", "node_sums",
           "exact_scale", "exact_sums", "EXACT_BITS", "NONFINITE_K",
           "fused_route_hist_ref", "route_rows_ref", "build_histograms_ref",
           "node_values_ref", "node_sums_ref", "node_sums_scale",
           "NODE_SUMS_BITS", "quantize_gradients",
           "pack_route_tables", "pack_bins_4bit", "unpack_bins_4bit",
           "fits_v2", "fused_row_block", "launch_counts",
           "single_prec_hess", "bins_int64", "rows_int64", "gather_bins",
           "wide_bin_limit",
           "reset_launch_counts", "recording_launches", "add_launches",
           "scratch_buffers",
           "chunk_tallies_ref", "num_chunks", "CHUNK_ROWS"]

# node table columns (csrc/route_hist.cuh keeps the same constants)
TBL_FLAGS, TBL_FEAT, TBL_THR, TBL_LEFT, TBL_RIGHT = 0, 1, 2, 3, 4
TBL_SLOT, TBL_SLOTL, TBL_SLOTR = 5, 6, 7
TBL_COLS = 8
# EFB columns (csrc/route_hist.cuh): the split feature's bundle column, and
# for efb_range its segment [seg_lo, seg_hi], the last left position of the
# threshold, the side of the default bin, the NaN bin's position (-1 none)
TBL_BCOL, TBL_SEG_LO, TBL_SEG_HI, TBL_PT = 8, 9, 10, 11
TBL_DBLEFT, TBL_PNAN = 12, 13
TBL_COLS_EFB = 16
FLAG_SPLIT, FLAG_DEFAULT_LEFT, FLAG_CAT = 1, 2, 4
#: rows of a routing CTA and of a partition chunk (csrc/route_hist.cuh
#: kChunkRows): route_rows' chunk tallies are the partition's input
CHUNK_ROWS = 2048


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


def bins_int64(bins: torch.Tensor) -> torch.Tensor:
    """An unpacked bin matrix (or any slice of one) as int64: uint8 bins
    widened, uint16 bins through an int16 view masked to 16 bits (torch's
    uint16 has few operators; no value wraps)."""
    if bins.dtype == torch.uint16:
        return bins.view(torch.int16).to(torch.int64) & 0xFFFF
    return bins.to(torch.int64)


def rows_int64(bins: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """bins[rows] as int64, of an unpacked uint8 or uint16 bin matrix
    (uint16 indexed through its int16 view)."""
    if bins.dtype == torch.uint16:
        return bins.view(torch.int16)[rows].to(torch.int64) & 0xFFFF
    return bins[rows].to(torch.int64)


def gather_bins(bins: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """[N] int64: row i's bin in column col[i] ([N] int64) of an unpacked
    [N, F] uint8 or uint16 bin matrix."""
    if bins.dtype == torch.uint16:
        return torch.gather(bins.view(torch.int16), 1, col[:, None])[:, 0] \
            .to(torch.int64) & 0xFFFF
    return torch.gather(bins, 1, col[:, None])[:, 0].to(torch.int64)


# ---------------------------------------------------------------------------
# dispatch: which branch of the growth sweep a pass takes
# ---------------------------------------------------------------------------

_V2_BUDGET_BYTES = 80 * 1024 * 1024
_V2_ROW_BLOCK = 4096
_FGROUP = 4


def fits_v2(num_slots: int, num_features: int, bmax: int,
            quantized: bool = False, route_width: int = 0,
            row_block: int = _V2_ROW_BLOCK, const_hess: float = 0.0,
            double_prec: bool = True) -> bool:
    """The JAX package's fits_v2 (double-bf16, single-bf16 hessian or
    quantized channels: 5, 4 or 3, two fewer with a constant hessian):
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
        nchan = 3 if quantized else (5 if double_prec else 4)
    out = nchan * num_slots * num_features * b * 4
    plane = _round_up(num_features, 128)
    flane_r = _round_up(max(route_width, num_features), 128)
    route_cost = 36 if route_width and route_width != num_features else 24
    inputs = row_block * (12 * plane + route_cost * flane_r +
                          2 * _FGROUP * b)
    return out + inputs <= _V2_BUDGET_BYTES


def fused_row_block(num_slots: int, num_features: int, bmax: int,
                    const_hess: float, quantized: bool = False,
                    double_prec: bool = True) -> int:
    """The row block the reference's sweep sizes its fused kernel with
    (2048 at small frontiers; else the widest of 8192/4096/2048 whose
    working set fits) — an input of `fits_v2`."""
    if num_slots <= 64:
        return 2048
    for rb in (8192, 4096, 2048):
        if fits_v2(num_slots, num_features, bmax, quantized, row_block=rb,
                   const_hess=const_hess, double_prec=double_prec):
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
                      child_r, slot_of_node, cat_bitset, m_pad: int,
                      bcol=None, efb=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Node tables for the routing kernels: ([m_pad, TBL_COLS] int32,
    [m_pad, W] int32 categorical left-set words). Each node row carries its
    children's next-pass slots, so routing picks the destination slot
    without a second lookup. Rows past the tree are unsplit, slot -1.

    efb (an EfbDev): the table is [m_pad, TBL_COLS_EFB], its EFB columns
    holding each node's split-feature bundle column (bcol, [m1] i32; the
    feature id when None) and, where the plan has its scan tables, the
    bundle-range constants of the node's (feature, threshold) (the JAX
    package's pack_route_tables(efb=), histogram_mxu.py:923-930)."""
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
    width = TBL_COLS
    if efb is not None:
        width = TBL_COLS_EFB
        fr = feat.to(torch.int64).clamp(0, efb.col_of_feat.shape[0] - 1)
        zero = torch.zeros(m1, dtype=torch.int32, device=dev)
        er = efb.scan
        if er is not None:
            th = thr.to(torch.int64).clamp(0, er.pos_thresh.shape[1] - 1)
            range_cols = [efb.seg_lo[fr], efb.seg_hi[fr],
                          er.pos_thresh[fr, th],
                          torch.where(er.nan_is_default[fr], default_left,
                                      er.db_le_t[fr, th]),
                          er.p_nan_f[fr]]
        else:
            range_cols = [zero, zero, zero, zero, zero - 1]
        cols += [feat if bcol is None else bcol] + range_cols + [zero, zero]
    tbl = torch.zeros((m_pad, width), dtype=torch.int32, device=dev)
    tbl[:, TBL_SLOT:TBL_COLS].fill_(-1)
    tbl[:m1] = torch.stack([c.to(torch.int32) for c in cols], dim=1)
    member = torch.zeros((m_pad, cat_bitset.shape[1]), dtype=torch.int32,
                         device=dev)
    # int64 words hold 32 bits; the cast keeps the low 32 (two's complement)
    member[:m1] = cat_bitset.to(torch.int32)
    return tbl, member


# ---------------------------------------------------------------------------
# exact mode's fixed point (csrc/route_hist.cuh keeps the same rule)
# ---------------------------------------------------------------------------

#: bits of a row's fixed-point value: |rint(v x 2^k)| <= 2^EXACT_BITS. The
#: scatter kernel splits it into a 20-bit low word and the rest, each
#: summed over up to 4096 rows in a 32-bit shared-memory word
EXACT_BITS = 38
#: exact_scale's exponent of a channel that holds a non-finite value
NONFINITE_K = -32768


def exact_scale(grad, hess, cnt) -> torch.Tensor:
    """[3] i32: the exponent k of the fixed point of each exact-mode
    channel (grad, hess, count), on the tensors' device with no host sync.
    With max |v| < 2^e over all n rows (frexp), k = B - e where B =
    min(EXACT_BITS, 62 - ceil(log2 n)): every row's |rint(v x 2^k)| <= 2^B
    and every cell's sum <= n x 2^B <= 2^62 fits an int64; the rounding
    costs at most 2^-(B+1) of 2^e a row (about 2^-38 of the channel's max
    at B = 38). A channel whose max is not finite gets NONFINITE_K: its
    cells come out NaN. The grower computes it once per tree; a histogram
    wrapper called without one computes it from its own inputs (in the
    single-precision mode, from the rounded hessians it sums)."""
    n = grad.shape[0]
    if n == 0:
        return torch.zeros(3, dtype=torch.int32, device=grad.device)
    amax = torch.stack([torch.amax(torch.abs(t)).to(torch.float32)
                        for t in (grad, hess, cnt)])
    bits = min(EXACT_BITS, 62 - (n - 1).bit_length())
    k = bits - torch.frexp(amax).exponent
    return torch.where(torch.isfinite(amax), k, NONFINITE_K) \
        .to(torch.int32)


def single_prec_hess(hess: torch.Tensor) -> torch.Tensor:
    """The hessians the single-precision mode sums: each f32 value rounded
    to bf16, round to nearest even (the TPU kernels' operand cast), as
    f32."""
    return hess.to(torch.bfloat16).to(torch.float32)


def _single(double_prec: bool, quantized: bool, const_hess: float) -> bool:
    """Whether a histogram call runs the single-precision mode: exact
    sums of a per-row hessian with double_prec off."""
    return not (double_prec or quantized or const_hess)


def exact_sums(grad, hess, cnt, scale: torch.Tensor) -> torch.Tensor:
    """[3] f32: the (grad, hess, count) sums of all rows as the exact
    histograms take them — each value's fixed point under `scale`
    (exact_scale), summed in int64 and scaled back once — so they do not
    depend on the order of the additions: the same bits on every device,
    and equal to the sum of any exact histogram's cells before those are
    rounded."""
    return _exact_result(_fixed_point(
        torch.stack([grad, hess, cnt], dim=1), scale).sum(0), scale)


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2.0 ** k as float64, exactly (the exponent field written directly),
    for integer k in float64's normal range."""
    return ((k.to(torch.int64) + 1023) << 52).view(torch.float64)


def _fixed_point(data: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[M, 3] f32 rows (grad, hess, count) -> their int64 fixed-point
    values rint(v x 2^k) (exact product in float64, one rounding, half to
    even, as the kernels' __double2ll_rn); 0 in a non-finite channel."""
    finite = k != NONFINITE_K
    q = torch.round(data.to(torch.float64) *
                    torch.where(finite, _pow2(k), 0.0))
    return torch.where(finite, q, 0.0).to(torch.int64)


def _exact_result(sums: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """int64 cell sums [..., 3] -> f32(float64(sum) x 2^-k); NaN in a
    non-finite channel."""
    inv = torch.where(k != NONFINITE_K, _pow2(-k),
                      torch.full((), float("nan"), dtype=torch.float64,
                                 device=k.device))
    return (sums.to(torch.float64) * inv).to(torch.float32)


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the yardstick the kernels are held to)
# ---------------------------------------------------------------------------

def num_chunks(n: int) -> int:
    """Partition chunks of n rows (CHUNK_ROWS each, at least one)."""
    return max(1, -(-n // CHUNK_ROWS))


def chunk_tallies_ref(row_slot, num_slots: int) -> torch.Tensor:
    """[num_slots + 1, C] i32, C = num_chunks(n): the rows of each slot in
    each chunk of CHUNK_ROWS consecutive rows, slot-major; the last row
    (the trash slot) counts the rows whose slot is < 0 or >= num_slots.
    Its row sums are the per-slot counts, the trash slot's included."""
    n = row_slot.shape[0]
    c = num_chunks(n)
    key = torch.where((row_slot < 0) | (row_slot >= num_slots), num_slots,
                      row_slot).to(torch.int64)
    chunk = torch.arange(n, device=row_slot.device) // CHUNK_ROWS
    flat = torch.bincount(key * c + chunk, minlength=(num_slots + 1) * c)
    return flat.view(num_slots + 1, c).to(torch.int32)


def route_rows_ref(bins, row_node, tbl, member, feat_tbl, *,
                   num_features: int = 0, emit_counts: bool = False,
                   num_slots: int = 0, chunk_tallies: bool = False,
                   loc_table=None, efb_range: bool = False):
    """(new row_node, new row_slot) after one level of routing; with
    emit_counts also the [num_slots] i32 count of rows whose new slot is
    in [0, num_slots), or with chunk_tallies too the rows per slot and
    chunk (chunk_tallies_ref, trash slot included). num_features > 0:
    bins are 4-bit packed. loc_table / efb_range: bins are EFB bundle
    columns and the table has the EFB columns (module docstring; the JAX
    package's _route_decide, histogram_mxu.py:315-430): the row's bin is
    that of the split feature's bundle column, decoded to the original
    local bin through loc_table, or compared as a bundle position
    (efb_range: in-segment rows go left iff pos <= the threshold's
    position, the NaN position by default_left, out-of-segment rows by
    the default bin's side)."""
    bins = _unpacked(bins, num_features)
    m = tbl.shape[0]
    efb = loc_table is not None or efb_range
    f = feat_tbl.shape[0] if efb else bins.shape[1]
    node = row_node.to(torch.int64)
    in_range = (node >= 0) & (node < m)
    row = tbl[node.clamp(0, m - 1)]                              # [N, cols]
    flags = torch.where(in_range, row[:, TBL_FLAGS], 0)
    defl = (flags & FLAG_DEFAULT_LEFT) != 0
    feat = row[:, TBL_FEAT].to(torch.int64).clamp(0, f - 1)
    col = row[:, TBL_BCOL].to(torch.int64).clamp(0, bins.shape[1] - 1) \
        if efb else feat
    binv = torch.gather(bins, 1, col[:, None])[:, 0].to(torch.int64)
    if efb_range:
        in_seg = (binv >= row[:, TBL_SEG_LO]) & (binv <= row[:, TBL_SEG_HI])
        num_left = torch.where(
            in_seg, torch.where(binv == row[:, TBL_PNAN], defl,
                                binv <= row[:, TBL_PT]),
            row[:, TBL_DBLEFT] != 0)
    else:
        if loc_table is not None:
            bb = loc_table.shape[1]
            binv = loc_table.reshape(-1)[feat * bb + binv.clamp(0, bb - 1)] \
                .to(torch.int64)
        nb = feat_tbl[feat, 0].to(torch.int64)
        is_nan_bin = (feat_tbl[feat, 1] != 0) & (binv == nb - 1)
        num_left = torch.where(is_nan_bin, defl, binv <= row[:, TBL_THR])
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
    if chunk_tallies:
        return new_node, new_slot, chunk_tallies_ref(new_slot, num_slots)
    live = new_slot[(new_slot >= 0) & (new_slot < num_slots)]
    counts = torch.bincount(live.to(torch.int64), minlength=num_slots)
    return new_node, new_slot, counts.to(torch.int32)


def build_histograms_ref(bins, grad, hess, cnt, row_slot, *, num_slots: int,
                         bmax: int, const_hess: float = 0.0,
                         quantized: bool = False, num_features: int = 0,
                         scale: torch.Tensor = None,
                         double_prec: bool = True) -> torch.Tensor:
    """[num_slots, F, bmax, 3] f32 (grad, hess, count) per-slot histograms
    by index_add_ over flattened (slot, feature, bin) cells; rows with slot
    < 0 or >= num_slots are dropped. Exact mode: the rows' fixed-point
    values under `scale` (exact_scale of grad, hess, cnt when None) summed
    in int64 and scaled back once, as every kernel does; a channel with a
    non-finite value (anywhere in its n rows, parked rows included) is NaN
    in every cell, so a NaN never becomes a finite sum. const_hess != 0:
    hessian sums are const x count. quantized: grad and hess hold whole
    numbers (int8 from quantize_gradients), summed exactly in int64; the
    result holds the unscaled integer sums. num_features > 0: bins are
    4-bit packed; uint16 bins are read as they are. double_prec=False:
    the single-precision mode (module docstring)."""
    bins = _unpacked(bins, num_features)
    n, f = bins.shape
    dev = bins.device
    if _single(double_prec, quantized, const_hess):
        hess = single_prec_hess(hess)
    rows = torch.nonzero((row_slot >= 0) & (row_slot < num_slots))[:, 0]
    slot = row_slot[rows].to(torch.int64)
    cells = ((slot[:, None] * f + torch.arange(f, device=dev)[None, :])
             * bmax + rows_int64(bins, rows)).reshape(-1)     # [Nv*F]
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
        k = exact_scale(grad, hess, cnt) if scale is None else scale
        hist = _exact_result(cell_sums(_fixed_point(
            torch.stack([g, h, cnt[rows]], dim=1), k)), k)
    return _fill_const_hess(hist.view(num_slots, f, bmax, 3), const_hess)


def fused_route_hist_ref(bins, grad, hess, cnt, row_node, tbl, member,
                         feat_tbl, *, num_slots: int, bmax: int,
                         const_hess: float = 0.0, quantized: bool = False,
                         num_features: int = 0, scale: torch.Tensor = None,
                         loc_table=None, efb_range: bool = False,
                         double_prec: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hist [num_slots, F, bmax, 3], new row_node): route one level, then
    histogram the rows by their new slot (build_histograms_ref). With
    loc_table or efb_range (route_rows_ref) the bins are EFB bundle
    columns: F is Fb and bmax is Bb."""
    bins = _unpacked(bins, num_features)
    new_node, new_slot = route_rows_ref(bins, row_node, tbl, member,
                                        feat_tbl, loc_table=loc_table,
                                        efb_range=efb_range)
    hist = build_histograms_ref(bins, grad, hess, cnt, new_slot,
                                num_slots=num_slots, bmax=bmax,
                                const_hess=const_hess, quantized=quantized,
                                scale=scale, double_prec=double_prec)
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


#: node_sums' fixed point: a channel's values take k = NODE_SUMS_BITS - e -
#: lg (max |x| < 2^e, n <= 2^lg rows), so every row is at most
#: 2^(NODE_SUMS_BITS - lg) and a node's sum at most 2^NODE_SUMS_BITS
NODE_SUMS_BITS = 61


def node_sums_scale(amax: torch.Tensor, n: int) -> torch.Tensor:
    """[3] i32: node_sums' fixed-point exponent k of each channel from its
    max |x| (amax, [3] f32) over all n rows; NONFINITE_K where the max is
    not finite (csrc/node_sums.cu scale_of)."""
    lg = (n - 1).bit_length() if n > 1 else 0
    k = NODE_SUMS_BITS - lg - torch.frexp(amax).exponent
    return torch.where(torch.isfinite(amax), k, NONFINITE_K) \
        .to(torch.int32)


def node_sums_ref(row_node, grad, hess, cnt, *, num_nodes: int
                  ) -> torch.Tensor:
    """[num_nodes, 3] f32 per-node (sum grad, sum hess, sum count): the
    kernel's fixed-point sum. Each value adds rint(x x 2^k) as an int64
    under its channel's node_sums_scale (from max |x| over all n rows,
    ignored ones included), the int64 sums come out as f32(float64(sum) x
    2^-k); a channel whose max is not finite is NaN in every node. Rows
    whose node is < 0 or >= num_nodes are ignored."""
    n = row_node.shape[0]
    dev = row_node.device
    if n == 0:
        return torch.zeros((num_nodes, 3), dtype=torch.float32, device=dev)
    data = torch.stack([grad, hess, cnt], dim=1)
    k = node_sums_scale(data.abs().amax(0), n)
    node = row_node.to(torch.int64)
    keep = (node >= 0) & (node < num_nodes)
    sums = torch.zeros((num_nodes, 3), dtype=torch.int64, device=dev) \
        .index_add_(0, node[keep], _fixed_point(data[keep], k))
    return _exact_result(sums, k)


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
    if t.dtype == dtype and t.shape == shape and t.is_contiguous():
        return                      # the launch path's common case, at once
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _bin_dims(bins: torch.Tensor, num_features: int,
              wide_ok: bool = False) -> Tuple[int, int]:
    """(logical feature count F, packed bytes a row fh or 0 if unpacked) of
    a bin matrix; checks its dtype, layout and packed width. wide_ok: the
    kernel also reads unpacked uint16 bins."""
    n, fcols = bins.shape
    if wide_ok and bins.dtype == torch.uint16 and not num_features:
        _check(bins, "bins", torch.uint16, (n, fcols))
        return fcols, 0
    _check(bins, "bins", torch.uint8, (n, fcols))
    if not num_features:
        return fcols, 0
    if fcols != (num_features + 1) // 2:
        raise ValueError(f"packed bins: {fcols} columns for {num_features} "
                         "features, expected ceil(F/2)")
    return num_features, fcols


def _efb_mode(loc_table, efb_range: bool) -> int:
    """The routing kernel's mode: 0 plain, 1 loc_table, 2 efb_range."""
    if efb_range:
        return 2
    return 0 if loc_table is None else 1


def _check_route_args(bins, row_node, tbl, member, feat_tbl,
                      num_features, loc_table=None, efb_range=False
                      ) -> Tuple[int, int]:
    f, fh = _bin_dims(bins, num_features)
    _check(row_node, "row_node", torch.int32, (bins.shape[0],))
    mode = _efb_mode(loc_table, efb_range)
    if mode and fh:
        raise ValueError("EFB routing reads unpacked bundle columns")
    _check(tbl, "tbl", torch.int32,
           (tbl.shape[0], TBL_COLS_EFB if mode else TBL_COLS))
    if tbl.data_ptr() % 16:
        raise ValueError("tbl must start on a 16-byte boundary (the kernel "
                         "reads a node's row as int4)")
    _check(member, "member", torch.int32, (tbl.shape[0], member.shape[1]))
    nf = feat_tbl.shape[0] if mode else f
    _check(feat_tbl, "feat_tbl", torch.int32, (nf, 2))
    if mode == 1:
        _check(loc_table, "loc_table", torch.int32,
               (nf, loc_table.shape[1]))
    return f, fh


#: the scatter kernel's shared-memory budget of a feature group
#: (csrc/build_histograms_scatter.cu kGroupSmemBytes): one feature's cells,
#: 6 words each exact and 3 quantized, must fit it
GROUP_SMEM_BYTES = 100 * 1024


def wide_bin_limit(quantized: bool = False) -> int:
    """The widest bin axis the scatter kernel takes over uint16 bins: the
    bins of one feature whose cells fit its shared-memory budget (4266
    exact, 8533 quantized)."""
    return GROUP_SMEM_BYTES // (4 * (3 if quantized else 6))


def _check_hist_args(bins, grad, hess, cnt, bmax, quantized,
                    num_features, wide_ok: bool = False) -> Tuple[int, int]:
    """Checks the histogram kernels' inputs; returns _bin_dims. wide_ok:
    uint16 bins are taken (the scatter kernel), up to wide_bin_limit."""
    f, fh = _bin_dims(bins, num_features, wide_ok)
    n = bins.shape[0]
    gdt = torch.int8 if quantized else torch.float32
    for t, name, dt in ((grad, "grad", gdt), (hess, "hess", gdt),
                        (cnt, "cnt", torch.float32)):
        _check(t, name, dt, (n,))
    if bins.dtype == torch.uint16:
        limit = wide_bin_limit(quantized)
        if not 0 < bmax <= limit:
            raise ValueError(
                f"bmax {bmax} outside (0, {limit}]: the scatter kernel "
                "holds one feature's cells in its shared-memory budget "
                f"of {GROUP_SMEM_BYTES} bytes")
    elif not 0 < bmax <= 256:
        raise ValueError(f"bmax {bmax} outside (0, 256] (uint8 bins)")
    return f, fh


def _scale_of(scale, grad, hess, cnt, quantized, single: bool = False):
    """The exact mode's fixed-point scale: the caller's (checked), else
    exact_scale of the inputs (single: of the rounded hessians); None in
    quantized mode."""
    if quantized:
        return None
    if scale is None:
        return exact_scale(grad, single_prec_hess(hess) if single else hess,
                           cnt)
    _check(scale, "scale", torch.int32, (3,))
    return scale


def fused_route_hist(bins, grad, hess, cnt, row_node, tbl, member, feat_tbl,
                     *, num_slots: int, bmax: int, const_hess: float = 0.0,
                     quantized: bool = False, num_features: int = 0,
                     scale: torch.Tensor = None, loc_table=None,
                     efb_range: bool = False, double_prec: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route rows through the previous pass's tables and build the new
    frontier's histograms. Returns (hist [S, F, bmax, 3], new row_node [N]
    i32). quantized: grad and hess are int8 and the gradient channels hold
    their unscaled integer sums; else scale ([3] i32, exact_scale of grad,
    hess, cnt when None) is the fixed point of the sums. num_features > 0:
    bins are 4-bit packed (pack_bins_4bit) with that many features.
    loc_table / efb_range: bins are EFB bundle columns (route_rows'
    modes), F is Fb and bmax is Bb; the launches count with "_efb" (loc
    table) or "_efbr" (range) after the wrapper's name. double_prec=False:
    the single-precision mode (module docstring), counted with "_sp".

    On the card: route_rows with chunk tallies, then the partition kernel
    fed those tallies (no count pass of its own) and the scatter kernel
    (histogram_pallas.scatter_histograms), the design of build_histograms;
    the scatter kernel's launches count here, the routing's (as
    route_rows_counts) and the partition's under their own names. Only the
    outputs are allocated: the slots, tallies and partition live in the
    device's scratch buffers. Integer sums: the result is the plain
    version's bit for bit."""
    args = (bins, grad, hess, cnt, row_node, tbl, member, feat_tbl)
    kw = dict(num_slots=num_slots, bmax=bmax, const_hess=const_hess,
              quantized=quantized, num_features=num_features, scale=scale,
              double_prec=double_prec)
    if _on_cpu(*args):
        return fused_route_hist_ref(*args, loc_table=loc_table,
                                    efb_range=efb_range, **kw)
    _check_hist_args(bins, grad, hess, cnt, bmax, quantized, num_features)
    n = bins.shape[0]
    dev = bins.device
    node = torch.empty(n, dtype=torch.int32, device=dev)
    slot = scratch(dev, "route_slot", n)
    tallies = scratch(dev, "route_tallies",
                      (num_slots + 1) * num_chunks(n)).view(num_slots + 1, -1)
    _route(bins, row_node, tbl, member, feat_tbl, num_features, node, slot,
           tallies, None, num_slots, loc_table, efb_range)
    from .histogram_pallas import scatter_histograms   # imports this module
    hist = scatter_histograms(
        "fused_route_hist" + _EFB_SUFFIX[_efb_mode(loc_table, efb_range)],
        bins, grad, hess, cnt, slot, slot_tallies=tallies, **kw)
    return hist, node


#: slots the routing kernel tallies at most (its [S + 1] shared counters)
_ROUTE_MAX_SLOTS = 232448 // 4 - 1


def route_rows(bins, row_node, tbl, member, feat_tbl, *,
               num_features: int = 0, emit_counts: bool = False,
               num_slots: int = 0, chunk_tallies: bool = False,
               loc_table=None, efb_range: bool = False):
    """Advance rows one level: (new row_node, new row_slot), both [N] i32.
    emit_counts (needs num_slots > 0): also the [num_slots] i32 count of
    rows whose new slot is in [0, num_slots), parked rows excluded — the
    metadata of the scatter histogram's partition, from the same sweep;
    with chunk_tallies, in its place the [num_slots + 1, C] i32 rows per
    slot and partition chunk (chunk_tallies_ref: the trash slot last), the
    partition's own input. num_features > 0: bins are 4-bit packed. Both
    count modes launch as route_rows_counts; the counts are the tallies'
    row sums, taken on the card by a second kernel of the same call.
    loc_table ([F, Bb] i32) / efb_range: bins are EFB bundle columns
    (route_rows_ref), tbl has TBL_COLS_EFB columns; the launches count
    with "_efb" / "_efbr" after "route_rows"."""
    if emit_counts and not 0 < num_slots <= _ROUTE_MAX_SLOTS:
        raise ValueError(f"emit_counts needs num_slots in (0, "
                         f"{_ROUTE_MAX_SLOTS}], got {num_slots}")
    if chunk_tallies and not emit_counts:
        raise ValueError("chunk_tallies needs emit_counts")
    kw = dict(num_features=num_features, emit_counts=emit_counts,
              num_slots=num_slots, chunk_tallies=chunk_tallies,
              loc_table=loc_table, efb_range=efb_range)
    if _on_cpu(bins, row_node, tbl, member, feat_tbl):
        return route_rows_ref(bins, row_node, tbl, member, feat_tbl, **kw)
    n = bins.shape[0]
    dev = bins.device
    # one allocation; the slots start on a 16-byte boundary, as the
    # kernel's int4 stores want
    n4 = -(-n // 4) * 4
    out = torch.empty(2 * n4, dtype=torch.int32, device=dev)
    node_out, slot_out = out[:n], out[n4:n4 + n]
    if not emit_counts:
        _route(bins, row_node, tbl, member, feat_tbl, num_features,
               node_out, slot_out, None, None, 0, loc_table, efb_range)
        return node_out, slot_out
    shape = (num_slots + 1, num_chunks(n))
    if chunk_tallies:
        tallies = torch.empty(shape, dtype=torch.int32, device=dev)
        counts = None
    else:
        tallies = scratch(dev, "route_tallies", shape[0] * shape[1])
        counts = torch.empty(num_slots, dtype=torch.int32, device=dev)
    _route(bins, row_node, tbl, member, feat_tbl, num_features, node_out,
           slot_out, tallies, counts, num_slots, loc_table, efb_range)
    return node_out, slot_out, tallies if chunk_tallies else counts


#: launch-count suffix of each routing mode (_efb_mode)
_EFB_SUFFIX = ("", "_efb", "_efbr")


def _route(bins, row_node, tbl, member, feat_tbl, num_features, node_out,
           slot_out, tallies, counts, num_slots, loc_table=None,
           efb_range=False) -> None:
    """The routing kernel into node_out and slot_out ([N] i32) and, given
    tallies ([num_slots + 1, C] i32, or a scratch buffer that long), the
    chunk tallies; given counts ([num_slots] i32) too, their row sums. The
    one launch path of route_rows and fused_route_hist."""
    f, fh = _check_route_args(bins, row_node, tbl, member, feat_tbl,
                              num_features, loc_table, efb_range)
    mode = _efb_mode(loc_table, efb_range)
    _cuda.call("route_rows", bins.device, bins, row_node, tbl, member,
               feat_tbl, node_out, slot_out, tallies, counts,
               loc_table if mode == 1 else None, bins.shape[0], f, fh,
               tbl.shape[0], member.shape[1], num_slots,
               loc_table.shape[1] if mode == 1 else 0, mode)
    count_launch("route_rows" + _EFB_SUFFIX[mode],
                 counts=tallies is not None, packed=fh > 0)


def build_histograms(bins, grad, hess, cnt, row_slot, *, num_slots: int,
                     bmax: int, const_hess: float = 0.0,
                     quantized: bool = False, num_features: int = 0,
                     scale: torch.Tensor = None,
                     double_prec: bool = True) -> torch.Tensor:
    """Per-slot histograms [S, F, bmax, 3] keyed by row_slot (rows with
    slot < 0 or >= S dropped). quantized, num_features, scale,
    double_prec: as in fused_route_hist. On the card the rows are
    partitioned by slot (the partition kernel, counting for itself) and
    summed by the scatter kernel, whose launches count here; the result
    is the plain version's bit for bit."""
    if _on_cpu(bins, grad, hess, cnt, row_slot):
        return build_histograms_ref(bins, grad, hess, cnt, row_slot,
                                    num_slots=num_slots, bmax=bmax,
                                    const_hess=const_hess,
                                    quantized=quantized,
                                    num_features=num_features, scale=scale,
                                    double_prec=double_prec)
    from .histogram_pallas import scatter_histograms   # imports this module
    return scatter_histograms(
        "build_histograms", bins, grad, hess, cnt, row_slot,
        num_slots=num_slots, bmax=bmax, num_features=num_features,
        const_hess=const_hess, quantized=quantized, scale=scale,
        double_prec=double_prec)


def build_histograms_auto(bins, grad, hess, cnt, row_slot, *,
                          num_slots: int, bmax: int, const_hess: float = 0.0,
                          quantized: bool = False, num_features: int = 0,
                          scale: torch.Tensor = None,
                          double_prec: bool = True) -> torch.Tensor:
    """The JAX package's build_histograms_mxu_auto: the v2 kernel's
    function (one row pass, reads packed bins) where fits_v2 holds at its
    default row block, else the v1 kernel's, on bins unpacked first (the
    JAX v1 kernel cannot read nibbles; packed storage targets small-bmax
    shapes, which always fit v2). Both are build_histograms here."""
    f = num_features or bins.shape[1]
    if not fits_v2(num_slots, f, bmax, quantized, const_hess=const_hess,
                   double_prec=double_prec):
        bins, num_features = _unpacked(bins, num_features), 0
    return build_histograms(bins, grad, hess, cnt, row_slot,
                            num_slots=num_slots, bmax=bmax,
                            const_hess=const_hess, quantized=quantized,
                            num_features=num_features, scale=scale,
                            double_prec=double_prec)


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


# the kernels' scratch buffers, by device and use, grown as needed and
# reused by every call on that device in stream order (calls on two streams
# of one device at once would share them)
_SCRATCH: Dict[Tuple[torch.device, str], torch.Tensor] = {}


def scratch(dev: torch.device, name: str, numel: int,
            dtype=torch.int32) -> torch.Tensor:
    """[numel] of the device's scratch buffer `name`, uninitialised. A
    buffer never grows while a CUDA graph is captured (the graph would
    keep the new one, and every later call would use memory of the graph's
    pool): a caller that captures sizes the buffers first, by running the
    captured code once eagerly. Outside a capture a buffer grows by
    replacing the old one, which is then freed unless someone holds it: a
    caller that keeps captured graphs holds scratch_buffers(dev), taken
    after its captures, for as long as it replays them."""
    buf = _SCRATCH.get((dev, name))
    if buf is None or buf.numel() < numel:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"scratch buffer {name!r} would grow to {numel} elements "
                "during a CUDA graph capture: run the captured code once "
                "eagerly first")
        buf = torch.empty(numel, dtype=dtype, device=dev)
        _SCRATCH[(dev, name)] = buf
    return buf[:numel]


def scratch_buffers(dev: torch.device) -> List[torch.Tensor]:
    """The device's scratch buffers as they stand. Taken after a capture
    (no buffer grows during one), they are every buffer the captured
    graphs use: holding them keeps that memory for the graphs, whatever
    later calls grow."""
    return [buf for (d, _), buf in _SCRATCH.items() if d == dev]


def node_sums(row_node, grad, hess, cnt, *, num_nodes: int) -> torch.Tensor:
    """Exact per-node (sum grad, sum hess, sum count) as [num_nodes, 3]
    f32; rows whose node is < 0 or >= num_nodes are ignored. Fixed-point
    int64 sums (node_sums_ref), so the kernel equals its plain version
    bit for bit. On the card: one call, which takes the channel maxima,
    sums and scales back on the device, into a scratch buffer cached per
    device (calls on two streams of one device at once would share it)."""
    if _on_cpu(row_node, grad, hess, cnt):
        return node_sums_ref(row_node, grad, hess, cnt, num_nodes=num_nodes)
    n = row_node.shape[0]
    _check(row_node, "row_node", torch.int32, (n,))
    for t, name in ((grad, "grad"), (hess, "hess"), (cnt, "cnt")):
        _check(t, name, torch.float32, (n,))
    dev = row_node.device
    out = torch.empty((num_nodes, 3), dtype=torch.float32, device=dev)
    if num_nodes == 0:
        return out
    # four u32 words of channel maxima, then the [m, 3] int64 sums (the
    # kernel zeroes them first)
    _cuda.call("node_sums", dev, row_node, grad, hess, cnt,
               scratch(dev, "node_sums", 2 + 3 * num_nodes, torch.int64),
               out, n, num_nodes)
    count_launch("node_sums")
    return out


# ---------------------------------------------------------------------------
# launch counts
# ---------------------------------------------------------------------------

# each kernel's modes, as suffixes of its launch-count keys: "_int"
# quantized (int8 gradients, int32 cells), "_counts" route_rows'
# emit_counts, "_packed" 4-bit packed bins; a launch counts under its
# wrapper's name plus the suffixes of the modes it ran in, in this order
_MODES = {"fused_route_hist": ("_int", "_packed", "_sp"),
          "route_rows": ("_counts", "_packed"),
          # the EFB routing modes (never packed): loc table, range
          "fused_route_hist_efb": ("_int", "_sp"),
          "fused_route_hist_efbr": ("_int", "_sp"),
          "route_rows_efb": ("_counts",), "route_rows_efbr": ("_counts",),
          "build_histograms": ("_int", "_packed", "_sp"),
          # and over uint16 bins: the portable grower's
          "build_histograms_scatter": ("_int", "_packed", "_sp", "_wide"),
          # histogram_pallas: the partition inside build_histograms_scatter
          "partition_rows": (),
          "node_values": (), "node_sums": (),
          # learner/linear.py: the leaf models' sums (L1) and values (L2)
          "linear_gram": (), "linear_values": (),
          # split_kernel.find_best_splits_kernel: plain and monotone modes
          "find_best_splits": (), "find_best_splits_mono": (),
          # prune.prune_best_first
          "prune_best_first": (),
          # predict.stacked_score_traj / predict_binned_tree, and its
          # class mode (k trees an iteration: class_score_add, a
          # multiclass block's stacked_score_traj)
          "predict_binned": ("_wide",), "predict_binned_class": ("_wide",),
          # and their bundled-matrix mode (EFB)
          "predict_binned_efb": ("_wide",),
          "predict_binned_class_efb": ("_wide",)}
_LAUNCHES: Dict[str, int] = {}
# tallies of launches recorded into CUDA graphs being captured (innermost
# last): a captured launch does not run then, it runs at each replay
_RECORDING: List[Dict[str, int]] = []


def count_launch(name: str, *, quantized: bool = False, packed: bool = False,
                 counts: bool = False, single: bool = False,
                 wide: bool = False) -> None:
    """Count one kernel launch of wrapper `name` in the given modes; while
    a CUDA graph is captured (recording_launches), into the graph's tally
    instead."""
    key = name + "_int" * quantized + "_counts" * counts + \
        "_packed" * packed + "_sp" * single + "_wide" * wide
    if _RECORDING:
        tally = _RECORDING[-1]
        tally[key] = tally.get(key, 0) + 1
    else:
        _LAUNCHES[key] += 1


@contextlib.contextmanager
def recording_launches():
    """Within the block, launches go to the yielded tally, not the counts:
    wrap a CUDA graph's capture in it, and add the tally at each replay
    (add_launches), so the counts stay the launches that ran."""
    tally: Dict[str, int] = {}
    _RECORDING.append(tally)
    try:
        yield tally
    finally:
        _RECORDING.pop()


def add_launches(tally: Dict[str, int]) -> None:
    """Add a replayed graph's recorded launches to the counts."""
    for key, n in tally.items():
        _LAUNCHES[key] += n


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, one key per kernel and mode:
    the wrapper's name for its plain mode, suffixed "_int" (quantized),
    "_counts" (emit_counts), "_packed" (4-bit bins), "_sp" (single-
    precision hessians) and "_wide" (uint16 bins) for the others."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()
    for name, suffixes in _MODES.items():
        keys = [name]
        for suf in suffixes:
            keys += [k + suf for k in keys]
        _LAUNCHES.update(dict.fromkeys(keys, 0))


reset_launch_counts()
