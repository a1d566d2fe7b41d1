"""Linear models in tree leaves (linear_tree=true).

Port of lightgbm_tpu/learner/linear.py (reference LinearTreeLearner,
src/treelearner/linear_tree_learner.cpp:150-380): after a tree is grown,
every leaf gets a ridge-regularized linear model over the numerical
features split on its root path, fit against the Newton objective of the
constant leaf values:

    minimize  sum_i [ g_i f(x_i) + 0.5 h_i f(x_i)^2 ]  + 0.5 lambda |beta|^2
    f(x) = beta . x_path + c     =>    [beta; c] = -(X'HX + lambda I)^-1 X'g

Kept from the JAX package: rows with NaN in any of their leaf's features,
and out-of-bag rows (cnt == 0), are left out of the fit, and a NaN row
falls back to the constant leaf_value at prediction; a leaf with fewer
usable rows than features + 1 keeps its constant; linear_lambda goes on
the coefficient diagonal only; categorical features never enter a leaf
model; a non-finite solution keeps the constant; a leaf takes its first
dmax path features in ascending index order (the JAX package's lax.top_k
on a 0/1 mask; here the stable descending sort).

Two hand-written kernels (csrc/linear_leaves.cu) do the device work that
is XLA in the JAX package:

- linear_gram (L1) sums X'HX [M+1, D+1, D+1], X'g [M+1, D+1] and the
  usable rows of each leaf over each row's leaf features plus the
  intercept column. The JAX package adds f32 outer products in row order;
  here every product v = (h x_i) x_j (g x_i for X'g) is formed in
  float64 and added as the int64 rint(v x 2^k), one power-of-two scale
  per (leaf, entry): with max |h| < 2^eh, max |x_i| < 2^ei over the
  leaf's usable rows and c <= 2^lg of them, k = 61 - lg - eh - ei - ej,
  so no row passes 2^(61 - lg) and no sum 2^61. Integer sums do not
  depend on the order of the additions, so the kernel equals its plain
  version (linear_gram_ref) bit for bit and two runs give the same bits.
  A leaf whose maxima are not finite comes out NaN and keeps its constant.
- linear_values (L2) evaluates the models row by row: const + sum over
  the D slots in ascending order of coeff x x (0 for an empty slot), each
  f32 op rounded on its own, leaf_value where a model feature is NaN. The
  kernel runs only the active slots: the adds of a run of empty slots
  come to one add of a signed zero (or NaN), which it keeps.

The batched ridge solve is torch.linalg.solve_ex in float64 (the JAX
package's jnp.linalg.solve, in f32): an exactly singular system comes out
with info > 0, and its leaf keeps its constant, as the JAX package's
non-finite solution does. On CUDA tensors each wrapper launches its
kernel or raises; on CPU tensors its plain version runs.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from . import _cuda
from .grower import TreeArrays
from .histogram_mxu import (NONFINITE_K, _check, _exact_result, _on_cpu,
                            _pow2, count_launch, scratch)

__all__ = ["LinearLeaves", "fit_linear_leaves", "fit_linear_leaves_ref",
           "linear_gram", "linear_gram_ref", "linear_leaf_values",
           "linear_leaf_values_ref", "leaf_features", "path_feature_masks"]

#: the gram's fixed point: every row of a (leaf, entry) is at most
#: 2^(GRAM_BITS - lg) and every sum at most 2^GRAM_BITS
GRAM_BITS = 61
#: rows a chunk of linear_gram_ref's products takes
_REF_CHUNK = 1 << 14
#: the kernel's slot limit: dmax <= 31 features and the intercept
MAX_SLOTS = 32
#: records a CTA of linear_gram's maxima and sums kernels takes
#: (csrc/linear_leaves.cu kChunk)
GRAM_CHUNK = 1024


class LinearLeaves(NamedTuple):
    """Per-node linear leaf models, arrays sized like TreeArrays [M+1]."""
    const: torch.Tensor   # [M+1] f32 intercept (leaves; fallback leaf_value)
    coeff: torch.Tensor   # [M+1, D] f32 coefficients (0 where unused)
    feat: torch.Tensor    # [M+1, D] i32 used-feature index, -1 = pad
    nfeat: torch.Tensor   # [M+1] i32 number of model features


def path_feature_masks(tree: TreeArrays, f: int,
                       is_cat: torch.Tensor) -> torch.Tensor:
    """[M+1, F] bool: the numerical features split on the root path of
    each node (the JAX package's _path_feature_masks, reference
    tree->branch_features). The JAX package walks each node's parents until
    it leaves the tree; here the ancestors are collected by pointer
    doubling, ceil(log2(M+1)) + 1 steps of [M+1, F] ops, so no host read
    decides when to stop. A node that parents itself (the JAX package's
    scratch row) or has no parent starts with an empty path."""
    m1 = tree.split_feature.shape[0]
    dev = tree.split_feature.device
    nodes = torch.arange(m1, device=dev)
    par = tree.parent.to(torch.int64)
    valid = (par >= 0) & (par < m1) & (par != nodes)
    pc = par.clamp(0, m1 - 1)
    feat = tree.split_feature[pc].to(torch.int64)
    fc = feat.clamp(0, max(f - 1, 0))
    hit = valid & (feat >= 0) & ~is_cat[fc]
    mask = torch.zeros((m1, f), dtype=torch.bool, device=dev) \
        .scatter_(1, fc[:, None], hit[:, None])
    anc = torch.where(valid, par, -1)
    for _ in range(max(1, math.ceil(math.log2(max(m1, 2)))) + 1):
        up = anc >= 0
        ac = anc.clamp(0)
        mask = mask | (mask[ac] & up[:, None])
        anc = torch.where(up, anc[ac], -1)
    return mask


def leaf_features(mask: torch.Tensor, dmax: int) -> torch.Tensor:
    """[M+1, dmax] i32: each node's first dmax set features of `mask` in
    ascending index order, -1 after them (lax.top_k's tie order, through
    the stable descending sort)."""
    m1, f = mask.shape
    v, idx = torch.sort(mask.to(torch.uint8), dim=1, descending=True,
                        stable=True)
    take = min(dmax, f)
    feat = torch.where(v[:, :take] > 0, idx[:, :take],
                       -1).to(torch.int32)
    if take < dmax:
        feat = torch.cat([feat, torch.full((m1, dmax - take), -1,
                                           dtype=torch.int32,
                                           device=mask.device)], 1)
    return feat.contiguous()


def _abs_bits(x: torch.Tensor) -> torch.Tensor:
    """|x|'s f32 bit pattern as int32 (non-negative; a NaN's orders above
    +inf), the kernel's atomicMax key."""
    return x.contiguous().view(torch.int32) & 0x7FFFFFFF


def _exponent(bits: torch.Tensor) -> torch.Tensor:
    """frexp exponent e (|x| < 2^e; 0 at 0) of the f32 values of `bits`,
    NONFINITE_K where they are not finite."""
    a = bits.view(torch.float32)
    return torch.where(torch.isfinite(a), torch.frexp(a).exponent,
                       NONFINITE_K).to(torch.int64)


def _scale(lg: torch.Tensor, *exps: torch.Tensor) -> torch.Tensor:
    """GRAM_BITS - lg - sum(exps), NONFINITE_K where any is."""
    k = GRAM_BITS - lg
    bad = torch.zeros_like(k, dtype=torch.bool)
    for e in exps:
        k = k - e
        bad = bad | (e == NONFINITE_K)
    return torch.where(bad, NONFINITE_K, k)


def _leaf_rows(raw, row_node, cnt, feat):
    """(node [N] i64, usable [N] bool, xt [N, D+1] f32): each row's node,
    whether it enters its leaf's fit (a node in range, cnt > 0, no NaN in
    its leaf's features) and its leaf's feature values with the intercept
    column (0 in empty slots)."""
    n, f = raw.shape
    m1 = feat.shape[0]
    node = row_node.to(torch.int64)
    inside = (node >= 0) & (node < m1)
    lf = feat[node.clamp(0, m1 - 1)]
    fm = lf >= 0
    xg = raw.gather(1, lf.clamp(0, max(f - 1, 0)).to(torch.int64))
    nanr = (torch.isnan(xg) & fm).any(1)
    usable = inside & ~nanr & (cnt > 0)
    x = torch.where(fm, xg, torch.zeros((), dtype=xg.dtype, device=xg.device))
    xt = torch.cat([x, torch.ones((n, 1), dtype=x.dtype, device=x.device)],
                   1)
    return node, usable, xt


def linear_gram_ref(raw, row_node, grad, hess, cnt, feat
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of linear_gram: (X'HX [M+1, D+1, D+1] f32, X'g
    [M+1, D+1] f32, usable rows [M+1] i32). Each (leaf, entry) sum is the
    int64 sum of rint(v x 2^k) over the leaf's usable rows, v formed in
    float64 as (h x_i) x_j and g x_i, k from the leaf's maxima (module
    docstring), scaled back to f32 once."""
    m1, d = feat.shape
    d1 = d + 1
    dev = raw.device
    node, usable, xt = _leaf_rows(raw, row_node, cnt, feat)
    nd = node[usable]
    xu, hu, gu = xt[usable], hess[usable], grad[usable]
    count = torch.zeros(m1, dtype=torch.int32, device=dev) \
        .index_add_(0, nd, torch.ones_like(nd, dtype=torch.int32))

    def amax(src):
        out = torch.zeros((m1,) + src.shape[1:], dtype=torch.int32,
                          device=dev)
        idx = nd.view((-1,) + (1,) * (src.dim() - 1)).expand_as(src)
        return out.scatter_reduce_(0, idx, src, "amax")

    ex = _exponent(amax(_abs_bits(xu)))                       # [M+1, D+1]
    eh = _exponent(amax(_abs_bits(hu)))[:, None]
    eg = _exponent(amax(_abs_bits(gu)))[:, None]
    c1 = (count.to(torch.float64) - 1).clamp(min=0)
    lg = torch.where(count > 1, torch.frexp(c1).exponent.to(torch.int64),
                     0)[:, None]
    ii, jj = torch.triu_indices(d1, d1, device=dev)
    kp = _scale(lg, eh, ex[:, ii], ex[:, jj])                 # [M+1, T]
    kg = _scale(lg, eg, ex)                                   # [M+1, D+1]
    sp = torch.zeros((m1, ii.shape[0]), dtype=torch.int64, device=dev)
    sg = torch.zeros((m1, d1), dtype=torch.int64, device=dev)
    for c0 in range(0, nd.shape[0], _REF_CHUNK):
        c = slice(c0, c0 + _REF_CHUNK)
        rows = nd[c]
        x = xu[c].to(torch.float64)
        hx = hu[c].to(torch.float64)[:, None] * x
        for sums, v, k in (
                (sp, hx[:, ii] * x[:, jj], kp[rows]),
                (sg, gu[c].to(torch.float64)[:, None] * x, kg[rows])):
            finite = k != NONFINITE_K
            q = torch.round(v * torch.where(finite, _pow2(k), 0.0))
            sums.index_add_(0, rows, torch.where(finite, q, 0.0)
                            .to(torch.int64))
    vals = _exact_result(sp, kp)
    xthx = torch.zeros((m1, d1, d1), dtype=torch.float32, device=dev)
    xthx[:, ii, jj] = vals
    xthx[:, jj, ii] = vals
    return xthx, _exact_result(sg, kg), count


def _record_width(nf: int) -> int:
    """Floats of a leaf's records in linear_gram's scratch: its nf
    features, h, g and the usable flag, padded to a power of two."""
    w = 4
    while w < nf + 3:
        w *= 2
    return w


def gram_scratch_bytes(n: int, m1: int, d: int) -> int:
    """Bytes of linear_gram's scratch (csrc/linear_leaves.cu carve): the
    part zeroed every call (int32 row counts, reservation cursors, usable
    counts and maxima; the int64 sums), then, each at 16 bytes, each
    leaf's first record float (int64), active count and columns (int32);
    the chunk table (an int32 pair a chunk of GRAM_CHUNK records, n /
    GRAM_CHUNK + M+1 of them); the records, at most n _record_width(d)
    f32."""
    d1 = d + 1
    zeroed = -(-4 * m1 * (d1 + 5) // 8) * 8 + \
        8 * m1 * (d1 * (d1 + 1) // 2 + d1)
    tables = 8 * m1 + 4 * m1 * (d + 1)
    chunks = 8 * (-(-n // GRAM_CHUNK) + m1)
    return sum(-(-b // 16) * 16 for b in (zeroed, tables, chunks)) + \
        4 * n * _record_width(d)


def linear_gram(raw, row_node, grad, hess, cnt, feat
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(X'HX [M+1, D+1, D+1] f32, X'g [M+1, D+1] f32, usable rows [M+1]
    i32) of each leaf over its rows' features feat [M+1, D] (-1: empty
    slot) and the intercept column; raw [N, F] f32, row_node [N] i32,
    grad/hess/cnt [N] f32. Fixed-point int64 sums (linear_gram_ref), so
    the kernel equals its plain version bit for bit. On the card: one
    call (the rows counted by leaf; raw read in row order once, each row's
    features, h and g written as a record in its leaf's run; the records'
    maxima, then their sums a CTA a chunk of GRAM_CHUNK; the scale back)
    into a scratch buffer cached per device."""
    if _on_cpu(raw, row_node, grad, hess, cnt, feat):
        return linear_gram_ref(raw, row_node, grad, hess, cnt, feat)
    n, f = raw.shape
    m1, d = feat.shape
    if not 0 < d < MAX_SLOTS:
        raise ValueError(f"feat: {d} slots, the kernel takes 1 to "
                         f"{MAX_SLOTS - 1}")
    _check(raw, "raw", torch.float32, (n, f))
    _check(row_node, "row_node", torch.int32, (n,))
    for t, name in ((grad, "grad"), (hess, "hess"), (cnt, "cnt")):
        _check(t, name, torch.float32, (n,))
    _check(feat, "feat", torch.int32, (m1, d))
    dev = raw.device
    xthx = torch.empty((m1, d + 1, d + 1), dtype=torch.float32, device=dev)
    xtg = torch.empty((m1, d + 1), dtype=torch.float32, device=dev)
    count = torch.empty(m1, dtype=torch.int32, device=dev)
    nbytes = gram_scratch_bytes(n, m1, d)
    buf = scratch(dev, "linear_gram", (nbytes + 7) // 8, torch.int64)
    _cuda.call("linear_gram", dev, raw, row_node, grad, hess, cnt, feat,
               buf, xthx, xtg, count, n, f, m1, d, nbytes)
    count_launch("linear_gram")
    return xthx, xtg, count


def linear_leaf_values_ref(tree: TreeArrays, lin: LinearLeaves,
                           leaf: torch.Tensor,
                           raw: torch.Tensor) -> torch.Tensor:
    """Plain version of linear_leaf_values: for each row, const + the
    products coeff x x added slot after slot in f32 (x 0 in an empty
    slot), leaf_value where a model feature is NaN, 0 for a node out of
    range."""
    n, f = raw.shape
    m1, d = lin.feat.shape
    node = leaf.to(torch.int64)
    inside = (node >= 0) & (node < m1)
    nc = node.clamp(0, m1 - 1)
    lf = lin.feat[nc]
    fm = lf >= 0
    xg = raw.gather(1, lf.clamp(0, max(f - 1, 0)).to(torch.int64))
    x = torch.where(fm, xg, torch.zeros((), dtype=xg.dtype, device=xg.device))
    nanr = (torch.isnan(x) & fm).any(1)
    coeff = lin.coeff[nc]
    acc = lin.const[nc]
    for s in range(d):
        acc = acc + coeff[:, s] * x[:, s]
    out = torch.where(nanr, tree.leaf_value[nc], acc)
    return torch.where(inside, out, torch.zeros((), dtype=out.dtype,
                                                device=out.device))


def linear_leaf_values(tree: TreeArrays, lin: LinearLeaves,
                       leaf: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
    """[N] f32 leaf-model outputs of rows whose leaf node ids are `leaf`
    [N] i32 over their raw values [N, F] (the JAX package's
    linear_leaf_values): NaN in a model feature falls back to the
    constant leaf_value (reference tree.cpp:133-150). On the card: each
    leaf's active slots compacted (one launch), then the rows, a thread a
    row over its leaf's active slots in the plain version's order of f32
    ops, the signed zeros of the empty slots kept (one launch); the
    compact models in a scratch buffer cached per device."""
    if _on_cpu(raw, leaf, lin.const, tree.leaf_value):
        return linear_leaf_values_ref(tree, lin, leaf, raw)
    n, f = raw.shape
    m1, d = lin.feat.shape
    _check(raw, "raw", torch.float32, (n, f))
    _check(leaf, "leaf", torch.int32, (n,))
    _check(tree.leaf_value, "leaf_value", torch.float32, (m1,))
    _check(lin.const, "const", torch.float32, (m1,))
    coeff = lin.coeff.contiguous()
    feat = lin.feat.contiguous()
    _check(coeff, "coeff", torch.float32, (m1, d))
    _check(feat, "feat", torch.int32, (m1, d))
    out = torch.empty(n, dtype=torch.float32, device=raw.device)
    model = scratch(raw.device, "linear_values",
                    (16 + m1 * (16 + 8 * d) + 7) // 8, torch.int64)
    _cuda.call("linear_values", raw.device, raw, leaf, tree.leaf_value,
               lin.const, coeff, feat, model, out, n, f, m1, d)
    count_launch("linear_values")
    return out


def _solve(tree: TreeArrays, feat: torch.Tensor, xthx, xtg, count,
           linear_lambda: float, dmax: int) -> LinearLeaves:
    """The batched ridge solve and the leaves that keep their constant
    (the JAX package's fit_linear_leaves after its accumulation)."""
    m1 = feat.shape[0]
    d1 = dmax + 1
    dev = feat.device
    nfeat = (feat >= 0).sum(1).to(torch.int32)
    lam_diag = torch.cat([torch.ones(dmax, dtype=torch.float32, device=dev),
                          torch.zeros(1, dtype=torch.float32, device=dev)])
    a = xthx + torch.diag(lam_diag * float(linear_lambda))[None]
    # empty feature slots: an identity row and column and a zero right
    # side, so their coefficients solve to 0
    active = torch.cat([feat >= 0, torch.ones((m1, 1), dtype=torch.bool,
                                              device=dev)], 1)
    pair = active[:, :, None] & active[:, None, :]
    a = torch.where(pair, a, torch.eye(d1, dtype=torch.float32,
                                       device=dev)[None])
    rhs = torch.where(active, xtg, torch.zeros((), dtype=xtg.dtype,
                                               device=dev))
    sol, info = torch.linalg.solve_ex(a.to(torch.float64),
                                      rhs.to(torch.float64)[..., None])
    sol = (-sol[..., 0]).to(torch.float32)
    ok = (tree.is_leaf & (nfeat > 0) & (count >= nfeat + 1) & (info == 0) &
          torch.isfinite(sol).all(1))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    const = torch.where(ok, sol[:, dmax], tree.leaf_value)
    coeff = torch.where(ok[:, None] & (feat >= 0), sol[:, :dmax], zero)
    nfeat = torch.where(ok, nfeat, 0).to(torch.int32)
    feat = torch.where(nfeat[:, None] > 0, feat, -1).to(torch.int32)
    return LinearLeaves(const=const, coeff=coeff, feat=feat, nfeat=nfeat)


def fit_linear_leaves(tree: TreeArrays, row_node: torch.Tensor,
                      raw: torch.Tensor, grad: torch.Tensor,
                      hess: torch.Tensor, cnt: torch.Tensor,
                      is_cat: torch.Tensor, linear_lambda: float, *,
                      dmax: int) -> LinearLeaves:
    """Fit every leaf model of one tree (the JAX package's
    fit_linear_leaves): raw [N, F] f32 raw feature values (NaN allowed),
    row_node [N] each row's leaf node id, grad/hess [N] with the row
    sample folded in, cnt [N] 1.0 for in-bag rows, is_cat [F] bool. The
    sums are linear_gram (kernel L1 on the card), the solve solve_ex;
    no host read."""
    feat = leaf_features(path_feature_masks(tree, raw.shape[1], is_cat),
                         dmax)
    xthx, xtg, count = linear_gram(raw, row_node, grad, hess, cnt, feat)
    return _solve(tree, feat, xthx, xtg, count, linear_lambda, dmax)


def fit_linear_leaves_ref(tree: TreeArrays, row_node: torch.Tensor,
                          raw: torch.Tensor, grad: torch.Tensor,
                          hess: torch.Tensor, cnt: torch.Tensor,
                          is_cat: torch.Tensor, linear_lambda: float, *,
                          dmax: int) -> LinearLeaves:
    """fit_linear_leaves with the plain version of the sums on any
    device."""
    feat = leaf_features(path_feature_masks(tree, raw.shape[1], is_cat),
                         dmax)
    xthx, xtg, count = linear_gram_ref(raw, row_node, grad, hess, cnt, feat)
    return _solve(tree, feat, xthx, xtg, count, linear_lambda, dmax)
