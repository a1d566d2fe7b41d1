"""The best-first prune's plain version against the JAX package, on the CPU.

prune.prune_best_first_ref (the replay and pointer doubling of the
JAX package's _prune_to_best_first, whose card kernel is
csrc/prune_best_first.cu) runs on random overgrown trees: node ids
assigned as the grower assigns them (children after their parent, in
pairs), gains drawn from a few values so that ties are common, more
overgrown leaves than the prune keeps. Its selections are held to a
sequential numpy replay (first index on ties, as lax.argmax), and the
port's whole prune (grower_mxu._prune_to_best_first: the plain version,
the compaction and the row map) to the JAX package's _prune_to_best_first
in interpret mode: every field of the compacted tree and the row map
equal. The compacted tree's last row is the scratch node, which the JAX
scatter fills with whichever dropped node it writes last; it is left out.
The forced cases rank a root-connected set of forced nodes by
gain + 1e30 (rank_gain, the grower's key for forced splits: in f32 every
such key is 1e30, one tied group at the top of the best-first order),
the compacted tree keeping the true gains.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.learner import grower as jax_tree
from lightgbm_tpu.learner import grower_mxu as jax_grower
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.learner import grower_mxu as torch_grower
from lightgbm_tpu_torch.learner.prune import prune_best_first_ref
from tests.test_torch_one_thread import one_thread  # noqa: F401


def _overgrown(rng, m_grow, n_splits, n_rows, ties):
    """numpy fields (the JAX package's dtypes) of a tree of n_splits
    splits in an [m_grow + 1] node space, and rows spread over its
    leaves."""
    m1 = m_grow + 1
    left = np.full(m1, -1, np.int32)
    right = np.full(m1, -1, np.int32)
    parent = np.full(m1, -1, np.int32)
    depth = np.zeros(m1, np.int32)
    leaves, nn = [0], 1
    for _ in range(n_splits):
        j = leaves.pop(rng.randint(len(leaves)))
        left[j], right[j] = nn, nn + 1
        parent[nn] = parent[nn + 1] = j
        depth[nn] = depth[nn + 1] = depth[j] + 1
        leaves += [nn, nn + 1]
        nn += 2
    internal = left >= 0
    gain = np.where(internal, rng.randint(1, 6, m1) if ties
                    else rng.rand(m1) * 10, 0).astype(np.float32)
    is_leaf = np.zeros(m1, bool)
    is_leaf[leaves] = True
    fields = dict(
        split_feature=np.where(internal, rng.randint(0, 9, m1), -1)
        .astype(np.int32),
        threshold_bin=np.where(internal, rng.randint(0, 60, m1), 0)
        .astype(np.int32),
        default_left=internal & (rng.rand(m1) < 0.5),
        is_cat=internal & (rng.rand(m1) < 0.2),
        cat_bitset=np.where(internal[:, None],
                            rng.randint(0, 2 ** 32, (m1, 2),
                                        dtype=np.uint64), 0)
        .astype(np.uint32),
        left=left, right=right, parent=parent,
        leaf_value=rng.randn(m1).astype(np.float32),
        sum_grad=rng.randn(m1).astype(np.float32),
        sum_hess=rng.rand(m1).astype(np.float32),
        count=rng.randint(1, 100, m1).astype(np.float32),
        gain=gain, depth=depth, is_leaf=is_leaf,
        num_nodes=np.int32(nn), num_leaves=np.int32(len(leaves)))
    row_node = rng.choice(np.asarray(leaves, np.int32), n_rows)
    return fields, row_node


def _forced_rank(rng, fields, share=0.3):
    """gain + 1e30 (f32) on a root-connected set of internal nodes (the
    root, then each internal child of a forced node with probability
    1 - share), gain elsewhere: the grower's rank keys for forced
    splits."""
    left, right = fields["left"], fields["right"]
    forced = np.zeros(len(left), bool)
    todo = [0] if left[0] >= 0 else []
    while todo:
        j = todo.pop(0)
        forced[j] = True
        for c in (left[j], right[j]):
            if left[c] >= 0 and rng.rand() > share:
                todo.append(int(c))
    rank = fields["gain"] + np.where(forced, np.float32(1e30),
                                     np.float32(0))
    return rank.astype(np.float32), forced


def _replay_numpy(fields, num_leaves, m_grow):
    """(sel, kept, new_id, composed) by a sequential numpy replay."""
    left, right = fields["left"], fields["right"]
    parent = fields["parent"]
    m1 = m_grow + 1
    gains = np.where(left >= 0, fields["gain"], -np.inf).astype(np.float32)
    avail = np.full(m1, -np.inf, np.float32)
    avail[0] = gains[0]
    sel = np.zeros(m1, bool)
    for _ in range(num_leaves - 1):
        j = int(np.argmax(avail))
        ok = avail[j] > -np.inf
        sel[j] |= ok
        avail[j] = -np.inf
        for c in (left[j], right[j]):
            c = min(max(int(c), 0), m_grow) if ok else m_grow
            avail[c] = gains[c] if c < m_grow else -np.inf
    kept = np.zeros(m1, bool)
    for i in range(m1):
        if i == 0:
            kept[i] = True
        elif parent[i] >= 0:
            a, ok = i, True
            while a != 0:
                a = parent[a]
                ok &= bool(sel[a])
            kept[i] = ok
    leaf = kept & ~sel
    new_id = np.cumsum(kept) - 1
    composed = np.zeros(m1, np.float32)
    for i in range(m1):
        a = i
        while not (leaf[a] or a == 0):
            a = min(max(int(parent[a]), 0), m_grow)
        composed[i] = new_id[a]
    return sel, kept, new_id, composed


_CASES = [  # (m_grow, splits, num_leaves, ties, forced)
    (59, 29, 15, True, False), (59, 29, 15, False, False),
    (127, 60, 31, True, False), (255, 100, 31, False, False),
    (63, 7, 15, True, False), (19, 9, 2, True, False),
    (59, 29, 15, False, True), (127, 60, 31, True, True),
    (255, 100, 31, False, True), (63, 30, 4, False, True)]


@pytest.mark.parametrize("case", range(len(_CASES)))
def test_prune_plain_version_matches_jax(case):
    m_grow, n_splits, num_leaves, ties, forced = _CASES[case]
    rng = np.random.RandomState(100 + case)
    fields, row_node = _overgrown(rng, m_grow, n_splits, 500, ties)
    tree = convert.tree_arrays_from_numpy(fields)
    rank = None
    if forced:
        is_forced = np.zeros(1, bool)
        while is_forced.sum() < 3:     # a group of three forced nodes or more
            rank, is_forced = _forced_rank(rng, fields)
        assert np.all(rank[is_forced] == np.float32(1e30))

    sel, kept, new_id, composed = prune_best_first_ref(
        tree.left, tree.right, tree.parent,
        tree.gain if rank is None else torch.as_tensor(rank),
        num_leaves=num_leaves)
    want = _replay_numpy(dict(fields, gain=fields["gain"] if rank is None
                              else rank), num_leaves, m_grow)
    for got, exp, name in zip((sel, kept, new_id, composed), want,
                              ("sel", "kept", "new_id", "composed")):
        np.testing.assert_array_equal(got.numpy(), exp, err_msg=name)
    if forced:
        # forced nodes come first: as many as the steps allow, in id order
        steps = min(num_leaves - 1, int(is_forced.sum()))
        assert sel[torch.as_tensor(is_forced)].sum() == steps

    pruned, rows = torch_grower._prune_to_best_first(
        tree, torch.as_tensor(row_node), num_leaves=num_leaves,
        m_grow=m_grow,
        rank_gain=None if rank is None else torch.as_tensor(rank))
    jtree = jax_tree.TreeArrays(**{k: jnp.asarray(v)
                                   for k, v in fields.items()})
    j_pruned, j_rows = jax_grower._prune_to_best_first(
        jtree, jnp.asarray(row_node), num_leaves=num_leaves, m_grow=m_grow,
        interpret=True,
        rank_gain=None if rank is None else jnp.asarray(rank))
    j_np = convert.tree_arrays_from_numpy(
        {k: np.asarray(v) for k, v in j_pruned._asdict().items()})
    mf = 2 * num_leaves - 1
    for name in pruned._fields:
        got, exp = getattr(pruned, name), getattr(j_np, name)
        if got.dim():
            got, exp = got[:mf], exp[:mf]
        np.testing.assert_array_equal(got.numpy(), exp.numpy(),
                                      err_msg=name)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(j_rows))
    assert int(pruned.num_leaves) == min(num_leaves, n_splits + 1)
    # the true gains are kept
    assert float(pruned.gain.max()) < 1e20


# ---- the card kernel's algorithm (csrc/prune_best_first.cu), phase for
# phase in numpy: best-first order from path-minimum keys

def _key48(gains):
    """Each node's 48-bit key in lax.argmax's order (NaN above every
    number, then the larger gain, ties to the lower id): the gain's
    order-preserving 32 bits (-0 as +0, every NaN the top) above
    0xffff - id."""
    g = np.where(gains == 0, np.float32(0), gains).astype(np.float32)
    b = g.view(np.uint32).astype(np.uint64)
    ordg = np.where(b >= 0x80000000, ~b & 0xffffffff, b | 0x80000000)
    ordg = np.where(np.isnan(g), 0xffffffff, ordg).astype(np.uint64)
    ids = np.arange(len(g), dtype=np.uint64)
    return (ordg << np.uint64(16)) | (np.uint64(0xffff) - ids)


def _prune_by_groups(left, right, parent, gain, num_leaves):
    """(sel, kept, new_id, composed) as the card kernel computes them:
    1. E(v), the least key on the path root..v, and whether v is reached
       (no proper ancestor's gain NaN), by pointer doubling over the
       parents the children arrays give;
    2. the group boundary: the key T of rank S = num_leaves - 1 (from the
       top, 0-based) among the reached nodes whose E is above -inf, by a
       radix select of 8-bit digits, and r, T's rank among its own group;
    3. every reached non-NaN node whose E beats T is selected, then r
       steps of the sequential replay from T's node (the boundary group's
       head) select the rest;
    4. the closure and the renumbering, as prune_best_first_ref."""
    m1 = len(left)
    m_grow = m1 - 1
    gains = np.where(left >= 0, gain, -np.inf).astype(np.float32)
    key = _key48(gains)
    rounds = max(1, (m1 - 1).bit_length())
    # 1. parents from the children, reach flags, E by doubling
    ptr = np.arange(m1)
    ok = np.zeros(m1, bool)
    ok[0] = True
    for j in np.flatnonzero(left >= 0):
        for c in (left[j], right[j]):
            c = min(max(int(c), 0), m_grow)
            if 0 < c < m_grow:
                ptr[c] = j
                ok[c] = not np.isnan(gains[j])
    e = np.arange(m1)
    for _ in range(rounds):
        pe = e[ptr]
        e = np.where(key[pe] < key[e], pe, e)
        ok = ok & ok[ptr]
        ptr = ptr[ptr]
    valid = ok & ~(gains[e] == -np.inf)
    # 2. radix select of rank S over the valid nodes' keys key[e]
    steps = num_leaves - 1
    sel = np.zeros(m1, bool)
    ek = key[e]
    if valid.sum() <= steps:
        sel = valid & ~np.isnan(gains)
    else:
        k, prefix = steps, np.uint64(0)
        for shift in range(40, -8, -8):
            hi = np.uint64(shift + 8)
            cand = valid & ((ek >> hi) == (prefix >> hi))
            digit = ((ek[cand] >> np.uint64(shift)) & np.uint64(255)) \
                .astype(np.int64)
            hist = np.bincount(digit, minlength=256)
            for d in range(255, -1, -1):
                if k < hist[d]:
                    break
                k -= hist[d]
            prefix |= np.uint64(d) << np.uint64(shift)
        # 3. the groups above T whole, then r = k replay steps from T's node
        sel = valid & (ek > prefix) & ~np.isnan(gains)
        head = 0xffff - int(prefix & np.uint64(0xffff))
        avail = np.full(m1, -np.inf, np.float32)
        avail[head] = gains[head]
        for _ in range(k):
            j = int(np.argmax(avail))
            okj = avail[j] > -np.inf
            sel[j] |= okj
            avail[j] = -np.inf
            for c in (left[j], right[j]):
                c = min(max(int(c), 0), m_grow) if okj else m_grow
                avail[c] = gains[c] if c < m_grow else -np.inf
    # 4. the closure: as prune_best_first_ref
    par = np.clip(parent, 0, m_grow)
    ids = np.arange(m1)
    p, acc = np.where(ids == 0, ids, par), np.where(ids == 0, True, sel[par])
    for _ in range(rounds):
        acc, p = acc & acc[p], p[p]
    kept = acc & ((ids == 0) | (parent >= 0))
    nxt = np.where((kept & ~sel) | (ids == 0), ids, par)
    for _ in range(rounds):
        nxt = nxt[nxt]
    new_id = (np.cumsum(kept) - 1).astype(np.int32)
    return sel, kept, new_id, new_id[nxt].astype(np.float32)


def _model_tree(rng, kind):
    """(left, right, parent, gain, num_leaves) of one overgrown tree of the
    kind named: random shapes and step counts, gains as named."""
    m_grow = int(rng.choice([15, 31, 63, 127, 255]))
    if kind == "chain":        # a rising chain: one group, the whole tree
        n_splits = (m_grow - 1) // 2
    else:
        n_splits = rng.randint(0, (m_grow - 1) // 2 + 1)
    m1 = m_grow + 1
    left = np.full(m1, -1, np.int32)
    right = np.full(m1, -1, np.int32)
    parent = np.full(m1, -1, np.int32)
    leaves, nn = [0], 1
    for _ in range(n_splits):
        j = max(leaves) if kind == "chain" else \
            leaves.pop(rng.randint(len(leaves)))
        if kind == "chain":
            leaves.remove(j)
        left[j], right[j] = nn, nn + 1
        parent[nn] = parent[nn + 1] = j
        leaves += [nn, nn + 1]
        nn += 2
    if kind == "chain":
        gain = np.arange(m1, dtype=np.float32) + 1
    elif kind == "ties":       # integer gains, as quantized trees tie
        gain = rng.randint(1, 4, m1).astype(np.float32)
    elif kind == "depth":      # gains fall with depth, a child may beat
        gain = (rng.rand(m1) * 10 / (1 + np.log2(np.arange(m1) + 1)))
    else:
        gain = rng.rand(m1).astype(np.float32) * 10
    gain = gain.astype(np.float32)
    if kind == "nan":
        gain[rng.rand(m1) < 0.15] = np.nan
        gain[rng.rand(m1) < 0.1] = np.inf
    if kind == "ninf":
        gain[rng.rand(m1) < (0.2 if rng.rand() < 0.7 else 1.0)] = -np.inf
    if kind == "zeros":        # -0 and +0 tie on the id
        gain = np.where(rng.rand(m1) < 0.5, np.float32(-0.0),
                        np.float32(0.0)).astype(np.float32)
    if kind == "forced":       # a root-connected 1e30-tied top group
        gain, _ = _forced_rank(rng, dict(left=left, right=right, gain=gain),
                               share=float(rng.choice([0.0, 0.3, 0.7])))
    # leaves carry gains too; the kernel reads them only where left >= 0
    num_leaves = int(rng.randint(2, m_grow + 2))
    return left, right, parent, gain, num_leaves


_MODEL_KINDS = ("random", "ties", "depth", "nan", "ninf", "zeros", "chain",
                "forced")


@pytest.mark.parametrize("kind", _MODEL_KINDS)
def test_group_order_model_matches_replay(kind):
    """The kernel's algorithm (numpy model) equals prune_best_first_ref in
    all four outputs on 120 random overgrown trees of each kind: random
    gains, integer-tied gains, gains falling with depth, NaN and +inf
    gains, -inf gains (sometimes every one), signed zeros, rising
    chains (the boundary group is the whole tree) and forced rank keys (a
    root-connected group tied at 1e30 above the rest); trees of 0 splits
    up to full, step counts from 1 to more than the tree has."""
    rng = np.random.RandomState(2024 + _MODEL_KINDS.index(kind))
    for _ in range(120):
        left, right, parent, gain, nl = _model_tree(rng, kind)
        got = _prune_by_groups(left, right, parent, gain, nl)
        want = prune_best_first_ref(*(torch.as_tensor(a) for a in
                                      (left, right, parent, gain)),
                                    num_leaves=nl)
        for g, w, name in zip(got, want, ("sel", "kept", "new_id",
                                          "composed")):
            np.testing.assert_array_equal(g, w.numpy(), err_msg=name)


def test_group_order_model_matches_jax():
    """The whole prune with the kernel's algorithm in place of the replay
    (the port's grower_mxu._prune_to_best_first) against the JAX
    package's _prune_to_best_first: tied gains, NaN gains, a rising chain
    and forced rank keys, every field of the compacted tree and the row
    map equal."""
    rng = np.random.RandomState(77)
    for case, (m_grow, n_splits, num_leaves, kind) in enumerate((
            (63, 25, 15, "ties"), (63, 31, 15, "nan"),
            (63, 31, 15, "chain"), (63, 31, 15, "forced"))):
        fields, row_node = _overgrown(rng, m_grow, n_splits, 300,
                                      kind == "ties")
        if kind == "nan":
            fields["gain"][rng.rand(m_grow + 1) < 0.2] = np.nan
        if kind == "chain":
            # each split's right child splits next, at a larger gain
            left, right, parent = (np.full(m_grow + 1, -1, np.int32)
                                   for _ in range(3))
            for j in range(0, 2 * n_splits, 2):
                left[j], right[j] = j + 1, j + 2
                parent[j + 1] = parent[j + 2] = j
            right[0] = 2
            fields.update(left=left, right=right, parent=parent,
                          gain=np.arange(m_grow + 1, dtype=np.float32))
            leaves = np.flatnonzero((left < 0) & (parent >= 0))
            row_node = rng.choice(leaves, 300).astype(np.int32)
        tree = convert.tree_arrays_from_numpy(fields)
        rank = _forced_rank(rng, fields)[0] if kind == "forced" else None

        def model(l, r, p, g, *, num_leaves):
            return tuple(torch.as_tensor(a) for a in _prune_by_groups(
                l.numpy(), r.numpy(), p.numpy(), g.numpy(), num_leaves))
        orig = torch_grower.prune_best_first
        torch_grower.prune_best_first = model
        try:
            pruned, rows = torch_grower._prune_to_best_first(
                tree, torch.as_tensor(row_node), num_leaves=num_leaves,
                m_grow=m_grow,
                rank_gain=None if rank is None else torch.as_tensor(rank))
        finally:
            torch_grower.prune_best_first = orig
        jtree = jax_tree.TreeArrays(**{k: jnp.asarray(v)
                                       for k, v in fields.items()})
        j_pruned, j_rows = jax_grower._prune_to_best_first(
            jtree, jnp.asarray(row_node), num_leaves=num_leaves,
            m_grow=m_grow, interpret=True,
            rank_gain=None if rank is None else jnp.asarray(rank))
        j_np = convert.tree_arrays_from_numpy(
            {k: np.asarray(v) for k, v in j_pruned._asdict().items()})
        mf = 2 * num_leaves - 1
        for name in pruned._fields:
            got, exp = getattr(pruned, name), getattr(j_np, name)
            if got.dim():
                got, exp = got[:mf], exp[:mf]
            np.testing.assert_array_equal(got.numpy(), exp.numpy(),
                                          err_msg=f"{kind} {name}")
        np.testing.assert_array_equal(rows.numpy(), np.asarray(j_rows))
