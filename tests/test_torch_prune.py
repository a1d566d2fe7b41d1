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


_CASES = [  # (m_grow, splits, num_leaves, ties)
    (59, 29, 15, True), (59, 29, 15, False), (127, 60, 31, True),
    (255, 100, 31, False), (63, 7, 15, True), (19, 9, 2, True)]


@pytest.mark.parametrize("case", range(len(_CASES)))
def test_prune_plain_version_matches_jax(case):
    m_grow, n_splits, num_leaves, ties = _CASES[case]
    rng = np.random.RandomState(100 + case)
    fields, row_node = _overgrown(rng, m_grow, n_splits, 500, ties)
    tree = convert.tree_arrays_from_numpy(fields)

    sel, kept, new_id, composed = prune_best_first_ref(
        tree.left, tree.right, tree.parent, tree.gain, num_leaves=num_leaves)
    want = _replay_numpy(fields, num_leaves, m_grow)
    for got, exp, name in zip((sel, kept, new_id, composed), want,
                              ("sel", "kept", "new_id", "composed")):
        np.testing.assert_array_equal(got.numpy(), exp, err_msg=name)

    pruned, rows = torch_grower._prune_to_best_first(
        tree, torch.as_tensor(row_node), num_leaves=num_leaves,
        m_grow=m_grow)
    jtree = jax_tree.TreeArrays(**{k: jnp.asarray(v)
                                   for k, v in fields.items()})
    j_pruned, j_rows = jax_grower._prune_to_best_first(
        jtree, jnp.asarray(row_node), num_leaves=num_leaves, m_grow=m_grow,
        interpret=True)
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
