"""Best-first prune of an overgrown tree: the replay and its closure.

Port of the replay half of lightgbm_tpu/learner/grower_mxu.py
_prune_to_best_first (:57-170), which the JAX package runs as XLA (a
fori_loop of argmax steps and pointer doubling). The grower overgrows a
tree to ~overshoot x num_leaves leaves, recording every split's gain; the
reference grows strictly best first (serial_tree_learner.cpp:159-210), so
the replay pops the available node of largest gain num_leaves - 1 times
(the first index on ties, as lax.argmax) and makes its children available.
A node is kept iff every proper ancestor was selected; rows move to their
nearest kept-leaf ancestor; kept nodes are renumbered densely.

`prune_best_first` runs the hand-written kernel csrc/prune_best_first.cu
(one CTA) for CUDA tensors and its plain version `prune_best_first_ref`
(the JAX formulation in torch ops) for CPU tensors. The kernel does not
replay step by step: it computes each node's least key on its root path
by pointer doubling, radix-selects the boundary group of the best-first
order and replays that group alone (the design in the source;
tests/test_torch_prune.py holds a numpy model of it, phase for phase, to
the plain version). Every output is an integer or a selection, so the
kernel equals its plain version exactly.
The compaction of the tree and the row map stay in the grower
(grower_mxu._prune_to_best_first: torch ops and node_values).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _cuda
from .histogram_mxu import _check, _on_cpu, count_launch

__all__ = ["prune_best_first", "prune_best_first_ref", "PRUNE_MAX_NODES"]

#: nodes the kernel holds: 320 chunks of 32 ids, 20 bytes of shared
#: memory a node (csrc/prune_best_first.cu kMaxChunks)
PRUNE_MAX_NODES = 32 * 320


def _rounds(m1: int) -> int:
    """Pointer-doubling rounds that reach the root from any of m1 ids."""
    return max(1, (m1 - 1).bit_length())


def prune_best_first_ref(left, right, parent, gain, *, num_leaves: int
                         ) -> Tuple[torch.Tensor, ...]:
    """Plain version of prune_best_first, in torch ops on the tensors'
    device: the JAX package's fori_loop replay and pointer doubling."""
    m1 = left.shape[0]
    m_grow = m1 - 1
    dev = left.device
    ninf = torch.full((), float("-inf"), dtype=torch.float32, device=dev)
    gains = torch.where(left >= 0, gain, ninf)
    avail = ninf.expand(m1).clone()
    avail[0] = gains[0]
    sel = torch.zeros(m1, dtype=torch.bool, device=dev)
    for _ in range(num_leaves - 1):
        j = torch.argmax(avail)
        ok = avail[j] > ninf
        sel[j] = sel[j] | ok
        avail[j] = ninf
        cl = torch.where(ok, left[j].clamp(0, m_grow), m_grow).to(torch.int64)
        cr = torch.where(ok, right[j].clamp(0, m_grow), m_grow) \
            .to(torch.int64)
        avail[cl] = torch.where(cl < m_grow, gains[cl], ninf)
        avail[cr] = torch.where(cr < m_grow, gains[cr], ninf)

    par = parent.to(torch.int64).clamp(0, m_grow)
    ids = torch.arange(m1, dtype=torch.int64, device=dev)
    is_root = ids == 0
    ptr = torch.where(is_root, ids, par)
    acc = torch.where(is_root, True, sel[par])
    for _ in range(_rounds(m1)):
        acc = acc & acc[ptr]
        ptr = ptr[ptr]
    kept = acc & (is_root | (parent >= 0))
    nxt = torch.where((kept & ~sel) | is_root, ids, par)
    for _ in range(_rounds(m1)):
        nxt = nxt[nxt]
    new_id = (torch.cumsum(kept.to(torch.int32), 0) - 1).to(torch.int32)
    return sel, kept, new_id, new_id[nxt].to(torch.float32)


def prune_best_first(left, right, parent, gain, *, num_leaves: int
                     ) -> Tuple[torch.Tensor, ...]:
    """The replay of num_leaves - 1 best-first steps over an overgrown
    tree ([m1] i32 children and parents, -1 for none; [m1] f32 split
    gains, read where left >= 0; the last id is the scratch node) and its
    closure. Returns (sel [m1] bool: selected; kept [m1] bool: every
    proper ancestor selected; new_id [m1] i32: kept ids counted up to
    here, minus one; composed [m1] f32: new_id of each node's nearest
    kept-leaf ancestor, the row map's node table). One launch on the
    card, no host sync."""
    args = (left, right, parent, gain)
    if _on_cpu(*args):
        return prune_best_first_ref(*args, num_leaves=num_leaves)
    m1 = left.shape[0]
    for t, name in ((left, "left"), (right, "right"), (parent, "parent")):
        _check(t, name, torch.int32, (m1,))
    _check(gain, "gain", torch.float32, (m1,))
    if not 0 < m1 <= PRUNE_MAX_NODES:
        raise ValueError(f"prune_best_first: {m1} nodes outside (0, "
                         f"{PRUNE_MAX_NODES}] (the kernel's shared memory)")
    dev = left.device
    flags = torch.empty((2, m1), dtype=torch.bool, device=dev)
    new_id = torch.empty(m1, dtype=torch.int32, device=dev)
    composed = torch.empty(m1, dtype=torch.float32, device=dev)
    _cuda.call("prune_best_first", dev, left, right, parent, gain, flags[0],
               flags[1], new_id, composed, m1, max(num_leaves - 1, 0),
               _rounds(m1))
    count_launch("prune_best_first")
    return flags[0], flags[1], new_id, composed
