"""Tree state of the grower (port of lightgbm_tpu/learner/grower.py:54-118).

`TreeArrays` is the struct-of-arrays tree the grower fills, indexed by node
id and sized [max_nodes + 1] (the last row is scratch): the device-resident
counterpart of the reference Tree (include/LightGBM/tree.h:25) and CUDATree
(cuda_tree.hpp:28). Node 0 is the root; internal nodes carry split info,
leaves carry output values. Categorical left-sets are int64 words holding
32 bits each (the JAX package's uint32 words; torch's uint32 has few ops).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["TreeArrays", "_init_tree"]


class TreeArrays(NamedTuple):
    split_feature: torch.Tensor   # i32, used-feature idx; -1 for leaf
    threshold_bin: torch.Tensor   # i32; numerical: left iff bin <= t
    default_left: torch.Tensor    # bool (NaN direction)
    is_cat: torch.Tensor          # bool; decision: bin in cat_bitset -> left
    cat_bitset: torch.Tensor      # [M+1, W] int64 words of 32 bits
    left: torch.Tensor            # i32 child id
    right: torch.Tensor           # i32 child id
    parent: torch.Tensor          # i32, -1 for root
    leaf_value: torch.Tensor      # f32 node output
    sum_grad: torch.Tensor        # f32
    sum_hess: torch.Tensor        # f32
    count: torch.Tensor           # f32
    gain: torch.Tensor            # f32 split gain of internal nodes
    depth: torch.Tensor           # i32
    is_leaf: torch.Tensor         # bool
    num_nodes: torch.Tensor       # i32 scalar
    num_leaves: torch.Tensor      # i32 scalar


def _init_tree(max_nodes: int, root_grad, root_hess, root_count,
               root_value, bitset_words: int = 1,
               device=None) -> TreeArrays:
    m1 = max_nodes + 1

    def zf():
        return torch.zeros(m1, dtype=torch.float32, device=device)

    def with_root(v):
        t = zf()
        t[0] = v
        return t

    def full_i(v):
        return torch.full((m1,), v, dtype=torch.int32, device=device)

    is_leaf = torch.zeros(m1, dtype=torch.bool, device=device)
    is_leaf[0].fill_(True)
    return TreeArrays(
        split_feature=full_i(-1), threshold_bin=full_i(0),
        default_left=torch.zeros(m1, dtype=torch.bool, device=device),
        is_cat=torch.zeros(m1, dtype=torch.bool, device=device),
        cat_bitset=torch.zeros((m1, bitset_words), dtype=torch.int64,
                               device=device),
        left=full_i(-1), right=full_i(-1), parent=full_i(-1),
        leaf_value=with_root(root_value), sum_grad=with_root(root_grad),
        sum_hess=with_root(root_hess), count=with_root(root_count),
        gain=zf(), depth=full_i(0), is_leaf=is_leaf,
        num_nodes=torch.ones((), dtype=torch.int32, device=device),
        num_leaves=torch.ones((), dtype=torch.int32, device=device))
