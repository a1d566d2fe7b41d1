"""State carried across from the JAX package, given as numpy arrays.

The port imports nothing of lightgbm_tpu; a caller that holds the JAX
package's state (a grown TreeArrays, a binned matrix, a score vector)
hands it over as numpy arrays and gets the port's counterpart. Bitsets
change representation on the way: the JAX package keeps categorical
left-sets as uint32 words, the port as int64 words holding 32 bits each.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .binning import BinMapper
from .data import BinnedDataset, Metadata
from .learner.grower import TreeArrays
from .learner.linear import LinearLeaves

__all__ = ["tree_arrays_from_numpy", "tree_arrays_to_numpy",
           "linear_leaves_from_numpy", "linear_leaves_to_numpy",
           "binned_from_numpy", "score_from_numpy", "key_from_numpy"]

_DTYPES = {
    "split_feature": torch.int32, "threshold_bin": torch.int32,
    "default_left": torch.bool, "is_cat": torch.bool,
    "cat_bitset": torch.int64, "left": torch.int32, "right": torch.int32,
    "parent": torch.int32, "leaf_value": torch.float32,
    "sum_grad": torch.float32, "sum_hess": torch.float32,
    "count": torch.float32, "gain": torch.float32, "depth": torch.int32,
    "is_leaf": torch.bool, "num_nodes": torch.int32,
    "num_leaves": torch.int32,
}


def tree_arrays_from_numpy(arrays: Dict[str, np.ndarray],
                           device="cpu") -> TreeArrays:
    """TreeArrays from the JAX package's fields (name -> numpy array)."""
    out = {}
    for name in TreeArrays._fields:
        a = np.asarray(arrays[name])
        if name == "cat_bitset":
            a = a.astype(np.uint32).astype(np.int64)
        out[name] = torch.tensor(a, device=device).to(_DTYPES[name])
    return TreeArrays(**out)


def tree_arrays_to_numpy(tree: TreeArrays) -> Dict[str, np.ndarray]:
    """The inverse: numpy fields in the JAX package's dtypes."""
    out = {}
    for name in TreeArrays._fields:
        a = getattr(tree, name).detach().cpu().numpy()
        out[name] = a.astype(np.uint32) if name == "cat_bitset" else a
    return out


_LIN_DTYPES = {"const": torch.float32, "coeff": torch.float32,
               "feat": torch.int32, "nfeat": torch.int32}


def linear_leaves_from_numpy(arrays: Dict[str, np.ndarray],
                             device="cpu") -> LinearLeaves:
    """LinearLeaves from the JAX package's fields (name -> numpy array)."""
    return LinearLeaves(**{
        name: torch.tensor(np.asarray(arrays[name]), device=device)
        .to(_LIN_DTYPES[name]) for name in LinearLeaves._fields})


def linear_leaves_to_numpy(lin: LinearLeaves) -> Dict[str, np.ndarray]:
    """The inverse: numpy fields (f32 const and coeff, i32 feat and
    nfeat)."""
    return {name: getattr(lin, name).detach().cpu().numpy()
            for name in LinearLeaves._fields}


def binned_from_numpy(bins: np.ndarray, num_bins: np.ndarray,
                      missing_types: np.ndarray, is_categorical: np.ndarray,
                      bin_mappers_state: Sequence[dict],
                      used_features: Optional[np.ndarray] = None,
                      num_total_features: Optional[int] = None,
                      label: Optional[np.ndarray] = None,
                      feature_names: Optional[List[str]] = None,
                      group: Optional[np.ndarray] = None
                      ) -> BinnedDataset:
    """BinnedDataset from a binned matrix and its mappers' state
    (BinMapper.to_dict of each used feature). The per-feature arrays must
    agree with the mappers; group: the query sizes or boundaries of a
    ranking dataset."""
    mappers = [BinMapper.from_dict(d) for d in bin_mappers_state]
    f = len(mappers)
    used = np.arange(f, dtype=np.int32) if used_features is None \
        else np.asarray(used_features, np.int32)
    n = bins.shape[0]
    ds = BinnedDataset(np.ascontiguousarray(bins), mappers, used,
                       num_total_features or f,
                       Metadata(n, label=label, group=group),
                       feature_names)
    for name, given in (("num_bins", num_bins),
                        ("missing_types", missing_types),
                        ("is_categorical", is_categorical)):
        if not np.array_equal(getattr(ds, name), np.asarray(given)):
            raise ValueError(f"{name} disagrees with the bin mappers")
    return ds


def score_from_numpy(score: np.ndarray, device="cpu") -> torch.Tensor:
    """A training-score vector as the port holds it: [N] f32."""
    return torch.as_tensor(np.asarray(score, np.float32).reshape(-1),
                           device=device)


def key_from_numpy(key: np.ndarray, device="cpu") -> torch.Tensor:
    """A jax.random key's two uint32 words (jax.random.key_data, or a raw
    PRNGKey array) as the port's key: an int64 [2] tensor
    (lightgbm_tpu_torch.rng)."""
    words = np.asarray(key).astype(np.uint32).reshape(2)
    return torch.as_tensor(words.astype(np.int64), device=device)
