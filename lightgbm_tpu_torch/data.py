"""Binned dataset + training metadata (host side).

Copy of the dense-numpy subset of lightgbm_tpu/data.py for the
PyTorch/CUDA port (reference include/LightGBM/dataset.h:355 `Dataset`,
dataset.h:45 `Metadata`): a row-major `[num_data, num_used_features]`
uint8/uint16 bin matrix, trivial features dropped up front like the
reference's feature_pre_filter, and the used->original index map kept for
model output. The booster copies the bin matrix to the device once. A
validation set bins with its training set's mappers and keeps its used
features (BinnedDataset.from_reference; the JAX package's
basic.py:462-477, reference LoadFromFileAlignWithOtherDataset,
dataset_loader.cpp:299). A scipy sparse matrix is binned without
densifying its raw values (BinnedDataset.from_sparse, the JAX package's
data.py:197-250): only the bin matrix is dense. Linear trees keep the used
features' raw values beside the bins (keep_raw: BinnedDataset.raw, [N,
F_used] f32, the JAX package's data.py:131-136,157-194); they need dense
input, so from_sparse refuses keep_raw as the JAX package does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .binning import (BinMapper, bin_columns, find_bin_mappers,
                      find_bin_mappers_sparse)
from .utils.log import Log

__all__ = ["Metadata", "BinnedDataset", "is_sparse"]


def is_sparse(data) -> bool:
    """A scipy sparse matrix or array (duck-typed: no scipy import)."""
    return hasattr(data, "tocsc") and hasattr(data, "nnz")


def _canonical_csc(X):
    """X as CSC with sorted indices and duplicates summed: scipy lets a
    (row, col) entry repeat, meaning the sum, which indexing would not
    take."""
    X = X.tocsc(copy=True)
    X.sum_duplicates()
    X.sort_indices()
    return X


def _bin_sparse(X_csc, used, mappers, dtype) -> np.ndarray:
    """[N, len(used)] bins of a canonical CSC matrix: each used column's
    zero bin, then its stored values binned in place."""
    binned = np.empty((X_csc.shape[0], len(used)), dtype=dtype)
    indptr, indices, vals = X_csc.indptr, X_csc.indices, X_csc.data
    for j, f in enumerate(used):
        m = mappers[j]
        lo, hi = int(indptr[f]), int(indptr[f + 1])
        binned[:, j] = m._value_to_bin_scalar(0.0)
        if hi > lo:
            binned[indices[lo:hi], j] = m.values_to_bins(
                np.asarray(vals[lo:hi], dtype=np.float64)).astype(dtype)
    return binned


class Metadata:
    """Labels, weights, query boundaries, init scores (dataset.h:45)."""

    def __init__(self, num_data: int,
                 label: Optional[np.ndarray] = None,
                 weight: Optional[np.ndarray] = None,
                 init_score: Optional[np.ndarray] = None,
                 group: Optional[np.ndarray] = None):
        self.num_data = num_data
        self.label = None if label is None else \
            np.ascontiguousarray(label, dtype=np.float32).reshape(-1)
        self.weight = None if weight is None else \
            np.ascontiguousarray(weight, dtype=np.float32).reshape(-1)
        self.init_score = None if init_score is None else \
            np.ascontiguousarray(init_score, dtype=np.float64)
        # group: the sizes of the queries, or their boundaries (starting
        # at 0, non-decreasing); kept as boundaries [Q + 1]
        self.query_boundaries: Optional[np.ndarray] = None
        if group is not None:
            group = np.asarray(group)
            if len(group) and group[0] == 0 and np.all(np.diff(group) >= 0):
                self.query_boundaries = group.astype(np.int64)
            else:
                self.query_boundaries = np.concatenate(
                    [[0], np.cumsum(group)]).astype(np.int64)
        if self.label is not None and len(self.label) != num_data:
            Log.fatal("Length of label (%d) != num_data (%d)",
                      len(self.label), num_data)
        if self.weight is not None and len(self.weight) != num_data:
            Log.fatal("Length of weight (%d) != num_data (%d)",
                      len(self.weight), num_data)
        if self.query_boundaries is not None and \
                self.query_boundaries[-1] != num_data:
            Log.fatal("Sum of query counts (%d) != num_data (%d)",
                      int(self.query_boundaries[-1]), num_data)


def _select_used_features(all_mappers, pre_filter: bool):
    """Drop trivial features (reference feature_pre_filter), pick the
    bin-matrix dtype."""
    used, used_mappers = [], []
    for f, m in enumerate(all_mappers):
        if pre_filter and m.is_trivial:
            continue
        used.append(f)
        used_mappers.append(m)
    if not used:
        Log.warning("All features are trivial (constant); nothing to learn")
    used = np.array(used, dtype=np.int32)
    max_num_bin = max([m.num_bin for m in used_mappers], default=2)
    dtype = np.uint8 if max_num_bin <= 256 else np.uint16
    return used, used_mappers, dtype


def _raw_of(X: np.ndarray, used: np.ndarray,
            keep: bool) -> Optional[np.ndarray]:
    """The used columns of dense X as a contiguous f32 matrix, or None."""
    return np.ascontiguousarray(X[:, used], dtype=np.float32) if keep \
        else None


class BinnedDataset:
    """Quantized dataset: `[num_data, num_used_features]` bin matrix."""

    def __init__(self, bins: np.ndarray, mappers: List[BinMapper],
                 used_features: np.ndarray, num_total_features: int,
                 metadata: Metadata,
                 feature_names: Optional[List[str]] = None,
                 raw: Optional[np.ndarray] = None):
        if bins.shape[1] != len(used_features):
            raise ValueError("bin matrix width != number of used features")
        self.bins = bins                      # [N, F_used] uint8/uint16
        # raw values of the used features, kept only for linear trees
        # (reference Dataset has_raw_, dataset.cpp:418-420)
        self.raw = raw                        # [N, F_used] f32 or None
        self.mappers = mappers                # per USED feature
        self.used_features = used_features    # used idx -> original idx
        self.num_total_features = num_total_features
        self.metadata = metadata
        self.feature_names = feature_names or [
            f"Column_{i}" for i in range(num_total_features)]
        self.num_bins = np.array([m.num_bin for m in mappers], dtype=np.int32)
        self.is_categorical = np.array(
            [m.is_categorical for m in mappers], dtype=bool)
        self.missing_types = np.array(
            [m.missing_type for m in mappers], dtype=np.int32)
        self.default_bins = np.array(
            [m.default_bin for m in mappers], dtype=np.int32)

    @staticmethod
    def from_raw(X: np.ndarray, metadata: Metadata, max_bin: int = 255,
                 min_data_in_bin: int = 3, sample_cnt: int = 200000,
                 use_missing: bool = True, zero_as_missing: bool = False,
                 categorical_features: Optional[Sequence[int]] = None,
                 seed: int = 1, feature_names: Optional[List[str]] = None,
                 feature_pre_filter: bool = True,
                 native: bool = True,
                 keep_raw: bool = False) -> "BinnedDataset":
        """Quantize a dense raw feature matrix (native=False: the numpy
        plain versions of the mapper search and the quantization);
        keep_raw: keep the used features' raw values as f32 (raw)."""
        X = np.asarray(X)
        if X.ndim != 2:
            raise ValueError("X must be 2-dimensional")
        num_total = X.shape[1]
        all_mappers = find_bin_mappers(
            X, max_bin=max_bin, min_data_in_bin=min_data_in_bin,
            sample_cnt=sample_cnt, use_missing=use_missing,
            zero_as_missing=zero_as_missing,
            categorical_features=categorical_features, seed=seed,
            native=native)
        used, used_mappers, dtype = _select_used_features(
            all_mappers, feature_pre_filter)
        binned = bin_columns(X, used, used_mappers, dtype, native=native)
        return BinnedDataset(binned, used_mappers, used, num_total, metadata,
                             feature_names, raw=_raw_of(X, used, keep_raw))

    @staticmethod
    def from_sparse(X, metadata: Metadata, max_bin: int = 255,
                    min_data_in_bin: int = 3, sample_cnt: int = 200000,
                    use_missing: bool = True, zero_as_missing: bool = False,
                    categorical_features: Optional[Sequence[int]] = None,
                    seed: int = 1, feature_names: Optional[List[str]] = None,
                    feature_pre_filter: bool = True,
                    keep_raw: bool = False) -> "BinnedDataset":
        """Quantize a scipy CSR/CSC matrix without densifying its raw
        values: the mappers from each column's stored values and implicit
        zeros (find_bin_mappers_sparse), then the bins of each used column
        (the reference's SparseBin ingestion, sparse_bin.hpp:73). The same
        mappers and bin matrix as from_raw on the dense matrix. keep_raw
        (linear trees) raises: leaf models need dense raw values."""
        if keep_raw:
            raise ValueError(
                "linear_tree requires dense input (leaf linear models "
                "need raw feature values)")
        X = _canonical_csc(X)
        all_mappers = find_bin_mappers_sparse(
            X, max_bin=max_bin, min_data_in_bin=min_data_in_bin,
            sample_cnt=sample_cnt, use_missing=use_missing,
            zero_as_missing=zero_as_missing,
            categorical_features=categorical_features, seed=seed)
        used, used_mappers, dtype = _select_used_features(
            all_mappers, feature_pre_filter)
        return BinnedDataset(_bin_sparse(X, used, used_mappers, dtype),
                             used_mappers, used, X.shape[1], metadata,
                             feature_names)

    @staticmethod
    def from_reference(X: np.ndarray, metadata: Metadata,
                       reference: "BinnedDataset",
                       feature_names: Optional[List[str]] = None,
                       native: bool = True,
                       keep_raw: bool = False) -> "BinnedDataset":
        """Quantize X with the reference (training) dataset's mappers,
        keeping its used features: the bin matrix the JAX package gets by
        binning every column with the reference's mappers and keeping the
        used ones (the same dtype: the other columns' trivial mappers have
        one bin). X may be a scipy sparse matrix (binned as
        from_sparse bins); keep_raw: keep the used features' raw values
        (dense X only, as from_sparse)."""
        sparse = is_sparse(X)
        if sparse and keep_raw:
            raise ValueError(
                "linear_tree requires dense input (leaf linear models "
                "need raw feature values)")
        if not sparse:
            X = np.asarray(X)
        if len(X.shape) != 2 or X.shape[1] != reference.num_total_features:
            raise ValueError(
                f"validation data has shape {X.shape}; the training data "
                f"has {reference.num_total_features} features")
        used = reference.used_features
        dtype = reference.bins.dtype
        if sparse:
            binned = _bin_sparse(_canonical_csc(X), used, reference.mappers,
                                 dtype)
        else:
            binned = bin_columns(X, used, reference.mappers, dtype,
                                 native=native)
        return BinnedDataset(binned, list(reference.mappers), used,
                             reference.num_total_features, metadata,
                             feature_names or reference.feature_names,
                             raw=_raw_of(X, used, keep_raw))

    @property
    def num_data(self) -> int:
        return self.bins.shape[0]

    @property
    def num_features(self) -> int:
        return self.bins.shape[1]
