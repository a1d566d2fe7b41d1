"""Host-side feature quantization: value -> bin mapping.

Behavior-equivalent redesign of the reference BinMapper
(include/LightGBM/bin.h:61-236, src/io/bin.cpp:78-470):

- numerical features: distinct values of a sample are packed greedily into at
  most `max_bin` bins (big-count values get dedicated bins, zero always sits
  alone in its own bin, NaN occupies the last bin when missing_type==NaN);
- categorical features: category codes sorted by frequency, rare categories
  beyond 99% cumulative count dropped, bin 0 reserved for NaN/unseen;
- `value_to_bin` vectorized with searchsorted (replaces the reference's
  per-value binary search bin.h:149).

This runs on the host once per dataset; the result (uint8/uint16 bin
matrix) is what lives in device memory. Copy of lightgbm_tpu/binning.py
for the PyTorch/CUDA port. Where the JAX package dispatches to its native
runtime, the port dispatches to its own copy (lightgbm_tpu_torch/cext:
the greedy bin search, the sample transpose, the whole-matrix numeric
bound search and, above 10,000 rows, the whole-matrix quantization); the
numpy paths stay as the plain versions, reached with native=False. The
two give the same mappers (compare with repr: bounds can be NaN) and the
same bin matrix byte for byte, so the port's bin mappers equal the JAX
package's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import cext
from .utils.timer import global_timer

__all__ = ["BinMapper", "MissingType", "find_bin_mappers",
           "find_bin_mappers_sparse"]

_ZERO_THRESHOLD = 1e-35


class MissingType:
    NONE = 0
    ZERO = 1
    NAN = 2


def _check_double_equal(a: float, b: float) -> bool:
    upper = b + 1e-9 * max(abs(a), abs(b))
    return a <= upper and a >= b - 1e-9 * max(abs(a), abs(b))


def _greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                     max_bin: int, total_cnt: int,
                     min_data_in_bin: int, native: bool = True
                     ) -> List[float]:
    """Pack distinct values into <= max_bin bins; returns bin upper bounds
    (last bound is +inf). Mirrors src/io/bin.cpp:78 GreedyFindBin; the
    native runtime's copy unless native=False."""
    if native and len(distinct_values):
        return cext.greedy_find_bin(distinct_values, counts, max_bin,
                                    total_cnt, min_data_in_bin).tolist()
    n = len(distinct_values)
    bounds: List[float] = []
    if n == 0:
        return [math.inf]
    if n <= max_bin:
        cur = 0
        for i in range(n - 1):
            cur += int(counts[i])
            if cur >= min_data_in_bin:
                val = (distinct_values[i] + distinct_values[i + 1]) / 2.0
                if not bounds or not _check_double_equal(bounds[-1], val):
                    bounds.append(val)
                    cur = 0
        bounds.append(math.inf)
        return bounds
    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total_cnt // min_data_in_bin))
    mean_bin_size = total_cnt / max_bin
    is_big = counts >= mean_bin_size
    rest_bin_cnt = max_bin - int(is_big.sum())
    rest_sample_cnt = total_cnt - int(counts[is_big].sum())
    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)

    uppers: List[float] = []
    lowers: List[float] = [float(distinct_values[0])]
    cur = 0
    for i in range(n - 1):
        if not is_big[i]:
            rest_sample_cnt -= int(counts[i])
        cur += int(counts[i])
        if is_big[i] or cur >= mean_bin_size or \
                (is_big[i + 1] and cur >= max(1.0, mean_bin_size * 0.5)):
            uppers.append(float(distinct_values[i]))
            lowers.append(float(distinct_values[i + 1]))
            if len(uppers) >= max_bin - 1:
                break
            cur = 0
            if not is_big[i]:
                rest_bin_cnt -= 1
                mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
    for i in range(len(uppers)):
        val = (uppers[i] + lowers[i + 1]) / 2.0
        if not bounds or not _check_double_equal(bounds[-1], val):
            bounds.append(val)
    bounds.append(math.inf)
    return bounds


def _find_bin_zero_as_one(distinct_values: np.ndarray, counts: np.ndarray,
                          max_bin: int, total_sample_cnt: int,
                          min_data_in_bin: int,
                          native: bool = True) -> List[float]:
    """Zero gets a dedicated bin; negatives binned left of it, positives right.
    Mirrors src/io/bin.cpp:256 FindBinWithZeroAsOneBin."""
    n = len(distinct_values)
    if n == 0:
        return [math.inf]
    neg_mask = distinct_values <= -_ZERO_THRESHOLD
    pos_mask = distinct_values > _ZERO_THRESHOLD
    left_cnt_data = int(counts[neg_mask].sum())
    right_cnt_data = int(counts[pos_mask].sum())
    cnt_zero = total_sample_cnt - left_cnt_data - right_cnt_data

    left_idx = np.nonzero(~neg_mask)[0]
    left_cnt = int(left_idx[0]) if len(left_idx) else n
    right_idx = np.nonzero(pos_mask)[0]
    right_start = int(right_idx[0]) if len(right_idx) else -1

    bounds: List[float] = []
    if left_cnt > 0:
        left_max_bin = max(
            1, int(left_cnt_data / max(total_sample_cnt, 1) / 2 * (max_bin - 1)))
        bounds = _greedy_find_bin(distinct_values[:left_cnt], counts[:left_cnt],
                                  left_max_bin, left_cnt_data, min_data_in_bin,
                                  native)
        bounds[-1] = -_ZERO_THRESHOLD
    if right_start >= 0:
        right_max_bin = max_bin - 1 - len(bounds)
        if right_max_bin > 0:
            right = _greedy_find_bin(
                distinct_values[right_start:], counts[right_start:],
                right_max_bin, right_cnt_data, min_data_in_bin, native)
            bounds.append(_ZERO_THRESHOLD)
            bounds.extend(right)
        else:
            bounds.append(math.inf)
    else:
        bounds.append(math.inf)
    if cnt_zero <= 0 and len(bounds) >= 2:
        # no actual zeros: boundaries stay, harmless (matches upstream which
        # still inserts the zero bin only when zeros exist in the sample path)
        pass
    return bounds


class BinMapper:
    """Per-feature value -> bin quantizer (reference bin.h:61)."""

    def __init__(self) -> None:
        self.num_bin: int = 1
        self.missing_type: int = MissingType.NONE
        self.is_categorical: bool = False
        self.is_trivial: bool = True
        self.bin_upper_bound: np.ndarray = np.array([np.inf])
        self.bin_2_categorical: List[int] = []
        self.categorical_2_bin: Dict[int, int] = {}
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0  # bin of value 0.0 (reference bin.h:131)
        self.sparse_rate: float = 0.0

    # ---- construction -------------------------------------------------
    @staticmethod
    def from_sample(values: np.ndarray, total_sample_cnt: int, max_bin: int,
                    min_data_in_bin: int = 3, use_missing: bool = True,
                    zero_as_missing: bool = False,
                    is_categorical: bool = False,
                    forced_bounds: Optional[Sequence[float]] = None,
                    native: bool = True) -> "BinMapper":
        """Build from a (possibly subsampled) value vector. Values absent
        from `values` relative to total_sample_cnt are implicit zeros
        (reference FindBin bin.cpp:325-360 treats them so). native=False
        keeps the greedy bin search in numpy."""
        m = BinMapper()
        values = np.asarray(values, dtype=np.float64)
        nan_mask = np.isnan(values)
        na_cnt = int(nan_mask.sum())
        values = values[~nan_mask]

        if not use_missing:
            m.missing_type = MissingType.NONE
        elif zero_as_missing:
            m.missing_type = MissingType.ZERO
        else:
            m.missing_type = MissingType.NAN if na_cnt > 0 else MissingType.NONE

        zero_cnt = int(total_sample_cnt - len(values) - na_cnt)
        if is_categorical:
            m._build_categorical(values, na_cnt, total_sample_cnt, max_bin)
            return m

        # distinct values with zero spliced in at its sorted position
        if len(values):
            values = np.sort(values)
            # merge nearly-equal neighbours, keeping the larger value
            keep = np.ones(len(values), dtype=bool)
            diffs = np.diff(values)
            tol = 1e-9 * np.maximum(np.abs(values[:-1]), np.abs(values[1:]))
            keep[:-1] = diffs > tol
            distinct = values[keep]
            counts = np.diff(np.concatenate(
                [[0], np.nonzero(keep)[0] + 1])).astype(np.int64)
        else:
            distinct = np.array([], dtype=np.float64)
            counts = np.array([], dtype=np.int64)
        if zero_cnt > 0 or len(distinct) == 0:
            pos = int(np.searchsorted(distinct, 0.0))
            if pos >= len(distinct) or abs(distinct[pos]) > _ZERO_THRESHOLD:
                distinct = np.insert(distinct, pos, 0.0)
                counts = np.insert(counts, pos, max(zero_cnt, 0))
        m.min_val = float(distinct[0]) if len(distinct) else 0.0
        m.max_val = float(distinct[-1]) if len(distinct) else 0.0

        if m.missing_type == MissingType.NAN:
            bounds = _find_bin_zero_as_one(
                distinct, counts, max_bin - 1, total_sample_cnt - na_cnt,
                min_data_in_bin, native)
            bounds.append(math.nan)  # last bin = NaN bin (bin.cpp:401-404)
        else:
            bounds = _find_bin_zero_as_one(
                distinct, counts, max_bin, total_sample_cnt, min_data_in_bin,
                native)
            if m.missing_type == MissingType.ZERO and len(bounds) == 2:
                m.missing_type = MissingType.NONE
        m.bin_upper_bound = np.asarray(bounds, dtype=np.float64)
        m.num_bin = len(bounds)
        # trivial when all data lands in one bin (constant feature) —
        # reference prunes via is_trivial + feature_pre_filter. Bins are
        # monotone over the sorted distinct values, so "one occupied bin"
        # reduces to first and last landing together.
        if len(distinct):
            ends = m.values_to_bins_numeric_only(distinct[[0, -1]])
            occupied = 1 if ends[0] == ends[1] else 2
        else:
            occupied = 0
        if na_cnt > 0:
            occupied += 1
        m.is_trivial = m.num_bin <= 1 or occupied <= 1
        m.default_bin = m._value_to_bin_scalar(0.0)
        if total_sample_cnt > 0:
            m.sparse_rate = zero_cnt / total_sample_cnt
        return m

    @staticmethod
    def _from_native(bounds: np.ndarray, mtype: int, minmax, zero_na,
                     total_sample_cnt: int) -> "BinMapper":
        """Assemble a numeric mapper from cext.find_numeric_bounds output:
        the scalar tail of from_sample."""
        m = BinMapper()
        m.missing_type = int(mtype)
        m.bin_upper_bound = np.asarray(bounds, np.float64)
        m.num_bin = len(bounds)
        m.min_val = float(minmax[0])
        m.max_val = float(minmax[1])
        zero_cnt, na_cnt = int(zero_na[0]), int(zero_na[1])
        ends = m.values_to_bins_numeric_only(
            np.asarray([m.min_val, m.max_val]))
        occupied = (1 if ends[0] == ends[1] else 2) + (1 if na_cnt else 0)
        m.is_trivial = m.num_bin <= 1 or occupied <= 1
        m.default_bin = m._value_to_bin_scalar(0.0)
        if total_sample_cnt > 0:
            m.sparse_rate = zero_cnt / total_sample_cnt
        return m

    def _build_categorical(self, values: np.ndarray, na_cnt: int,
                           total_sample_cnt: int, max_bin: int) -> None:
        self.is_categorical = True
        ints = values.astype(np.int64)
        neg = ints < 0
        na_cnt += int(neg.sum())
        ints = ints[~neg]
        cats, counts = np.unique(ints, return_counts=True)
        order = np.argsort(-counts, kind="stable")
        cats, counts = cats[order], counts[order]
        # implicit zeros
        zero_cnt = total_sample_cnt - len(values) - (na_cnt - int(neg.sum()))
        if zero_cnt > 0:
            if 0 in cats:
                idx = int(np.nonzero(cats == 0)[0][0])
                counts[idx] += zero_cnt
                order = np.argsort(-counts, kind="stable")
                cats, counts = cats[order], counts[order]
            else:
                cats = np.append(cats, 0)
                counts = np.append(counts, zero_cnt)
                order = np.argsort(-counts, kind="stable")
                cats, counts = cats[order], counts[order]
        cut_cnt = int(round((total_sample_cnt - na_cnt) * 0.99))
        # bin 0 is the NaN/unseen dummy (bin.cpp:452-456)
        self.bin_2_categorical = [-1]
        self.categorical_2_bin = {-1: 0}
        self.num_bin = 1
        used = 0
        i = 0
        while i < len(cats) and self.num_bin < max_bin:
            if used >= cut_cnt and self.num_bin >= 2:
                break
            self.bin_2_categorical.append(int(cats[i]))
            self.categorical_2_bin[int(cats[i])] = self.num_bin
            used += int(counts[i])
            self.num_bin += 1
            i += 1
        self.is_trivial = self.num_bin <= 2 and na_cnt == 0
        self.missing_type = MissingType.NAN
        self.default_bin = self.categorical_2_bin.get(0, 0)
        self.min_val = float(cats.min()) if len(cats) else 0.0
        self.max_val = float(cats.max()) if len(cats) else 0.0

    # ---- mapping ------------------------------------------------------
    def _value_to_bin_scalar(self, value: float) -> int:
        return int(self.values_to_bins(np.array([value]))[0])

    def values_to_bins_numeric_only(self, values: np.ndarray) -> np.ndarray:
        """Bin finite values during construction (no NaN branch needed)."""
        n_numeric = self.num_bin
        if self.missing_type == MissingType.NAN:
            n_numeric -= 1
        search_bounds = self.bin_upper_bound[:max(n_numeric - 1, 0)]
        return np.searchsorted(search_bounds, values, side="left")

    def values_to_bins(self, values: np.ndarray) -> np.ndarray:
        """Vectorized value->bin (reference bin.h:149 ValueToBin)."""
        vals = np.asarray(values, dtype=np.float64)
        if self.is_categorical:
            return self._cat_bins_from_f64(vals)
        out = self._numeric_bins_from_f64(vals, own=vals is not values)
        return out.astype(np.int32, copy=False)

    def _cat_bins_from_f64(self, vals: np.ndarray) -> np.ndarray:
        """Categorical value->bin over a float64 vector: sorted-key LUT
        (searchsorted + equality mask) instead of a per-value dict loop;
        unseen/negative/non-finite all land in dummy bin 0."""
        ints = np.where(~np.isfinite(vals), -1, vals).astype(np.int64)
        items = sorted(self.categorical_2_bin.items())
        keys = np.asarray([k for k, _ in items], dtype=np.int64)
        bins = np.asarray([b for _, b in items], dtype=np.int32)
        if not len(keys):
            return np.zeros(len(ints), dtype=np.int32)
        pos = np.minimum(np.searchsorted(keys, ints), len(keys) - 1)
        return np.where(keys[pos] == ints, bins[pos], 0).astype(np.int32)

    def _numeric_bins_from_f64(self, vals: np.ndarray,
                               own: bool = False) -> np.ndarray:
        """Numeric value->bin over a float64 vector. `own=True` marks
        `vals` as a scratch buffer this call may mutate in place (the
        ZERO-missing rewrite then skips its defensive copy). NaN fixups
        run only when NaNs are actually present, so the common all-finite
        column pays searchsorted + one mask scan and nothing else."""
        n_numeric = self.num_bin
        has_nan_bin = self.missing_type == MissingType.NAN
        if has_nan_bin:
            n_numeric -= 1
        search_bounds = self.bin_upper_bound[:max(n_numeric - 1, 0)]
        nan_mask = np.isnan(vals)
        has_nan = bool(nan_mask.any())
        if has_nan and self.missing_type == MissingType.ZERO:
            if not own:
                vals = vals.copy()
            vals[nan_mask] = 0.0
        # searchsorted(left) gives first bound >= v, matching "v <= bound"
        out = np.searchsorted(search_bounds, vals, side="left")
        if has_nan:
            # ZERO already rewrote NaN->0.0, whose searchsorted result IS
            # default_bin, so overwriting again is a no-op kept for parity
            out[nan_mask] = self.num_bin - 1 if has_nan_bin \
                else self.default_bin
        return out

    def bin_to_threshold_value(self, bin_idx: int) -> float:
        """Real-valued split threshold for `value <= threshold` given the
        chosen bin (used for model serialization; reference stores the bin
        upper bound as the tree threshold, tree.cpp RecomputeMaxDepth path)."""
        if self.is_categorical:
            return float(bin_idx)
        b = min(bin_idx, len(self.bin_upper_bound) - 1)
        v = float(self.bin_upper_bound[b])
        if math.isinf(v) or math.isnan(v):
            v = float(self.max_val)
        return v

    # ---- serialization ------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "num_bin": self.num_bin,
            "missing_type": self.missing_type,
            "is_categorical": self.is_categorical,
            "is_trivial": self.is_trivial,
            "bin_upper_bound": self.bin_upper_bound.tolist(),
            "bin_2_categorical": self.bin_2_categorical,
            "min_val": self.min_val,
            "max_val": self.max_val,
            "default_bin": self.default_bin,
            "sparse_rate": self.sparse_rate,
        }

    @staticmethod
    def from_dict(d: dict) -> "BinMapper":
        m = BinMapper()
        m.num_bin = d["num_bin"]
        m.missing_type = d["missing_type"]
        m.is_categorical = d["is_categorical"]
        m.is_trivial = d["is_trivial"]
        m.bin_upper_bound = np.asarray(d["bin_upper_bound"], dtype=np.float64)
        m.bin_2_categorical = list(d["bin_2_categorical"])
        m.categorical_2_bin = {c: i for i, c in enumerate(m.bin_2_categorical)}
        m.min_val = d["min_val"]
        m.max_val = d["max_val"]
        m.default_bin = d["default_bin"]
        m.sparse_rate = d.get("sparse_rate", 0.0)
        return m


def find_bin_mappers(X: np.ndarray, max_bin: int = 255,
                     min_data_in_bin: int = 3,
                     sample_cnt: int = 200000,
                     use_missing: bool = True,
                     zero_as_missing: bool = False,
                     categorical_features: Optional[Sequence[int]] = None,
                     seed: int = 1,
                     feature_names: Optional[Sequence[str]] = None,
                     native: bool = True) -> List[BinMapper]:
    """Find per-feature BinMappers from (a sample of) X.

    Reference: DatasetLoader::ConstructBinMappersFromTextData two-round
    sampling (dataset_loader.cpp:~690). The sample's transpose and every
    numeric feature's bounds come from the native runtime (the JAX
    package's dispatch, lightgbm_tpu/binning.py:411-490); categorical
    features, and every feature with native=False, go through numpy
    (BinMapper.from_sample), which gives the same mappers. The sampling
    and the native bound search add into utils.timer.global_timer's
    dataset_sample and dataset_bounds, as in the JAX package.
    """
    num_data, num_features = X.shape
    cat_set = set(categorical_features or [])
    if native:
        # the first native call builds the library with g++: keep that
        # one-time cost out of the dataset_sample bucket
        cext.build_all()
    with global_timer.timeit("dataset_sample"):
        sample_t = None
        if num_data > sample_cnt:
            rng = np.random.RandomState(seed)
            idx = np.sort(rng.choice(num_data, size=sample_cnt,
                                     replace=False))
            total = sample_cnt
            if (native and isinstance(X, np.ndarray)
                    and X.dtype in (np.float32, np.float64)
                    and X.flags["C_CONTIGUOUS"]):
                # gather + transpose + f64 cast in one native pass, bit
                # for bit the numpy chain below
                sample_t = cext.sample_transpose(X, idx)
            else:
                sample = X[idx]
        else:
            sample = X
            total = num_data
        if sample_t is None:
            # transpose once: per-feature slices become contiguous
            # (transpose + dtype conversion fused into one allocation)
            sample_t = np.ascontiguousarray(np.asarray(sample).T,
                                            dtype=np.float64)

    def from_sample(f):
        col = sample_t[f]
        nonzero = col[(np.abs(col) > _ZERO_THRESHOLD) | np.isnan(col)]
        return BinMapper.from_sample(
            nonzero, total, max_bin, min_data_in_bin, use_missing,
            zero_as_missing, is_categorical=f in cat_set, native=native)

    numeric = [f for f in range(num_features) if f not in cat_set]
    if not (native and numeric):
        return [from_sample(f) for f in range(num_features)]
    # the whole-matrix numeric bound search (the reference's OpenMP FindBin
    # loop), behavior-exact with from_sample
    sub = sample_t[numeric] if len(numeric) < num_features else sample_t
    with global_timer.timeit("dataset_bounds"):
        blist, mtype, minmax, zero_na = cext.find_numeric_bounds(
            sub, max_bin, min_data_in_bin, use_missing, zero_as_missing)
    mappers: List[Optional[BinMapper]] = [None] * num_features
    for j, f in enumerate(numeric):
        mappers[f] = BinMapper._from_native(blist[j], mtype[j], minmax[j],
                                            zero_na[j], total)
    for f in range(num_features):
        if mappers[f] is None:
            mappers[f] = from_sample(f)
    return mappers


def find_bin_mappers_sparse(X_csc, max_bin: int = 255,
                            min_data_in_bin: int = 3,
                            sample_cnt: int = 200000,
                            use_missing: bool = True,
                            zero_as_missing: bool = False,
                            categorical_features: Optional[Sequence[int]]
                            = None, seed: int = 1) -> List[BinMapper]:
    """find_bin_mappers over a scipy CSC matrix (sorted indices, no
    duplicates) without densifying it (the JAX package's
    find_bin_mappers_sparse, lightgbm_tpu/binning.py:554): each column
    gives the stored values of the sampled rows (the dense path's sample,
    the same RandomState draw); the absent entries are the implicit zeros
    BinMapper.from_sample models through total_sample_cnt (reference
    FindBin, bin.cpp:325-360). The same mappers as the dense matrix's."""
    num_data, num_features = X_csc.shape
    cat_set = set(categorical_features or [])
    if num_data > sample_cnt:
        rng = np.random.RandomState(seed)
        idx = np.sort(rng.choice(num_data, size=sample_cnt, replace=False))
        total = sample_cnt
    else:
        idx = None
        total = num_data
    indptr, indices, vals = X_csc.indptr, X_csc.indices, X_csc.data
    mappers = []
    for f in range(num_features):
        lo, hi = int(indptr[f]), int(indptr[f + 1])
        rows_f = indices[lo:hi]
        v = np.asarray(vals[lo:hi], dtype=np.float64)
        if idx is not None:
            pos = np.minimum(np.searchsorted(idx, rows_f), len(idx) - 1)
            v = v[idx[pos] == rows_f]
        nonzero = v[(np.abs(v) > _ZERO_THRESHOLD) | np.isnan(v)]
        mappers.append(BinMapper.from_sample(
            nonzero, total, max_bin, min_data_in_bin, use_missing,
            zero_as_missing, is_categorical=f in cat_set))
    return mappers


def bin_columns(X: np.ndarray, feat_indices: Sequence[int],
                mappers: Sequence["BinMapper"], dtype,
                native: bool = True) -> np.ndarray:
    """Quantize X[:, feat_indices[j]] with mappers[j] into a [N, len(used)]
    bin matrix. Above 10,000 rows the numeric features go through the
    native whole-matrix quantization (the JAX package's dispatch,
    lightgbm_tpu/binning.py:494-552); categorical features, smaller inputs
    and native=False take the vectorized numpy path, which gives the same
    bytes."""
    num_data = X.shape[0]
    numeric = [j for j, m in enumerate(mappers) if not m.is_categorical]
    rest = list(range(len(mappers)))
    out = None
    if native and numeric and num_data > 10000:
        bounds, offs, nsearch, nanb = [], [0], [], []
        for j in numeric:
            m = mappers[j]
            n_numeric = m.num_bin - (m.missing_type == MissingType.NAN)
            sb = m.bin_upper_bound[:max(n_numeric - 1, 0)]
            bounds.append(sb)
            offs.append(offs[-1] + len(sb))
            nsearch.append(len(sb))
            nanb.append(m.num_bin - 1 if m.missing_type == MissingType.NAN
                        else m.default_bin)
        sub = cext.bin_matrix(
            X, np.asarray([feat_indices[j] for j in numeric], np.int32),
            np.concatenate(bounds), np.asarray(offs[:-1], np.int64),
            np.asarray(nsearch, np.int32), np.asarray(nanb, np.int32),
            dtype)
        if len(numeric) == len(mappers):
            return sub
        out = np.empty((num_data, len(feat_indices)), dtype=dtype)
        out[:, numeric] = sub
        rest = [j for j, m in enumerate(mappers) if m.is_categorical]
    if out is None:
        out = np.empty((num_data, len(feat_indices)), dtype=dtype)
    # one reusable contiguous float64 scratch per column that the mapper
    # may mutate in place (own=True skips the ZERO-missing copy),
    # searchsorted, then a single strided store
    scratch = np.empty(num_data, dtype=np.float64)
    for j in rest:
        m = mappers[j]
        np.copyto(scratch, X[:, feat_indices[j]], casting="unsafe")
        out[:, j] = m._cat_bins_from_f64(scratch) if m.is_categorical \
            else m._numeric_bins_from_f64(scratch, own=True)
    return out
