"""Device-resident serving forest: one-time Booster -> device-tensor load.

The port's copy of lightgbm_tpu/serving/forest.py. The training-side
device predictor (learner/predict.py) works in BIN space: rows are
quantized with the training BinMappers and every node decision is an
exact integer compare. At serving time the training mappers may be gone
(model loaded from a text file), so the forest is rebuilt from the model
itself: the only feature values a tree ever compares against are its own
split thresholds, so binning new rows against the sorted set of
per-feature thresholds reproduces every `value <= threshold` decision
exactly (the same trick the reference's CUDA predictor uses to avoid
re-binning, and what makes the serving path self-contained: no Dataset
required).

Per-feature missing handling is folded into the reconstruction:

- missing_type NAN  -> a trailing NaN bin routed by each node's
  default_left (the `missing_is_nan` mechanism of the traversal).
- missing_type ZERO -> NaN maps to 0.0 first, then |v| <= kZeroThreshold
  maps to the trailing default-routed bin: exactly the reference's
  NumericalDecision ZERO branch (tree.h:335-412) expressed in bin space.
- missing_type NONE -> NaN maps to 0.0 and bins normally.

Categorical features bin raw category values through a rank LUT; bin 0
is the unseen/NaN dummy whose bit is never set in any node bitset, so
unseen categories fall right, matching HostTree.predict_rows.

A model whose numeric nodes disagree on missing_type within one feature
(impossible for models trained here, possible for foreign hand-edited
files) or that uses linear leaves is marked unsupported; the serving
engine then answers through the host predict path instead of guessing.

The port's differences: the forest's arrays are torch tensors on an
explicit device (`build_device_forest(model, device)`, `place_on(device)`
is `.to(device)`); categorical bitsets are int64 words holding 32 bits
each (the JAX package's are uint32 words), as everywhere in the port;
and `bin_rows` returns the narrowest of uint8, uint16 and int32 that holds
every feature's bins, the widths csrc/serve_forest.cu reads (the JAX
binner always returns int32: the values are the same).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..learner.grower import TreeArrays
from ..tree import HostModel, HostTree

__all__ = ["DeviceForest", "FeatureBinner", "build_device_forest",
           "bin_dtype_for"]

_CAT_BIT = 1
_DEFAULT_LEFT_BIT = 2
_MISSING_SHIFT = 2
_ZERO_THRESHOLD = 1e-35


def bin_dtype_for(max_num_bin: int):
    """The narrowest numpy dtype holding bins 0..max_num_bin - 1."""
    if max_num_bin <= 256:
        return np.uint8
    if max_num_bin <= 65536:
        return np.uint16
    return np.int32


@dataclasses.dataclass
class FeatureBinner:
    """Host-side quantizer for one original feature, rebuilt from the
    model's own split thresholds (numeric) or category bitsets (cat)."""
    is_categorical: bool = False
    # numeric: sorted unique split thresholds; v <= edges[k] <-> bin <= k
    edges: Optional[np.ndarray] = None
    missing_type: int = 0          # 0 None, 1 Zero, 2 NaN (tree.h masks)
    # categorical: raw category value -> bin (0 = unseen/NaN dummy)
    cat_to_bin: Optional[Dict[int, int]] = None
    num_bin: int = 1

    @property
    def has_default_bin(self) -> bool:
        """Trailing bin routed by default_left (NaN bin / zero bin)."""
        return not self.is_categorical and self.missing_type in (1, 2)

    def bin_values(self, col: np.ndarray) -> np.ndarray:
        """[N] raw float column -> [N] int32 serving bins."""
        if self.is_categorical:
            out = np.zeros(len(col), np.int32)
            ok = np.isfinite(col) & (col >= 0) & (col < 2147483647.0)
            lut = self.cat_to_bin or {}
            ints = col[ok].astype(np.int64)
            out[ok] = np.array([lut.get(int(v), 0) for v in ints],
                               np.int32) if len(ints) else 0
            return out
        if self.edges is None or len(self.edges) == 0:
            return np.zeros(len(col), np.int32)
        isnan = np.isnan(col)
        vals = np.where(isnan, 0.0, col)  # NONE/ZERO: NaN behaves as 0
        out = np.searchsorted(self.edges, vals, side="left").astype(np.int32)
        if self.missing_type == 2:          # NAN: dedicated trailing bin
            out = np.where(isnan, self.num_bin - 1, out)
        elif self.missing_type == 1:        # ZERO: |v|<=eps default-routed
            out = np.where(np.abs(vals) <= _ZERO_THRESHOLD,
                           self.num_bin - 1, out)
        return out.astype(np.int32)


class _StackedArrays:
    """Forest-shaped numpy staging buffers before the device push."""

    def __init__(self, t: int, m1: int, w: int):
        self.split_feature = np.full((t, m1), -1, np.int32)
        self.threshold_bin = np.zeros((t, m1), np.int32)
        self.default_left = np.zeros((t, m1), bool)
        self.is_cat = np.zeros((t, m1), bool)
        self.cat_bitset = np.zeros((t, m1, w), np.int64)
        self.left = np.full((t, m1), -1, np.int32)
        self.right = np.full((t, m1), -1, np.int32)
        self.parent = np.full((t, m1), -1, np.int32)
        self.leaf_value = np.zeros((t, m1), np.float32)
        self.num_nodes = np.zeros(t, np.int32)
        self.num_leaves = np.zeros(t, np.int32)


@dataclasses.dataclass
class DeviceForest:
    """Stacked device tensors + host binners for one loaded model.

    Built once per model load (see `build_device_forest` /
    `Booster.device_forest`), then shared by every request: the serving
    hot path only bins rows and calls `predict_binned_forest` on the
    resident tensors.
    """
    stacked: object                 # TreeArrays with leading [T] axis
    tree_class: object              # [T] int32
    num_bins: object                # [F] int32
    missing_is_nan: object          # [F] bool
    binners: List[FeatureBinner]
    num_outputs: int
    num_features: int
    num_trees: int
    objective: str
    average_output: bool
    num_iterations: int
    supported: bool = True
    unsupported_reason: str = ""
    _model: Optional[HostModel] = None

    @property
    def device(self) -> Optional[torch.device]:
        """Where the tensors live (None for an unsupported forest)."""
        return None if self.tree_class is None else self.tree_class.device

    @property
    def bin_dtype(self):
        """The numpy dtype `bin_rows` returns: the narrowest holding every
        feature's bins."""
        return bin_dtype_for(max((b.num_bin for b in self.binners),
                                 default=1))

    def bin_rows(self, X: np.ndarray) -> np.ndarray:
        """[N, >=F] raw features -> [N, F] serving bins (bin_dtype)."""
        X = np.asarray(X, np.float64)
        n = X.shape[0]
        out = np.zeros((n, self.num_features), self.bin_dtype)
        for f, binner in enumerate(self.binners):
            if f >= X.shape[1]:
                break
            out[:, f] = binner.bin_values(X[:, f])
        return out

    def convert_raw(self, raw: np.ndarray,
                    raw_score: bool = False) -> np.ndarray:
        """Raw device scores -> HostModel.predict output: averaged for
        RF models, objective-converted unless raw_score, [N] when the
        model has a single output column."""
        raw = np.asarray(raw, np.float64)
        if self.average_output:
            raw = raw / max(self.num_iterations, 1)
        if not raw_score and self._model is not None:
            raw = self._model._convert_output(raw)
        return raw[:, 0] if self.num_outputs == 1 else raw

    def place_on(self, device) -> "DeviceForest":
        """The same logical forest with its tensors on `device` (itself
        when they are there already); host-side binners and the fallback
        model are shared (the tensors are never written after the build,
        so replicas share nothing mutable). `ForestPack` implements the
        same method: replica placement is polymorphic over single models
        and packs."""
        device = torch.device(device)
        if not self.supported or _same_device(self.device, device):
            return self
        return dataclasses.replace(
            self,
            stacked=TreeArrays(*[t.to(device) for t in self.stacked]),
            tree_class=self.tree_class.to(device),
            num_bins=self.num_bins.to(device),
            missing_is_nan=self.missing_is_nan.to(device))

    def nbytes_device(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.stacked)


def _same_device(a: Optional[torch.device], b: torch.device) -> bool:
    """a and b name the same device ("cuda" is the current card)."""
    if a is None or a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (a.index if a.index is not None else current) == \
        (b.index if b.index is not None else current)


def _node_missing_type(dt: int) -> int:
    return (dt >> _MISSING_SHIFT) & 3


def _collect_binners(model: HostModel) -> (List[FeatureBinner], str):
    """Rebuild per-feature quantizers from the forest's own decisions."""
    nf = model.max_feature_idx + 1
    thresholds: List[set] = [set() for _ in range(nf)]
    cat_vals: List[set] = [set() for _ in range(nf)]
    mtypes: List[set] = [set() for _ in range(nf)]
    is_cat_f = np.zeros(nf, bool)
    for t in model.trees:
        for i in range(t.num_leaves - 1):
            f = int(t.split_feature[i])
            dt = int(t.decision_type[i])
            if dt & _CAT_BIT:
                is_cat_f[f] = True
                ci = int(t.threshold[i])
                lo = int(t.cat_boundaries[ci])
                hi = int(t.cat_boundaries[ci + 1])
                for w in range(lo, hi):
                    word = int(t.cat_threshold[w])
                    base = (w - lo) * 32
                    while word:
                        b = (word & -word).bit_length() - 1
                        cat_vals[f].add(base + b)
                        word &= word - 1
            else:
                thresholds[f].add(float(t.threshold[i]))
                mtypes[f].add(_node_missing_type(dt))
    binners: List[FeatureBinner] = []
    for f in range(nf):
        if is_cat_f[f] and thresholds[f]:
            return [], (f"feature {f} mixes categorical and numerical "
                        "splits")
        if len(mtypes[f]) > 1:
            return [], (f"feature {f} mixes missing_type values "
                        f"{sorted(mtypes[f])} across nodes")
        if is_cat_f[f]:
            cats = sorted(cat_vals[f])
            binners.append(FeatureBinner(
                is_categorical=True,
                cat_to_bin={c: i + 1 for i, c in enumerate(cats)},
                num_bin=len(cats) + 1))
        else:
            edges = np.asarray(sorted(thresholds[f]), np.float64)
            mt = next(iter(mtypes[f])) if mtypes[f] else 0
            # bins: len(edges)+1 value ranges, +1 default-routed bin for
            # NAN/ZERO missing handling
            nb = len(edges) + 1 + (1 if mt in (1, 2) else 0)
            binners.append(FeatureBinner(edges=edges, missing_type=mt,
                                         num_bin=nb))
    return binners, ""


def _fill_tree(buf: _StackedArrays, ti: int, t: HostTree,
               binners: List[FeatureBinner]) -> None:
    """One HostTree (reference numbering: internal 0..ni-1, leaf ~li)
    into node-id space (internal i -> i, leaf li -> ni + li)."""
    ni = max(t.num_leaves - 1, 0)
    nl = t.num_leaves

    def node_id(c: int) -> int:
        return c if c >= 0 else ni + (~c)

    for i in range(ni):
        f = int(t.split_feature[i])
        dt = int(t.decision_type[i])
        binner = binners[f]
        buf.split_feature[ti, i] = f
        buf.left[ti, i] = node_id(int(t.left_child[i]))
        buf.right[ti, i] = node_id(int(t.right_child[i]))
        if dt & _CAT_BIT:
            buf.is_cat[ti, i] = True
            ci = int(t.threshold[i])
            lo = int(t.cat_boundaries[ci])
            hi = int(t.cat_boundaries[ci + 1])
            lut = binner.cat_to_bin or {}
            for w in range(lo, hi):
                word = int(t.cat_threshold[w])
                base = (w - lo) * 32
                while word:
                    b = (word & -word).bit_length() - 1
                    sb = lut.get(base + b, 0)
                    if sb > 0:
                        buf.cat_bitset[ti, i, sb // 32] |= 1 << (sb % 32)
                    word &= word - 1
        else:
            thr = float(t.threshold[i])
            # exact: thr is a member of the edge set by construction
            buf.threshold_bin[ti, i] = int(
                np.searchsorted(binner.edges, thr, side="left"))
            mt = _node_missing_type(dt)
            if mt in (1, 2):
                buf.default_left[ti, i] = bool(dt & _DEFAULT_LEFT_BIT)
        children = (int(t.left_child[i]), int(t.right_child[i]))
        for c in children:
            buf.parent[ti, node_id(c)] = i
    for li in range(nl):
        buf.leaf_value[ti, ni + li] = np.float32(t.leaf_value[li])
    buf.num_nodes[ti] = ni + nl
    buf.num_leaves[ti] = nl


def build_device_forest(model: HostModel, device="cpu") -> DeviceForest:
    """Flatten + stack a HostModel into resident tensors on `device`.

    Returns an unsupported (host-fallback) DeviceForest instead of
    raising when the model cannot be served from device exactly.
    """
    k = max(model.num_tree_per_iteration, 1)
    nf = model.max_feature_idx + 1
    device = torch.device(device)

    def unsupported(reason: str) -> DeviceForest:
        return DeviceForest(
            stacked=None, tree_class=None, num_bins=None,
            missing_is_nan=None, binners=[], num_outputs=k,
            num_features=nf, num_trees=len(model.trees),
            objective=model.objective,
            average_output=model.average_output,
            num_iterations=model.num_iterations,
            supported=False, unsupported_reason=reason, _model=model)

    if not model.trees:
        return unsupported("model has no trees")
    if any(t.is_linear for t in model.trees):
        return unsupported("linear-leaf models need raw feature values; "
                           "served via the host predict path")
    binners, why = _collect_binners(model)
    if why:
        return unsupported(why)

    m1 = max(max(t.num_leaves - 1, 0) + t.num_leaves
             for t in model.trees) + 1          # + scratch row
    max_cat_bin = max((b.num_bin for b in binners if b.is_categorical),
                      default=1)
    w = max((max_cat_bin - 1) // 32 + 1, 1)
    nt = len(model.trees)
    buf = _StackedArrays(nt, m1, w)
    for ti, t in enumerate(model.trees):
        _fill_tree(buf, ti, t, binners)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    zf = torch.zeros((nt, m1), dtype=torch.float32, device=device)
    stacked = TreeArrays(
        split_feature=dev(buf.split_feature),
        threshold_bin=dev(buf.threshold_bin),
        default_left=dev(buf.default_left),
        is_cat=dev(buf.is_cat),
        cat_bitset=dev(buf.cat_bitset),
        left=dev(buf.left),
        right=dev(buf.right),
        parent=dev(buf.parent),
        leaf_value=dev(buf.leaf_value),
        sum_grad=zf, sum_hess=zf.clone(), count=zf.clone(),
        gain=zf.clone(),
        depth=torch.zeros((nt, m1), dtype=torch.int32, device=device),
        is_leaf=dev(buf.split_feature < 0),
        num_nodes=dev(buf.num_nodes),
        num_leaves=dev(buf.num_leaves))
    tree_class = dev(np.asarray(
        [model.tree_class[i] if i < len(model.tree_class) else i % k
         for i in range(nt)], np.int32))
    num_bins = dev(np.asarray([b.num_bin for b in binners], np.int32))
    # the trailing default-routed bin (NaN bin or ZERO bin) rides the
    # traversal's missing_is_nan mechanism either way
    missing = dev(np.asarray([b.has_default_bin for b in binners], bool))
    return DeviceForest(
        stacked=stacked, tree_class=tree_class, num_bins=num_bins,
        missing_is_nan=missing, binners=binners, num_outputs=k,
        num_features=nf, num_trees=nt,
        objective=model.objective, average_output=model.average_output,
        num_iterations=model.num_iterations, _model=model)
