"""Host-side model representation + LightGBM-compatible text serialization.

Mirrors the reference model text format exactly (GBDT::SaveModelToString
src/boosting/gbdt_model_text.cpp:311, Tree::ToString src/io/tree.cpp:339,
load path gbdt_model_text.cpp:421) so models serialized here can be
cross-checked/loaded by the reference's predictor and vice versa:

  header: version=v3, num_class, num_tree_per_iteration, label_index,
          max_feature_idx, objective, feature_names, feature_infos,
          tree_sizes
  per tree: num_leaves/num_cat/split_feature/split_gain/threshold/
          decision_type/left_child/right_child/leaf_value/leaf_weight/
          leaf_count/internal_value/internal_weight/internal_count/
          [cat_boundaries/cat_threshold]/is_linear/shrinkage

Node numbering follows the reference Tree: internal nodes 0..num_leaves-2,
leaves addressed as `~leaf_index` (negative) in child arrays (tree.h:25).
decision_type packs {categorical:1, default_left:2, missing_type<<2}
(tree.h decision-type masks; missing: None=0, Zero=1, NaN=2).

Copy of lightgbm_tpu/tree.py for the PyTorch/CUDA port without refit,
JSON dump and prediction early stop. Prediction runs the native runtime's
forest predictor (cext/predict.cpp, OpenMP over rows), as the JAX
package's does; the numpy tree walk stays as its plain version
(native=False) and gives the same bits: both add each row's leaf values in
tree order in float64, and a linear leaf's value as const + coeff x x
feature after feature (the JAX package's numpy walk takes a matrix
product, which may round otherwise). Linear leaves (linear_tree) are
written and read as the reference's is_linear sections; SHAP
contributions (predict(pred_contrib=True), shap.py) refuse linear trees,
as the reference does. A model text written by either package loads in
the other.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from . import cext

__all__ = ["HostTree", "HostModel"]

_CAT_BIT = 1
_DEFAULT_LEFT_BIT = 2
_MISSING_SHIFT = 2
_ZERO_THRESHOLD = 1e-35


def _fmt(x: float) -> str:
    """Double formatting akin to Common::ArrayToString<true> (%.17g-ish)."""
    return np.format_float_positional(
        np.float64(x), precision=17, unique=True, trim="0") \
        if np.isfinite(x) else ("1e+300" if x > 0 else "-1e+300")


def _join(arr, fmt=str) -> str:
    return " ".join(fmt(v) for v in arr)


@dataclasses.dataclass
class HostTree:
    """One tree in reference numbering (internal idx / ~leaf idx)."""
    num_leaves: int
    split_feature: np.ndarray      # [ni] original feature idx
    split_gain: np.ndarray         # [ni]
    threshold: np.ndarray          # [ni] double (or cat_boundaries index)
    decision_type: np.ndarray      # [ni] uint8
    left_child: np.ndarray         # [ni]
    right_child: np.ndarray        # [ni]
    leaf_value: np.ndarray         # [nl]
    leaf_weight: np.ndarray        # [nl]
    leaf_count: np.ndarray         # [nl]
    internal_value: np.ndarray     # [ni]
    internal_weight: np.ndarray    # [ni]
    internal_count: np.ndarray     # [ni]
    cat_boundaries: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(1, np.int32))
    cat_threshold: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.uint32))
    shrinkage: float = 1.0
    is_linear: bool = False
    # linear leaves (reference tree.h leaf_const_/leaf_coeff_/leaf_features_)
    leaf_const: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float64))   # [nl]
    leaf_coeff: List[np.ndarray] = dataclasses.field(default_factory=list)
    leaf_features: List[np.ndarray] = dataclasses.field(default_factory=list)

    @property
    def num_cat(self) -> int:
        return len(self.cat_boundaries) - 1

    # ---- prediction (reference tree.h:335-412 decisions) -------------
    def predict_rows(self, X: np.ndarray) -> np.ndarray:
        leaf = self.leaf_index_rows(X)
        if not self.is_linear:
            return self.leaf_value[leaf]
        # linear leaves: const + coeff . x, feature after feature in
        # float64 (cext/predict.cpp's order); NaN in a model feature falls
        # back to the constant leaf_value (tree.cpp:133-150)
        out = np.empty(len(leaf), np.float64)
        order = np.argsort(leaf, kind="stable")
        bounds = np.searchsorted(leaf[order], np.arange(self.num_leaves + 1))
        for li in range(self.num_leaves):
            rows = order[bounds[li]:bounds[li + 1]]
            if rows.size == 0:
                continue
            feats = self.leaf_features[li] if li < len(self.leaf_features) \
                else np.zeros(0, np.int32)
            v = np.full(rows.size, float(self.leaf_const[li])
                        if li < len(self.leaf_const)
                        else float(self.leaf_value[li]))
            nanr = np.zeros(rows.size, bool)
            for fi, c in zip(feats, self.leaf_coeff[li]):
                xv = X[rows, int(fi)].astype(np.float64)
                nanr |= np.isnan(xv)
                v = v + float(c) * xv
            v[nanr] = self.leaf_value[li]
            out[rows] = v
        return out

    def leaf_index_rows(self, X: np.ndarray) -> np.ndarray:
        n = X.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n, np.int32)
        node = np.zeros(n, np.int32)  # internal idx; leaves become ~leaf
        active = node >= 0
        while active.any():
            idx = node[active]
            feat = self.split_feature[idx]
            vals = X[active, feat]
            thr = self.threshold[idx]
            dt = self.decision_type[idx]
            is_cat = (dt & _CAT_BIT) != 0
            default_left = (dt & _DEFAULT_LEFT_BIT) != 0
            missing_t = (dt >> _MISSING_SHIFT) & 3
            isnan = np.isnan(vals)
            # None-missing: NaN -> 0 (tree.h NumericalDecision)
            vals = np.where(isnan & (missing_t != 2), 0.0, vals)
            is_zero = np.abs(vals) <= _ZERO_THRESHOLD
            use_default = ((missing_t == 1) & is_zero & ~is_cat) | \
                          ((missing_t == 2) & isnan & ~is_cat)
            go_left = np.where(use_default, default_left, vals <= thr)
            if is_cat.any():
                ci = np.where(is_cat)[0]
                cat_left = np.zeros(len(ci), bool)
                for k, j in enumerate(ci):
                    v = vals[j]
                    if not np.isfinite(v) or v < 0:
                        cat_left[k] = False
                        continue
                    iv = int(v)
                    c = int(thr[j])  # cat_boundaries index
                    lo, hi = self.cat_boundaries[c], self.cat_boundaries[c + 1]
                    word = iv // 32
                    if word < hi - lo:
                        cat_left[k] = bool(
                            (int(self.cat_threshold[lo + word]) >>
                             (iv % 32)) & 1)
                go_left[ci] = cat_left
            nxt = np.where(go_left, self.left_child[idx],
                           self.right_child[idx])
            node[active] = nxt
            active = node >= 0
        return ~node  # leaf index

    # ---- text io ------------------------------------------------------
    def to_string(self) -> str:
        lines = [f"num_leaves={self.num_leaves}",
                 f"num_cat={self.num_cat}"]
        if self.num_leaves > 1:
            lines += [
                "split_feature=" + _join(self.split_feature),
                "split_gain=" + _join(self.split_gain, _fmt),
                "threshold=" + _join(self.threshold, _fmt),
                "decision_type=" + _join(self.decision_type),
                "left_child=" + _join(self.left_child),
                "right_child=" + _join(self.right_child),
                "leaf_value=" + _join(self.leaf_value, _fmt),
                "leaf_weight=" + _join(self.leaf_weight, _fmt),
                "leaf_count=" + _join(self.leaf_count),
                "internal_value=" + _join(self.internal_value, _fmt),
                "internal_weight=" + _join(self.internal_weight, _fmt),
                "internal_count=" + _join(self.internal_count),
            ]
        else:
            lines += ["leaf_value=" + _join(self.leaf_value, _fmt)]
        if self.num_cat > 0:
            lines += ["cat_boundaries=" + _join(self.cat_boundaries),
                      "cat_threshold=" + _join(self.cat_threshold)]
        lines += [f"is_linear={int(self.is_linear)}"]
        if self.is_linear:
            # reference Tree::ToString linear section (tree.cpp:377-399):
            # flattened per-leaf feature lists and coefficients
            nf = [len(self.leaf_features[li])
                  if li < len(self.leaf_features) else 0
                  for li in range(self.num_leaves)]
            lines += [
                "leaf_const=" + _join(self.leaf_const, _fmt),
                "num_features=" + _join(nf),
                "leaf_features=" + _join(
                    [f for fl in self.leaf_features for f in fl]),
                "leaf_coeff=" + _join(
                    [c for cl in self.leaf_coeff for c in cl], _fmt),
            ]
        lines += [f"shrinkage={_fmt(self.shrinkage)}"]
        return "\n".join(lines) + "\n\n"

    @staticmethod
    def from_block(kv: Dict[str, str]) -> "HostTree":
        nl = int(kv["num_leaves"])

        def arr(key, dtype, default_len=0):
            if key not in kv or kv[key] == "":
                return np.zeros(default_len, dtype)
            return np.asarray(kv[key].split(" "), dtype=dtype)

        if nl > 1:
            t = HostTree(
                num_leaves=nl,
                split_feature=arr("split_feature", np.int32),
                split_gain=arr("split_gain", np.float64),
                threshold=arr("threshold", np.float64),
                decision_type=arr("decision_type", np.int32).astype(np.uint8),
                left_child=arr("left_child", np.int32),
                right_child=arr("right_child", np.int32),
                leaf_value=arr("leaf_value", np.float64),
                leaf_weight=arr("leaf_weight", np.float64, nl),
                leaf_count=arr("leaf_count", np.int64, nl),
                internal_value=arr("internal_value", np.float64, nl - 1),
                internal_weight=arr("internal_weight", np.float64, nl - 1),
                internal_count=arr("internal_count", np.int64, nl - 1),
                shrinkage=float(kv.get("shrinkage", 1)),
                is_linear=bool(int(kv.get("is_linear", 0))))
        else:
            t = HostTree(
                num_leaves=nl,
                split_feature=np.zeros(0, np.int32),
                split_gain=np.zeros(0, np.float64),
                threshold=np.zeros(0, np.float64),
                decision_type=np.zeros(0, np.uint8),
                left_child=np.zeros(0, np.int32),
                right_child=np.zeros(0, np.int32),
                leaf_value=arr("leaf_value", np.float64),
                leaf_weight=np.zeros(nl, np.float64),
                leaf_count=np.zeros(nl, np.int64),
                internal_value=np.zeros(0, np.float64),
                internal_weight=np.zeros(0, np.float64),
                internal_count=np.zeros(0, np.int64),
                shrinkage=float(kv.get("shrinkage", 1)),
                is_linear=bool(int(kv.get("is_linear", 0))))
        if "cat_boundaries" in kv:
            t.cat_boundaries = np.asarray(
                kv["cat_boundaries"].split(" "), np.int64)
            t.cat_threshold = np.asarray(
                kv["cat_threshold"].split(" "), np.uint64).astype(np.uint32)
        if t.is_linear and "leaf_const" in kv:
            t.leaf_const = arr("leaf_const", np.float64, nl)
            nf = arr("num_features", np.int64, nl)
            flat_f = arr("leaf_features", np.int64)
            flat_c = arr("leaf_coeff", np.float64)
            offs = np.concatenate([[0], np.cumsum(nf)]).astype(np.int64)
            t.leaf_features = [flat_f[offs[i]:offs[i + 1]].astype(np.int32)
                               for i in range(nl)]
            t.leaf_coeff = [flat_c[offs[i]:offs[i + 1]] for i in range(nl)]
        return t


class HostModel:
    """Full model: header + trees (reference GBDT model text)."""

    def __init__(self):
        self.trees: List[HostTree] = []
        self.tree_class: List[int] = []
        self.num_class = 1
        self.num_tree_per_iteration = 1
        self.label_index = 0
        self.max_feature_idx = 0
        self.objective = "regression"
        self.average_output = False
        self.feature_names: List[str] = []
        self.feature_infos: List[str] = []
        self.params: Dict[str, str] = {}
        # training-time pandas category lists per categorical column
        # (reference basic.py pandas_categorical round-trip)
        self.pandas_categorical = None

    @property
    def num_iterations(self) -> int:
        return len(self.trees) // max(self.num_tree_per_iteration, 1)

    def _flatten_native(self) -> dict:
        """The forest as the concatenated arrays the native predictor
        reads (the JAX package's HostModel._flatten_native): a linear
        tree's leaves add their constants and, from lfeat_off, their
        features and coefficients; cached until the tree list changes."""
        cached = getattr(self, "_native_flat", None)
        if cached is not None and cached["num_trees"] == len(self.trees):
            return cached
        trees = self.trees
        k = max(self.num_tree_per_iteration, 1)

        def offsets(sizes):
            return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)

        def cat(key, dtype):
            parts = [np.asarray(getattr(t, key), dtype) for t in trees]
            return np.ascontiguousarray(np.concatenate(parts)) if parts \
                else np.zeros(0, dtype)

        leaf_off = offsets([t.num_leaves for t in trees])
        lconst = np.zeros(int(leaf_off[-1]), np.float64)
        nfeat = np.zeros(int(leaf_off[-1]), np.int64)
        lfeats: List[np.ndarray] = []
        lcoefs: List[np.ndarray] = []
        for i, t in enumerate(trees):
            if not t.is_linear:
                continue
            for li in range(min(t.num_leaves, len(t.leaf_const))):
                gi = int(leaf_off[i]) + li
                lconst[gi] = t.leaf_const[li]
                feats = t.leaf_features[li] if li < len(t.leaf_features) \
                    else []
                nfeat[gi] = len(feats)
                lfeats.append(np.asarray(feats, np.int32))
                lcoefs.append(np.asarray(t.leaf_coeff[li], np.float64)
                              if li < len(t.leaf_coeff) else
                              np.zeros(0, np.float64))

        def joined(parts, dtype):
            return np.ascontiguousarray(np.concatenate(parts), dtype) \
                if parts else np.zeros(0, dtype)

        flat = {
            "num_trees": len(trees),
            "tree_class": np.ascontiguousarray(
                [self.tree_class[i] if i < len(self.tree_class) else i % k
                 for i in range(len(trees))], np.int32),
            "node_off": offsets([max(t.num_leaves - 1, 0) for t in trees]),
            "leaf_off": offsets([t.num_leaves for t in trees]),
            "catb_off": offsets([len(t.cat_boundaries) for t in trees]),
            "catt_off": offsets([len(t.cat_threshold) for t in trees]),
            "split_feature": cat("split_feature", np.int32),
            "threshold": cat("threshold", np.float64),
            "decision_type": cat("decision_type", np.uint8),
            "left": cat("left_child", np.int32),
            "right": cat("right_child", np.int32),
            "leaf_value": cat("leaf_value", np.float64),
            "cat_boundaries": cat("cat_boundaries", np.int64),
            "cat_threshold": cat("cat_threshold", np.uint32),
            "is_linear": np.ascontiguousarray(
                [int(t.is_linear) for t in trees], np.uint8),
            "leaf_const": lconst,
            "lfeat_off": offsets(nfeat),
            "leaf_features": joined(lfeats, np.int32),
            "leaf_coeff": joined(lcoefs, np.float64),
        }
        self._native_flat = flat
        return flat

    # ------------------------------------------------------------------
    @staticmethod
    def from_gbdt(gbdt, train_dataset) -> "HostModel":
        """Convert the booster's TreeArrays into reference numbering; a
        random forest's model averages its trees (average_output)."""
        from .boosting.rf import RF
        model = HostModel()
        cfg = gbdt.config
        model.num_class = max(int(cfg.num_class), 1)
        model.num_tree_per_iteration = gbdt.num_tree_per_iteration
        model.objective = _objective_string(gbdt, cfg)
        model.average_output = isinstance(gbdt, RF)
        ds = train_dataset.binned if train_dataset is not None else None
        if ds is not None:
            model.max_feature_idx = ds.num_total_features - 1
            model.feature_names = list(ds.feature_names)
            model.feature_infos = _feature_infos(ds)
            model.pandas_categorical = getattr(ds, "pandas_categorical",
                                               None)
            used_to_orig = np.asarray(ds.used_features, np.int64)
            mappers = ds.mappers
        else:
            model.max_feature_idx = 0
            used_to_orig = None
            mappers = None
        model.params = {k: str(v) for k, v in cfg.raw_params.items()}
        lins = gbdt.linear_models
        for ti, (tarr, cls) in enumerate(zip(gbdt.trees, gbdt.tree_class)):
            model.trees.append(host_tree_from_arrays(
                tarr, used_to_orig, mappers, float(cfg.learning_rate),
                lin=lins[ti] if ti < len(lins) else None))
            model.tree_class.append(cls)
        return model

    # ------------------------------------------------------------------
    def predict(self, X: np.ndarray, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False,
                native: bool = True) -> np.ndarray:
        """Scores ([n] or [n, k]; raw or converted), with pred_leaf each
        row's leaf index in each tree ([n, trees] int32), or with
        pred_contrib the SHAP contributions ([n, (F + 1) x k],
        predict_contrib), through the native predictor or (native=False)
        the numpy tree walk."""
        k = max(self.num_tree_per_iteration, 1)
        total_iters = self.num_iterations
        if num_iteration is None or num_iteration <= 0:
            num_iteration = total_iters - start_iteration
        end_iteration = min(start_iteration + num_iteration, total_iters)
        rng = range(start_iteration * k, end_iteration * k)
        if pred_leaf:
            if native:
                return cext.forest_predict_leaf(
                    self._flatten_native(), X, rng.start, rng.stop)
            out = np.zeros((X.shape[0], len(rng)), np.int32)
            for j, ti in enumerate(rng):
                out[:, j] = self.trees[ti].leaf_index_rows(X)
            return out
        if pred_contrib:
            if any(t.is_linear for t in self.trees):
                # reference parity: predictor.hpp:90 Log::Fatal
                raise NotImplementedError(
                    "Predicting SHAP feature contributions is not "
                    "implemented for linear trees.")
            return self.predict_contrib(X, start_iteration, end_iteration)
        if native:
            out = cext.forest_predict(self._flatten_native(), X, k,
                                      rng.start, rng.stop)
        else:
            out = np.zeros((X.shape[0], k), np.float64)
            for ti in rng:
                cls = self.tree_class[ti] if ti < len(self.tree_class) \
                    else ti % k
                out[:, cls] += self.trees[ti].predict_rows(X)
        if self.average_output:
            out /= max(end_iteration - start_iteration, 1)
        if not raw_score:
            out = self._convert_output(out)
        return out[:, 0] if k == 1 else out

    def predict_contrib(self, X: np.ndarray, start_iteration: int,
                        end_iteration: int) -> np.ndarray:
        """SHAP values of the iterations [start_iteration, end_iteration)
        by TreeSHAP (shap.py; reference Tree::PredictContrib): [n, (F + 1)
        x k], each class's expected value last in its block."""
        from .shap import tree_shap_model
        return tree_shap_model(self, X, start_iteration, end_iteration)

    def _convert_output(self, raw: np.ndarray) -> np.ndarray:
        obj = self.objective.split(" ")[0]
        if obj == "binary":
            sigmoid = _objective_param(self.objective, "sigmoid", 1.0)
            return 1.0 / (1.0 + np.exp(-sigmoid * raw))
        if obj in ("multiclass", "softmax"):
            e = np.exp(raw - raw.max(axis=1, keepdims=True))
            return e / e.sum(axis=1, keepdims=True)
        if obj in ("multiclassova", "multiclass_ova"):
            sigmoid = _objective_param(self.objective, "sigmoid", 1.0)
            return 1.0 / (1.0 + np.exp(-sigmoid * raw))
        if obj in ("poisson", "gamma", "tweedie"):
            return np.exp(raw)
        if obj in ("cross_entropy", "xentropy"):
            return 1.0 / (1.0 + np.exp(-raw))
        if obj in ("cross_entropy_lambda", "xentlambda"):
            return np.log1p(np.exp(raw))
        return raw

    # ------------------------------------------------------------------
    def feature_importance(self, importance_type: str = "split"
                           ) -> np.ndarray:
        nf = self.max_feature_idx + 1
        imp = np.zeros(nf, np.float64)
        for t in self.trees:
            for i in range(t.num_leaves - 1):
                f = int(t.split_feature[i])
                if importance_type == "split":
                    imp[f] += 1.0
                else:
                    imp[f] += max(float(t.split_gain[i]), 0.0)
        return imp

    # ------------------------------------------------------------------
    def to_string(self, num_iteration: Optional[int] = None,
                  start_iteration: int = 0) -> str:
        k = max(self.num_tree_per_iteration, 1)
        total = self.num_iterations
        start_iteration = max(0, min(start_iteration, total))
        num_used = len(self.trees)
        if num_iteration is not None and num_iteration > 0:
            num_used = min((start_iteration + num_iteration) * k, num_used)
        start_model = start_iteration * k
        lines = ["tree", "version=v3",
                 f"num_class={self.num_class}",
                 f"num_tree_per_iteration={self.num_tree_per_iteration}",
                 f"label_index={self.label_index}",
                 f"max_feature_idx={self.max_feature_idx}",
                 f"objective={self.objective}"]
        if self.average_output:
            lines.append("average_output")
        lines.append("feature_names=" + " ".join(self.feature_names))
        lines.append("feature_infos=" + " ".join(self.feature_infos))
        tree_strs = []
        for i in range(start_model, num_used):
            s = f"Tree={i - start_model}\n" + self.trees[i].to_string()
            tree_strs.append(s)
        lines.append("tree_sizes=" + " ".join(
            str(len(s) + 1) for s in tree_strs))
        lines.append("")
        body = "\n".join(lines) + "\n"
        body += "\n".join(tree_strs)
        if tree_strs:
            body += "\n"
        body += "end of trees\n"
        imp = self.feature_importance("split")
        pairs = sorted(
            [(int(imp[i]), self.feature_names[i])
             for i in range(len(self.feature_names)) if imp[i] > 0],
            key=lambda p: -p[0])
        body += "\nfeature_importances:\n"
        for cnt, name in pairs:
            body += f"{name}={cnt}\n"
        if self.params:
            body += "\nparameters:\n"
            for kk, v in self.params.items():
                body += f"[{kk}: {v}]\n"
            body += "end of parameters\n"
        # pandas category lists (reference python basic.py:591-624): the
        # reference's _load_pandas_categorical reads only the file tail, so
        # this must be the LAST line of the model string.
        import json as _json
        body += "\npandas_categorical:%s\n" % _json.dumps(
            self.pandas_categorical, default=str)
        return body

    @staticmethod
    def from_string(s: str) -> "HostModel":
        model = HostModel()
        lines = s.split("\n")
        i = 0
        # header
        while i < len(lines):
            line = lines[i].strip()
            i += 1
            if line.startswith("Tree="):
                i -= 1
                break
            if line == "tree" or line == "":
                continue
            if line == "average_output":
                model.average_output = True
                continue
            if "=" in line:
                key, val = line.split("=", 1)
                if key == "num_class":
                    model.num_class = int(val)
                elif key == "num_tree_per_iteration":
                    model.num_tree_per_iteration = int(val)
                elif key == "label_index":
                    model.label_index = int(val)
                elif key == "max_feature_idx":
                    model.max_feature_idx = int(val)
                elif key == "objective":
                    model.objective = val
                elif key == "feature_names":
                    model.feature_names = val.split(" ") if val else []
                elif key == "feature_infos":
                    model.feature_infos = val.split(" ") if val else []
        # trees
        while i < len(lines):
            line = lines[i].strip()
            if line.startswith("end of trees"):
                break
            if not line.startswith("Tree="):
                i += 1
                continue
            i += 1
            kv: Dict[str, str] = {}
            while i < len(lines):
                tline = lines[i].strip()
                if tline == "" :
                    i += 1
                    if i < len(lines) and not lines[i].strip().startswith(
                            tuple(["Tree=", "end of trees"])):
                        continue
                    break
                if "=" in tline:
                    kk, vv = tline.split("=", 1)
                    kv[kk] = vv
                i += 1
            model.trees.append(HostTree.from_block(kv))
        k = max(model.num_tree_per_iteration, 1)
        model.tree_class = [ti % k for ti in range(len(model.trees))]
        if "pandas_categorical:" in s:
            import json as _json
            pline = s.split("pandas_categorical:", 1)[1].split("\n", 1)[0]
            try:
                model.pandas_categorical = _json.loads(pline)
            except ValueError:
                model.pandas_categorical = None
        # parameters tail (optional)
        if "parameters:" in s:
            tail = s.split("parameters:", 1)[1]
            for pline in tail.split("\n"):
                pline = pline.strip()
                if pline.startswith("[") and ": " in pline:
                    kk, vv = pline[1:-1].split(": ", 1)
                    model.params[kk] = vv
        return model

# ---------------------------------------------------------------------------

def _objective_param(objective_str: str, key: str, default: float) -> float:
    """Parse `key:value` tokens from a serialized objective string."""
    for tok in objective_str.split(" ")[1:]:
        if tok.startswith(key + ":"):
            return float(tok.split(":", 1)[1])
    return default


def _objective_string(gbdt, cfg) -> str:
    obj = gbdt.objective
    if obj is None:
        return cfg.objective or "custom"
    name = obj.name
    if name == "binary":
        return f"binary sigmoid:{obj.sigmoid:g}"
    if name in ("multiclass", "multiclassova"):
        extra = f" num_class:{cfg.num_class}"
        if name == "multiclassova":
            extra += f" sigmoid:{obj.sigmoid:g}"
        return name + extra
    if name == "lambdarank":
        return "lambdarank"
    return name


def _feature_infos(ds) -> List[str]:
    infos = ["none"] * ds.num_total_features
    for j, f in enumerate(ds.used_features):
        m = ds.mappers[j]
        if m.is_categorical:
            cats = sorted(c for c in m.bin_2_categorical if c >= 0)
            infos[int(f)] = ":".join(str(c) for c in cats) if cats else "none"
        else:
            infos[int(f)] = f"[{m.min_val:g}:{m.max_val:g}]"
    return infos


def _host(x) -> np.ndarray:
    """numpy view of a tensor on any device, or of an array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") \
        else np.asarray(x)


def host_tree_from_arrays(tarr, used_to_orig: Optional[np.ndarray],
                          mappers, shrinkage: float, lin=None) -> HostTree:
    """Convert TreeArrays (node-id space; tensors on any device, or numpy
    arrays) to reference numbering. cat_bitset words hold 32 bits each.
    lin: the tree's LinearLeaves (learner/linear.py), written as linear
    leaves in original feature indices, coefficients of magnitude <= 1e-35
    dropped as the reference drops them (linear_tree_learner.cpp:356-362)."""
    nn = int(tarr.num_nodes)
    split_feature = _host(tarr.split_feature)[:nn]
    is_leaf = split_feature < 0
    node_ids = np.arange(nn)
    internal_ids = node_ids[~is_leaf]
    leaf_ids = node_ids[is_leaf]
    internal_rank = np.full(nn, -1)
    internal_rank[internal_ids] = np.arange(len(internal_ids))
    leaf_rank = np.full(nn, -1)
    leaf_rank[leaf_ids] = np.arange(len(leaf_ids))

    left = _host(tarr.left)[:nn]
    right = _host(tarr.right)[:nn]
    thr_bin = _host(tarr.threshold_bin)[:nn]
    default_left = _host(tarr.default_left)[:nn]
    is_cat = _host(tarr.is_cat)[:nn]
    cat_bitsets = _host(tarr.cat_bitset)[:nn]
    value = _host(tarr.leaf_value)[:nn]
    sum_hess = _host(tarr.sum_hess)[:nn]
    count = _host(tarr.count)[:nn]
    gain = _host(tarr.gain)[:nn]

    nl = len(leaf_ids)
    ni = len(internal_ids)
    if nl == 0:
        nl = 1

    def child_ref(cid):
        if cid < 0:
            return 0
        return internal_rank[cid] if internal_rank[cid] >= 0 \
            else ~int(leaf_rank[cid])

    cat_boundaries = [0]
    cat_threshold: List[int] = []
    t_split_feature = np.zeros(ni, np.int32)
    t_threshold = np.zeros(ni, np.float64)
    t_decision = np.zeros(ni, np.uint8)
    t_left = np.zeros(ni, np.int32)
    t_right = np.zeros(ni, np.int32)
    for r, nid in enumerate(internal_ids):
        fu = int(split_feature[nid])
        forig = int(used_to_orig[fu]) if used_to_orig is not None else fu
        t_split_feature[r] = forig
        t_left[r] = child_ref(int(left[nid]))
        t_right[r] = child_ref(int(right[nid]))
        m = mappers[fu] if mappers is not None else None
        if is_cat[nid]:
            # decode the node's bin bitset -> category-value bitset
            # (reference SplitInfo::cat_threshold -> Tree cat storage,
            # tree.h:25 cat_boundaries_/cat_threshold_)
            words_bins = cat_bitsets[nid]
            catvals = []
            for b in range(len(words_bins) * 32):
                if (int(words_bins[b // 32]) >> (b % 32)) & 1:
                    catval = m.bin_2_categorical[b] if m is not None and \
                        b < len(m.bin_2_categorical) else b
                    catvals.append(max(int(catval), 0))
            if not catvals:
                catvals = [0]
            nwords = max(catvals) // 32 + 1
            words = [0] * nwords
            for catval in catvals:
                words[catval // 32] |= (1 << (catval % 32))
            t_threshold[r] = len(cat_boundaries) - 1
            cat_boundaries.append(cat_boundaries[-1] + nwords)
            cat_threshold.extend(words)
            missing_t = 2
            t_decision[r] = _CAT_BIT | (missing_t << _MISSING_SHIFT)
        else:
            if m is not None:
                t_threshold[r] = m.bin_to_threshold_value(int(thr_bin[nid]))
                missing_t = int(m.missing_type)
            else:
                t_threshold[r] = float(thr_bin[nid])
                missing_t = 0
            t_decision[r] = (_DEFAULT_LEFT_BIT if default_left[nid] else 0) \
                | (missing_t << _MISSING_SHIFT)

    tree = HostTree(
        num_leaves=nl,
        split_feature=t_split_feature,
        split_gain=gain[internal_ids].astype(np.float64),
        threshold=t_threshold,
        decision_type=t_decision,
        left_child=t_left,
        right_child=t_right,
        leaf_value=value[leaf_ids].astype(np.float64) if len(leaf_ids)
        else np.asarray([float(value[0])]),
        leaf_weight=sum_hess[leaf_ids].astype(np.float64) if len(leaf_ids)
        else np.zeros(1),
        leaf_count=count[leaf_ids].astype(np.int64) if len(leaf_ids)
        else np.zeros(1, np.int64),
        internal_value=value[internal_ids].astype(np.float64),
        internal_weight=sum_hess[internal_ids].astype(np.float64),
        internal_count=count[internal_ids].astype(np.int64),
        cat_boundaries=np.asarray(cat_boundaries, np.int64),
        cat_threshold=np.asarray(cat_threshold, np.uint32),
        shrinkage=shrinkage)
    if lin is not None:
        const = _host(lin.const)[:nn]
        coeff = _host(lin.coeff)[:nn]
        lfeat = _host(lin.feat)[:nn]
        tree.is_linear = True
        tree.leaf_const = const[leaf_ids].astype(np.float64) \
            if len(leaf_ids) else np.asarray([float(value[0])])
        tree.leaf_features, tree.leaf_coeff = [], []
        for nid in (leaf_ids if len(leaf_ids) else [0]):
            keep = (lfeat[nid] >= 0) & (np.abs(coeff[nid]) > _ZERO_THRESHOLD)
            fu = lfeat[nid][keep].astype(np.int64)
            tree.leaf_features.append(
                (used_to_orig[fu] if used_to_orig is not None else fu)
                .astype(np.int32))
            tree.leaf_coeff.append(coeff[nid][keep].astype(np.float64))
    return tree
