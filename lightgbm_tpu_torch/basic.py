"""User-facing Dataset and Booster (reference python-package/lightgbm/basic.py).

Port of the numpy and scipy-sparse subset of lightgbm_tpu/basic.py:
`Dataset(data,
label, ..., reference=)` with lazy construction (a validation set bins
with its reference's mappers; `Dataset.create_valid`) and
`Booster(params, train_set)` with update (optionally on a custom
objective's gradients) / update_batch / rollback_one_iter / add_valid /
eval_train / eval_valid / reset_parameter / predict (raw, converted, leaf
indices or SHAP contributions) / model_to_string / save_model. A booster trained on from an
init_model keeps the base model's trees in front of its own. Training runs
on the device named by `device_type` ("cuda" by default, "cpu" on
request); prediction runs on the host model (the native predictor), like
the JAX package's Booster.predict. Sparse data (a scipy CSR/CSC matrix)
is binned without densifying its values (BinnedDataset.from_sparse; a
validation set too) and predicted densified in row chunks, as in the JAX
package (basic.py:366-436, 943-960). A pandas DataFrame's category
columns train as categorical features through their codes, and valid
sets and predictions encode them in the training category order
(_data_from_pandas; the model text's pandas_categorical).
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .boosting.gbdt import (GBDT, check_supported, create_boosting,
                             resolve_device)
from .config import Config
from .data import BinnedDataset, Metadata, is_sparse
from .metrics import METRIC_ALIASES, create_metric
from .objectives import create_objective
from .tree import HostModel
from .utils.log import LightGBMError, Log

__all__ = ["Dataset", "Booster", "LightGBMError"]


def _is_pandas_df(data) -> bool:
    return hasattr(data, "dtypes") and hasattr(data, "columns") and \
        hasattr(data, "select_dtypes")


def _data_from_pandas(df, pandas_categorical=None):
    """DataFrame -> (f64 matrix, categorical column indices,
    pandas_categorical): the JAX package's _data_from_pandas
    (lightgbm_tpu/basic.py:70-100, the reference's basic.py:541-624).
    Category-dtype columns become their category codes; training
    remembers each column's category list, and a valid set or a
    prediction encodes through the training lists, so codes follow the
    training order whatever the frame's own categories; unseen categories
    and NaN become NaN."""
    cat_cols = [str(c) for c in df.select_dtypes(
        include=["category"]).columns]
    names = [str(c) for c in df.columns]
    if pandas_categorical is None:
        # native python scalars, so the model text's JSON round-trips
        # int and float categories exactly
        pandas_categorical = [df[c].cat.categories.tolist()
                              for c in cat_cols]
    elif len(cat_cols) != len(pandas_categorical):
        raise ValueError("train and valid dataset categorical_feature do "
                         "not match.")
    df = df.copy(deep=False)
    for col, cats in zip(cat_cols, pandas_categorical):
        codes = df[col].cat.set_categories(cats).cat.codes
        df[col] = np.where(codes.values < 0, np.nan,
                           codes.values.astype(np.float64))
    X = np.ascontiguousarray(df.astype(np.float64).values, dtype=np.float64)
    return X, [names.index(c) for c in cat_cols], pandas_categorical


def _to_2d_float(data) -> np.ndarray:
    if hasattr(data, "values") and not isinstance(data, np.ndarray):
        data = data.values  # pandas
    if is_sparse(data):
        data = data.toarray()
    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    if arr.dtype in (np.float32, np.float64):
        return arr
    return np.ascontiguousarray(arr, dtype=np.float64)


class Dataset:
    """Lazily-constructed binned dataset (reference basic.py:1163)."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        self.free_raw_data = free_raw_data
        self._binned: Optional[BinnedDataset] = None

    def construct(self) -> "Dataset":
        if self._binned is not None:
            return self
        cfg = Config(self.params)
        # sparse stays sparse through binning: only the bins are dense
        sparse_in = is_sparse(self.data)
        pandas_cat = None
        pandas_cat_idx: List[int] = []
        if _is_pandas_df(self.data):
            # category columns as codes; a valid set encodes through the
            # training set's category lists
            ref_pc = None if self.reference is None else getattr(
                self.reference.binned, "pandas_categorical", None)
            X, pandas_cat_idx, pandas_cat = _data_from_pandas(self.data,
                                                              ref_pc)
        else:
            X = self.data if sparse_in else _to_2d_float(self.data)
        names: Optional[List[str]] = None
        if self.feature_name != "auto" and self.feature_name is not None:
            names = list(self.feature_name)
        elif hasattr(self.data, "columns"):
            names = [str(c) for c in self.data.columns]
        cat: List[int] = []
        if self.categorical_feature != "auto" and self.categorical_feature:
            for c in self.categorical_feature:
                if isinstance(c, str):
                    if names and c in names:
                        cat.append(names.index(c))
                else:
                    cat.append(int(c))
        elif cfg.categorical_feature:
            cat = [int(c) for c in str(cfg.categorical_feature).split(",")
                   if c != ""]
        elif pandas_cat_idx:
            cat = list(pandas_cat_idx)   # "auto": the category columns
        md = Metadata(
            X.shape[0],
            label=None if self.label is None else
            np.asarray(self.label, dtype=np.float32).reshape(-1),
            weight=None if self.weight is None else
            np.asarray(self.weight, np.float32),
            init_score=None if self.init_score is None else
            np.asarray(self.init_score),
            group=None if self.group is None else np.asarray(self.group))
        if self.reference is not None:
            # a valid set: the training set's mappers and used features
            self._binned = BinnedDataset.from_reference(
                X, md, self.reference.binned, names,
                keep_raw=cfg.linear_tree)
            self._binned.pandas_categorical = pandas_cat
            if self.free_raw_data:
                self.data = None
            return self
        build = BinnedDataset.from_sparse if sparse_in \
            else BinnedDataset.from_raw
        self._binned = build(
            X, md, max_bin=cfg.max_bin, min_data_in_bin=cfg.min_data_in_bin,
            sample_cnt=cfg.bin_construct_sample_cnt,
            use_missing=cfg.use_missing, zero_as_missing=cfg.zero_as_missing,
            categorical_features=cat, seed=cfg.data_random_seed,
            feature_names=names, feature_pre_filter=cfg.feature_pre_filter,
            keep_raw=cfg.linear_tree)
        self._binned.pandas_categorical = pandas_cat
        if self.free_raw_data:
            self.data = None
        return self

    @property
    def binned(self) -> BinnedDataset:
        self.construct()
        return self._binned

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A validation Dataset binned with this one's mappers (reference
        basic.py Dataset.create_valid)."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params,
                       free_raw_data=self.free_raw_data)

    def get_group(self):
        return self.group

    def set_group(self, group) -> "Dataset":
        """The query sizes (or boundaries) of a ranking dataset; a binned
        dataset takes them at once."""
        self.group = group
        if self._binned is not None and group is not None:
            md = self._binned.metadata
            self._binned.metadata = Metadata(
                self._binned.num_data, label=md.label, weight=md.weight,
                init_score=md.init_score, group=np.asarray(group))
        return self


class Booster:
    """Training/prediction handle (reference basic.py:2594)."""

    train_data_name = "training"

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = dict(params or {})
        self.config = Config(self.params)
        Log.set_verbosity(self.config.verbosity)
        self._model: Optional[HostModel] = None
        self.gbdt: Optional[GBDT] = None
        self.train_set: Optional[Dataset] = None
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self.name_valid_sets: List[str] = []
        self._valid_data: List[Dataset] = []
        # a model continued from (engine.train(init_model=...)): its trees
        # ride in front of this booster's in predict and the model text
        self._base_model: Optional["Booster"] = None
        if model_file is not None:
            with open(model_file) as fh:
                model_str = fh.read()
        if model_str is not None:
            self._model = HostModel.from_string(model_str)
            return
        if train_set is None:
            raise LightGBMError("Booster needs train_set or a model")
        if not isinstance(train_set, Dataset):
            raise TypeError("train_set must be a Dataset")
        # refuse before paying for binning
        check_supported(self.config)
        device = resolve_device(self.config.device_type)
        cfg = self.config
        objective = create_objective(cfg.objective, cfg)
        metric_names = cfg.metric_list()
        if not metric_names and cfg.objective in METRIC_ALIASES:
            metric_names = [cfg.objective]
        self._metric_names = metric_names
        # refuse an unported metric before binning too
        metrics = self._metrics()
        self.train_set = train_set
        merged = dict(train_set.params)
        merged.update(self.params)
        train_set.params = merged
        binned = train_set.binned
        for m in metrics:
            m.init(binned.metadata, binned.num_data)
        # the JAX package hands the booster the same metrics whichever way
        # is_provide_training_metric is set (lightgbm_tpu/basic.py:726-728)
        self.gbdt = create_boosting(cfg, binned, objective, device,
                                    train_metrics=metrics)

    def _metrics(self) -> list:
        return [m for m in (create_metric(nm, self.config)
                            for nm in self._metric_names) if m is not None]

    # ------------------------------------------------------------------
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Evaluate `data` (binned with the training set's mappers) under
        `name` from now on; the trees trained so far are replayed over
        it."""
        data.reference = self.train_set
        if self.config.linear_tree and data._binned is None:
            # valid sets keep their raw values for the leaf models
            data.params = dict(data.params or {}, linear_tree=True)
        data.construct()
        metrics = self._metrics()
        for m in metrics:
            m.init(data.binned.metadata, data.binned.num_data)
        self.gbdt.add_valid(data.binned, name, metrics)
        self.name_valid_sets.append(name)
        self._valid_data.append(data)
        return self

    def update(self, train_set=None, fobj=None) -> bool:
        """One boosting iteration; returns True if no further splits
        (reference LGBM_BoosterUpdateOneIter). fobj(score, train_set) ->
        (grad, hess): train on a custom objective's gradients (the
        booster's constant-hessian gate is dropped for good)."""
        if train_set is not None and train_set is not self.train_set:
            raise NotImplementedError(
                "update(train_set=<another Dataset>) is not ported to "
                "lightgbm_tpu_torch (ROADMAP.md port queue A12)")
        self._model = None
        if fobj is not None:
            gb = self.gbdt
            gb.set_custom_objective()
            score = gb.train_score
            grad, hess = fobj(gb.train_score_host(), self.train_set)

            def dev(a):
                # [N], or [N, k] (the host score's layout) made class-major
                a = np.asarray(a, np.float32)
                if score.dim() == 2:
                    a = np.ascontiguousarray(
                        a.reshape(score.shape[1], score.shape[0]).T)
                return torch.as_tensor(a, device=score.device).reshape(
                    score.shape)
            return gb.train_one_iter(dev(grad), dev(hess))
        return self.gbdt.train_one_iter()

    def update_batch(self, num_iterations: int) -> bool:
        """num_iterations boosting iterations, the trees of as many
        update() calls, grown through the fused trainer (CUDA graphs on
        the card); returns True if training cannot continue (a lagged
        poll, as in the JAX package). With valid sets the block leaves its
        valid-score trajectory (GBDT._fused_valid_traj)."""
        self._model = None
        return self.gbdt.train_many(num_iterations)

    def update_batch_dispatch(self, num_iterations: int) -> dict:
        """update_batch split where the trees are appended: run the block
        and return the handle finalize_block takes; update_batch(n) is
        finalize_block(update_batch_dispatch(n))."""
        self._model = None
        return self.gbdt.train_many_dispatch(num_iterations)

    def finalize_block(self, handle: dict) -> bool:
        self._model = None
        return self.gbdt.finalize_block(handle)

    def rollback_one_iter(self) -> "Booster":
        """Drop the last iteration's tree (and its scores)."""
        self._model = None
        self.gbdt.rollback_one_iter()
        return self

    def current_iteration(self) -> int:
        if self.gbdt is not None:
            n = self.gbdt.current_iteration()
            if self._base_model is not None:
                n += self._base_model.current_iteration()
            return n
        return self._model.num_iterations if self._model else 0

    @property
    def num_trees_per_iteration(self) -> int:
        """Trees an iteration: num_class for the multiclass objectives."""
        if self.gbdt is not None:
            return self.gbdt.num_tree_per_iteration
        return self._model.num_tree_per_iteration if self._model else 1

    def num_trees(self) -> int:
        if self.gbdt is not None:
            n = len(self.gbdt.trees)
            if self._base_model is not None:
                n += self._base_model.num_trees()
            return n
        return len(self._model.trees) if self._model else 0

    # ------------------------------------------------------------------
    def eval_train(self, feval=None) -> List:
        """[(data name, metric name, value, is higher better)] of the
        training set."""
        res = [(self.train_data_name, name, val, _higher_better(name))
               for name, val in self.gbdt.eval_train().items()]
        res.extend(self._custom_eval(feval, self.train_data_name, None))
        return res

    def eval_valid(self, feval=None) -> List:
        """The same for every validation set, in the order added."""
        res = []
        for i, name in enumerate(self.name_valid_sets):
            for mname, val in self.gbdt.eval_valid(i).items():
                res.append((name, mname, val, _higher_better(mname)))
            res.extend(self._custom_eval(feval, name, i))
        return res

    def _custom_eval(self, feval, data_name, valid_idx):
        """feval(score, dataset) -> (name, value, is_higher_better) or a
        list of them, on host scores."""
        if feval is None:
            return []
        funcs = feval if isinstance(feval, (list, tuple)) else [feval]
        if valid_idx is None:
            score = self.gbdt.train_score_host()
            data = self.train_set
        else:
            score = self.gbdt._valid_score_host(valid_idx)
            data = self._valid_data[valid_idx]
        out = []
        for fn in funcs:
            r = fn(score, data)
            for name, val, higher in (r if isinstance(r, list) else [r]):
                out.append((data_name, name, val, higher))
        return out

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Change parameters between iterations (the learning rate of the
        next trees, reset_parameter callbacks); the fused trainer, built
        with the old settings, goes."""
        self.params.update(params)
        self.config.update(params)
        if self.gbdt is not None:
            self.gbdt.shrinkage_rate = float(self.config.learning_rate)
            self.gbdt.config = self.config
            self.gbdt.release_fused()
        return self

    # ------------------------------------------------------------------
    def _host_model(self) -> HostModel:
        if self._model is None:
            model = HostModel.from_gbdt(self.gbdt, self.train_set)
            if self._base_model is not None:
                # continued training: the base model's trees in front
                base = self._base_model._host_model()
                model.trees = list(base.trees) + model.trees
                model.tree_class = list(base.tree_class) + model.tree_class
                if not model.feature_names and base.feature_names:
                    model.feature_names = base.feature_names
                    model.feature_infos = base.feature_infos
                    model.max_feature_idx = base.max_feature_idx
            self._model = model
        return self._model

    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False) -> np.ndarray:
        """Scores, leaf indices (pred_leaf) or SHAP contributions
        (pred_contrib: [n, (F + 1) x k], the expected value last in each
        class's block; a CSR matrix for sparse input, as in the JAX
        package; NotImplementedError on linear trees) of the host model."""
        model = self._host_model()
        kw = dict(start_iteration=start_iteration,
                  num_iteration=num_iteration, raw_score=raw_score,
                  pred_leaf=pred_leaf, pred_contrib=pred_contrib)
        if _is_pandas_df(data) and model.pandas_categorical is not None:
            # category columns coded in the training category order
            data = _data_from_pandas(data, model.pandas_categorical)[0]
        if is_sparse(data):
            # densified in row chunks of about 32 MB, so wide sparse input
            # never needs its whole dense matrix (the JAX package's
            # basic.py:943-960)
            csr = data.tocsr()
            if csr.shape[0] == 0:
                return model.predict(np.zeros((0, csr.shape[1])), **kw)
            chunk = max(1, (32 << 20) // max(1, 8 * csr.shape[1]))
            outs = [model.predict(_to_2d_float(csr[i:i + chunk]), **kw)
                    for i in range(0, csr.shape[0], chunk)]
            if pred_contrib:
                # [n, F + 1] contributions stay sparse for sparse input
                import scipy.sparse as sp
                return sp.vstack([sp.csr_matrix(o) for o in outs])
            return np.concatenate(outs, axis=0)
        return model.predict(_to_2d_float(data), **kw)

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        return self._host_model().to_string(
            num_iteration=num_iteration, start_iteration=start_iteration)

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        with open(filename, "w") as fh:
            fh.write(self.model_to_string(num_iteration, start_iteration))
        return self


def _higher_better(metric_name: str) -> bool:
    return metric_name.split("@")[0] in ("auc", "ndcg", "map",
                                         "average_precision", "auc_mu")


def _best_score_dict(evaluation_result_list) -> Dict[str, Dict[str, float]]:
    best = collections.defaultdict(collections.OrderedDict)
    for data_name, eval_name, score, _ in evaluation_result_list or []:
        best[data_name][eval_name] = score
    return best
