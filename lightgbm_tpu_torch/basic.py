"""User-facing Dataset and Booster (reference python-package/lightgbm/basic.py).

Port of the numpy, scipy-sparse and file subset of lightgbm_tpu/basic.py:
`Dataset(data, label, ..., reference=)` with lazy construction (a
validation set bins with its reference's mappers; `Dataset.create_valid`;
`data` a path: a binary dataset cache, or a CSV/TSV text file with the
label in column 0), the field accessors (get_/set_ label, weight, group,
init_score, get_field/set_field), num_data/num_feature, subset (whole
queries of grouped data, ROADMAP C23), set_categorical_feature and
save_binary; and `Booster(params, train_set)` with update (optionally on
a custom objective's gradients; another train_set is ignored with a
warning, as the JAX package ignores it: C24) / update_batch /
rollback_one_iter / add_valid / eval_train / eval_valid / reset_parameter
/ predict (raw, converted, leaf indices or SHAP contributions, with the
prediction early stop; validate_features is accepted and ignored, as in
the JAX package) / refit / model_to_string / save_model / dump_model /
feature_name / feature_importance / lower_bound / upper_bound /
free_dataset / copies, and the training state of a checkpoint bundle
(_training_state / _restore_training_state). Model files and caches go
through utils/file_io.open_file. A booster trained on from an init_model, or
resumed from a bundle, keeps the base model's trees in front of its own.
Training runs on the device named by `device_type` ("cuda" by default,
"cpu" on request); prediction runs on the host model (the native predictor), like
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
from .observability import configure_from_config
from .objectives import create_objective
from .tree import HostModel
from .utils.file_io import open_file
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


def _load_svmlight_or_csv(path: str) -> np.ndarray:
    """A CSV/TSV text file as a float64 matrix (tab-separated when its
    first line holds a tab; the JAX package's basic.py:127-134)."""
    with open_file(path) as fh:
        first = fh.readline()
    delim = "\t" if "\t" in first else ","
    with open_file(path) as fh:
        return np.loadtxt(fh, delimiter=delim)


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
        data = self.data
        if isinstance(data, str):
            if BinnedDataset.is_binary_file(data):
                return self._construct_binary(data)
            raw = _load_svmlight_or_csv(data)
            if self.label is None:
                self.label, raw = raw[:, 0], raw[:, 1:]
            data = raw
        # sparse stays sparse through binning: only the bins are dense
        sparse_in = is_sparse(data)
        pandas_cat = None
        pandas_cat_idx: List[int] = []
        if _is_pandas_df(data):
            # category columns as codes; a valid set encodes through the
            # training set's category lists
            ref_pc = None if self.reference is None else getattr(
                self.reference.binned, "pandas_categorical", None)
            X, pandas_cat_idx, pandas_cat = _data_from_pandas(data, ref_pc)
        else:
            X = data if sparse_in else _to_2d_float(data)
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

    def _construct_binary(self, path: str) -> "Dataset":
        """The binary fast path (reference LoadFromBinFile,
        dataset_loader.cpp:274; the JAX package's basic.py:305-342): no
        parsing and no bin finding. A valid set's cache must hold its
        reference's mappers; metadata given to the constructor overrides
        the cached."""
        self._binned = BinnedDataset.load_binary(path)
        if self.reference is not None:
            # reference Dataset::CheckAlign via LGBM_BoosterAddValidData:
            # "different bin mappers with training data"
            ref = self.reference.binned
            same = (
                ref.num_total_features == self._binned.num_total_features
                and np.array_equal(ref.used_features,
                                   self._binned.used_features)
                and all(_same_mapper(a, b) for a, b in
                        zip(ref.mappers, self._binned.mappers)))
            if not same:
                raise ValueError(
                    "Cannot use binary dataset file as validation data: it "
                    "has different bin mappers than the training data. "
                    "Re-save it with reference=<train dataset>.")
        md = self._binned.metadata
        self._binned.metadata = Metadata(
            self._binned.num_data,
            label=self.label if self.label is not None else md.label,
            weight=self.weight if self.weight is not None else md.weight,
            init_score=self.init_score if self.init_score is not None
            else md.init_score,
            group=np.asarray(self.group) if self.group is not None
            else md.query_boundaries)
        if self.free_raw_data:
            self.data = None
        return self

    @property
    def binned(self) -> BinnedDataset:
        self.construct()
        return self._binned

    # ------------------------------------------------------------------
    def num_data(self) -> int:
        return self.binned.num_data

    def num_feature(self) -> int:
        return self.binned.num_total_features

    def get_label(self):
        if self.label is not None:
            return np.asarray(self.label)
        if self._binned is not None:
            return self._binned.metadata.label
        return None

    def get_weight(self):
        return self.weight

    def get_init_score(self):
        return self.init_score

    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._binned is not None:
            self._binned.metadata.label = np.asarray(
                label, np.float32).reshape(-1)
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._binned is not None and weight is not None:
            self._binned.metadata.weight = np.asarray(weight, np.float32)
        return self

    def set_init_score(self, init_score) -> "Dataset":
        """A user init score; it replaces a continuation's seed, so
        init_model's double-count guard sees it as the user's again."""
        self.init_score = init_score
        self._seeded_init_score = False
        if self._binned is not None:
            self._binned.metadata.init_score = None if init_score is None \
                else np.asarray(init_score, np.float32)
        return self

    def set_field(self, name, data) -> "Dataset":
        return {"label": self.set_label, "weight": self.set_weight,
                "group": self.set_group,
                "init_score": self.set_init_score}[name](data)

    def get_field(self, name):
        return {"label": self.get_label, "weight": self.get_weight,
                "group": self.get_group,
                "init_score": self.get_init_score}[name]()

    def subset(self, used_indices, params=None) -> "Dataset":
        """The rows `used_indices` as a constructed Dataset sharing this
        one's mappers (BinnedDataset.subset: whole queries of grouped
        data, else LightGBMError)."""
        sub = Dataset(None, params=params or self.params)
        sub._binned = self.binned.subset(np.asarray(used_indices))
        sub.reference = self
        return sub

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        """Change the categorical features (reference basic.py
        set_categorical_feature): a constructed dataset drops its bins and
        rebuilds them at next use, which needs the raw data
        (free_raw_data=False)."""
        if self.categorical_feature == categorical_feature:
            return self
        if self._binned is not None:
            if self.data is None:
                raise LightGBMError(
                    "Cannot set categorical feature after freed raw data, "
                    "set free_raw_data=False when construct Dataset to "
                    "avoid this.")
            Log.warning("categorical_feature in Dataset is overridden.\n"
                        "New categorical_feature is %s",
                        sorted(list(categorical_feature))
                        if not isinstance(categorical_feature, str)
                        else categorical_feature)
            self._binned = None
        self.categorical_feature = categorical_feature
        return self

    def save_binary(self, filename: str) -> "Dataset":
        """Write the constructed dataset to a binary cache
        (BinnedDataset.save_binary). A continuation's seeded init scores
        are training state of one run and are not saved."""
        binned = self.binned
        if getattr(self, "_seeded_init_score", False):
            saved = binned.metadata.init_score
            binned.metadata.init_score = None
            try:
                binned.save_binary(filename)
            finally:
                binned.metadata.init_score = saved
        else:
            binned.save_binary(filename)
        return self

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
            with open_file(model_file) as fh:
                model_str = fh.read()
        if model_str is not None:
            self._model = HostModel.from_string(model_str)
            return
        if train_set is None:
            raise LightGBMError("Booster needs train_set or a model")
        if not isinstance(train_set, Dataset):
            raise TypeError("train_set must be a Dataset")
        # the observability registry, the flight recorder and the span
        # profiler take a training booster's observe*, flightrec* and
        # profile_* settings (a booster loaded from a model, such as a
        # resumed run's base model, leaves them as they are)
        configure_from_config(self.config)
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
        booster's constant-hessian gate is dropped for good). Another
        train_set is ignored with a warning and the booster trains on its
        own, as the JAX package ignores it (ROADMAP C24: the reference
        resets the training data, LGBM_BoosterResetTrainingData)."""
        if train_set is not None and train_set is not self.train_set:
            Log.warning("update(train_set=...) ignores the Dataset it is "
                        "given: the booster trains on its own train_set")
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

    # ------------------------------------------------------------------
    # training-state serialization (reliability/checkpoint.py bundles)
    def _training_state(self):
        """(json state, arrays) of everything model_to_string does not
        carry (GBDT.training_state) plus best_iteration: with the saved
        model text, enough for _restore_training_state to continue the
        run bit for bit."""
        state, arrays = self.gbdt.training_state()
        state["best_iteration"] = int(self.best_iteration)
        return state, arrays

    def _restore_training_state(self, ckpt) -> None:
        """Restore from a reliability.checkpoint.CheckpointState; the
        caller (engine.train's resume) has attached the bundle's model as
        _base_model."""
        self._model = None
        self.gbdt.restore_training_state(ckpt.iteration, ckpt.state,
                                         ckpt.arrays)
        best = int(ckpt.state.get("best_iteration", -1))
        if best >= 0:
            self.best_iteration = best

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

    def num_model_per_iteration(self) -> int:
        return self.num_trees_per_iteration

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

    def device_forest(self, device=None):
        """Memoized device-stacked serving forest (serving/forest.py) on
        `device`: by default the training device, or for a booster loaded
        from a model the device its device_type names (the card unless
        "cpu"; without a card that raises).

        Repeated serving calls reuse the resident tensors instead of
        re-stacking the trees per call. Invalidation is by HostModel
        identity: every mutation point (update / update_batch /
        rollback_one_iter / a restored checkpoint) clears `self._model`,
        so the next call here sees a fresh HostModel object and rebuilds
        (refit and a model reload give a new Booster)."""
        model = self._host_model()
        if device is None:
            device = self.gbdt.device if self.gbdt is not None \
                else resolve_device(self.config.device_type)
        cached = getattr(self, "_device_forest", None)
        if cached is not None and cached._model is model:
            placed = cached.place_on(device)
            if placed is cached:
                return cached
            self._device_forest = placed
            return placed
        from .serving.forest import build_device_forest
        self._device_forest = build_device_forest(model, device)
        return self._device_forest

    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False,
                validate_features: bool = False,
                pred_early_stop: bool = False,
                pred_early_stop_freq: int = 10,
                pred_early_stop_margin: float = 10.0,
                **kwargs) -> np.ndarray:
        """Scores, leaf indices (pred_leaf) or SHAP contributions
        (pred_contrib: [n, (F + 1) x k], the expected value last in each
        class's block; a CSR matrix for sparse input, as in the JAX
        package; NotImplementedError on linear trees) of the host model,
        with the margin early stop of HostModel.predict
        (pred_early_stop*). validate_features and other keywords are
        accepted and ignored, as in the JAX package (ROADMAP C6)."""
        model = self._host_model()
        kw = dict(start_iteration=start_iteration,
                  num_iteration=num_iteration, raw_score=raw_score,
                  pred_leaf=pred_leaf, pred_contrib=pred_contrib,
                  pred_early_stop=pred_early_stop,
                  pred_early_stop_freq=pred_early_stop_freq,
                  pred_early_stop_margin=pred_early_stop_margin)
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

    def refit(self, data, label, decay_rate: Optional[float] = None,
              **kwargs) -> "Booster":
        """A new Booster whose leaf values are refitted on (data, label)
        (reference gbdt.cpp:287 RefitTree; HostModel.refit): decay x old +
        (1 - decay) x new, decay refit_decay_rate unless given. The
        gradients run on the training device, or, for a booster loaded
        from a model, on the device its device_type names."""
        model = self._host_model()
        decay = self.config.refit_decay_rate if decay_rate is None \
            else decay_rate
        cfg = self.config
        if model.num_class > 1 and int(cfg.num_class) != model.num_class:
            # the model's class count, for a booster loaded from a model
            cfg = Config(dict(self.params, num_class=model.num_class))
        device = self.gbdt.device if self.gbdt is not None \
            else resolve_device(cfg.device_type)
        new_model = model.refit(_to_2d_float(data),
                                np.asarray(label, np.float32), decay, cfg,
                                device)
        return Booster(params=self.params, model_str=new_model.to_string())

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0,
                        importance_type: str = "split") -> str:
        return self._host_model().to_string(
            num_iteration=num_iteration, start_iteration=start_iteration)

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> "Booster":
        with open_file(filename, "w") as fh:
            fh.write(self.model_to_string(num_iteration, start_iteration))
        return self

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> dict:
        """The model as the reference's JSON dump (HostModel.to_json)."""
        return self._host_model().to_json(num_iteration, start_iteration)

    # ------------------------------------------------------------------
    def feature_name(self) -> List[str]:
        return self._host_model().feature_names

    def num_feature(self) -> int:
        return self._host_model().max_feature_idx + 1

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        """Splits ("split") or total gains ("gain") a feature, over every
        tree; `iteration` is accepted and ignored, as in the JAX
        package."""
        return self._host_model().feature_importance(importance_type)

    def lower_bound(self) -> float:
        model = self._host_model()
        return min((t.leaf_value.min() for t in model.trees), default=0.0)

    def upper_bound(self) -> float:
        model = self._host_model()
        return max((t.leaf_value.max() for t in model.trees), default=0.0)

    def free_dataset(self) -> "Booster":
        self.train_set = None
        return self

    def free_network(self) -> "Booster":
        return self

    def __copy__(self):
        return self.__deepcopy__(None)

    def __deepcopy__(self, _):
        """A Booster of this one's model text and params (a prediction
        handle: it holds no training state)."""
        return Booster(params=self.params, model_str=self.model_to_string())


def _same_mapper(a, b) -> bool:
    """Mapper equality, NaN bounds equal to each other (a bound list may
    hold NaN, which == never matches)."""
    da, db = a.to_dict(), b.to_dict()
    if da.keys() != db.keys():
        return False
    for key in da:
        x, y = np.asarray(da[key]), np.asarray(db[key])
        if x.shape != y.shape:
            return False
        if x.dtype.kind == "f" or y.dtype.kind == "f":
            same = np.array_equal(x.astype(np.float64), y.astype(np.float64),
                                  equal_nan=True)
        else:
            same = np.array_equal(x, y)
        if not same:
            return False
    return True


def _higher_better(metric_name: str) -> bool:
    return metric_name.split("@")[0] in ("auc", "ndcg", "map",
                                         "average_precision", "auc_mu")


def _best_score_dict(evaluation_result_list) -> Dict[str, Dict[str, float]]:
    best = collections.defaultdict(collections.OrderedDict)
    for data_name, eval_name, score, _ in evaluation_result_list or []:
        best[data_name][eval_name] = score
    return best
