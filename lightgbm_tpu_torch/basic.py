"""User-facing Dataset and Booster (reference python-package/lightgbm/basic.py).

Port of the dense-numpy subset of lightgbm_tpu/basic.py: `Dataset(data,
label, ...)` with lazy construction and `Booster(params, train_set)` with
update / update_batch / predict / model_to_string / save_model. Training runs on the
device named by `device_type` ("cuda" by default, "cpu" on request);
prediction runs on the host model (numpy tree walk), like the JAX
package's Booster.predict.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np

from .boosting.gbdt import GBDT, check_supported, resolve_device
from .config import Config
from .data import BinnedDataset, Metadata
from .objectives import create_objective
from .tree import HostModel
from .utils.log import LightGBMError, Log

__all__ = ["Dataset", "Booster", "LightGBMError"]


def _to_2d_float(data) -> np.ndarray:
    if hasattr(data, "values") and not isinstance(data, np.ndarray):
        data = data.values  # pandas
    if hasattr(data, "tocsc") and hasattr(data, "nnz"):
        raise NotImplementedError(
            "sparse input is not ported to lightgbm_tpu_torch yet "
            "(ROADMAP.md port queue P8); pass a dense array")
    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    if arr.dtype in (np.float32, np.float64):
        return arr
    return np.ascontiguousarray(arr, dtype=np.float64)


class Dataset:
    """Lazily-constructed binned dataset (reference basic.py:1163)."""

    def __init__(self, data, label=None, weight=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True):
        self.data = data
        self.label = label
        self.weight = weight
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
        X = _to_2d_float(self.data)
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
        md = Metadata(
            X.shape[0],
            label=None if self.label is None else
            np.asarray(self.label, dtype=np.float32).reshape(-1),
            weight=None if self.weight is None else
            np.asarray(self.weight, np.float32),
            init_score=None if self.init_score is None else
            np.asarray(self.init_score))
        self._binned = BinnedDataset.from_raw(
            X, md, max_bin=cfg.max_bin, min_data_in_bin=cfg.min_data_in_bin,
            sample_cnt=cfg.bin_construct_sample_cnt,
            use_missing=cfg.use_missing, zero_as_missing=cfg.zero_as_missing,
            categorical_features=cat, seed=cfg.data_random_seed,
            feature_names=names, feature_pre_filter=cfg.feature_pre_filter)
        if self.free_raw_data:
            self.data = None
        return self

    @property
    def binned(self) -> BinnedDataset:
        self.construct()
        return self._binned


class Booster:
    """Training/prediction handle (reference basic.py:2594)."""

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
        objective = create_objective(self.config.objective, self.config)
        self.train_set = train_set
        merged = dict(train_set.params)
        merged.update(self.params)
        train_set.params = merged
        self.gbdt = GBDT(self.config, train_set.binned, objective, device)

    def update(self, train_set=None, fobj=None) -> bool:
        """One boosting iteration; returns True if no further splits
        (reference LGBM_BoosterUpdateOneIter)."""
        if train_set is not None or fobj is not None:
            raise NotImplementedError(
                "update(train_set=..., fobj=...) is not ported to "
                "lightgbm_tpu_torch yet (ROADMAP.md port queue P10)")
        self._model = None
        return self.gbdt.train_one_iter()

    def update_batch(self, num_iterations: int) -> bool:
        """num_iterations boosting iterations, the trees of as many
        update() calls, grown through the fused trainer (CUDA graphs on
        the card); returns True if training cannot continue (a lagged
        poll, as in the JAX package)."""
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

    def current_iteration(self) -> int:
        if self.gbdt is not None:
            return self.gbdt.current_iteration()
        return self._model.num_iterations if self._model else 0

    def _host_model(self) -> HostModel:
        if self._model is None:
            self._model = HostModel.from_gbdt(self.gbdt, self.train_set)
        return self._model

    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False) -> np.ndarray:
        return self._host_model().predict(
            _to_2d_float(data), start_iteration=start_iteration,
            num_iteration=num_iteration, raw_score=raw_score)

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        return self._host_model().to_string(
            num_iteration=num_iteration, start_iteration=start_iteration)

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        with open(filename, "w") as fh:
            fh.write(self.model_to_string(num_iteration, start_iteration))
        return self
