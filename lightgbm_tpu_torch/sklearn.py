"""scikit-learn estimator API (reference python-package/lightgbm/sklearn.py).

The port's copy of lightgbm_tpu/sklearn.py: LGBMModel, LGBMRegressor,
LGBMClassifier and LGBMRanker with the reference's constructor signature
and fit/predict semantics (sklearn.py:347,973,1019,1173): eval_set
handling, early stopping through callbacks, classes_ (labels of any
type, encoded to 0..k-1), feature importances, pandas passthrough. Every
fit goes through engine.train, so it trains on the card unless the
parameters ask for device_type="cpu". The module never imports
scikit-learn; get_params/set_params follow its estimator contract, so
sklearn.base.clone copies an estimator where scikit-learn is installed.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from .basic import Booster, Dataset
from .callback import early_stopping as early_stopping_cb
from .callback import log_evaluation
from .engine import train as train_fn
from .utils.log import Log

__all__ = ["LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker"]


class LGBMModel:
    """Base sklearn-style estimator (reference sklearn.py:347)."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[str] = None,
                 class_weight: Optional[Union[Dict, str]] = None,
                 min_split_gain: float = 0.0, min_child_weight: float = 1e-3,
                 min_child_samples: int = 20, subsample: float = 1.0,
                 subsample_freq: int = 0, colsample_bytree: float = 1.0,
                 reg_alpha: float = 0.0, reg_lambda: float = 0.0,
                 random_state: Optional[int] = None, n_jobs: int = -1,
                 importance_type: str = "split", **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.importance_type = importance_type
        self._other_params = dict(kwargs)
        self._Booster: Optional[Booster] = None
        self._n_features: Optional[int] = None
        self._classes = None
        self._n_classes = 1
        self._evals_result: Dict = {}
        self._best_iteration = -1
        self._best_score: Dict = {}
        self.set_params(**kwargs)

    # ---- sklearn plumbing --------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = {
            "boosting_type": self.boosting_type,
            "num_leaves": self.num_leaves, "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "n_estimators": self.n_estimators,
            "subsample_for_bin": self.subsample_for_bin,
            "objective": self.objective, "class_weight": self.class_weight,
            "min_split_gain": self.min_split_gain,
            "min_child_weight": self.min_child_weight,
            "min_child_samples": self.min_child_samples,
            "subsample": self.subsample,
            "subsample_freq": self.subsample_freq,
            "colsample_bytree": self.colsample_bytree,
            "reg_alpha": self.reg_alpha, "reg_lambda": self.reg_lambda,
            "random_state": self.random_state, "n_jobs": self.n_jobs,
            "importance_type": self.importance_type,
        }
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for key, value in params.items():
            if hasattr(self, key) and not key.startswith("_"):
                setattr(self, key, value)
            self._other_params[key] = value
        return self

    def _default_objective(self) -> str:
        return "regression"

    def _process_params(self, stage: str) -> Dict[str, Any]:
        params = self.get_params()
        params.pop("importance_type", None)
        params.pop("n_estimators", None)
        params.pop("class_weight", None)
        obj = params.pop("objective", None) or self._default_objective()
        params["objective"] = obj
        alias_map = {"boosting_type": "boosting", "subsample": "bagging_fraction",
                     "subsample_freq": "bagging_freq",
                     "colsample_bytree": "feature_fraction",
                     "min_child_samples": "min_data_in_leaf",
                     "min_child_weight": "min_sum_hessian_in_leaf",
                     "min_split_gain": "min_gain_to_split",
                     "reg_alpha": "lambda_l1", "reg_lambda": "lambda_l2",
                     "subsample_for_bin": "bin_construct_sample_cnt",
                     "random_state": "seed", "n_jobs": "num_threads"}
        for src, dst in alias_map.items():
            if src in params:
                val = params.pop(src)
                if val is not None:
                    params[dst] = val
        if params.get("seed") is None:
            params.pop("seed", None)
        params.setdefault("verbosity", -1)
        return params

    # ---- fit ----------------------------------------------------------
    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_class_weight=None, eval_init_score=None, eval_group=None,
            eval_metric=None, early_stopping_rounds=None, verbose=False,
            feature_name="auto", categorical_feature="auto",
            callbacks=None, init_model=None) -> "LGBMModel":
        params = self._process_params("fit")
        if eval_metric is not None:
            params["metric"] = eval_metric if isinstance(eval_metric, str) \
                else ",".join(m for m in eval_metric if isinstance(m, str))
        y_arr = np.asarray(y).reshape(-1)
        sw = sample_weight
        if self.class_weight is not None and self._classes is not None:
            cw = self._compute_class_weight(y_arr)
            sw = cw if sw is None else np.asarray(sw) * cw
        train_set = Dataset(X, label=y_arr, weight=sw, group=group,
                            init_score=init_score,
                            feature_name=feature_name,
                            categorical_feature=categorical_feature,
                            params=params)
        valid_sets: List[Dataset] = []
        valid_names: List[str] = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                if vx is X and vy is y:
                    valid_sets.append(train_set)
                else:
                    vw = eval_sample_weight[i] \
                        if eval_sample_weight is not None else None
                    vg = eval_group[i] if eval_group is not None else None
                    vi = eval_init_score[i] \
                        if eval_init_score is not None else None
                    vy_arr = self._transform_label(np.asarray(vy).reshape(-1))
                    valid_sets.append(Dataset(
                        vx, label=vy_arr, weight=vw, group=vg, init_score=vi,
                        reference=train_set, params=params))
                valid_names.append(
                    eval_names[i] if eval_names is not None else f"valid_{i}")
        cbs = list(callbacks or [])
        if early_stopping_rounds is not None and early_stopping_rounds > 0:
            cbs.append(early_stopping_cb(early_stopping_rounds,
                                         verbose=bool(verbose)))
        if verbose and isinstance(verbose, (int, bool)) and verbose is not False:
            period = 1 if verbose is True else int(verbose)
            cbs.append(log_evaluation(period))
        self._evals_result = {}
        from .callback import record_evaluation
        cbs.append(record_evaluation(self._evals_result))
        self._Booster = train_fn(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None,
            valid_names=valid_names or None, callbacks=cbs,
            init_model=init_model)
        self._n_features = np.asarray(X).shape[1] \
            if hasattr(X, "shape") else train_set.num_feature()
        self._best_iteration = self._Booster.best_iteration
        self._best_score = self._Booster.best_score
        return self

    def _transform_label(self, y):
        return y

    def _compute_class_weight(self, y):
        if self.class_weight == "balanced":
            classes, counts = np.unique(y, return_counts=True)
            weights = len(y) / (len(classes) * counts)
            lut = dict(zip(classes, weights))
        else:
            lut = dict(self.class_weight)
        return np.asarray([lut.get(v, 1.0) for v in y], np.float32)

    # ---- predict ------------------------------------------------------
    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs):
        if self._Booster is None:
            raise ValueError("Estimator not fitted, call fit first")
        return self._Booster.predict(
            X, raw_score=raw_score, start_iteration=start_iteration,
            num_iteration=num_iteration, pred_leaf=pred_leaf,
            pred_contrib=pred_contrib)

    # ---- attributes ---------------------------------------------------
    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise ValueError("No booster found. Need to call fit beforehand.")
        return self._Booster

    @property
    def n_features_(self) -> int:
        return self._n_features

    @property
    def best_iteration_(self) -> int:
        return self._best_iteration

    @property
    def best_score_(self) -> Dict:
        return self._best_score

    @property
    def evals_result_(self) -> Dict:
        return self._evals_result

    @property
    def feature_importances_(self) -> np.ndarray:
        return self.booster_.feature_importance(self.importance_type)

    @property
    def feature_name_(self) -> List[str]:
        return self.booster_.feature_name()


class LGBMRegressor(LGBMModel):
    """Reference sklearn.py:1019 LGBMRegressor."""

    def _default_objective(self) -> str:
        return "regression"


class LGBMClassifier(LGBMModel):
    """Reference sklearn.py:973 LGBMClassifier."""

    def _default_objective(self) -> str:
        return "binary" if self._n_classes <= 2 else "multiclass"

    def fit(self, X, y, **kwargs):
        y_arr = np.asarray(y).reshape(-1)
        # _classes_override: a caller that knows the global class set
        # (the JAX package's dask.py) encodes every part the same
        override = getattr(self, "_classes_override", None)
        self._classes = np.unique(y_arr) if override is None \
            else np.asarray(override)
        self._n_classes = len(self._classes)
        self._label_map = {c: i for i, c in enumerate(self._classes)}
        y_enc = np.asarray([self._label_map[v] for v in y_arr], np.float32)
        if self._n_classes > 2:
            self._other_params["num_class"] = self._n_classes
        if "eval_set" in kwargs and kwargs["eval_set"] is not None:
            pass  # labels transformed via _transform_label in base fit
        return super().fit(X, y_enc, **kwargs)

    def _transform_label(self, y):
        return np.asarray([self._label_map.get(v, 0) for v in y], np.float32)

    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs):
        result = self.predict_proba(X, raw_score, start_iteration,
                                    num_iteration, pred_leaf, pred_contrib,
                                    **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if self._n_classes > 2:
            idx = np.argmax(result, axis=1)
        else:
            idx = (result[:, 1] > 0.5).astype(int) if result.ndim == 2 \
                else (result > 0.5).astype(int)
        return self._classes[idx]

    def predict_proba(self, X, raw_score: bool = False,
                      start_iteration: int = 0,
                      num_iteration: Optional[int] = None,
                      pred_leaf: bool = False, pred_contrib: bool = False,
                      **kwargs):
        result = super().predict(X, raw_score, start_iteration,
                                 num_iteration, pred_leaf, pred_contrib,
                                 **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if self._n_classes <= 2 and result.ndim == 1:
            return np.column_stack([1.0 - result, result])
        return result

    @property
    def classes_(self):
        return self._classes

    @property
    def n_classes_(self) -> int:
        return self._n_classes


class LGBMRanker(LGBMModel):
    """Reference sklearn.py:1173 LGBMRanker."""

    def _default_objective(self) -> str:
        return "lambdarank"

    def fit(self, X, y, group=None, **kwargs):
        if group is None:
            raise ValueError("Should set group for ranking task")
        eval_group = kwargs.get("eval_group")
        if kwargs.get("eval_set") is not None and eval_group is None:
            raise ValueError("Eval_group cannot be None when eval_set is not "
                             "None")
        return super().fit(X, y, group=group, **kwargs)
