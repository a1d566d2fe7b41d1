"""Objective functions: per-row gradient/hessian computation in PyTorch.

Port of lightgbm_tpu/objectives.py (reference src/objective/*.hpp, factory
objective_function.cpp:17-89); the ranking objectives are in
objectives_rank.py. Labels and weights live on the training device as f32
tensors; `get_gradients(score)` runs there, in f32, with the JAX package's
operation order (its weak-typed Python constants meet the f32 tensors as
f32 here too):

  regression L2: grad = score - label, hess = 1 (constant hessian)
  L1, quantile, MAPE: sign / pinball gradients, hess = 1, leaves renewed
  Huber, Fair: clipped / smoothed gradients, leaves renewed
  poisson, gamma, tweedie: log-link forms
  binary:        response = -y*sigma / (1 + exp(y*sigma*score)),
                 hess = |r| * (sigma - |r|), y in {-1, +1}
  multiclass:    p = softmax(score), grad = p - onehot,
                 hess = k/(k-1) * p * (1 - p)
  multiclassova: one binary objective a class (is_pos: label == class)
  cross_entropy(_lambda): logistic link on a label in [0, 1]

A multiclass objective (num_model_per_iteration = num_class > 1) takes
the score class-major, [num_class, N], and returns its gradients so: each
class's row is contiguous, the layout the growth kernels read. Objectives
with need_renew_tree_output have their leaves set to a weighted
percentile of the residuals after growth (learner/renew.py, at
renew_percentile).

Objective "none" (a custom objective: engine.train sets it for fobj) makes
no objective; the caller supplies the gradients. `convert_output` maps raw
host scores (f32 numpy, [N] or [N, k]) to predictions for the metrics, in
f32 as the JAX package's does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config
from .data import Metadata
from .utils.log import Log

__all__ = ["ObjectiveFunction", "RegressionL2", "RegressionL1", "Huber",
           "Fair", "Poisson", "Quantile", "Mape", "Gamma", "Tweedie",
           "BinaryLogloss", "MulticlassSoftmax", "MulticlassOVA",
           "CrossEntropy", "CrossEntropyLambda", "create_objective",
           "gradients_at", "OBJECTIVE_ALIASES"]

_EPS = 1e-15


def _f32(x: float) -> float:
    """x rounded to float32: how the JAX package's weak-typed Python
    constants meet its f32 arrays."""
    return float(np.float32(x))


class ObjectiveFunction:
    """Base class (reference include/LightGBM/objective_function.h)."""

    name = "custom"
    num_model_per_iteration = 1
    is_constant_hessian = False
    # per-row hessian constant promised when is_constant_hessian: the
    # kernels reconstruct hessian sums as constant x count
    constant_hessian_value = 1.0
    need_renew_tree_output = False
    #: get_gradients takes the iteration (a draw per iteration: xendcg)
    draws_per_iteration = False

    def __init__(self, config: Config):
        self.config = config
        self.label: Optional[torch.Tensor] = None
        self.weight: Optional[torch.Tensor] = None
        self._label_np: Optional[np.ndarray] = None
        self._weight_np: Optional[np.ndarray] = None

    def init(self, metadata: Metadata, num_data: int,
             device: torch.device) -> None:
        if metadata.label is None:
            Log.fatal("Label is required for objective %s", self.name)
        self.num_data = num_data
        self.device = device
        self._label_np = metadata.label
        self._weight_np = metadata.weight
        self.label = torch.as_tensor(metadata.label, device=device)
        self.weight = None if metadata.weight is None else \
            torch.as_tensor(metadata.weight, device=device)
        self.check_label()

    def check_label(self) -> None:
        pass

    def _weighted(self, grad, hess) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.weight is not None:
            return grad * self.weight, hess * self.weight
        return grad, hess

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        return raw

    def _avg_label(self) -> float:
        lbl = np.asarray(self._label_np, dtype=np.float64)
        if self._weight_np is not None:
            w = np.asarray(self._weight_np, dtype=np.float64)
            return float((lbl * w).sum() / max(w.sum(), _EPS))
        return float(lbl.mean())


def gradients_at(objective: ObjectiveFunction, score: torch.Tensor, it):
    """The objective's (grad, hess) at `score`; one that draws per
    iteration (rank_xendcg) draws under iteration `it`, an int or the
    fused trainer's device int32 scalar."""
    if objective.draws_per_iteration:
        return objective.get_gradients(score, it)
    return objective.get_gradients(score)


def _weighted_median(lbl: np.ndarray, w: np.ndarray) -> float:
    """The smallest label whose cumulative weight reaches half the total
    (the reference's weighted PercentileFun, as the JAX package takes
    it)."""
    order = np.argsort(lbl)
    cw = np.cumsum(w[order])
    return float(lbl[order][np.searchsorted(cw, 0.5 * cw[-1])])


# ---------------------------------------------------------------------------
# Regression family (regression_objective.hpp)
# ---------------------------------------------------------------------------

class RegressionL2(ObjectiveFunction):
    name = "regression"
    is_constant_hessian = True

    def __init__(self, config: Config):
        super().__init__(config)
        self.sqrt = bool(config.reg_sqrt)

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        lbl = self.label
        self.trans_label = torch.sign(lbl) * torch.sqrt(torch.abs(lbl)) \
            if self.sqrt else lbl
        self._trans_np = np.sign(self._label_np) * np.sqrt(
            np.abs(self._label_np)) if self.sqrt else self._label_np

    def get_gradients(self, score):
        grad = score - self.trans_label
        hess = torch.ones_like(score)
        return self._weighted(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        lbl = np.asarray(self._trans_np, dtype=np.float64)
        if self._weight_np is not None:
            w = np.asarray(self._weight_np, dtype=np.float64)
            return float((lbl * w).sum() / max(w.sum(), _EPS))
        return float(lbl.mean())

    def convert_output(self, raw):
        if self.sqrt:
            return np.sign(raw) * raw * raw
        return raw


class RegressionL1(RegressionL2):
    name = "regression_l1"
    need_renew_tree_output = True
    renew_percentile = 0.5

    def __init__(self, config: Config):
        super().__init__(config)
        self.sqrt = False

    def get_gradients(self, score):
        grad = torch.sign(score - self.label)
        return self._weighted(grad, torch.ones_like(score))

    def boost_from_score(self, class_id: int = 0) -> float:
        lbl = np.asarray(self._label_np, dtype=np.float64)
        if self._weight_np is not None:
            return _weighted_median(
                lbl, np.asarray(self._weight_np, dtype=np.float64))
        return float(np.percentile(lbl, 50))


class Huber(RegressionL2):
    name = "huber"
    is_constant_hessian = False
    need_renew_tree_output = True
    renew_percentile = 0.5

    def __init__(self, config: Config):
        super().__init__(config)
        self.sqrt = False
        self.alpha = float(config.alpha)

    def get_gradients(self, score):
        diff = score - self.label
        a = _f32(self.alpha)
        grad = torch.where(torch.abs(diff) <= a, diff, torch.sign(diff) * a)
        return self._weighted(grad, torch.ones_like(score))


class Fair(RegressionL2):
    name = "fair"
    is_constant_hessian = False
    need_renew_tree_output = True
    renew_percentile = 0.5

    def __init__(self, config: Config):
        super().__init__(config)
        self.sqrt = False
        self.c = float(config.fair_c)

    def get_gradients(self, score):
        diff = score - self.label
        c = _f32(self.c)
        den = torch.abs(diff) + c
        grad = c * diff / den
        hess = _f32(self.c * self.c) / (den * den)
        return self._weighted(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0


class Poisson(RegressionL2):
    name = "poisson"
    is_constant_hessian = False

    def __init__(self, config: Config):
        super().__init__(config)
        self.sqrt = False
        self.max_delta_step = float(config.poisson_max_delta_step)

    def check_label(self):
        if float(np.asarray(self._label_np).min()) < 0:
            Log.fatal("[%s]: at least one target label is negative",
                      self.name)

    def get_gradients(self, score):
        grad = torch.exp(score) - self.label
        hess = torch.exp(score + _f32(self.max_delta_step))
        return self._weighted(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        return float(np.log(max(self._avg_label(), _EPS)))

    def convert_output(self, raw):
        return np.exp(np.asarray(raw, np.float32))


class Quantile(RegressionL2):
    name = "quantile"
    need_renew_tree_output = True

    def __init__(self, config: Config):
        super().__init__(config)
        self.sqrt = False
        self.alpha = float(config.alpha)
        self.renew_percentile = self.alpha

    def get_gradients(self, score):
        delta = score - self.label
        grad = torch.where(
            delta >= 0, torch.full_like(score, _f32(1.0 - self.alpha)),
            torch.full_like(score, _f32(-self.alpha)))
        return self._weighted(grad, torch.ones_like(score))

    def boost_from_score(self, class_id: int = 0) -> float:
        return float(np.percentile(np.asarray(self._label_np),
                                   self.alpha * 100))


class Mape(RegressionL2):
    name = "mape"
    need_renew_tree_output = True
    renew_percentile = 0.5

    def __init__(self, config: Config):
        super().__init__(config)
        self.sqrt = False

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        # label_weight = 1/max(1, |label|), folded into the sample weight
        # (regression_objective.hpp RegressionMAPELOSS)
        lw = 1.0 / torch.clamp(torch.abs(self.label), min=1.0)
        self.weight = lw if self.weight is None else self.weight * lw
        self._weight_np = self.weight.cpu().numpy()

    def get_gradients(self, score):
        grad = torch.sign(score - self.label)
        return self._weighted(grad, torch.ones_like(score))

    def boost_from_score(self, class_id: int = 0) -> float:
        return _weighted_median(
            np.asarray(self._label_np, dtype=np.float64),
            np.asarray(self._weight_np, dtype=np.float64))


class Gamma(Poisson):
    name = "gamma"

    def get_gradients(self, score):
        exp_s = torch.exp(-score)
        grad = 1.0 - self.label * exp_s
        hess = self.label * exp_s
        return self._weighted(grad, hess)


class Tweedie(Poisson):
    name = "tweedie"

    def __init__(self, config: Config):
        super().__init__(config)
        self.rho = float(config.tweedie_variance_power)

    def get_gradients(self, score):
        a, b = _f32(1.0 - self.rho), _f32(2.0 - self.rho)
        exp_1 = torch.exp(a * score)
        exp_2 = torch.exp(b * score)
        grad = -self.label * exp_1 + exp_2
        hess = -self.label * a * exp_1 + b * exp_2
        return self._weighted(grad, hess)


# ---------------------------------------------------------------------------
# Binary (binary_objective.hpp)
# ---------------------------------------------------------------------------

class BinaryLogloss(ObjectiveFunction):
    name = "binary"

    def __init__(self, config: Config, is_pos=None):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        self.is_unbalance = bool(config.is_unbalance)
        self.scale_pos_weight = float(config.scale_pos_weight)
        # which labels are positive (MulticlassOVA: label == class)
        self._is_pos = is_pos or (lambda y: y > 0)
        if self.is_unbalance and self.scale_pos_weight != 1.0:
            Log.fatal("Cannot set is_unbalance and scale_pos_weight "
                      "at the same time")

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        pos = self._is_pos(self._label_np)
        cnt_pos, cnt_neg = int(pos.sum()), int((~pos).sum())
        if not (cnt_pos > 0 and cnt_neg > 0):
            Log.warning("Contains only one class")
        w_pos, w_neg = 1.0, 1.0
        if self.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.scale_pos_weight
        pos_t = torch.as_tensor(pos, device=device)
        one = torch.ones((), dtype=torch.float32, device=device)
        self.y_signed = torch.where(pos_t, one, -one)
        self.label_weight = torch.where(pos_t, one * w_pos, one * w_neg)
        self._pavg = float(pos.mean()) if num_data else 0.5
        if self._weight_np is not None:
            w = self._weight_np
            self._pavg = float((pos * w).sum() / max(float(w.sum()), _EPS))

    def get_gradients(self, score):
        y = self.y_signed
        sig = self.sigmoid
        response = -y * sig / (1.0 + torch.exp(y * sig * score))
        abs_r = torch.abs(response)
        grad = response * self.label_weight
        hess = abs_r * (sig - abs_r) * self.label_weight
        return self._weighted(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        pavg = float(np.clip(self._pavg, 1e-15, 1.0 - 1e-15))
        init = float(np.log(pavg / (1.0 - pavg)) / self.sigmoid)
        Log.info("[%s:BoostFromScore]: pavg=%f -> initscore=%f",
                 self.name, pavg, init)
        return init

    def convert_output(self, raw):
        raw = np.asarray(raw, np.float32)
        return np.float32(1.0) / (np.float32(1.0) + np.exp(
            np.float32(-self.sigmoid) * raw))


# ---------------------------------------------------------------------------
# Multiclass (multiclass_objective.hpp); scores class-major [k, N]
# ---------------------------------------------------------------------------

def softmax_rows(score: torch.Tensor) -> torch.Tensor:
    """Softmax over the classes of a class-major [k, N] score, as
    jax.nn.softmax takes it over the last axis: exp(x - max) over the
    sum of those exps, the sum taken class after class."""
    e = torch.exp(score - score.amax(dim=0))
    s = e[0]
    for c in range(1, e.shape[0]):
        s = s + e[c]
    return e / s


class MulticlassSoftmax(ObjectiveFunction):
    name = "multiclass"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        if self.num_class < 2:
            raise ValueError(
                "multiclass objective needs num_class >= 2 "
                f"(got {self.num_class})")
        self.num_model_per_iteration = self.num_class

    def check_label(self):
        lbl = self._label_np
        if lbl.min() < 0 or lbl.max() >= self.num_class:
            Log.fatal("Label must be in [0, %d) for multiclass objective",
                      self.num_class)

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        cls = torch.arange(self.num_class, device=device)[:, None]
        self.onehot = (self.label.to(torch.int32)[None, :] == cls).to(
            torch.float32)

    def get_gradients(self, score):
        """score [k, N] -> grad, hess [k, N]."""
        p = softmax_rows(score)
        grad = p - self.onehot
        # hessian factor k/(k-1) (multiclass_objective.hpp:31,105), as the
        # JAX package takes it
        factor = self.num_class / (self.num_class - 1.0)
        hess = factor * p * (1.0 - p)
        if self.weight is not None:
            return grad * self.weight, hess * self.weight
        return grad, hess

    def boost_from_score(self, class_id: int = 0) -> float:
        # log class prior (multiclass_objective.hpp:155), clamped
        lbl = self._label_np.astype(np.int64)
        w = np.asarray(self._weight_np, np.float64) \
            if self._weight_np is not None else np.ones(len(lbl))
        p = float(w[lbl == class_id].sum() / max(w.sum(), _EPS))
        return float(np.log(max(1e-15, p)))

    def convert_output(self, raw):
        raw = np.asarray(raw, np.float32)
        e = np.exp(raw - raw.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)


class MulticlassOVA(ObjectiveFunction):
    name = "multiclassova"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        self.num_model_per_iteration = self.num_class
        self.sigmoid = float(config.sigmoid)
        self.binary_objs = []

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        self.binary_objs = []
        for k in range(self.num_class):
            obj = BinaryLogloss(self.config,
                                is_pos=lambda y, kk=k: y == kk)
            obj.init(metadata, num_data, device)
            self.binary_objs.append(obj)

    def get_gradients(self, score):
        """score [k, N] -> grad, hess [k, N]."""
        gh = [o.get_gradients(score[k])
              for k, o in enumerate(self.binary_objs)]
        return (torch.stack([g for g, _ in gh]),
                torch.stack([h for _, h in gh]))

    def boost_from_score(self, class_id: int = 0) -> float:
        return self.binary_objs[class_id].boost_from_score()

    def convert_output(self, raw):
        raw = np.asarray(raw, np.float32)
        return np.float32(1.0) / (np.float32(1.0) + np.exp(
            np.float32(-self.sigmoid) * raw))


# ---------------------------------------------------------------------------
# Cross-entropy (xentropy_objective.hpp)
# ---------------------------------------------------------------------------

class CrossEntropy(ObjectiveFunction):
    name = "cross_entropy"

    def check_label(self):
        lbl = self._label_np
        if lbl.min() < 0 or lbl.max() > 1:
            Log.fatal("[%s]: label must be in [0, 1] interval", self.name)

    def get_gradients(self, score):
        z = 1.0 / (1.0 + torch.exp(-score))
        grad = z - self.label
        hess = z * (1.0 - z)
        return self._weighted(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        p = float(np.clip(self._avg_label(), 1e-15, 1 - 1e-15))
        return float(np.log(p / (1.0 - p)))

    def convert_output(self, raw):
        raw = np.asarray(raw, np.float32)
        return np.float32(1.0) / (np.float32(1.0) + np.exp(-raw))


class CrossEntropyLambda(CrossEntropy):
    name = "cross_entropy_lambda"

    def get_gradients(self, score):
        # (xentropy_objective.hpp:190-220): the weight rides the link, not
        # the loss, so there is no extra product
        w = self.weight if self.weight is not None else 1.0
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-w * hhat)
        enf = torch.exp(-score)
        grad = (1.0 - self.label / z) * w / (1.0 + enf)
        c = 1.0 / (1.0 - z)
        d = 1.0 + epf
        a = w * epf / (z * d)
        b = (d / w - 1.0) * c + 1.0
        hess = a * (1.0 + self.label * c * (a * b - 1.0)) / d * w
        return grad, hess

    def boost_from_score(self, class_id: int = 0) -> float:
        avg = self._avg_label()
        return float(np.log(np.expm1(np.clip(avg, 1e-15, None)) + 1e-15)) \
            if avg > 0 else -20.0

    def convert_output(self, raw):
        return np.log1p(np.exp(np.asarray(raw, np.float32)))


# ---------------------------------------------------------------------------
# Factory (objective_function.cpp:17-89)
# ---------------------------------------------------------------------------

OBJECTIVE_ALIASES = {
    "regression": "regression", "regression_l2": "regression",
    "l2": "regression", "mean_squared_error": "regression",
    "mse": "regression", "l2_root": "regression", "rmse": "regression",
    "root_mean_squared_error": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1",
    "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "quantile": "quantile", "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
    "lambdarank": "lambdarank", "rank_xendcg": "rank_xendcg",
    "xendcg": "rank_xendcg", "xe_ndcg": "rank_xendcg",
    "xe_ndcg_mart": "rank_xendcg", "xendcg_mart": "rank_xendcg",
    "none": "none", "null": "none", "custom": "none", "na": "none",
}


def create_objective(name: str,
                     config: Config) -> Optional[ObjectiveFunction]:
    """The objective `name` names, or None for "none" (gradients from the
    caller)."""
    from .objectives_rank import LambdarankNDCG, RankXENDCG
    canonical = OBJECTIVE_ALIASES.get(name)
    if canonical is None:
        Log.fatal("Unknown objective %s", name)
    if canonical == "none":
        return None
    if name in ("l2_root", "rmse", "root_mean_squared_error"):
        config.reg_sqrt = True
    classes = {
        "regression": RegressionL2, "regression_l1": RegressionL1,
        "huber": Huber, "fair": Fair, "poisson": Poisson,
        "quantile": Quantile, "mape": Mape, "gamma": Gamma,
        "tweedie": Tweedie, "binary": BinaryLogloss,
        "multiclass": MulticlassSoftmax, "multiclassova": MulticlassOVA,
        "cross_entropy": CrossEntropy,
        "cross_entropy_lambda": CrossEntropyLambda,
        "lambdarank": LambdarankNDCG, "rank_xendcg": RankXENDCG,
    }
    return classes[canonical](config)
