"""Evaluation metrics (reference src/metric/, factory metric.cpp:17-62).

Copy of lightgbm_tpu/metrics.py for the PyTorch/CUDA port: numpy on the
host, once per evaluated iteration, off the device path (the reference
likewise evaluates on the CPU between boosting iterations,
gbdt.cpp:469-572). Scores come back from the device once a block per
valid set (engine.train). Ported: every metric whose objective or inputs
the port has: the pointwise regression metrics, binary_logloss,
binary_error, auc, average_precision, cross_entropy, cross_entropy_lambda
and kullback_leibler. The multiclass metrics (multi_logloss, multi_error,
auc_mu) and the ranking metrics (ndcg, map: query groups) are refused by
create_metric, naming ROADMAP.md A6.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .config import Config
from .data import Metadata
from .utils.log import Log

__all__ = ["Metric", "create_metric", "default_metric_for_objective",
           "METRIC_ALIASES"]

_EPS = 1e-15


class Metric:
    name = "metric"
    is_higher_better = False

    def __init__(self, config: Config):
        self.config = config

    def init(self, metadata: Metadata, num_data: int) -> None:
        self.metadata = metadata
        self.num_data = num_data
        self.label = None if metadata.label is None else \
            np.asarray(metadata.label, dtype=np.float64)
        self.weight = None if metadata.weight is None else \
            np.asarray(metadata.weight, dtype=np.float64)
        self.sum_weight = float(self.weight.sum()) if self.weight is not None \
            else float(num_data)

    def _avg(self, losses: np.ndarray) -> float:
        if self.weight is not None:
            return float((losses * self.weight).sum() / self.sum_weight)
        return float(losses.mean())

    def evaluate(self, score: np.ndarray,
                 convert: Optional[Callable] = None) -> float:
        raise NotImplementedError


class _PointwiseMetric(Metric):
    """Average of a per-row loss on converted predictions."""
    convert_score = True

    def point_loss(self, pred: np.ndarray, label: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def evaluate(self, score, convert=None):
        pred = score
        if self.convert_score and convert is not None:
            pred = convert(score)
        return self._avg(self.point_loss(np.asarray(pred, np.float64),
                                         self.label))


class L2Metric(_PointwiseMetric):
    name = "l2"

    def point_loss(self, p, y):
        return (p - y) ** 2


class RMSEMetric(L2Metric):
    name = "rmse"

    def evaluate(self, score, convert=None):
        return float(np.sqrt(super().evaluate(score, convert)))


class L1Metric(_PointwiseMetric):
    name = "l1"

    def point_loss(self, p, y):
        return np.abs(p - y)


class QuantileMetric(_PointwiseMetric):
    name = "quantile"

    def point_loss(self, p, y):
        a = self.config.alpha
        d = y - p
        return np.where(d >= 0, a * d, (a - 1.0) * d)


class HuberMetric(_PointwiseMetric):
    name = "huber"

    def point_loss(self, p, y):
        a = self.config.alpha
        d = np.abs(p - y)
        return np.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))


class FairMetric(_PointwiseMetric):
    name = "fair"

    def point_loss(self, p, y):
        c = self.config.fair_c
        x = np.abs(p - y)
        return c * x - c * c * np.log1p(x / c)


class PoissonMetric(_PointwiseMetric):
    name = "poisson"

    def point_loss(self, p, y):
        eps = 1e-10
        p = np.maximum(p, eps)
        return p - y * np.log(p)


class MapeMetric(_PointwiseMetric):
    name = "mape"

    def point_loss(self, p, y):
        return np.abs((y - p) / np.maximum(1.0, np.abs(y)))


class GammaMetric(_PointwiseMetric):
    name = "gamma"

    def point_loss(self, p, y):
        psi = 1.0
        theta = -1.0 / np.maximum(p, _EPS)
        a = psi
        b = -np.log(-theta)
        c = 1.0 / psi * np.log(y / psi) - np.log(y) - 0  # lgamma(1/psi)=0
        return -(y * theta - b) / a - c


class GammaDevianceMetric(_PointwiseMetric):
    name = "gamma_deviance"

    def point_loss(self, p, y):
        eps = 1e-9
        x = y / np.maximum(p, eps)
        return 2.0 * (x - np.log(np.maximum(x, eps)) - 1.0)


class TweedieMetric(_PointwiseMetric):
    name = "tweedie"

    def point_loss(self, p, y):
        rho = self.config.tweedie_variance_power
        eps = 1e-10
        p = np.maximum(p, eps)
        a = y * np.power(p, 1.0 - rho) / (1.0 - rho)
        b = np.power(p, 2.0 - rho) / (2.0 - rho)
        return -a + b


class BinaryLoglossMetric(_PointwiseMetric):
    name = "binary_logloss"

    def point_loss(self, p, y):
        p = np.clip(p, _EPS, 1.0 - _EPS)
        return -(y * np.log(p) + (1.0 - y) * np.log(1.0 - p))


class BinaryErrorMetric(_PointwiseMetric):
    name = "binary_error"

    def point_loss(self, p, y):
        pred = (p > 0.5).astype(np.float64)
        return (pred != (y > 0)).astype(np.float64)


class AUCMetric(Metric):
    name = "auc"
    is_higher_better = True

    def evaluate(self, score, convert=None):
        y = self.label > 0
        w = self.weight if self.weight is not None else np.ones_like(
            self.label)
        return self._auc_fast(score, y, w)

    @staticmethod
    def _auc_fast(score, y, w):
        order = np.argsort(-np.asarray(score), kind="stable")
        ys, ws = y[order], w[order]
        # group ties
        ss = np.asarray(score)[order]
        boundary = np.concatenate([[True], ss[1:] != ss[:-1]])
        gid = np.cumsum(boundary) - 1
        npos_g = np.bincount(gid, weights=ys * ws)
        nneg_g = np.bincount(gid, weights=(~ys) * ws)
        cum_neg_before = np.concatenate([[0.0], np.cumsum(nneg_g)[:-1]])
        # pairs: pos in group beats all negs after; ties count half
        total_neg = nneg_g.sum()
        wins = (npos_g * (total_neg - cum_neg_before - nneg_g)).sum()
        ties = (npos_g * nneg_g).sum()
        sum_pos = npos_g.sum()
        if sum_pos <= 0 or total_neg <= 0:
            return 0.5
        return float((wins + 0.5 * ties) / (sum_pos * total_neg))


class AveragePrecisionMetric(Metric):
    name = "average_precision"
    is_higher_better = True

    def evaluate(self, score, convert=None):
        y = (self.label > 0).astype(np.float64)
        w = self.weight if self.weight is not None else np.ones_like(y)
        order = np.argsort(-np.asarray(score), kind="stable")
        ys, ws = y[order], w[order]
        tp = np.cumsum(ys * ws)
        fp = np.cumsum((1 - ys) * ws)
        precision = tp / np.maximum(tp + fp, _EPS)
        total_pos = (y * w).sum()
        if total_pos <= 0:
            return 0.5
        recall_delta = ys * ws / total_pos
        return float((precision * recall_delta).sum())


class CrossEntropyMetric(_PointwiseMetric):
    name = "cross_entropy"

    def point_loss(self, p, y):
        p = np.clip(p, _EPS, 1.0 - _EPS)
        return -(y * np.log(p) + (1.0 - y) * np.log(1.0 - p))


class CrossEntropyLambdaMetric(_PointwiseMetric):
    name = "cross_entropy_lambda"
    convert_score = False

    def point_loss(self, raw, y):
        # xentropy_metric.hpp XentLambdaLoss, approximately
        return np.log1p(np.exp(raw)) - y * raw

    def evaluate(self, score, convert=None):
        raw = np.asarray(score, np.float64)
        y = self.label
        w = self.weight if self.weight is not None else np.ones_like(y)
        # reference xentropy_metric.hpp:XentLambdaLoss: loss with weights in
        # the link: yhat = 1-exp(-w*log1p(exp(raw)))
        hhat = np.log1p(np.exp(raw))
        z = 1.0 - np.exp(-w * hhat)
        z = np.clip(z, _EPS, 1.0 - _EPS)
        loss = -(y * np.log(z) + (1.0 - y) * np.log(1.0 - z))
        return float(loss.mean())


class KLDivMetric(_PointwiseMetric):
    name = "kullback_leibler"

    def point_loss(self, p, y):
        p = np.clip(p, _EPS, 1.0 - _EPS)
        yy = np.clip(y, _EPS, 1.0 - _EPS)
        return (yy * np.log(yy / p) +
                (1.0 - yy) * np.log((1.0 - yy) / (1.0 - p)))


METRIC_ALIASES = {
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2",
    "regression": "l2", "regression_l2": "l2",
    "l2_root": "rmse", "rmse": "rmse", "root_mean_squared_error": "rmse",
    "l1": "l1", "mean_absolute_error": "l1", "mae": "l1",
    "regression_l1": "l1",
    "quantile": "quantile", "huber": "huber", "fair": "fair",
    "poisson": "poisson", "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "gamma_deviance": "gamma_deviance",
    "tweedie": "tweedie",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "binary_error": "binary_error",
    "auc": "auc", "average_precision": "average_precision",
    "auc_mu": "auc_mu",
    "ndcg": "ndcg", "lambdarank": "ndcg", "rank_xendcg": "ndcg",
    "xendcg": "ndcg", "map": "map", "mean_average_precision": "map",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "softmax": "multi_logloss", "multiclassova": "multi_logloss",
    "multi_error": "multi_error",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
    "kullback_leibler": "kullback_leibler", "kldiv": "kullback_leibler",
}

_CLASSES = {
    "l2": L2Metric, "rmse": RMSEMetric, "l1": L1Metric,
    "quantile": QuantileMetric, "huber": HuberMetric, "fair": FairMetric,
    "poisson": PoissonMetric, "mape": MapeMetric, "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric, "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric, "binary_error": BinaryErrorMetric,
    "auc": AUCMetric, "average_precision": AveragePrecisionMetric,
    "cross_entropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "kullback_leibler": KLDivMetric,
}


# metrics whose objectives or inputs the port does not have yet
_UNPORTED = {"multi_logloss": "multiclass", "multi_error": "multiclass",
             "auc_mu": "multiclass",
             "ndcg": "ranking (query groups)",
             "map": "ranking (query groups)"}


def create_metric(name: str, config: Config) -> Optional[Metric]:
    canonical = METRIC_ALIASES.get(name)
    if canonical is None:
        if name in ("", "none", "null", "na", "custom"):
            return None
        Log.fatal("Unknown metric %s", name)
    if canonical in _UNPORTED:
        raise NotImplementedError(
            f"metric {name!r} ({canonical}) is not ported to "
            f"lightgbm_tpu_torch yet: {_UNPORTED[canonical]} "
            "(ROADMAP.md port queue A6)")
    m = _CLASSES[canonical](config)
    m.name = canonical
    return m


def default_metric_for_objective(objective: str) -> Optional[str]:
    return METRIC_ALIASES.get(objective)
