"""Evaluation metrics (reference src/metric/, factory metric.cpp:17-62).

Copy of lightgbm_tpu/metrics.py for the PyTorch/CUDA port: numpy on the
host, once per evaluated iteration, off the device path (the reference
likewise evaluates on the CPU between boosting iterations,
gbdt.cpp:469-572). Scores come back from the device once a block per
valid set (engine.train). Every metric of the JAX package: the pointwise
regression metrics, binary_logloss, binary_error, auc,
average_precision, cross_entropy, cross_entropy_lambda,
kullback_leibler, the multiclass metrics (multi_logloss, multi_error with
multi_error_top_k, auc_mu) on [N, k] scores, and the ranking metrics
(ndcg and map at each of eval_at, named ndcg@k and map@k, with
label_gain) over the dataset's query groups. As in the JAX package,
auc_mu averages the pairwise class AUCs without auc_mu_weights.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

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


class MultiLoglossMetric(Metric):
    name = "multi_logloss"

    def evaluate(self, score, convert=None):
        p = convert(score) if convert is not None else score
        p = np.asarray(p, np.float64)
        idx = self.label.astype(np.int64)
        pt = np.clip(p[np.arange(len(idx)), idx], _EPS, None)
        return self._avg(-np.log(pt))


class MultiErrorMetric(Metric):
    name = "multi_error"

    def evaluate(self, score, convert=None):
        p = np.asarray(score, np.float64)
        k = self.config.multi_error_top_k
        idx = self.label.astype(np.int64)
        true_p = p[np.arange(len(idx)), idx]
        # an error unless the true class ranks in the top k (ties count as
        # correct)
        rank = (p > true_p[:, None]).sum(axis=1)
        return self._avg((rank >= k).astype(np.float64))


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


class _QueryMetric(Metric):
    """A ranking metric at each of eval_at, averaged over the queries."""
    is_higher_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            Log.fatal("%s metric requires query information",
                      self.name.upper())
        self.eval_at = [int(k) for k in
                        (self.config.eval_at or [1, 2, 3, 4, 5])]

    def query_value(self, lbl, order, k) -> float:
        raise NotImplementedError

    def evaluate_multi(self, score) -> Dict[str, float]:
        qb = self.metadata.query_boundaries
        out = {}
        for k in self.eval_at:
            vals = []
            for qi in range(len(qb) - 1):
                s, e = qb[qi], qb[qi + 1]
                order = np.argsort(-np.asarray(score[s:e]), kind="stable")
                vals.append(self.query_value(self.label[s:e], order, k))
            out[f"{self.name}@{k}"] = float(np.mean(vals))
        return out

    def evaluate(self, score, convert=None):
        return list(self.evaluate_multi(score).values())[0]


class NDCGMetric(_QueryMetric):
    name = "ndcg"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        gains = self.config.label_gain
        self.label_gain = np.asarray(gains, np.float64) if gains \
            else (2.0 ** np.arange(32)) - 1.0

    def query_value(self, lbl, order, k):
        lbl = lbl.astype(np.int64)
        gains = self.label_gain[lbl[order][:k]]
        disc = 1.0 / np.log2(np.arange(len(gains)) + 2.0)
        dcg = (gains * disc).sum()
        ideal = np.sort(self.label_gain[lbl])[::-1][:k]
        idcg = (ideal * disc[:len(ideal)]).sum()
        return dcg / idcg if idcg > 0 else 1.0


class MapMetric(_QueryMetric):
    name = "map"

    def query_value(self, lbl, order, k):
        rel = (lbl > 0).astype(np.float64)
        rel_sorted = rel[order][:k]
        prec = np.cumsum(rel_sorted) / (np.arange(len(rel_sorted)) + 1.0)
        npos = min(rel.sum(), k)
        return float((prec * rel_sorted).sum() / npos) if npos > 0 else 1.0


class AucMuMetric(Metric):
    name = "auc_mu"
    is_higher_better = True

    def evaluate(self, score, convert=None):
        # multiclass AUC-mu (Kleiman & Page): the average of the pairwise
        # class AUCs on score differences (metric/multiclass_metric.hpp)
        p = np.asarray(score, np.float64)
        num_class = p.shape[1]
        y = self.label.astype(np.int64)
        w = self.weight if self.weight is not None else np.ones(len(y))
        total, cnt = 0.0, 0
        for a in range(num_class):
            for b in range(a + 1, num_class):
                mask = (y == a) | (y == b)
                if mask.sum() == 0:
                    continue
                total += AUCMetric._auc_fast(p[mask, a] - p[mask, b],
                                             y[mask] == a, w[mask])
                cnt += 1
        return total / max(cnt, 1)


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
    "auc_mu": AucMuMetric, "ndcg": NDCGMetric, "map": MapMetric,
    "multi_logloss": MultiLoglossMetric, "multi_error": MultiErrorMetric,
    "cross_entropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "kullback_leibler": KLDivMetric,
}


def create_metric(name: str, config: Config) -> Optional[Metric]:
    canonical = METRIC_ALIASES.get(name)
    if canonical is None:
        if name in ("", "none", "null", "na", "custom"):
            return None
        Log.fatal("Unknown metric %s", name)
    m = _CLASSES[canonical](config)
    m.name = canonical
    return m


def default_metric_for_objective(objective: str) -> Optional[str]:
    return METRIC_ALIASES.get(objective)
