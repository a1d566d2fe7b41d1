"""Valid-set metrics reduced on the device over a block's score trajectory.

Port of lightgbm_tpu/pipeline/device_eval.py. The non-pipelined block
loop copies each valid set's whole per-iteration score matrix to the host
([b, N] or [b, N, k] f32, GBDT.valid_traj_point) and runs metrics.py on
it. Here the metric reductions run on the trajectory's device, in torch
ops (the JAX package's vmapped jnp reduction is XLA glue, not a kernel):
one [b, n_metrics] f32 tensor a valid set, so the early-stop/callback
protocol copies a few hundred bytes a block instead of the score
matrices.

Fidelity contract (the JAX module's): the formulas follow metrics.py term
for term (weighted mean = (loss * w).sum() / sum_weight, the same eps
floors, convert_output computed once a point and shared by the metrics
that convert), but arithmetic is f32 on the device where metrics.py
computes in float64, so logged metric values may differ in the trailing
digits. Trees and scores never flow through this module; only an exactly
tied early-stop comparison could flip, which is why the tests pin
best_iteration across both eval paths. The one deliberate deviation:
upper clip bounds use 1e-7 where metrics.py uses 1e-15, because
1 - 1e-15 rounds to 1.0 in f32 and log(1 - p) would be -inf.

Engagement is all-or-nothing per run: if any metric on any valid set has
no device form (the rank and AUC families need per-query sorts), the
executor evaluates everything on the host.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

__all__ = ["DeviceEval", "build_device_eval"]

_EPS = 1e-15          # lower clip floor (f32-representable; metrics.py)
_EPS_HI = 1e-7        # upper clip margin: 1 - 1e-15 == 1.0 in f32

# metrics.py's _PointwiseMetric family with a direct torch transcription.
# cross_entropy_lambda is excluded (its weighted link folds the weight
# inside the loss, another averaging contract), as are the sort-based
# families (auc, average_precision, auc_mu, ndcg, map).
_POINTWISE = frozenset((
    "l2", "rmse", "l1", "quantile", "huber", "fair", "poisson", "mape",
    "gamma", "gamma_deviance", "tweedie", "binary_logloss",
    "binary_error", "cross_entropy", "kullback_leibler"))
_MULTI = frozenset(("multi_logloss", "multi_error"))


def _point_loss(m, p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The torch transcription of metrics.py's point_loss for metric m
    (the JAX package's device_eval._point_loss)."""
    n, cfg = m.name, m.config
    if n in ("l2", "rmse"):
        return (p - y) ** 2
    if n == "l1":
        return torch.abs(p - y)
    if n == "quantile":
        a = float(cfg.alpha)
        d = y - p
        return torch.where(d >= 0, a * d, (a - 1.0) * d)
    if n == "huber":
        a = float(cfg.alpha)
        d = torch.abs(p - y)
        return torch.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))
    if n == "fair":
        c = float(cfg.fair_c)
        x = torch.abs(p - y)
        return c * x - c * c * torch.log1p(x / c)
    if n == "poisson":
        pp = torch.clamp(p, min=1e-10)
        return pp - y * torch.log(pp)
    if n == "mape":
        return torch.abs((y - p) / torch.clamp(torch.abs(y), min=1.0))
    if n == "gamma":
        theta = -1.0 / torch.clamp(p, min=_EPS)
        b = -torch.log(-theta)
        # psi=1 makes metrics.py's c term log(y) - log(y); keep it so
        # non-positive labels propagate the same NaNs
        return -(y * theta - b) - (torch.log(y) - torch.log(y))
    if n == "gamma_deviance":
        x = y / torch.clamp(p, min=1e-9)
        return 2.0 * (x - torch.log(torch.clamp(x, min=1e-9)) - 1.0)
    if n == "tweedie":
        rho = float(cfg.tweedie_variance_power)
        pp = torch.clamp(p, min=1e-10)
        a = y * torch.pow(pp, 1.0 - rho) / (1.0 - rho)
        b = torch.pow(pp, 2.0 - rho) / (2.0 - rho)
        return -a + b
    if n in ("binary_logloss", "cross_entropy"):
        pp = torch.clamp(p, _EPS, 1.0 - _EPS_HI)
        return -(y * torch.log(pp) + (1.0 - y) * torch.log(1.0 - pp))
    if n == "binary_error":
        return ((p > 0.5) != (y > 0)).to(torch.float32)
    if n == "kullback_leibler":
        pp = torch.clamp(p, _EPS, 1.0 - _EPS_HI)
        yy = torch.clamp(y, _EPS, 1.0 - _EPS_HI)
        return (yy * torch.log(yy / pp) +
                (1.0 - yy) * torch.log((1.0 - yy) / (1.0 - pp)))
    raise KeyError(n)


def _supported(m, num_class: int) -> bool:
    n = getattr(m, "name", None)
    if num_class > 1:
        return n in _MULTI
    return n in _POINTWISE


class _SetEval:
    """fn(traj [b, N] | [b, N, k]) -> [b, len(ms)] f32 for one valid set's
    metric list: each metric of every trajectory point at once."""

    def __init__(self, ms, obj, num_class: int, device: torch.device):
        self.ms, self.obj = ms, obj
        self.label = torch.as_tensor(np.asarray(ms[0].label, np.float32),
                                     device=device)
        self.weight = None if ms[0].weight is None else torch.as_tensor(
            np.asarray(ms[0].weight, np.float32), device=device)
        self.sum_weight = float(ms[0].sum_weight)
        self.idx = None
        if num_class > 1:
            self.idx = torch.as_tensor(
                np.asarray(ms[0].label).astype(np.int64), device=device)

    def _avg(self, loss: torch.Tensor) -> torch.Tensor:
        if self.weight is None:
            return torch.mean(loss, dim=1)
        return torch.sum(loss * self.weight, dim=1) / self.sum_weight

    def __call__(self, s: torch.Tensor) -> torch.Tensor:
        conv = None   # convert_output(s), computed once, shared

        def converted():
            nonlocal conv
            if conv is None:
                conv = self.obj.convert_output_device(s) \
                    if self.obj is not None else s
            return conv

        vals = []
        for m in self.ms:
            if m.name == "multi_logloss":
                idx = self.idx.expand(s.shape[0], -1).unsqueeze(2)
                pt = torch.gather(converted(), 2, idx)[..., 0]
                vals.append(self._avg(-torch.log(
                    torch.clamp(pt, min=_EPS))))
            elif m.name == "multi_error":
                k = int(m.config.multi_error_top_k)
                idx = self.idx.expand(s.shape[0], -1).unsqueeze(2)
                tp = torch.gather(s, 2, idx)
                rank = (s > tp).sum(dim=2)
                vals.append(self._avg((rank >= k).to(torch.float32)))
            else:
                p = converted() if getattr(m, "convert_score", True) else s
                v = self._avg(_point_loss(m, p, self.label))
                if m.name == "rmse":
                    v = torch.sqrt(v)
                vals.append(v)
        return torch.stack(vals, dim=1)


class DeviceEval:
    """Per-valid-set trajectory evaluators plus what the host needs to
    rebuild engine.train's evaluation_result_list protocol."""

    def __init__(self, fns, names, valid_names):
        self.fns = fns                # per valid set: fn(traj) -> [b, nm]
        self.names = names            # per valid set: metric name list
        self.valid_names = valid_names

    def dispatch(self, trajs) -> List[Optional[torch.Tensor]]:
        """Launch the metric reductions of every valid set; returns device
        tensors without a sync."""
        return [fn(trajs[vi]) if fn is not None else None
                for vi, fn in enumerate(self.fns)]

    def evlist_at(self, mhost: List[Optional[np.ndarray]], j: int) -> List:
        """(valid_name, metric_name, value, higher_better) tuples for inner
        iteration j, collapsing duplicate metric names as GBDT._eval does
        and shaped as Booster.eval_valid's tuples."""
        res = []
        for vi, vn in enumerate(self.valid_names):
            if mhost[vi] is None:
                continue
            vals = {}
            for mi, name in enumerate(self.names[vi]):
                vals[name] = float(mhost[vi][j, mi])
            for name, v in vals.items():
                higher = name.split("@")[0] in (
                    "auc", "ndcg", "map", "average_precision", "auc_mu")
                res.append((vn, name, v, higher))
        return res


def build_device_eval(booster) -> Optional[DeviceEval]:
    """DeviceEval over every valid set of `booster`, or None when any
    metric anywhere has no device form (host evaluation)."""
    gb = booster.gbdt
    valid_metrics = getattr(gb, "valid_metrics", None)
    if not valid_metrics:
        return None
    num_class = int(getattr(gb, "num_tree_per_iteration", 1))
    for ms in valid_metrics:
        for m in ms:
            if not _supported(m, num_class):
                return None
    fns, names = [], []
    for ms in valid_metrics:
        if not ms:
            fns.append(None)
            names.append([])
            continue
        fns.append(_SetEval(ms, gb.objective, num_class, gb.device))
        names.append([m.name for m in ms])
    return DeviceEval(fns, names, list(booster.name_valid_sets))
