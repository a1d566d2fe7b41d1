"""Objective functions: per-row gradient/hessian computation in PyTorch.

Port of the regression-L2 and binary subset of lightgbm_tpu/objectives.py
(reference src/objective/regression_objective.hpp,
binary_objective.hpp:105-135). Labels and weights live on the training
device as f32 tensors; `get_gradients(score)` runs there, in f32, with the
JAX package's operation order:

  regression L2: grad = score - label, hess = 1 (constant hessian)
  binary:        response = -y*sigma / (1 + exp(y*sigma*score)),
                 hess = |r| * (sigma - |r|), y in {-1, +1}

Objective "none" (a custom objective: engine.train sets it for fobj) makes
no objective; the caller supplies the gradients. `convert_output` maps raw
host scores (f32 numpy) to predictions for the metrics, in f32 as the JAX
package's does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config
from .data import Metadata
from .utils.log import Log

__all__ = ["ObjectiveFunction", "RegressionL2", "BinaryLogloss",
           "create_objective", "SUPPORTED_OBJECTIVES"]

_EPS = 1e-15


class ObjectiveFunction:
    """Base class (reference include/LightGBM/objective_function.h)."""

    name = "custom"
    is_constant_hessian = False
    # per-row hessian constant promised when is_constant_hessian: the
    # kernels reconstruct hessian sums as constant x count
    constant_hessian_value = 1.0

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
        self._label_np = metadata.label
        self._weight_np = metadata.weight
        self.label = torch.as_tensor(metadata.label, device=device)
        self.weight = None if metadata.weight is None else \
            torch.as_tensor(metadata.weight, device=device)

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


class BinaryLogloss(ObjectiveFunction):
    name = "binary"

    def __init__(self, config: Config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        self.is_unbalance = bool(config.is_unbalance)
        self.scale_pos_weight = float(config.scale_pos_weight)
        if self.is_unbalance and self.scale_pos_weight != 1.0:
            Log.fatal("Cannot set is_unbalance and scale_pos_weight "
                      "at the same time")

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        pos = self._label_np > 0
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


# objective names the port trains, with their aliases (the subset of the
# JAX package's OBJECTIVE_ALIASES that maps to regression or binary)
SUPPORTED_OBJECTIVES = {
    "regression": "regression", "regression_l2": "regression",
    "l2": "regression", "mean_squared_error": "regression",
    "mse": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "binary": "binary", "none": "none", "null": "none", "custom": "none",
    "na": "none",
}


def create_objective(name: str,
                     config: Config) -> Optional[ObjectiveFunction]:
    """The objective `name` names, or None for "none" (gradients from the
    caller)."""
    canonical = SUPPORTED_OBJECTIVES.get(name)
    if canonical is None:
        raise NotImplementedError(
            f"objective={name!r} is not ported to lightgbm_tpu_torch yet: "
            "it trains regression and binary (ROADMAP.md port queue P7)")
    if canonical == "none":
        return None
    if name in ("l2_root", "rmse", "root_mean_squared_error"):
        config.reg_sqrt = True
    return RegressionL2(config) if canonical == "regression" \
        else BinaryLogloss(config)
