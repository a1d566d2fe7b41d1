"""Segment-sum histograms: the hist_backend="scatter" backend.

Port of lightgbm_tpu/learner/histogram.py, the JAX package's plain XLA
oracle: rows scatter-add (grad, hess, count) into cells keyed by
(slot, feature, bin), one block of features at a time to bound the
[N x block] index buffer. Plain torch (`index_add_`), as the JAX version is
plain XLA — a backend of its own, not a kernel's plain version.

Sums run in float64 and are rounded to f32 once, so integer (quantized)
gradient sums come out exact whatever order the adds take, bit for bit
equal to the integer kernels' sums converted to f32.
"""

from __future__ import annotations

import torch

__all__ = ["build_histograms"]

#: features per index_add_ pass: bounds the [N x block] index buffer
_FEATURE_BLOCK = 8


def build_histograms(bins: torch.Tensor, grad: torch.Tensor,
                     hess: torch.Tensor, row_slot: torch.Tensor,
                     cnt: torch.Tensor = None, *, num_slots: int,
                     bmax: int) -> torch.Tensor:
    """Per-slot histograms [num_slots, F, bmax, 3] f32 (sum grad, sum hess,
    count) of an unpacked [N, F] bin matrix; rows whose slot is < 0 or >=
    num_slots go nowhere. grad/hess: [N], any real dtype (int8 quantized
    gradients included); cnt: [N] count weights, default 1."""
    n, f = bins.shape
    dev = bins.device
    if cnt is None:
        cnt = torch.ones(n, dtype=torch.float32, device=dev)
    data = torch.stack([grad.to(torch.float64), hess.to(torch.float64),
                        cnt.to(torch.float64)], dim=1)            # [N, 3]
    rows = torch.nonzero((row_slot >= 0) & (row_slot < num_slots))[:, 0]
    slot = row_slot[rows].to(torch.int64)
    data = data[rows]
    hist = torch.zeros((num_slots, f, bmax, 3), dtype=torch.float64,
                       device=dev)
    flat = hist.view(-1, 3)
    brows = bins[rows]
    fb = max(1, min(_FEATURE_BLOCK, f))
    for f0 in range(0, f, fb):
        js = torch.arange(f0, min(f0 + fb, f), device=dev)
        ids = (slot[:, None] * f + js[None, :]) * bmax + \
            brows[:, f0:f0 + fb].to(torch.int64)                  # [Nv, fb]
        flat.index_add_(0, ids.reshape(-1),
                        data[:, None, :].expand(-1, js.numel(), 3)
                        .reshape(-1, 3))
    return hist.to(torch.float32)
