"""Device-utilization accounting: MACs -> achieved TFLOP/s -> MFU.

Port of lightgbm_tpu/observability/mfu.py. The JAX package's MXU
histogram kernel has its arithmetic in closed form: one build pass over
N rows at frontier capacity S costs

    MACs = nchan * S * N * F * B_pad

bf16 multiply-accumulates of its one-hot matmul (nchan: 5 with
double-bf16 sums, 4 single-bf16, 3 quantized, 2 quantized +
constant-hessian), and `tree_macs` sums the batched grower's
deterministic doubling schedule plus the bridge pass. The functions are
ported as they are, for parity and for a matmul-shaped kernel to come.

The port's histogram kernels are scatter-shaped (K1: route, partition
and shared-memory atomics; K3/K4 and K7 likewise): they never perform
those MACs, so the registry's tree_macs_for is 0 on every path and MFU
reads as unavailable rather than invented (ROADMAP C21), as the JAX
package does for its own scatter kernels.

MFU = achieved TFLOP/s / the device's dense bf16 peak
(`device_peak_tflops`; `LGBM_TPU_PEAK_TFLOPS` overrides the table).
"""

from __future__ import annotations

import math
import os
import threading
from typing import Dict, Optional

__all__ = ["hist_channels", "histogram_macs", "tree_macs",
           "achieved_tflops", "mfu_fraction", "device_peak_tflops",
           "DeviceUtilization"]

# dense bf16 peak TFLOP/s per CUDA device, by a substring of its
# lower-cased name (most specific first). Sources: NVIDIA H100 Tensor Core
# GPU Architecture whitepaper, H100 SXM5, "Peak BF16 Tensor TFLOPS with
# FP32 Accumulate" 989.4 (1978.9 with sparsity); NVIDIA H100 datasheet,
# H100 PCIe, "BF16 Tensor Core" 1,513 teraFLOPS with sparsity (756.5
# dense). The JAX package's table holds TPU generations, which no CUDA
# device name matches.
_PEAK_TFLOPS_BF16 = (
    ("h100 pcie", 756.5),
    ("h100", 989.4),
)


def device_peak_tflops(device=None) -> float:
    """Dense bf16 peak of the device (default: CUDA device 0); 0.0 when
    unknown (the CPU, no card) so downstream MFU reads as unavailable
    rather than wrong. LGBM_TPU_PEAK_TFLOPS env overrides."""
    env = os.environ.get("LGBM_TPU_PEAK_TFLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    try:
        import torch
        if device is not None and torch.device(device).type != "cuda":
            return 0.0
        if not torch.cuda.is_available():
            return 0.0
        kind = str(torch.cuda.get_device_name(device)).lower()
    except Exception:
        return 0.0
    for pat, tf in _PEAK_TFLOPS_BF16:
        if pat in kind:
            return tf
    return 0.0


def hist_channels(*, double_prec: bool = True, quantized: bool = False,
                  const_hess: bool = False) -> int:
    """Histogram dot channels — the JAX package's fits_v2 nchan logic
    (lightgbm_tpu/learner/histogram_mxu.py): [g_hi, g_lo, h_hi, h_lo,
    cnt] double-bf16, [g, h, cnt] single/quantized, minus the hessian
    channel(s) under the constant-hessian fast path."""
    if const_hess:
        return 2 if quantized else 3
    return 3 if quantized else (5 if double_prec else 4)


def _lane_pad(x: int) -> int:
    return ((int(x) + 127) // 128) * 128


def histogram_macs(*, num_slots: int, num_rows: int, num_features: int,
                   bmax: int, nchan: int,
                   row_block: int = 4096) -> int:
    """MACs of ONE histogram build pass: nchan * S * N_pad * F * B_pad
    (N padded to the row block the kernel grids over)."""
    n_pad = ((int(num_rows) + row_block - 1) // row_block) * row_block
    return int(nchan) * int(num_slots) * n_pad * int(num_features) * \
        _lane_pad(bmax)


def tree_macs(*, num_leaves: int, num_rows: int, num_features: int,
              bmax: int, double_prec: bool = True,
              quantized: bool = False, const_hess: bool = False,
              hist_subtraction: bool = True, overshoot: float = 2.0,
              bridge_gate: float = 0.0, row_block: int = 4096) -> int:
    """Estimated histogram MACs to grow one tree on the JAX package's MXU
    path.

    Sums the grower's deterministic doubling schedule (grower_mxu.py:
    S = min(2*s, s_max) for s = 1, 2, 4, ... while s < s_max) plus the
    full-capacity bridge pass; sibling subtraction builds only the
    smaller child per pair, halving the slots per pass. A nonzero
    bridge_gate skips the bridge for on-schedule trees — the estimate
    keeps it (data-dependent skip), so treat the result as the
    no-skip schedule cost. Fixup passes (data-dependent, ~0 at the
    bench posture) are excluded."""
    over = overshoot if overshoot and overshoot >= 1.0 else 0.0
    L_g = int(math.ceil(num_leaves * over)) if over else int(num_leaves)
    s_max = L_g + 1
    nchan = hist_channels(double_prec=double_prec, quantized=quantized,
                          const_hess=const_hess)
    slots = 0
    s = 1
    passes = 0
    while s < s_max and passes < 32:
        s_p = min(max(2 * s, 2), s_max)
        slots += (s_p + 1) // 2 if hist_subtraction else s_p
        s *= 2
        passes += 1
    if over:
        # bridge pass at full capacity (skipped per-tree when
        # bridge_gate is already satisfied; counted here — see above)
        slots += (s_max + 1) // 2 if hist_subtraction else s_max
    return histogram_macs(num_slots=slots, num_rows=num_rows,
                          num_features=num_features, bmax=bmax,
                          nchan=nchan, row_block=row_block)


def achieved_tflops(macs_per_second: float) -> float:
    """1 MAC = 2 FLOPs; returns TFLOP/s."""
    return 2.0 * float(macs_per_second) / 1e12


def mfu_fraction(tflops: float, peak_tflops: Optional[float] = None
                 ) -> Optional[float]:
    """Model-flops-utilization in [0, 1]; None when the peak is
    unknown (never report a made-up denominator)."""
    peak = device_peak_tflops() if peak_tflops is None else peak_tflops
    if not peak or peak <= 0:
        return None
    return float(tflops) / float(peak)


class DeviceUtilization:
    """Accumulates estimated MACs + wall seconds; thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self.macs = 0
        self.trees = 0
        self.seconds = 0.0

    def add(self, macs: int, seconds: float, trees: int = 1) -> None:
        with self._lock:
            self.macs += int(macs)
            self.seconds += float(seconds)
            self.trees += int(trees)

    def reset(self) -> None:
        with self._lock:
            self.macs = 0
            self.trees = 0
            self.seconds = 0.0

    def snapshot(self) -> Dict:
        with self._lock:
            macs, secs, trees = self.macs, self.seconds, self.trees
        tf = achieved_tflops(macs / secs) if secs > 0 else 0.0
        peak = device_peak_tflops()
        frac = mfu_fraction(tf, peak) if macs else None
        return {
            "estimated_macs": macs,
            "trees": trees,
            "train_seconds": round(secs, 6),
            "achieved_tflops": round(tf, 6),
            "device_peak_tflops": peak,
            "mfu": round(frac, 8) if frac is not None else None,
        }
