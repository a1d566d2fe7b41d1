"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

Histogram GBDT training on an NVIDIA GPU through hand-written CUDA kernels
(csrc/), with the JAX package's API and model text format. The package
imports torch and numpy, never JAX or lightgbm_tpu. See README.md ("PyTorch
/ CUDA port") for what this slice covers.
"""

__version__ = "0.1.0"

from . import callback
from .basic import Booster, Dataset
from .callback import (EarlyStopException, early_stopping, log_evaluation,
                       record_evaluation, reset_parameter)
from .config import Config
from .engine import train
from .utils.log import LightGBMError, register_logger

__all__ = ["Dataset", "Booster", "train", "Config", "LightGBMError",
           "register_logger", "callback", "EarlyStopException",
           "early_stopping", "log_evaluation", "record_evaluation",
           "reset_parameter", "__version__"]
