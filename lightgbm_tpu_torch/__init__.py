"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

The same ``Dataset`` / ``train()`` / ``Booster`` surface, config keys and
model text format as ``lightgbm_tpu``, written in PyTorch, with every
kernel of the training path hand-written in CUDA C++ for Hopper
(``csrc/``, built with ``nvcc`` on first use).  Training runs on the CUDA
device unless ``device_type=cpu`` is passed; there the kernels' plain
PyTorch versions run.  This package never imports jax or lightgbm_tpu.
"""

from .config import Config
from .utils.log import LightGBMError, register_logger

__version__ = "0.1.0"

from .basic import Booster, Dataset  # noqa: E402
from .callback import log_evaluation  # noqa: E402
from .engine import train  # noqa: E402

__all__ = ["Config", "Dataset", "Booster", "train", "log_evaluation",
           "LightGBMError", "register_logger"]
