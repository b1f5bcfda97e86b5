"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

The same ``Dataset`` / ``train()`` / ``Booster`` surface, config keys and
model text format as ``lightgbm_tpu``, written in PyTorch, with every
kernel of the training path, and the forest predictor and TreeSHAP of
``Booster.predict``, hand-written in CUDA C++ for Hopper (``csrc/``,
built with ``nvcc`` on first use).  Training runs on the CUDA device
unless ``device_type=cpu`` is passed; there the kernels' plain PyTorch
versions run.  The sklearn estimators, the plots and the CLI
(``python -m lightgbm_tpu_torch``) sit on the same surface.  This package
never imports jax or lightgbm_tpu.
"""

from .config import Config
from .utils.log import LightGBMError, register_logger

__version__ = "0.1.0"

from .basic import Booster, Dataset, Sequence  # noqa: E402
from .callback import (EarlyStopException, early_stopping,  # noqa: E402
                       log_evaluation, record_evaluation, reset_parameter)
from .engine import CVBooster, cv, train  # noqa: E402

try:  # the estimators need numpy only; kept optional as in lightgbm_tpu
    from .sklearn import (LGBMClassifier, LGBMModel,  # noqa: E402
                          LGBMRanker, LGBMRegressor)
except ImportError:  # pragma: no cover
    pass

try:  # matplotlib / graphviz are imported inside the plotting functions
    from .plotting import (create_tree_digraph, plot_importance,  # noqa: E402
                           plot_metric, plot_split_value_histogram, plot_tree)
except ImportError:  # pragma: no cover
    pass

__all__ = ["Config", "Dataset", "Booster", "Sequence", "train", "cv",
           "CVBooster", "log_evaluation", "record_evaluation",
           "early_stopping", "reset_parameter", "EarlyStopException",
           "LightGBMError", "register_logger",
           "LGBMModel", "LGBMClassifier", "LGBMRegressor", "LGBMRanker",
           "plot_importance", "plot_split_value_histogram", "plot_metric",
           "plot_tree", "create_tree_digraph"]
