"""Boosting drivers (reference src/boosting/boosting.cpp:34 factory)."""

from ..config import Config
from ..io.dataset import Dataset
from ..utils import log
from .gbdt import GBDT


def create_boosting(config: Config, train_set: Dataset) -> GBDT:
    """reference Boosting::CreateBoosting; only gbdt is ported."""
    if config.boosting != "gbdt":
        log.fatal(f"boosting={config.boosting} is not supported by "
                  "lightgbm_tpu_torch yet")
    return GBDT(config, train_set)
