"""Boosting drivers (reference src/boosting/boosting.cpp:34 factory)."""

from ..config import Config
from ..io.dataset import Dataset
from ..utils import log
from .gbdt import GBDT


def create_boosting(config: Config, train_set: Dataset) -> GBDT:
    """reference Boosting::CreateBoosting: gbdt, dart or rf (``boosting=
    goss`` is gbdt with ``data_sample_strategy=goss``, config.py)."""
    from .dart import DART
    from .rf import RF
    kind = config.boosting
    if kind == "gbdt":
        return GBDT(config, train_set)
    if kind == "dart":
        return DART(config, train_set)
    if kind == "rf":
        return RF(config, train_set)
    log.fatal(f"Unknown boosting type: {kind}")
