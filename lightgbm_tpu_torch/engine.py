"""Training entry point: ``train()``.

Counterpart of ``lightgbm_tpu/engine.py`` ``train`` (reference
python-package/lightgbm/engine.py:109) with its classic per-iteration loop:
construct the datasets, build the booster, then per round update, evaluate
the valid sets on the host and run the callbacks.  The fused multi-round
scan, early stopping, continued training, ``cv`` and custom objectives or
eval functions come later.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

from .basic import Booster, Dataset
from .callback import CallbackEnv
from .config import normalize_params
from .utils import log


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[Sequence[Dataset]] = None,
          valid_names: Optional[Sequence[str]] = None,
          callbacks: Optional[List[Callable]] = None) -> Booster:
    """Train a booster (reference engine.py:109).  Runs on the CUDA device
    unless ``device_type=cpu`` is given; without a card that raises."""
    params = normalize_params(params)
    if "num_iterations" in params:
        num_boost_round = params["num_iterations"]
    params["num_iterations"] = num_boost_round
    booster = Booster(params=params, train_set=train_set)

    names = list(valid_names or [])
    train_in_valid = False
    for i, vs in enumerate(valid_sets or []):
        name = names[i] if i < len(names) else f"valid_{i}"
        if vs is train_set:
            train_in_valid = True
            continue
        booster.add_valid(vs, name)

    callbacks = sorted(callbacks or [], key=lambda cb: getattr(cb, "order",
                                                               0))
    evals: List = []
    for it in range(num_boost_round):
        finished = booster.update()
        evals = []
        if train_in_valid or booster._gbdt.config.is_provide_training_metric:
            evals.extend(booster.eval_train())
        evals.extend(booster.eval_valid())
        for cb in callbacks:
            cb(CallbackEnv(booster, params, it, 0, num_boost_round, evals))
        if finished:
            log.warning("Stopped training because there are no more "
                        "leaves that meet the split requirements")
            break
    booster.best_score = {}
    for name, metric, val, _ in evals:
        booster.best_score.setdefault(name, {})[metric] = val
    return booster
