"""Training entry point: ``train()``.

Counterpart of ``lightgbm_tpu/engine.py`` ``train`` / ``_run_training``
(reference python-package/lightgbm/engine.py:109): construct the datasets,
build the booster, then run the boosting rounds.  Where every callback is
``fused_safe`` (none at all, or only ``log_evaluation`` /
``record_evaluation`` / ``early_stopping``, which read the evaluation list)
and ``GBDT.supports_fused`` admits the configuration, the rounds run as the
fused loop (``GBDT.train_fused``: one CUDA graph replay a round on the
card, the callbacks driven once a round with the metrics evaluated on the
device); otherwise the classic loop updates, evaluates and calls back once
a round.  Both set ``best_iteration`` and ``best_score`` as the JAX
package does.  Continued training, ``cv`` and custom objectives or eval
functions come later.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

from .basic import Booster, Dataset
from .callback import CallbackEnv, EarlyStopException
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
    n_valid = 0
    for i, vs in enumerate(valid_sets or []):
        name = names[i] if i < len(names) else f"valid_{i}"
        if vs is train_set:
            train_in_valid = True
            continue
        booster.add_valid(vs, name)
        n_valid += 1

    callbacks = sorted(callbacks or [], key=lambda cb: getattr(cb, "order",
                                                               0))
    return _run_training(booster, params, num_boost_round, n_valid,
                         train_in_valid, callbacks)


def _run_training(booster: Booster, params, num_boost_round: int,
                  n_valid: int, train_in_valid: bool,
                  callbacks: List[Callable]) -> Booster:
    """The boosting rounds of ``train()``: the fused loop where it may run
    (the JAX package's gate), the classic loop otherwise."""
    gbdt = booster._gbdt
    fused_safe = all(getattr(cb, "fused_safe", False) for cb in callbacks)
    if (fused_safe and not train_in_valid and num_boost_round > 0
            and not gbdt.config.is_provide_training_metric
            and (not n_valid or callbacks)
            and gbdt.supports_fused()):
        es_params = next((cb.es_params for cb in callbacks
                          if getattr(cb, "es_params", None)), None)

        def cb_driver(it, evals):
            for cb in callbacks:
                cb(CallbackEnv(booster, params, it, 0, num_boost_round,
                               evals))
        try:
            finished = gbdt.train_fused(
                num_boost_round, cb_driver=cb_driver if callbacks else None,
                es_params=es_params)
        except EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            _set_best_score(booster, e.best_score)
            return booster
        if finished:
            log.warning("Stopped training because there are no more "
                        "leaves that meet the split requirements")
        if booster.best_iteration <= 0:
            _set_best_score(booster, gbdt._last_fused_evals)
        return booster

    evals: List = []
    for it in range(num_boost_round):
        finished = booster.update()
        evals = []
        if train_in_valid or gbdt.config.is_provide_training_metric:
            evals.extend(booster.eval_train())
        evals.extend(booster.eval_valid())
        try:
            for cb in callbacks:
                cb(CallbackEnv(booster, params, it, 0, num_boost_round,
                               evals))
        except EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            _set_best_score(booster, e.best_score)
            break
        if finished:
            log.warning("Stopped training because there are no more "
                        "leaves that meet the split requirements")
            break
    if booster.best_iteration <= 0:
        # unset without early stopping: predict() and save_model() then
        # use every tree
        _set_best_score(booster, evals)
    return booster


def _set_best_score(booster: Booster, evals) -> None:
    booster.best_score = {}
    for item in evals or []:
        booster.best_score.setdefault(item[0], {})[item[1]] = item[2]
