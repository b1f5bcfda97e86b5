"""Training callbacks: evaluation logging and recording, early stopping.

Counterpart of ``log_evaluation``, ``record_evaluation``,
``early_stopping`` and ``EarlyStopException`` of ``lightgbm_tpu/callback.py``
(reference python-package/lightgbm/callback.py, ``CallbackEnv``
namedtuple).  The three carry ``fused_safe``: they only read each round's
evaluation list, so the fused round loop (engine.py, ``GBDT.train_fused``)
drives them once per round with the metrics it evaluated on the device.
``early_stopping`` also carries ``es_params``, from which the fused loop
keeps its own stop flag inside the round.  Parameter resets and telemetry
come later.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List

from .utils import log

CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


class EarlyStopException(Exception):
    """Raised by :func:`early_stopping` to end training."""

    def __init__(self, best_iteration: int, best_score):
        super().__init__(best_iteration)
        self.best_iteration = best_iteration
        self.best_score = best_score


def log_evaluation(period: int = 1) -> Callable:
    """Log the evaluation results every ``period`` iterations."""
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list and \
                (env.iteration + 1) % period == 0:
            parts = [f"{item[0]}'s {item[1]}: {item[2]:g}"
                     for item in env.evaluation_result_list]
            log.info(f"[{env.iteration + 1}]\t" + "\t".join(parts))
    _callback.order = 10
    _callback.fused_safe = True
    return _callback


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]
                      ) -> Callable:
    """Record every round's evaluation results into ``eval_result``
    (``{set name: {metric: [values]}}``)."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _init(env: CallbackEnv) -> None:
        eval_result.clear()
        for item in env.evaluation_result_list:
            eval_result.setdefault(item[0], collections.OrderedDict())
            eval_result[item[0]].setdefault(item[1], [])

    def _callback(env: CallbackEnv) -> None:
        if not eval_result:
            _init(env)
        for item in env.evaluation_result_list:
            name, metric, val = item[0], item[1], item[2]
            eval_result.setdefault(name, collections.OrderedDict())
            eval_result[name].setdefault(metric, []).append(val)
    _callback.order = 20
    _callback.fused_safe = True
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True, min_delta: float = 0.0) -> Callable:
    """Stop when no evaluation metric improved by more than ``min_delta``
    in ``stopping_rounds`` rounds (reference callback.py:278)."""
    state: Dict[str, Any] = {}

    def _is_better(curr, best, bigger, delta):
        if bigger:
            return curr > best + delta
        return curr < best - delta

    def _init(env: CallbackEnv) -> None:
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one dataset and eval metric is "
                "required for evaluation")
        m = len(env.evaluation_result_list)
        state["best_score"] = [None] * m
        state["best_iter"] = [0] * m
        state["best_list"] = [None] * m
        state["first_metric"] = env.evaluation_result_list[0][1]
        if verbose:
            log.info(f"Training until validation scores don't improve for "
                     f"{stopping_rounds} rounds")

    def _callback(env: CallbackEnv) -> None:
        # a new train() run starts afresh (one callback object may serve
        # several runs)
        if env.iteration == env.begin_iteration:
            state.clear()
        if not state:
            _init(env)
        best_score = state["best_score"]
        best_iter = state["best_iter"]
        for i, item in enumerate(env.evaluation_result_list):
            name, metric, val, bigger = item[0], item[1], item[2], item[3]
            if name == "training":
                continue
            if first_metric_only and metric.split("@")[0] != \
                    state["first_metric"].split("@")[0]:
                continue
            if best_score[i] is None or _is_better(val, best_score[i], bigger,
                                                   min_delta):
                best_score[i] = val
                best_iter[i] = env.iteration
                state["best_list"][i] = list(env.evaluation_result_list)
            elif env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    log.info(f"Early stopping, best iteration is: "
                             f"[{best_iter[i] + 1}]")
                raise EarlyStopException(best_iter[i], state["best_list"][i])
            if env.iteration == env.end_iteration - 1:
                if verbose:
                    log.info(f"Did not meet early stopping. Best iteration is:"
                             f" [{best_iter[i] + 1}]")
                raise EarlyStopException(best_iter[i], state["best_list"][i])
    _callback.order = 30
    _callback.fused_safe = True
    # the fused loop's stop flag inside the round mirrors these
    _callback.es_params = (stopping_rounds, first_metric_only, min_delta)
    return _callback
