"""Training callbacks: evaluation logging.

Counterpart of ``log_evaluation`` of ``lightgbm_tpu/callback.py`` (reference python-package/lightgbm/callback.py
``CallbackEnv`` namedtuple).  Evaluation recording, early
stopping, parameter resets and telemetry come later.
"""

from __future__ import annotations

import collections
from typing import Callable

from .utils import log

CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def log_evaluation(period: int = 1) -> Callable:
    """Log the evaluation results every ``period`` iterations."""
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list and \
                (env.iteration + 1) % period == 0:
            parts = [f"{name}'s {metric}: {val:g}"
                     for name, metric, val, _ in env.evaluation_result_list]
            log.info(f"[{env.iteration + 1}]\t" + "\t".join(parts))
    _callback.order = 10
    return _callback
