"""Numeric guards: a per-round finite check with a configurable policy.

Counterpart of ``lightgbm_tpu/robustness/guards.py``.  Each boosting round
of the classic loop can be checked before its trees grow: one finite
reduction over the round's gradients, hessians and incoming score cache on
the booster's device and a single host read of its flag (nothing at the
default ``nan_policy=none``).  The arrays never leave the device.

Policies (``nan_policy``):

  * ``none``  -- no checks (the fused loop stays eligible),
  * ``raise`` -- a ``LightGBMError`` naming the round,
  * ``skip_round`` -- log and count the round, grow no trees, continue,
  * ``halt_and_keep_best`` -- stop training and keep every completed
    round (the engine records the last good round as ``best_iteration``).

Every trip bumps the booster's counters (obs/metrics.py), read through
``Booster.telemetry()``.
"""

from __future__ import annotations

import torch

from ..utils import log
from ..utils.log import LightGBMError

class NumericHalt(Exception):
    """Raised by ``nan_policy=halt_and_keep_best`` when a round fails the
    finite check; the engine catches it, keeps every completed round and
    stops training."""

    def __init__(self, iteration: int):
        super().__init__(f"numeric halt at boosting round {iteration}")
        self.iteration = iteration


def round_is_finite(*arrays) -> bool:
    """True when every given tensor is all-finite: the reductions stay on
    the tensors' device and one flag is read."""
    ok = None
    for a in arrays:
        if a is not None:
            fin = torch.isfinite(a).all()
            ok = fin if ok is None else ok & fin
    return True if ok is None else bool(ok)


def enforce_nan_policy(gb, grad, hess) -> bool:
    """Check one round's gradients, hessians and score cache and apply the
    booster's ``nan_policy``.  True when the round must be skipped; raises
    for ``raise`` and ``halt_and_keep_best``; False when the round is clean
    (or the policy is ``none``)."""
    policy = getattr(gb, "nan_policy", "none")
    if policy == "none":
        return False
    if round_is_finite(grad, hess, gb.scores):
        return False
    it = gb.iter_
    gb._count("nan_guard_trips")
    if policy == "raise":
        gb._count("nan_guard_raises")
        raise LightGBMError(
            f"nan_policy=raise: non-finite gradients/hessians/scores at "
            f"boosting round {it}")
    if policy == "skip_round":
        gb._count("nan_rounds_skipped")
        log.warning(f"non-finite gradients/hessians/scores at boosting "
                    f"round {it}; skipping the round "
                    "(nan_policy=skip_round)")
        return True
    gb._count("nan_guard_halts")
    log.warning(f"non-finite gradients/hessians/scores at boosting "
                f"round {it}; halting training and keeping the "
                f"{it} completed round(s) (nan_policy=halt_and_keep_best)")
    raise NumericHalt(it)
