"""Process- and booster-scoped telemetry counters and gauges.

Counterpart of ``lightgbm_tpu/obs/metrics.py``: counters are monotone
within a registry's lifetime, gauges carry the last sampled value.  Two
scopes: ``global_metrics`` (process-wide) and one registry per booster
(``GBDT.metrics``), read through ``Booster.telemetry()``.  Counters are
bumped on coarse host paths only (once a round or a decision), never inside
a captured round.  The port's counters: ``iterations``, ``strict_rounds``,
``fused_rounds``, ``trees_grown``, ``hist_build_rounds``,
``quantize_rounds``, ``fused_runner_cache_hits`` / ``_misses`` (a fused
``train()`` reusing or capturing its round) and the numeric guard's
``nan_guard_trips``, ``nan_guard_raises``, ``nan_rounds_skipped``,
``nan_guard_halts``.  Nothing in the port sets a gauge yet.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional


class MetricsRegistry:
    __slots__ = ("_counters", "_gauges", "_lock")

    def __init__(self) -> None:
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        # the global registry is shared by boosters training on several
        # threads: an unlocked read-modify-write drops increments
        self._lock = threading.Lock()

    def inc(self, name: str, value: float = 1) -> None:
        """Bump a monotone counter."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Copy of the current state."""
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges)}


#: process-wide registry
global_metrics = MetricsRegistry()


def count_event(name: str, value: float = 1,
                booster_metrics: Optional[MetricsRegistry] = None) -> None:
    """Bump ``name`` in the global registry and, when given, a booster's
    own registry."""
    global_metrics.inc(name, value)
    if booster_metrics is not None:
        booster_metrics.inc(name, value)
