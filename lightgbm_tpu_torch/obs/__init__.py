"""Training telemetry: the counter and gauge registry.

Counterpart of the ``metrics`` pillar of ``lightgbm_tpu/obs``.  The
JAX package's trace spans, phase timers, memory sampling and event journal
are not ported yet: ``Booster.telemetry()`` reports empty ``phases`` and
``memory``.
"""

from .metrics import MetricsRegistry, count_event, global_metrics

__all__ = ["MetricsRegistry", "global_metrics", "count_event"]
