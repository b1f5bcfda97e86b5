"""The serving predictor core (the JAX package's ``serving/``).

  * ``buckets.BucketLadder`` — requests pad up to a small geometric ladder
    of row counts (``serving_buckets`` config key), so every request runs
    at a shape the card has seen.
  * ``predictor.CompiledPredictor`` — one immutable model prepared for
    bucketed serving.  Exact mode computes leaf indices on the card (the
    forest kernel's leaves mode, ops/forest_kernels.py ``forest_leaves``)
    and finishes in host float64 — bit-identical to ``Booster.predict`` on
    the unpadded rows, linear leaves and all.  The C API's single-row fast
    path (capi_impl.py) runs through its bucket-1 form.
  * ``standalone.build_standalone`` — threshold tables straight from
    model text, no training Dataset required.

The HTTP server, the model registry and the replicated fleet
(``server.py``, ``registry.py``, ``fleet.py``) are not ported yet (ROADMAP
Queue 1 item 8).
"""

from .buckets import BucketLadder
from .predictor import CompiledPredictor, StandaloneUnsupported

__all__ = ["BucketLadder", "CompiledPredictor", "StandaloneUnsupported"]
