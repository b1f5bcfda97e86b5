"""One immutable model prepared for bucketed serving on the card.

The serving contract is two-sided:

  * **Bucket shapes only** — every chunk of a request runs at a bucket of
    the ladder (serving/buckets.py): the bins are padded to the bucket and
    copied into that bucket's device buffer, allocated once, so after one
    warm-up pass per bucket a request allocates no new device memory (the
    role the JAX package's compile cache and AOT store play for XLA
    programs; neither has a counterpart here).
  * **Bit-identity with ``Booster.predict``** — the default *exact* mode
    runs only the integer part on the device: per-tree leaf indices from
    the forest kernel's leaves mode (ops/forest_kernels.py
    ``forest_leaves``, one launch a chunk on the card; its plain version
    ``predict_forest_leaves`` on the CPU), then gathers leaf values and
    accumulates them per tree in host float64, the same arithmetic and
    order as the host walk (``Tree.values_from_leaf_index`` +
    ascending-tree accumulation).  Linear leaves ride the same host path.
    The leaf index does not depend on the operand type, so ``int8=`` is
    accepted and changes nothing.

Converted scores (``raw_score=False``) transform the raw margins on the
HOST in float64 (``basic._objective_string_transform``) — bitwise what a
text-loaded ``Booster.predict`` returns.  A TRAINED booster's own
``predict`` converts through the objective in float32, so for
sigmoid / softmax objectives the trained-vs-served converted scores agree
to float32 rounding rather than bitwise; raw margins are bitwise always.

The optional *fast* mode (``exact=False``) keeps the whole sum on the
device (the forest kernel's values mode, float32) — bit-identical to the
trained booster's own device predict (``GBDT._device_predict_raw``), and
padding-invariant, but float32 rather than the host walk's float64.
Linear models force exact mode.

The device is the trained booster's; a loaded model's comes from its
``params["device_type"]`` (the card unless ``cpu``), and its bin tables
and forest are the ones the Booster keeps for its own predict
(``Booster._standalone_forest``).  Request tracing
(``trace=``) and the AOT store (``aot_store=``) belong to the JAX
package's ``obs/`` and ``ops/`` layers (ROADMAP Queue 1 item 8) and raise.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs.metrics import MetricsRegistry, count_event
from ..utils import log
from .buckets import BucketLadder
from .standalone import StandaloneUnsupported


def _refuse_item8(what: str) -> None:
    log.fatal(f"{what} (the JAX package's request tracing / AOT store, "
              "ROADMAP Queue 1 item 8) is not supported by "
              "lightgbm_tpu_torch yet")


class RequestStats:
    """Per-request accounting the server turns into counters/JSONL."""

    __slots__ = ("rows", "chunks", "pad_rows", "warm_chunks", "fallback")

    def __init__(self) -> None:
        self.rows = 0
        self.chunks: List[Tuple[int, int]] = []  # (bucket, real rows)
        self.pad_rows = 0
        self.warm_chunks = 0
        self.fallback = False


class CompiledPredictor:
    """Immutable serving view of one model.

    Its forest and bucket buffers never change after construction — a
    hot-swap builds a NEW predictor, so in-flight requests keep predicting
    on the forest they resolved.  Device work of one predictor runs under
    its lock (the bucket buffers are shared by its requests).
    """

    def __init__(self, booster, *, ladder: Optional[BucketLadder] = None,
                 exact: bool = True, int8: bool = False,
                 metrics: Optional[MetricsRegistry] = None,
                 aot_store=None) -> None:
        from ..basic import Booster  # lazy: basic imports a lot
        if not isinstance(booster, Booster):
            raise log.LightGBMError(
                "CompiledPredictor requires a Booster (use from_model_text "
                "/ from_model_file for text artifacts)")
        if aot_store is not None:
            _refuse_item8("aot_store=")
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.ladder = ladder if ladder is not None else BucketLadder()
        self.int8 = bool(int8)
        self.k = max(1, booster.num_model_per_iteration())
        self.num_features = booster.num_feature()
        self.trees = list(booster._get_trees())
        self._warm: set = set()        # buckets already run
        self._lock = threading.Lock()
        self._bins_dev: Dict[int, torch.Tensor] = {}
        self._fallback = None          # host Booster when unsupported
        g = booster._gbdt
        if g is not None:
            from ..boosting.gbdt import forest_bitset_arrays
            from ..models.model_io import objective_to_string
            from ..models.predict import forest_from_numpy
            self.objective_str = objective_to_string(
                g.objective.NAME if g.objective else "none", g.config)
            self._binner = g.train_set.bin_external_pred
            fd, lin, self.cat_feats = forest_bitset_arrays(
                self.trees, self.k, g.train_set)
            self.device = g.device
            self.fb = forest_from_numpy(fd, self.device)
        else:
            self.objective_str = booster._loaded["objective"]
            tables = booster._standalone_forest(self.trees, self.k)
            if tables is None:
                # requests use the host booster
                self._fallback = booster
                self.fb = None
                self.cat_feats = ()
                self.exact = True
                return
            self._binner, self.fb, self.cat_feats = tables
            self.device = self.fb.feat.device
            lin = None
        self.exact = bool(exact)
        if not self.exact and (lin is not None
                               or any(t.is_linear for t in self.trees)):
            log.warning("serving: fast (device-sum) mode is not "
                        "padding-stable for linear leaves; using exact mode")
            self.exact = True

    # ------------------------------------------------------------ factories
    @classmethod
    def from_booster(cls, booster, **kw) -> "CompiledPredictor":
        return cls(booster, **kw)

    @classmethod
    def from_model_text(cls, model_str: str, params=None,
                        **kw) -> "CompiledPredictor":
        """``params``: the loaded Booster's (``device_type`` picks the
        device)."""
        from ..basic import Booster
        return cls(Booster(params=params, model_str=model_str), **kw)

    @classmethod
    def from_model_file(cls, model_file: str, params=None,
                        **kw) -> "CompiledPredictor":
        from ..basic import Booster
        return cls(Booster(params=params, model_file=model_file), **kw)

    # ------------------------------------------------------------- internals
    def _bins_on_device(self, bins: np.ndarray, rows: int,
                        bucket: int) -> torch.Tensor:
        """The chunk's bins padded to ``bucket``, feature-major i32
        [F, bucket], in the bucket's device buffer (made at its first
        use); on the CPU a tensor over the padded host array."""
        padded = np.zeros((bins.shape[1], bucket), np.int32)
        padded[:, :rows] = bins.T
        if self.device.type != "cuda":
            return torch.from_numpy(padded)
        buf = self._bins_dev.get(bucket)
        if buf is None:
            buf = torch.empty(padded.shape, dtype=torch.int32,
                              device=self.device)
            self._bins_dev[bucket] = buf
        buf.copy_(torch.from_numpy(padded))
        return buf

    def _leaves_for_chunk(self, bins: np.ndarray, rows: int,
                          bucket: int) -> np.ndarray:
        """Leaf indices for one bucket-padded chunk: i32 [T, rows]
        (padding sliced off)."""
        from ..ops import forest_kernels
        with self._lock:
            bins_t = self._bins_on_device(bins, rows, bucket)
            lv = forest_kernels.forest_leaves(self.fb, bins_t,
                                              self.cat_feats)
            return lv.cpu().numpy()[:, :rows]

    def _sums_for_chunk(self, bins: np.ndarray, rows: int,
                        bucket: int) -> np.ndarray:
        """Fast mode: the device float32 sums of one padded chunk,
        float64-cast and sliced — [rows, k]."""
        from ..ops import forest_kernels
        with self._lock:
            bins_t = self._bins_on_device(bins, rows, bucket)
            res = forest_kernels.forest_values(self.fb, bins_t, self.k,
                                               self.cat_feats)
            return res.cpu().numpy().astype(np.float64)[:rows]

    def _mark_chunk(self, bucket: int, stats: RequestStats) -> None:
        with self._lock:
            if bucket in self._warm:
                stats.warm_chunks += 1
            else:
                self._warm.add(bucket)

    # -------------------------------------------------------------- predict
    def predict_ex(self, X, raw_score: bool = True, trace=None,
                   parent: Optional[int] = None):
        """(output, RequestStats).  Output matches ``Booster.predict``:
        [n] for single-output models, [n, k] for multiclass."""
        if trace is not None:
            _refuse_item8("trace=")
        X = np.asarray(X, np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        n = X.shape[0]
        stats = RequestStats()
        stats.rows = n
        if self._fallback is not None:
            stats.fallback = True
            count_event("serve_host_fallback_requests", 1, self.metrics)
            return self._fallback.predict(X, raw_score=raw_score), stats
        bins = self._binner(X)
        chunks = self.ladder.chunks(n)
        for off, rows, bucket in chunks:
            stats.chunks.append((bucket, rows))
            stats.pad_rows += bucket - rows
            self._mark_chunk(bucket, stats)
        out = np.zeros((n, self.k))
        if self.exact:
            leaves = np.empty((len(self.trees), n), np.int32)
            for off, rows, bucket in chunks:
                leaves[:, off:off + rows] = self._leaves_for_chunk(
                    bins[off:off + rows], rows, bucket)
            # ascending tree order, one float64 add per tree — the exact
            # accumulation of the host walk (basic.py _host_raw)
            for ti, t in enumerate(self.trees):
                out[:, ti % self.k] += t.values_from_leaf_index(
                    X, leaves[ti])
        else:
            for off, rows, bucket in chunks:
                out[off:off + rows] = self._sums_for_chunk(
                    bins[off:off + rows], rows, bucket)
        if not raw_score:
            from ..basic import _objective_string_transform
            out = _objective_string_transform(out, self.objective_str)
        return (out[:, 0] if self.k == 1 else out), stats

    def predict(self, X, raw_score: bool = True):
        return self.predict_ex(X, raw_score=raw_score)[0]

    # -------------------------------------------------------------- contrib
    def predict_contrib_ex(self, X, trace=None, parent: Optional[int] = None):
        """(contribs, RequestStats): tree-SHAP through the bucket ladder.

        Rows are quantized to ladder buckets and zero-padded before the
        device TreeSHAP runs (models/shap.py with ``force_device=True``):
        SHAP is row-independent, so pad rows compute values that are
        sliced off.  Output layout is
        ``Booster.predict(pred_contrib=True)``'s ([n, F+1], or
        [n, k*(F+1)] class-major), at device float32 rather than the host
        walk's float64."""
        if trace is not None:
            _refuse_item8("trace=")
        from ..models import shap
        X = np.asarray(X, np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        n = X.shape[0]
        stats = RequestStats()
        stats.rows = n
        if self._fallback is not None:
            stats.fallback = True
            count_event("serve_host_fallback_requests", 1, self.metrics)
            return self._fallback.predict(X, pred_contrib=True), stats
        cols = self.num_features + 1 if self.k == 1 \
            else self.k * (self.num_features + 1)
        out = np.empty((n, cols))
        for off, rows, bucket in self.ladder.chunks(n):
            stats.chunks.append((bucket, rows))
            stats.pad_rows += bucket - rows
            self._mark_chunk(bucket, stats)
            padded = np.zeros((bucket, X.shape[1]))
            padded[:rows] = X[off:off + rows]
            res = shap.predict_contrib(
                self.trees, padded, self.num_features,
                num_tree_per_iteration=self.k, force_device=True,
                device=self.device)
            out[off:off + rows] = res[:rows]
        return out, stats

    def predict_contrib(self, X):
        return self.predict_contrib_ex(X)[0]

    # --------------------------------------------------------------- warmup
    def warmup(self) -> Dict[int, float]:
        """Run every bucket once up front (its device buffer allocated,
        the kernel library loaded); returns {bucket: seconds}.
        Idempotent."""
        return {b: d["total_s"] for b, d in self.warmup_ex().items()}

    def warmup_ex(self) -> Dict[int, Dict[str, float]]:
        """``warmup`` as ``{bucket: {"total_s", "lower_s", "aot_load_s"}}``
        (the JAX package's keys; with no program to lower or load here,
        ``lower_s`` is the whole wall time and ``aot_load_s`` 0)."""
        import time
        if self._fallback is not None:
            return {}
        timings: Dict[int, Dict[str, float]] = {}
        width = self.num_features
        for b in self.ladder.sizes:
            t0 = time.perf_counter()
            bins = self._binner(np.zeros((b, width)))
            if self.exact:
                self._leaves_for_chunk(bins, b, b)
            else:
                self._sums_for_chunk(bins, b, b)
            dt = time.perf_counter() - t0
            timings[b] = {"total_s": dt, "aot_load_s": 0.0, "lower_s": dt}
            with self._lock:
                self._warm.add(b)
        return timings
