"""Evaluation metrics, on the host in float64.

Counterpart of ``lightgbm_tpu/metrics.py`` for ``l2``, ``binary_logloss``
and ``auc`` (reference regression_metric.hpp, binary_metric.hpp), with the
JAX package's host (non-device) evaluation: the same NumPy code.  Other
metrics are not ported yet and are skipped with a warning, as unknown
metric names are.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import Config
from .io.dataset import Metadata
from .utils import log


class Metric:
    NAME = "none"
    bigger_is_better = False

    def __init__(self, config: Config):
        self.config = config

    def init(self, metadata: Metadata, num_data: int) -> None:
        self.metadata = metadata
        self.num_data = num_data
        self.label = np.asarray(metadata.label, np.float64)
        self.weight = None if metadata.weight is None else \
            np.asarray(metadata.weight, np.float64)
        self.sum_weight = float(self.weight.sum()) if self.weight is not None \
            else float(num_data)

    def eval(self, score: np.ndarray, objective=None) -> List[Tuple[str, float]]:
        raise NotImplementedError

    def _avg(self, losses: np.ndarray) -> float:
        if self.weight is not None:
            return float(np.sum(losses * self.weight) / self.sum_weight)
        return float(np.mean(losses))

    def _convert(self, score: np.ndarray, objective) -> np.ndarray:
        if objective is not None and objective.need_convert_output:
            return objective.convert_output(
                torch.as_tensor(score, dtype=torch.float32)).numpy()
        return score


class L2Metric(Metric):
    NAME = "l2"

    def eval(self, score, objective=None):
        pred = self._convert(score, objective)
        return [(self.NAME, self._avg((pred - self.label) ** 2))]


class BinaryLoglossMetric(Metric):
    NAME = "binary_logloss"

    def eval(self, score, objective=None):
        p = np.clip(self._convert(score, objective), 1e-15, 1 - 1e-15)
        y = self.label
        loss = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        return [(self.NAME, self._avg(loss))]


def _weighted_auc(label: np.ndarray, score: np.ndarray,
                  weight: Optional[np.ndarray]) -> float:
    """Rank-based weighted AUC (reference binary_metric.hpp AUCMetric)."""
    if weight is None:
        weight = np.ones_like(label, dtype=np.float64)
    order = np.argsort(score, kind="mergesort")
    y, s, w = label[order], score[order], weight[order]
    pos_w = np.where(y > 0, w, 0.0)
    neg_w = np.where(y > 0, 0.0, w)
    # tie-aware: within tied score groups, credit half the pos x neg mass
    cum_neg = np.cumsum(neg_w)
    total_neg = cum_neg[-1] if len(cum_neg) else 0.0
    total_pos = pos_w.sum()
    if total_pos <= 0 or total_neg <= 0:
        return 1.0
    boundary = np.r_[True, s[1:] != s[:-1]]
    gid = np.cumsum(boundary) - 1
    ng = gid[-1] + 1
    gpos = np.bincount(gid, weights=pos_w, minlength=ng)
    gneg = np.bincount(gid, weights=neg_w, minlength=ng)
    neg_before = np.cumsum(gneg) - gneg
    auc = np.sum(gpos * (neg_before + 0.5 * gneg))
    return float(auc / (total_pos * total_neg))


class AUCMetric(Metric):
    NAME = "auc"
    bigger_is_better = True

    def eval(self, score, objective=None):
        return [(self.NAME, _weighted_auc(self.label, score, self.weight))]


_METRICS = {"l2": L2Metric, "binary_logloss": BinaryLoglossMetric,
            "auc": AUCMetric}
_DEFAULT_METRIC_FOR_OBJECTIVE = {"regression": "l2",
                                 "binary": "binary_logloss"}


def create_metrics(config: Config) -> List[Metric]:
    """Factory (reference metric.cpp:21-127): explicit list, or the
    objective's default metric when none requested."""
    names: Sequence[str] = config.metric
    if not names:
        default = _DEFAULT_METRIC_FOR_OBJECTIVE.get(config.objective)
        names = [default] if default else []
    out: List[Metric] = []
    for nm in names:
        if nm in ("none", ""):
            continue
        cls = _METRICS.get(nm)
        if cls is None:
            log.warning(f"metric {nm} is not supported by lightgbm_tpu_torch "
                        "yet; skipped")
            continue
        out.append(cls(config))
    return out
