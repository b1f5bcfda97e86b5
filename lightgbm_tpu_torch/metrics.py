"""Evaluation metrics: on the device in float32, or on the host in float64.

Counterpart of ``lightgbm_tpu/metrics.py`` (reference regression_metric.hpp,
binary_metric.hpp, multiclass_metric.hpp, rank_metric.hpp, map_metric.hpp,
xentropy_metric.hpp), with the JAX package's two paths:

- **device** (:meth:`Metric.eval_device_traced`): plain PyTorch reductions
  on the scores' device returning a float32 ``[M]`` tensor with no host
  read, so the fused round loop (boosting/fused_graph.py) evaluates its
  valid sets inside the captured round; ``eval_device`` is the host
  wrapper the classic loop calls (one read of the M values);
- **host** (:meth:`Metric.eval`): float64 NumPy, the same code as the JAX
  package's, used when ``tpu_device_eval=false`` or
  ``deterministic=true``.

``ndcg`` evaluates on the device over the query buckets of ops/rank.py (a
stable sort a bucket, made canonical with ``+ 0.0``; every table made at
the first call, the fused loop's warm-up round, so nothing is copied
inside a captured round); ``map`` has no device path, as in the JAX
package, so a ``map`` valid set keeps the classic loop.  Unknown metric
names are skipped with a warning.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import Config
from .io.dataset import Metadata
from .ops.rank import rank_plan
from .utils import log


def _dev_pointwise(kind: str, p: torch.Tensor, y: torch.Tensor,
                   w: Optional[torch.Tensor],
                   sw: torch.Tensor) -> torch.Tensor:
    """The pointwise losses' float32 device average (the JAX package's
    ``_dev_pointwise``); ``sw``: the float32 sum of the weights."""
    if kind in ("l2", "rmse"):
        loss = (p - y) ** 2
    elif kind == "l1":
        loss = (p - y).abs()
    elif kind == "binary_logloss":
        # float32-safe clip: 1 - 1e-15 is not representable in float32
        # (the host path clips at 1e-15 in float64)
        pc = torch.clamp(p, 1e-7, 1 - 1e-7)
        loss = -(y * torch.log(pc) + (1 - y) * torch.log(1 - pc))
    elif kind == "binary_error":
        loss = ((p > 0.5) != (y > 0)).to(torch.float32)
    else:  # pragma: no cover
        raise ValueError(kind)
    avg = loss.mean() if w is None else (loss * w).sum() / sw
    return avg.sqrt() if kind == "rmse" else avg


def _segment_sums(gid: torch.Tensor, vals, n: int):
    """Sums of each ``vals`` tensor over the sorted group ids ``gid`` (i64
    [n], ascending from 0), [n] each, in an order fixed by the data: one
    segment reduction (no float atomics); the lengths are an integer
    scatter-add, exact in any order."""
    lengths = torch.zeros(n, dtype=torch.int64, device=gid.device) \
        .index_add_(0, gid, torch.ones_like(gid))
    return [torch.segment_reduce(v, "sum", lengths=lengths, unsafe=True,
                                 initial=0.0) for v in vals]


def _dev_auc(score: torch.Tensor, y: torch.Tensor,
             w: Optional[torch.Tensor]) -> torch.Tensor:
    """Weighted AUC in float32 on the device (the JAX package's
    ``_dev_auc``): a stable sort, tie groups by score value with half
    credit inside a group."""
    n = score.shape[0]
    order = torch.sort(score, stable=True).indices
    ys = y[order]
    ws = torch.ones_like(ys) if w is None else w[order]
    ss = score[order]
    zero = torch.zeros((), dtype=ws.dtype, device=ws.device)
    pos_w = torch.where(ys > 0, ws, zero)
    neg_w = torch.where(ys > 0, zero, ws)
    total_pos = pos_w.sum()
    total_neg = neg_w.sum()
    boundary = torch.ones(n, dtype=torch.int64, device=score.device)
    boundary[1:] = (ss[1:] != ss[:-1]).to(torch.int64)
    gid = torch.cumsum(boundary, 0) - 1
    gpos, gneg = _segment_sums(gid, (pos_w, neg_w), n)
    neg_before = torch.cumsum(gneg, 0) - gneg
    auc = (gpos * (neg_before + 0.5 * gneg)).sum()
    denom = total_pos * total_neg
    return torch.where(denom > 0, auc / torch.clamp_min(denom, 1e-30),
                       torch.ones_like(auc))


class Metric:
    NAME = "none"
    bigger_is_better = False
    #: the pointwise device loss (``_dev_pointwise``), or None: no device
    #: path unless the class overrides ``eval_device_traced``
    _DEV_KIND: Optional[str] = None
    #: True when ``eval_device_traced`` takes the whole [n, k] score matrix
    #: (the multiclass metrics); the others take a [n] column, so a k > 1
    #: booster evaluates only these on the device
    _DEV_MULTI: bool = False

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
        self._dev_cache = None

    def eval(self, score: np.ndarray, objective=None) -> List[Tuple[str, float]]:
        raise NotImplementedError

    def display_names(self) -> List[str]:
        """The names of the values ``eval`` returns, in order."""
        return [self.NAME]

    def has_device_eval(self) -> bool:
        return (type(self).eval_device_traced
                is not Metric.eval_device_traced
                or self._DEV_KIND is not None)

    def eval_device_traced(self, score_dev: torch.Tensor, objective=None
                           ) -> Optional[torch.Tensor]:
        """f32 [len(display_names())] on the scores' device with no host
        read, or None when this metric has no device path."""
        if self._DEV_KIND is None:
            return None
        y, w, sw = self._dev_arrays(score_dev.device)
        p = self._dev_convert(score_dev, objective)
        return _dev_pointwise(self._DEV_KIND, p, y, w, sw).reshape(1)

    def eval_device(self, score_dev: torch.Tensor, objective=None
                    ) -> Optional[List[Tuple[str, float]]]:
        """:meth:`eval_device_traced` read back (one host read), or None."""
        vals = self.eval_device_traced(score_dev, objective)
        if vals is None:
            return None
        host = vals.cpu().numpy()
        return [(name, float(host[i]))
                for i, name in enumerate(self.display_names())]

    def _dev_arrays(self, dev: torch.device):
        """Label, weight and the weights' float32 sum on ``dev``, made once
        (no host-to-device copy inside a captured round)."""
        cached = getattr(self, "_dev_cache", None)
        if cached is None or cached[0] != dev:
            y = torch.as_tensor(self.label, dtype=torch.float32, device=dev)
            w = None if self.weight is None else torch.as_tensor(
                self.weight, dtype=torch.float32, device=dev)
            sw = torch.tensor(self.sum_weight, dtype=torch.float32,
                              device=dev)
            cached = self._dev_cache = (dev, y, w, sw)
        return cached[1:]

    def _dev_convert(self, score: torch.Tensor, objective) -> torch.Tensor:
        if objective is not None and objective.need_convert_output:
            return objective.convert_output(score)
        return score

    def _avg(self, losses: np.ndarray) -> float:
        if self.weight is not None:
            return float(np.sum(losses * self.weight) / self.sum_weight)
        return float(np.mean(losses))

    def _convert(self, score: np.ndarray, objective) -> np.ndarray:
        if objective is not None and objective.need_convert_output:
            return objective.convert_output(
                torch.as_tensor(score, dtype=torch.float32)).numpy()
        return score


# ------------------------------------------------------------- regression
class _PointwiseRegression(Metric):
    def eval(self, score, objective=None):
        pred = self._convert(score, objective)
        return [(self.NAME, self._avg(self._loss(pred, self.label)))]


class L2Metric(_PointwiseRegression):
    NAME = "l2"
    _DEV_KIND = "l2"

    def _loss(self, p, y):
        return (p - y) ** 2


class RMSEMetric(_PointwiseRegression):
    NAME = "rmse"
    _DEV_KIND = "rmse"

    def eval(self, score, objective=None):
        pred = self._convert(score, objective)
        return [(self.NAME,
                 float(np.sqrt(self._avg((pred - self.label) ** 2))))]


class L1Metric(_PointwiseRegression):
    NAME = "l1"
    _DEV_KIND = "l1"

    def _loss(self, p, y):
        return np.abs(p - y)


class QuantileMetric(_PointwiseRegression):
    NAME = "quantile"

    def _loss(self, p, y):
        a = self.config.alpha
        d = y - p
        return np.where(d >= 0, a * d, (a - 1.0) * d)


class HuberMetric(_PointwiseRegression):
    NAME = "huber"

    def _loss(self, p, y):
        a = self.config.alpha
        d = np.abs(p - y)
        return np.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))


class FairMetric(_PointwiseRegression):
    NAME = "fair"

    def _loss(self, p, y):
        c = self.config.fair_c
        x = np.abs(p - y)
        return c * x - c * c * np.log1p(x / c)


class PoissonMetric(_PointwiseRegression):
    NAME = "poisson"

    def _loss(self, p, y):
        eps = 1e-10
        return p - y * np.log(np.maximum(p, eps))


class MAPEMetric(_PointwiseRegression):
    NAME = "mape"

    def _loss(self, p, y):
        return np.abs((y - p) / np.maximum(1.0, np.abs(y)))


class GammaMetric(_PointwiseRegression):
    NAME = "gamma"

    def _loss(self, p, y):
        eps = 1e-10
        psafe = np.maximum(p, eps)
        return y / psafe + np.log(psafe) - 1.0 - np.log(np.maximum(y, eps))


class GammaDevianceMetric(_PointwiseRegression):
    NAME = "gamma_deviance"

    def _loss(self, p, y):
        eps = 1e-10
        r = y / np.maximum(p, eps)
        return 2.0 * (np.log(np.maximum(1.0 / np.maximum(r, eps), eps))
                      + r - 1.0)


class TweedieMetric(_PointwiseRegression):
    NAME = "tweedie"

    def _loss(self, p, y):
        rho = self.config.tweedie_variance_power
        eps = 1e-10
        psafe = np.maximum(p, eps)
        return -y * np.power(psafe, 1 - rho) / (1 - rho) + \
            np.power(psafe, 2 - rho) / (2 - rho)


# ----------------------------------------------------------------- binary


class BinaryLoglossMetric(Metric):
    NAME = "binary_logloss"
    _DEV_KIND = "binary_logloss"

    def eval(self, score, objective=None):
        p = np.clip(self._convert(score, objective), 1e-15, 1 - 1e-15)
        y = self.label
        loss = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        return [(self.NAME, self._avg(loss))]


class BinaryErrorMetric(Metric):
    NAME = "binary_error"
    _DEV_KIND = "binary_error"

    def eval(self, score, objective=None):
        p = self._convert(score, objective)
        err = (p > 0.5) != (self.label > 0)
        return [(self.NAME, self._avg(err.astype(np.float64)))]


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

    def eval_device_traced(self, score_dev, objective=None):
        y, w, _ = self._dev_arrays(score_dev.device)
        return _dev_auc(score_dev, y, w).reshape(1)


class AveragePrecisionMetric(Metric):
    NAME = "average_precision"
    bigger_is_better = True

    def eval(self, score, objective=None):
        w = self.weight if self.weight is not None else \
            np.ones_like(self.label)
        order = np.argsort(-score, kind="mergesort")
        y, ww = self.label[order] > 0, w[order]
        tp = np.cumsum(np.where(y, ww, 0.0))
        fp = np.cumsum(np.where(y, 0.0, ww))
        prec = tp / np.maximum(tp + fp, 1e-20)
        total_pos = tp[-1] if len(tp) else 0.0
        if total_pos <= 0:
            return [(self.NAME, 1.0)]
        rec_delta = np.diff(np.r_[0.0, tp]) / total_pos
        return [(self.NAME, float(np.sum(prec * rec_delta)))]


# ------------------------------------------------------------- multiclass
class MultiLoglossMetric(Metric):
    NAME = "multi_logloss"
    _DEV_MULTI = True

    def eval(self, score, objective=None):
        # score: [n, k] raw, converted by the objective (softmax / sigmoid)
        p = self._convert(score, objective)
        if objective is None or not objective.need_convert_output:
            ex = np.exp(score - score.max(axis=1, keepdims=True))
            p = ex / ex.sum(axis=1, keepdims=True)
        idx = self.label.astype(int)
        p_true = np.clip(p[np.arange(len(idx)), idx], 1e-15, None)
        if getattr(objective, "NAME", "") == "multiclassova":
            p_true = np.clip(p_true / np.maximum(p.sum(axis=1), 1e-15),
                             1e-15, None)
        return [(self.NAME, self._avg(-np.log(p_true)))]

    def eval_device_traced(self, score_dev, objective=None):
        """The host formulation in float32 over the [n, k] scores."""
        y, w, sw = self._dev_arrays(score_dev.device)
        idx = y.to(torch.int64)[:, None]
        p = self._dev_convert(score_dev, objective)
        if objective is None or not objective.need_convert_output:
            ex = torch.exp(score_dev - score_dev.max(dim=1,
                                                     keepdim=True).values)
            p = ex / ex.sum(dim=1, keepdim=True)
        p_true = torch.clamp_min(p.gather(1, idx)[:, 0], 1e-15)
        if getattr(objective, "NAME", "") == "multiclassova":
            p_true = torch.clamp_min(
                p_true / torch.clamp_min(p.sum(dim=1), 1e-15), 1e-15)
        losses = -torch.log(p_true)
        val = losses.mean() if w is None else (losses * w).sum() / sw
        return val.reshape(1)


class MultiErrorMetric(Metric):
    NAME = "multi_error"
    _DEV_MULTI = True

    def eval(self, score, objective=None):
        k = self.config.multi_error_top_k
        idx = self.label.astype(int)
        true_score = score[np.arange(len(idx)), idx]
        # an error when the true class is not within the top k (reference
        # multiclass_metric.hpp MultiErrorMetric)
        rank = (score > true_score[:, None]).sum(axis=1)
        err = rank >= k
        return [(self.NAME, self._avg(err.astype(np.float64)))]

    def eval_device_traced(self, score_dev, objective=None):
        """Rank counting over the [n, k] scores (integer-exact)."""
        y, w, sw = self._dev_arrays(score_dev.device)
        idx = y.to(torch.int64)[:, None]
        true_score = score_dev.gather(1, idx)
        rank = (score_dev > true_score).sum(dim=1)
        err = (rank >= int(self.config.multi_error_top_k)).to(torch.float32)
        val = err.mean() if w is None else (err * w).sum() / sw
        return val.reshape(1)


class AucMuMetric(Metric):
    """Multiclass AUC-mu (reference multiclass_metric.hpp:368 AucMuMetric,
    Kleiman & Page 2019)."""
    NAME = "auc_mu"
    bigger_is_better = True

    def eval(self, score, objective=None):
        y = self.label.astype(int)
        k = self.config.num_class
        wmat = None
        if self.config.auc_mu_weights:
            wmat = np.asarray(self.config.auc_mu_weights,
                              np.float64).reshape(k, k)
        aucs = []
        for a in range(k):
            for b in range(a + 1, k):
                m = (y == a) | (y == b)
                if m.sum() == 0 or (y[m] == a).all() or (y[m] == b).all():
                    continue
                # the decision value: the difference of the class scores,
                # weighted by the partition weights when given
                if wmat is not None:
                    d = -(score[m] @ (wmat[a] - wmat[b]))
                else:
                    d = score[m, a] - score[m, b]
                aucs.append(_weighted_auc((y[m] == a).astype(np.float64), d,
                                          None if self.weight is None
                                          else self.weight[m]))
        return [(self.NAME, float(np.mean(aucs)) if aucs else 1.0)]


# ---------------------------------------------------------------- ranking
def _dcg_at_k(labels: np.ndarray, order: np.ndarray, k: int,
              label_gain: np.ndarray) -> float:
    top = order[:k]
    gains = label_gain[labels[top].astype(int)]
    return float(np.sum(gains / np.log2(np.arange(2, len(top) + 2))))


def _dev_ndcg_sums(ks: Sequence[int], score: torch.Tensor,
                   safe: torch.Tensor, valid: torch.Tensor,
                   gain_doc: torch.Tensor, idcgs: torch.Tensor,
                   disc: torch.Tensor) -> torch.Tensor:
    """Per-k NDCG sums over one query-length bucket's queries, f32
    [len(ks)] (the JAX package's ``_dev_ndcg_sums``): ``safe`` i64 [nq_b,
    Q] doc indices (pads 0) and ``valid`` bool [nq_b, Q], ``idcgs`` f32
    [len(ks), nq_b], ``disc`` f32 [Q]."""
    ninf = torch.full((), -np.inf, dtype=score.dtype, device=score.device)
    zero = torch.zeros((), dtype=score.dtype, device=score.device)
    sc = torch.where(valid, score[safe], ninf)
    order = torch.argsort(-sc + 0.0, dim=1, stable=True)
    g = torch.where(valid, gain_doc[safe], zero)
    g_srt = g.gather(1, order)
    out = []
    for i, k in enumerate(ks):
        kk = min(k, sc.shape[1])
        dcg = (g_srt[:, :kk] * disc[None, :kk]).sum(dim=1)
        idcg = idcgs[i]
        out.append(torch.where(idcg > 0,
                               dcg / torch.clamp_min(idcg, 1e-30),
                               torch.ones_like(dcg)).sum())
    return torch.stack(out)


class NDCGMetric(Metric):
    """reference rank_metric.hpp NDCGMetric + dcg_calculator.cpp."""
    NAME = "ndcg"
    bigger_is_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            log.fatal("NDCG metric requires query information")
        self.bounds = metadata.query_boundaries
        mx = int(self.label.max()) + 1 if len(self.label) else 1
        gains = self.config.label_gain or [float((1 << i) - 1)
                                           for i in range(max(mx, 31))]
        self.label_gain = np.asarray(gains, np.float64)
        self.ks = list(self.config.eval_at)
        self._rank_dev = None

    def eval(self, score, objective=None):
        res = {k: [] for k in self.ks}
        qw = []
        for qi in range(len(self.bounds) - 1):
            s, e = self.bounds[qi], self.bounds[qi + 1]
            lbl = self.label[s:e]
            sc = score[s:e]
            order = np.argsort(-sc, kind="mergesort")
            ideal = np.argsort(-lbl, kind="mergesort")
            qw.append(1.0)
            for k in self.ks:
                idcg = _dcg_at_k(lbl, ideal, k, self.label_gain)
                if idcg <= 0:
                    res[k].append(1.0)
                else:
                    res[k].append(_dcg_at_k(lbl, order, k, self.label_gain)
                                  / idcg)
        return [(f"ndcg@{k}", float(np.average(res[k], weights=qw)))
                for k in self.ks]

    def display_names(self):
        return [f"ndcg@{k}" for k in self.ks]

    def _rank_tables(self, dev: torch.device):
        """Each bucket's (safe, valid, idcgs, disc) and the documents'
        gains on ``dev``, made once."""
        if self._rank_dev is not None and self._rank_dev[0] == dev:
            return self._rank_dev[1:]
        plan = rank_plan(np.asarray(self.bounds),
                         self.config.rank_query_buckets, dev)
        gain_dev = torch.as_tensor(
            self.label_gain[self.label.astype(int)].astype(np.float32),
            device=dev)
        nq = len(self.bounds) - 1
        idcgs = np.zeros((len(self.ks), nq), np.float32)
        for qi in range(nq):
            s, e = self.bounds[qi], self.bounds[qi + 1]
            lbl = self.label[s:e]
            ideal = np.argsort(-lbl, kind="mergesort")
            for i, k in enumerate(self.ks):
                idcgs[i, qi] = _dcg_at_k(lbl, ideal, k, self.label_gain)
        tabs = [(b.safe, b.valid,
                 torch.as_tensor(idcgs[:, b.qids], device=dev),
                 torch.as_tensor((1.0 / np.log2(np.arange(max(b.cap, 1))
                                                + 2.0)).astype(np.float32),
                                 device=dev))
                for b in plan.buckets]
        self._rank_dev = (dev, tabs, gain_dev)
        return tabs, gain_dev

    def eval_device_traced(self, score_dev, objective=None):
        """The bucket sums of :func:`_dev_ndcg_sums` over the number of
        queries."""
        tabs, gain_dev = self._rank_tables(score_dev.device)
        total = None
        for safe, valid, idcgs, disc in tabs:
            part = _dev_ndcg_sums(self.ks, score_dev, safe, valid, gain_dev,
                                  idcgs, disc)
            total = part if total is None else total + part
        return total / (len(self.bounds) - 1)


class MapMetric(Metric):
    """reference map_metric.hpp MapMetric (host only, as in the JAX
    package)."""
    NAME = "map"
    bigger_is_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            log.fatal("MAP metric requires query information")
        self.bounds = metadata.query_boundaries
        self.ks = list(self.config.eval_at)

    def eval(self, score, objective=None):
        res = {k: [] for k in self.ks}
        for qi in range(len(self.bounds) - 1):
            s, e = self.bounds[qi], self.bounds[qi + 1]
            rel = (self.label[s:e] > 0).astype(np.float64)
            order = np.argsort(-score[s:e], kind="mergesort")
            rel_sorted = rel[order]
            hits = np.cumsum(rel_sorted)
            prec = hits / np.arange(1, len(rel_sorted) + 1)
            for k in self.ks:
                topk = slice(0, k)
                denom = min(k, int(rel.sum())) or 1
                ap = np.sum(prec[topk] * rel_sorted[topk]) / denom
                res[k].append(ap if rel.sum() > 0 else 1.0)
        return [(f"map@{k}", float(np.mean(res[k]))) for k in self.ks]

    def display_names(self):
        return [f"map@{k}" for k in self.ks]


# --------------------------------------------------------------- xentropy
class CrossEntropyMetric(Metric):
    NAME = "cross_entropy"

    def eval(self, score, objective=None):
        p = np.clip(self._convert(score, objective), 1e-15, 1 - 1e-15)
        y = self.label
        loss = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        return [(self.NAME, self._avg(loss))]


class CrossEntropyLambdaMetric(Metric):
    NAME = "cross_entropy_lambda"

    def eval(self, score, objective=None):
        # p through the lambda link (objectives.CrossEntropyLambda)
        w = self.weight if self.weight is not None else 1.0
        sp = np.logaddexp(0.0, score)
        p = np.clip(1.0 - np.exp(-w * sp), 1e-15, 1 - 1e-15)
        y = self.label
        loss = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        return [(self.NAME, float(np.mean(loss)))]


class KLDivergenceMetric(Metric):
    NAME = "kullback_leibler"

    def eval(self, score, objective=None):
        p = np.clip(self._convert(score, objective), 1e-15, 1 - 1e-15)
        y = np.clip(self.label, 1e-15, 1 - 1e-15)
        kl = y * np.log(y / p) + (1 - y) * np.log((1 - y) / (1 - p))
        return [(self.NAME, self._avg(kl))]


_METRICS = {
    "l1": L1Metric, "l2": L2Metric, "rmse": RMSEMetric,
    "quantile": QuantileMetric, "huber": HuberMetric, "fair": FairMetric,
    "poisson": PoissonMetric, "mape": MAPEMetric, "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric, "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric, "binary_error": BinaryErrorMetric,
    "auc": AUCMetric, "average_precision": AveragePrecisionMetric,
    "multi_logloss": MultiLoglossMetric, "multi_error": MultiErrorMetric,
    "auc_mu": AucMuMetric,
    "ndcg": NDCGMetric, "map": MapMetric,
    "cross_entropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "kullback_leibler": KLDivergenceMetric,
}

_DEFAULT_METRIC_FOR_OBJECTIVE = {
    "regression": "l2", "regression_l1": "l1", "huber": "huber",
    "fair": "fair", "poisson": "poisson", "quantile": "quantile",
    "mape": "mape", "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary_logloss",
    "multiclass": "multi_logloss", "multiclassova": "multi_logloss",
    "cross_entropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "lambdarank": "ndcg", "rank_xendcg": "ndcg",
}


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
            log.warning(f"Unknown metric: {nm}")
            continue
        out.append(cls(config))
    return out
