"""Objective functions (gradient/hessian providers).

Counterpart of ``lightgbm_tpu/objectives.py`` for every objective but the
ranking ones (reference regression_objective.hpp, binary_objective.hpp,
multiclass_objective.hpp, xentropy_objective.hpp).  Gradients are float32
torch ops on the score tensor's device, in the JAX package's operation
order (``sigmoid`` and ``softplus`` as XLA evaluates ``jax.nn.sigmoid`` and
``jax.nn.softplus``, softmax as ``jax.nn.softmax``); a quotient with a
scalar numerator is a tensor division (PyTorch's ``scalar / tensor`` is a
reciprocal and a product, two roundings).  Init scores and the l1 /
quantile / MAPE leaf renewal are the same float64 NumPy code.  Multiclass
objectives take and return [n, k].

The ranking objectives (reference rank_objective.hpp) group the queries
into the JAX package's length buckets (``rank_query_buckets``, ops/rank.py)
at ``init``, where every device table is made: ``lambdarank``'s gradients
are one launch of ``csrc/rank.cu`` on the card (the bucketed pair
arithmetic on the CPU), ``rank_xendcg``'s listwise softmax is plain
PyTorch on its Gumbel draw (``ops/prng.py gumbel``, the bits of
``jax.random.gumbel``).  ``jit_safe`` is the JAX package's flag: False
where a call changes the objective's state (rank_xendcg's key split,
position-debiased lambdarank's bias factors), which keeps the classic
loop.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config
from .io.dataset import Metadata
from .ops import prng
from .ops.rank import (lambdarank_gradients, pos_bias_newton, rank_plan,
                       xendcg_accum)
from .utils import log


def _weighted_percentile(values: np.ndarray, weights: Optional[np.ndarray],
                         alpha: float) -> float:
    """Weighted alpha-quantile (reference regression_objective.hpp
    PercentileFun/WeightedPercentileFun); the JAX package's code."""
    if len(values) == 0:
        return 0.0
    order = np.argsort(values)
    v = values[order]
    if weights is None:
        pos = alpha * (len(v) - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, len(v) - 1)
        frac = pos - lo
        return float(v[lo] * (1 - frac) + v[hi] * frac)
    w = weights[order]
    cw = np.cumsum(w)
    target = alpha * cw[-1]
    idx = int(np.searchsorted(cw, target))
    return float(v[min(idx, len(v) - 1)])


def _host(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    """A float32 device tensor as float64 numpy (None stays None)."""
    return None if t is None else t.cpu().numpy().astype(np.float64)


def _rdiv(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` rounded once, as XLA divides."""
    return torch.div(torch.full_like(den, num), den)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA lowers it: 1 / (1 + exp(-x))."""
    return _rdiv(1.0, 1.0 + torch.exp(-x))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): max(x, 0) +
    log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax(x, axis=1)`` of [n, k]: exp of the row minus its
    max, over the row's sum, added column by column in order."""
    e = torch.exp(x - x.max(dim=1, keepdim=True).values)
    s = e[:, 0]
    for c in range(1, e.shape[1]):
        s = s + e[:, c]
    return e / s[:, None]


class ObjectiveFunction:
    """Base interface (reference objective_function.h:19)."""

    num_model_per_iteration: int = 1
    need_renew_tree_output: bool = False
    is_constant_hessian: bool = False
    need_convert_output: bool = False
    #: ``get_gradients`` is a pure function of the score, so the fused loop
    #: may capture it; False where a call changes the objective's state
    #: (rank_xendcg's key split, position-debiased lambdarank's bias
    #: factors): those keep the classic loop, as in the JAX package
    jit_safe: bool = True

    def __init__(self, config: Config):
        self.config = config
        self.metadata: Optional[Metadata] = None
        self.num_data = 0
        self.device = torch.device("cpu")

    def init(self, metadata: Metadata, num_data: int,
             device: torch.device = torch.device("cpu")) -> None:
        self.metadata = metadata
        self.num_data = num_data
        self.device = device
        self._label = torch.as_tensor(np.asarray(metadata.label, np.float32),
                                      device=device)
        self._weight = None if metadata.weight is None else torch.as_tensor(
            np.asarray(metadata.weight, np.float32), device=device)

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    def convert_output(self, raw: torch.Tensor) -> torch.Tensor:
        return raw

    def renew_tree_output(self, score: np.ndarray, residual_fn,
                          leaf_of_row: np.ndarray,
                          num_leaves: int) -> Optional[np.ndarray]:
        """float64 [num_leaves] leaf outputs from the host scores before
        the tree (l1 / quantile / MAPE), or None."""
        return None

    def _apply_weight(self, g, h):
        if self._weight is not None:
            return g * self._weight, h * self._weight
        return g, h

    @property
    def name(self) -> str:
        return type(self).NAME  # type: ignore[attr-defined]


class RegressionL2Loss(ObjectiveFunction):
    """reference regression_objective.hpp RegressionL2loss."""
    NAME = "regression"
    is_constant_hessian = True

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        if self.config.reg_sqrt:
            lbl = np.asarray(metadata.label, np.float64)
            self._label = torch.as_tensor(
                (np.sign(lbl) * np.sqrt(np.abs(lbl))).astype(np.float32),
                device=device)
        self.need_convert_output = bool(self.config.reg_sqrt)

    def get_gradients(self, score):
        g = score - self._label
        h = torch.ones_like(score)
        return self._apply_weight(g, h)

    def boost_from_score(self, class_id=0):
        return float(np.average(_host(self._label),
                                weights=_host(self._weight)))

    def convert_output(self, raw):
        if self.config.reg_sqrt:
            return torch.sign(raw) * raw * raw
        return raw



class RegressionL1Loss(ObjectiveFunction):
    """reference regression_objective.hpp RegressionL1loss: leaf values
    renewed to the weighted median of the residuals."""
    NAME = "regression_l1"
    is_constant_hessian = True
    need_renew_tree_output = True
    _alpha = 0.5

    def get_gradients(self, score):
        g = torch.sign(score - self._label)
        h = torch.ones_like(score)
        return self._apply_weight(g, h)

    def boost_from_score(self, class_id=0):
        return _weighted_percentile(_host(self._label), _host(self._weight),
                                    0.5)

    def renew_tree_output(self, score, residual_fn, leaf_of_row, num_leaves):
        resid = _host(self._label) - score
        w = _host(self._weight)
        out = np.zeros(num_leaves)
        for leaf in range(num_leaves):
            m = leaf_of_row == leaf
            out[leaf] = _weighted_percentile(resid[m],
                                             None if w is None else w[m],
                                             self._alpha)
        return out


class RegressionHuberLoss(ObjectiveFunction):
    """reference regression_objective.hpp RegressionHuberLoss."""
    NAME = "huber"

    def get_gradients(self, score):
        a = self.config.alpha
        r = score - self._label
        g = torch.where(r.abs() <= a, r, a * torch.sign(r))
        h = torch.ones_like(score)
        return self._apply_weight(g, h)

    boost_from_score = RegressionL2Loss.boost_from_score


class RegressionFairLoss(ObjectiveFunction):
    """reference regression_objective.hpp RegressionFairLoss."""
    NAME = "fair"

    def get_gradients(self, score):
        c = self.config.fair_c
        r = score - self._label
        g = c * r / (r.abs() + c)
        d = r.abs() + c
        h = _rdiv(c * c, d * d)
        return self._apply_weight(g, h)


class RegressionPoissonLoss(ObjectiveFunction):
    """reference regression_objective.hpp RegressionPoissonLoss: log
    link."""
    NAME = "poisson"
    need_convert_output = True

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        if (np.asarray(metadata.label) < 0).any():
            log.fatal("[poisson]: at least one target label is negative")

    def get_gradients(self, score):
        g = torch.exp(score) - self._label
        h = torch.exp(score + self.config.poisson_max_delta_step)
        return self._apply_weight(g, h)

    def boost_from_score(self, class_id=0):
        avg = np.average(_host(self._label), weights=_host(self._weight))
        return float(np.log(max(avg, 1e-20)))

    def convert_output(self, raw):
        return torch.exp(raw)


class RegressionQuantileLoss(ObjectiveFunction):
    """reference regression_objective.hpp RegressionQuantileloss."""
    NAME = "quantile"
    is_constant_hessian = True
    need_renew_tree_output = True

    def get_gradients(self, score):
        a = self.config.alpha
        g = torch.where(score >= self._label, torch.full_like(score, 1.0 - a),
                        torch.full_like(score, -a))
        h = torch.ones_like(score)
        return self._apply_weight(g, h)

    def boost_from_score(self, class_id=0):
        return _weighted_percentile(_host(self._label), _host(self._weight),
                                    self.config.alpha)

    def renew_tree_output(self, score, residual_fn, leaf_of_row, num_leaves):
        self._alpha = self.config.alpha
        return RegressionL1Loss.renew_tree_output(self, score, residual_fn,
                                                  leaf_of_row, num_leaves)


class RegressionMAPELoss(ObjectiveFunction):
    """reference regression_objective.hpp RegressionMAPELOSS: L1 with
    1/|label| weights and a weighted-median renewal."""
    NAME = "mape"
    is_constant_hessian = True
    need_renew_tree_output = True

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        lbl = np.abs(np.asarray(metadata.label, np.float64))
        self._label_weight = torch.as_tensor(
            (1.0 / np.maximum(1.0, lbl)).astype(np.float32), device=device)

    def get_gradients(self, score):
        g = torch.sign(score - self._label) * self._label_weight
        h = self._label_weight
        return self._apply_weight(g, h)

    def _renew_weight(self) -> np.ndarray:
        lw = _host(self._label_weight)
        return lw if self._weight is None else lw * _host(self._weight)

    def boost_from_score(self, class_id=0):
        return _weighted_percentile(_host(self._label), self._renew_weight(),
                                    0.5)

    def renew_tree_output(self, score, residual_fn, leaf_of_row, num_leaves):
        resid = _host(self._label) - score
        lw = self._renew_weight()
        out = np.zeros(num_leaves)
        for leaf in range(num_leaves):
            m = leaf_of_row == leaf
            out[leaf] = _weighted_percentile(resid[m], lw[m], 0.5)
        return out


class RegressionGammaLoss(ObjectiveFunction):
    """reference regression_objective.hpp RegressionGammaLoss: log link."""
    NAME = "gamma"
    need_convert_output = True

    def get_gradients(self, score):
        g = 1.0 - self._label * torch.exp(-score)
        h = self._label * torch.exp(-score)
        return self._apply_weight(g, h)

    boost_from_score = RegressionPoissonLoss.boost_from_score
    convert_output = RegressionPoissonLoss.convert_output


class RegressionTweedieLoss(ObjectiveFunction):
    """reference regression_objective.hpp RegressionTweedieLoss: log
    link."""
    NAME = "tweedie"
    need_convert_output = True

    def get_gradients(self, score):
        rho = self.config.tweedie_variance_power
        e1 = torch.exp((1.0 - rho) * score)
        e2 = torch.exp((2.0 - rho) * score)
        g = -self._label * e1 + e2
        h = -self._label * (1.0 - rho) * e1 + (2.0 - rho) * e2
        return self._apply_weight(g, h)

    boost_from_score = RegressionPoissonLoss.boost_from_score
    convert_output = RegressionPoissonLoss.convert_output


class BinaryLogloss(ObjectiveFunction):
    """reference binary_objective.hpp BinaryLogloss."""
    NAME = "binary"
    need_convert_output = True

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        lbl = np.asarray(metadata.label)
        if not np.isin(np.unique(lbl), (0, 1)).all():
            log.fatal("Binary objective requires 0/1 labels")
        # label weights (is_unbalance / scale_pos_weight,
        # binary_objective.hpp ctor)
        w = None if metadata.weight is None else np.asarray(metadata.weight)
        cnt_pos = float((lbl == 1).sum() if w is None else w[lbl == 1].sum())
        cnt_neg = float((lbl == 0).sum() if w is None else w[lbl == 0].sum())
        lw_pos, lw_neg = 1.0, 1.0
        if self.config.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                lw_neg = cnt_pos / cnt_neg
            else:
                lw_pos = cnt_neg / cnt_pos
        lw_pos *= self.config.scale_pos_weight
        self._lw_pos, self._lw_neg = lw_pos, lw_neg
        self._cnt_pos, self._cnt_neg = cnt_pos, cnt_neg
        self._sign = torch.as_tensor(
            np.where(lbl == 1, 1.0, -1.0).astype(np.float32), device=device)
        # each row's label weight, made once: a round copies nothing from
        # the host (the fused loop captures it)
        self._lw = torch.as_tensor(
            np.where(lbl == 1, np.float32(lw_pos), np.float32(lw_neg))
            .astype(np.float32), device=device)

    def get_gradients(self, score):
        s = self.config.sigmoid
        z = self._sign * s * score
        resp = -self._sign * s / (1.0 + torch.exp(z))
        lw = self._lw
        g = resp * lw
        h = resp.abs() * (s - resp.abs()) * lw
        return self._apply_weight(g, h)

    def boost_from_score(self, class_id=0):
        s = self.config.sigmoid
        tot = self._cnt_pos * self._lw_pos + self._cnt_neg * self._lw_neg
        if tot <= 0:
            return 0.0
        p = np.clip(self._cnt_pos * self._lw_pos / tot, 1e-15, 1 - 1e-15)
        init = np.log(p / (1.0 - p)) / s
        log.info(f"[binary:BoostFromScore]: pavg={p:.6f} -> "
                 f"initscore={init:.6f}")
        return float(init)

    def convert_output(self, raw):
        return 1.0 / (1.0 + torch.exp(-self.config.sigmoid * raw))


class MulticlassSoftmax(ObjectiveFunction):
    """reference multiclass_objective.hpp MulticlassSoftmax: one tree per
    class per iteration; grad = p - y, hess = 2 p (1 - p)."""
    NAME = "multiclass"
    need_convert_output = True

    def __init__(self, config):
        super().__init__(config)
        self.num_model_per_iteration = config.num_class

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        lbl = np.asarray(metadata.label).astype(np.int32)
        k = self.config.num_class
        if lbl.min() < 0 or lbl.max() >= k:
            log.fatal(f"Label must be in [0, {k}) for multiclass")
        self._onehot = torch.as_tensor(np.eye(k, dtype=np.float32)[lbl],
                                       device=device)          # [n, k]

    def get_gradients(self, score):
        p = _softmax(score)
        g = p - self._onehot
        h = 2.0 * p * (1.0 - p)
        if self._weight is not None:
            g = g * self._weight[:, None]
            h = h * self._weight[:, None]
        return g, h

    def convert_output(self, raw):
        return _softmax(raw.reshape(-1, raw.shape[-1])).reshape(raw.shape)


class MulticlassOVA(ObjectiveFunction):
    """reference multiclass_objective.hpp MulticlassOVA: k independent
    binary-logloss problems."""
    NAME = "multiclassova"
    need_convert_output = True

    def __init__(self, config):
        super().__init__(config)
        self.num_model_per_iteration = config.num_class

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        lbl = np.asarray(metadata.label).astype(np.int32)
        k = self.config.num_class
        self._sign = torch.as_tensor(
            np.where(np.eye(k)[lbl] > 0, 1.0, -1.0).astype(np.float32),
            device=device)                                      # [n, k]

    def get_gradients(self, score):
        s = self.config.sigmoid
        z = self._sign * s * score
        resp = -self._sign * s / (1.0 + torch.exp(z))
        g = resp
        h = resp.abs() * (s - resp.abs())
        if self._weight is not None:
            g = g * self._weight[:, None]
            h = h * self._weight[:, None]
        return g, h

    def convert_output(self, raw):
        return _rdiv(1.0, 1.0 + torch.exp(-self.config.sigmoid * raw))


class CrossEntropy(ObjectiveFunction):
    """reference xentropy_objective.hpp CrossEntropy: probabilistic labels
    in [0, 1], logistic link."""
    NAME = "cross_entropy"
    need_convert_output = True

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        lbl = np.asarray(metadata.label)
        if lbl.min() < 0 or lbl.max() > 1:
            log.fatal("[cross_entropy]: labels must be in [0, 1]")

    def get_gradients(self, score):
        p = _sigmoid(score)
        g = p - self._label
        h = p * (1.0 - p)
        return self._apply_weight(g, h)

    def boost_from_score(self, class_id=0):
        avg = np.average(_host(self._label), weights=_host(self._weight))
        p = np.clip(avg, 1e-15, 1 - 1e-15)
        return float(np.log(p / (1.0 - p)))

    def convert_output(self, raw):
        return _sigmoid(raw)


class CrossEntropyLambda(ObjectiveFunction):
    """reference xentropy_objective.hpp CrossEntropyLambda: the weights
    enter the link, p = 1 - exp(-w softplus(f))."""
    NAME = "cross_entropy_lambda"
    need_convert_output = True

    def get_gradients(self, score):
        # L = -y log p + (1 - y) w softplus(f);
        # dL/df = w sig(f) (1 - y/p);
        # d2L/df2 = w sig(f) (1 - sig(f)) (1 - y/p)
        #           + w^2 sig(f)^2 y (1 - p) / p^2
        y = self._label
        w = torch.ones_like(score) if self._weight is None else self._weight
        sig = _sigmoid(score)
        sp = _softplus(score)
        one_m_p = torch.exp(-w * sp)
        p = torch.clamp(1.0 - one_m_p, 1e-15, 1.0)
        ws = w * sig
        g = ws * (1.0 - y / p)
        h = ws * (1.0 - sig) * (1.0 - y / p) + \
            ws * ws * y * one_m_p / (p * p)
        h = torch.clamp_min(h, 1e-15)
        return g, h

    def boost_from_score(self, class_id=0):
        p = max(np.average(_host(self._label)), 1e-15)
        return float(np.log(np.expm1(-np.log1p(-min(p, 1 - 1e-15)))
                            + 1e-300))

    def convert_output(self, raw):
        return torch.log1p(torch.exp(raw))


class LambdarankNDCG(ObjectiveFunction):
    """reference rank_objective.hpp:138 LambdarankNDCG: pairwise lambda
    gradients weighted by |dNDCG|, truncated at
    ``lambdarank_truncation_level``, optionally normalised per query
    (``lambdarank_norm``); with ``position`` metadata, per-position
    additive bias factors on the score, Newton-updated each call
    (rank_objective.hpp:43-56, 295)."""
    NAME = "lambdarank"

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            log.fatal("Lambdarank tasks require query information")
        lbl = np.asarray(metadata.label)
        gains = self.config.label_gain or [float((1 << i) - 1) for i in
                                           range(max(int(lbl.max()) + 1, 31))]
        self._label_gain = np.asarray(gains, np.float64)
        if int(lbl.max()) >= len(self._label_gain):
            log.fatal("label_gain shorter than max label")
        # inverse max DCG per query (rank_objective.hpp:165-177)
        bounds = np.asarray(metadata.query_boundaries)
        nq = len(bounds) - 1
        inv = np.zeros(nq, np.float64)
        trunc = self.config.lambdarank_truncation_level
        for i in range(nq):
            docs = np.arange(int(bounds[i]), int(bounds[i + 1]))
            g = np.sort(self._label_gain[lbl[docs].astype(int)])[::-1][:trunc]
            dcg = np.sum(g / np.log2(np.arange(2, len(g) + 2)))
            inv[i] = 1.0 / dcg if dcg > 0 else 0.0
        self._plan = rank_plan(bounds, self.config.rank_query_buckets,
                               device, inv)
        self._gain_of_doc = torch.as_tensor(
            self._label_gain[lbl.astype(int)].astype(np.float32),
            device=device)
        self.jit_safe = True
        self._positions = None
        if metadata.position is not None:
            ids, inv_idx = np.unique(np.asarray(metadata.position),
                                     return_inverse=True)
            self._positions = torch.as_tensor(inv_idx.astype(np.int64),
                                              device=device)
            # the documents in position order and the counts: the bias
            # step's sums as segment reductions
            self._pos_order = torch.as_tensor(
                np.argsort(inv_idx, kind="stable"), device=device)
            self._pos_counts = torch.as_tensor(
                np.bincount(inv_idx, minlength=len(ids)), device=device)
            self._pos_biases = torch.zeros(len(ids), dtype=torch.float32,
                                           device=device)
            self._pos_reg = float(
                self.config.lambdarank_position_bias_regularization)
            # the bias carry changes every call: the classic loop
            self.jit_safe = False

    def get_gradients(self, score):
        if self._positions is not None:
            score = score + self._pos_biases[self._positions]
        g, h = lambdarank_gradients(
            score, self._label, self._gain_of_doc, self._plan, self._weight,
            sigmoid=float(self.config.sigmoid),
            trunc=int(self.config.lambdarank_truncation_level),
            norm=bool(self.config.lambdarank_norm))
        if self._positions is not None:
            self._pos_biases = pos_bias_newton(
                g, h, self._pos_biases, self._pos_order, self._pos_counts,
                lr=float(self.config.learning_rate), reg=self._pos_reg)
        return g, h


class RankXENDCG(ObjectiveFunction):
    """reference rank_objective.hpp:378 RankXENDCG (XE-NDCG-MART, Bruch et
    al.): listwise cross-entropy against Gumbel-perturbed relevance
    targets over the same query buckets; each call splits the objective's
    key (``objective_seed``) and draws one Gumbel value a document."""
    NAME = "rank_xendcg"
    jit_safe = False

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            log.fatal("Ranking tasks require query information")
        self._plan = rank_plan(metadata.query_boundaries,
                               self.config.rank_query_buckets, device)
        self._rng = prng.key(int(self.config.objective_seed))

    def get_gradients(self, score):
        self._rng, key = prng.split(self._rng)
        gumbel = prng.gumbel(key, score.shape[0], score.device)
        g = torch.zeros_like(score)
        h = torch.zeros_like(score)
        for b in self._plan.buckets:
            g, h = xendcg_accum(score, self._label, gumbel, b, g, h)
        return self._apply_weight(g, h)


_OBJECTIVES = {
    "regression": RegressionL2Loss,
    "regression_l1": RegressionL1Loss,
    "huber": RegressionHuberLoss,
    "fair": RegressionFairLoss,
    "poisson": RegressionPoissonLoss,
    "quantile": RegressionQuantileLoss,
    "mape": RegressionMAPELoss,
    "gamma": RegressionGammaLoss,
    "tweedie": RegressionTweedieLoss,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
    "lambdarank": LambdarankNDCG,
    "rank_xendcg": RankXENDCG,
}


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """Factory (reference objective_function.cpp)."""
    name = config.objective
    if name == "none":
        return None
    cls = _OBJECTIVES.get(name)
    if cls is None:
        log.fatal(f"objective={name} is not supported by lightgbm_tpu_torch "
                  f"yet (ported: {', '.join(sorted(_OBJECTIVES))})")
    return cls(config)
