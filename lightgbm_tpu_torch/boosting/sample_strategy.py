"""Row sampling strategies: bagging and GOSS.

Counterpart of ``lightgbm_tpu/boosting/sample_strategy.py`` (reference
src/boosting/sample_strategy.{h,cpp}, bagging.hpp, goss.hpp).  Rows never
move: sampling is a bool ``row_mask`` [n] that the growers fold into every
histogram, count and compaction key (out-of-bag rows are still partitioned,
so the score update reaches them), and GOSS multiplies the sampled rows'
gradients by (1 - top_rate) / other_rate.

Each draw is a pure function of key words and the round's gradients: the
plain and pos/neg bagging masks are ``uniform(fold_in(key(bagging_seed),
iter // freq), n) < fraction``, GOSS's uniform draw is keyed on
``fold_in(key(bagging_seed), iter)``, all threefry bits of ops/prng.py
(``jax.random``'s).  The classic loop derives the key words as Python ints;
the fused round (boosting/fused_graph.py) stages them per chunk on the
device (:meth:`SampleStrategy.round_words`) and calls
:meth:`SampleStrategy.device_sample_fn`'s function inside the captured
round, so both loops draw the same rows.  Nothing in a draw reads the
device: the empty-mask rescue is a ``torch.where`` on ``any()``, GOSS's
top set a scatter of a fixed number of sorted indices, its warm-up a
``torch.where`` on a staged flag.  By-query bagging keeps a host numpy
draw per resample (the JAX package's), so it runs in the classic loop only.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io.dataset import Metadata
from ..ops import prng
from ..utils import log

#: ``fn(k0, k1, active, grad, hess) -> (row_mask, grad, hess)``: one
#: round's draw from its key words and warm-up flag (grad/hess [n, k])
DeviceSampleFn = Callable[..., Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]]


class SampleStrategy:
    """No sampling: every row, every round."""

    def __init__(self, config: Config, num_data: int):
        self.config = config
        self.num_data = num_data

    def sample(self, iter_: int, grad: torch.Tensor, hess: torch.Tensor,
               metadata: Metadata
               ) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
        """(row_mask or None, grad, hess) of iteration ``iter_``; grad and
        hess [n, k], reweighted under GOSS."""
        return None, grad, hess

    def device_sample_fn(self, metadata: Metadata,
                         device) -> Optional[DeviceSampleFn]:
        """The draw the fused round captures, or None when the strategy
        needs the host each resample (or does not sample).  Device operands
        it needs (pos/neg bagging's labels) are made here, before
        capture."""
        return None

    def round_words(self, iter_: int) -> Tuple[int, int, int]:
        """(key word 0, key word 1, active) the fused round stages for
        iteration ``iter_``."""
        return 0, 0, 0


class BaggingSampleStrategy(SampleStrategy):
    """bagging_fraction / bagging_freq / pos and neg bagging (reference
    bagging.hpp): a resample every ``bagging_freq`` iterations, keyed on
    the resample index."""

    def __init__(self, config: Config, num_data: int):
        super().__init__(config, num_data)
        self._mask: Optional[torch.Tensor] = None
        self._mask_iter = -1
        self._use_pos_neg = (config.pos_bagging_fraction < 1.0 or
                             config.neg_bagging_fraction < 1.0)
        self._rng = np.random.default_rng(config.bagging_seed)
        self._pos_dev: Optional[torch.Tensor] = None

    def _active(self) -> bool:
        return self.config.bagging_freq > 0 and (
            self.config.bagging_fraction < 1.0 or self._use_pos_neg)

    def _by_query(self, metadata: Metadata) -> bool:
        return (bool(self.config.bagging_by_query)
                and not self._use_pos_neg
                and metadata.query_boundaries is not None)

    def _positive(self, metadata: Metadata, device) -> torch.Tensor:
        """bool [n]: label > 0, on the device (made once)."""
        if self._pos_dev is None:
            self._pos_dev = torch.as_tensor(
                np.asarray(metadata.label) > 0, device=device)
        return self._pos_dev

    def round_words(self, iter_: int) -> Tuple[int, int, int]:
        freq = max(int(self.config.bagging_freq), 1)
        k = prng.fold_in(prng.key(self.config.bagging_seed), iter_ // freq)
        return k[0], k[1], 1

    def _draw(self, k0, k1, pos: Optional[torch.Tensor],
              device) -> torch.Tensor:
        """The bag of key ``(k0, k1)`` (Python ints or 0-d int64 tensors)."""
        cfg = self.config
        n = self.num_data
        u = prng.uniform((k0, k1), n, device)
        if pos is not None:
            m = torch.where(pos, u < cfg.pos_bagging_fraction,
                            u < cfg.neg_bagging_fraction)
        else:
            m = u < cfg.bagging_fraction
        # the empty-mask rescue (bagging.hpp draws again): row 0 joins
        row0 = torch.arange(n, device=device) == 0
        return torch.where(m.any(), m, m | row0)

    def device_sample_fn(self, metadata, device):
        if not self._active() or self._by_query(metadata):
            return None
        pos = self._positive(metadata, device) if self._use_pos_neg else None

        def fn(k0, k1, active, grad, hess):
            return self._draw(k0, k1, pos, device), grad, hess
        return fn

    def sample(self, iter_, grad, hess, metadata):
        if not self._active():
            return None, grad, hess
        dev = grad.device
        if not self._by_query(metadata):
            # the fused round's draw; recomputed at the resample cadence
            freq = max(int(self.config.bagging_freq), 1)
            ridx = iter_ // freq
            if self._mask is None or ridx != self._mask_iter:
                k0, k1, _ = self.round_words(iter_)
                pos = self._positive(metadata, dev) \
                    if self._use_pos_neg else None
                self._mask = self._draw(k0, k1, pos, dev)
                self._mask_iter = ridx
            return self._mask, grad, hess
        if iter_ % self.config.bagging_freq == 0 or self._mask is None:
            n = self.num_data
            qb = metadata.query_boundaries
            nq = len(qb) - 1
            qm = self._rng.random(nq) < self.config.bagging_fraction
            m = np.zeros(n, bool)
            for qi in np.nonzero(qm)[0]:
                m[qb[qi]:qb[qi + 1]] = True
            if not m.any():
                m[self._rng.integers(0, n)] = True
            self._mask = torch.as_tensor(m, device=dev)
        return self._mask, grad, hess


class GOSSStrategy(SampleStrategy):
    """Gradient-based one-side sampling (reference goss.hpp:18): keep the
    top ``top_rate`` of the rows by |g| sqrt(|h|), draw ``other_rate`` of
    the rest uniformly and amplify their g and h by (1 - top_rate) /
    other_rate; the first ``min(1 / learning_rate, num_iterations // 2)``
    iterations use every row."""

    def __init__(self, config: Config, num_data: int):
        super().__init__(config, num_data)
        if config.top_rate + config.other_rate > 1.0:
            log.fatal("top_rate + other_rate cannot be larger than 1.0")

    def _warmup_iters(self) -> int:
        return min(int(1.0 / max(self.config.learning_rate, 1e-6)),
                   self.config.num_iterations // 2)

    def round_words(self, iter_: int) -> Tuple[int, int, int]:
        k = prng.fold_in(prng.key(self.config.bagging_seed), iter_)
        return k[0], k[1], int(iter_ >= self._warmup_iters())

    def _select(self, k0, k1, grad, hess):
        """One GOSS draw (mask, grad, hess) under key ``(k0, k1)``."""
        n = self.num_data
        a, b = self.config.top_rate, self.config.other_rate
        top_k = max(1, int(n * a))
        score = (grad.abs() * torch.sqrt(hess.abs() + 1e-12)).sum(1)
        # the exact top-k set, ties broken by row (a >= threshold test
        # floods the set when gradients tie, as a constant-|grad| objective
        # makes them); + 0.0 makes -0.0 keys +0.0, which the JAX package's
        # stable CPU sort takes as equal and a CUDA radix sort does not
        order = torch.argsort(-score + 0.0, stable=True)
        is_top = torch.zeros(n, dtype=torch.bool, device=grad.device) \
            .index_fill_(0, order[:top_k], True)
        if b <= 0.0:
            return is_top, grad, hess
        other_k = max(1, int(n * b))
        u = prng.uniform((k0, k1), n, grad.device)
        # the non-top pool holds n - top_k rows; the JAX package divides
        # in float32
        pool = max(n - top_k, 1)
        p_other = min(float(np.float32(other_k) / np.float32(pool)), 1.0)
        is_other = ~is_top & (u < p_other)
        mask = is_top | is_other
        mult = torch.where(is_other, (1.0 - a) / b, 1.0)[:, None]
        return mask, grad * mult, hess * mult

    def device_sample_fn(self, metadata, device):
        def fn(k0, k1, active, grad, hess):
            mask, g2, h2 = self._select(k0, k1, grad, hess)
            # warm-up rounds: every row, unscaled (the classic loop's early
            # return)
            return (torch.where(active, mask, True),
                    torch.where(active, g2, grad),
                    torch.where(active, h2, hess))
        return fn

    def sample(self, iter_, grad, hess, metadata):
        if iter_ < self._warmup_iters():
            return None, grad, hess
        k0, k1, _ = self.round_words(iter_)
        return self._select(k0, k1, grad, hess)


def create_sample_strategy(config: Config, num_data: int) -> SampleStrategy:
    """reference sample_strategy.cpp:12-22."""
    if config.data_sample_strategy == "goss":
        return GOSSStrategy(config, num_data)
    return BaggingSampleStrategy(config, num_data)
