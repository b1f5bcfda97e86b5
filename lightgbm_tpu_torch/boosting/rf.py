"""Random-forest mode.

Counterpart of ``lightgbm_tpu/boosting/rf.py`` (reference src/boosting/rf.hpp
``RF : GBDT``): bagging required (config.py turns it on), gradients always
evaluated at the constant initial scores, and the ensemble's output the
average of its trees, which every tree carries by a shrinkage of
1 / num_iterations (known up front), so a saved model stands alone.  The
classic loop only (``GBDT.supports_fused`` takes plain GBDT).

Mid-training the score tensors hold (sum of t trees) / T: metrics evaluated
on the host (``tpu_device_eval=false`` or a metric with no device
evaluation) see :meth:`RF._host_scores`'s running average over t trees,
device-evaluated metrics the raw scores, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .gbdt import GBDT


class RF(GBDT):
    #: k > 1 metrics on the host, with ``_host_scores``' running average,
    #: as the JAX package's classic loop evaluates them (RF never fuses)
    _DEVICE_EVAL_MULTI = False

    def __init__(self, config, train_set, objective=None, metrics=None):
        super().__init__(config, train_set, objective, metrics)
        self.shrinkage_rate = 1.0 / max(1, int(config.num_iterations))
        # the constant scores gradients are evaluated at (the score tensor
        # is updated in place, so a copy)
        self._grad_scores = self.scores.clone()

    def boosting_gradients(self):
        if self.num_tree_per_iteration == 1:
            g, h = self.objective.get_gradients(self._grad_scores[:, 0])
            return g[:, None], h[:, None]
        return self.objective.get_gradients(self._grad_scores)

    def _host_scores(self, scores: torch.Tensor) -> np.ndarray:
        """The running average over the t trees so far: init + (s - init)
        T / t (reference rf.hpp renormalizes incrementally)."""
        s = scores.cpu().numpy().astype(np.float64)
        t = max(self.iter_, 1)
        T = max(1, int(self.config.num_iterations))
        init = self.init_scores[None, :]
        s = init + (s - init) * (T / t)
        return s[:, 0] if s.shape[1] == 1 else s
