"""DART boosting (Dropouts meet Multiple Additive Regression Trees).

Counterpart of ``lightgbm_tpu/boosting/dart.py`` (reference
src/boosting/dart.hpp ``DART : GBDT``): each iteration drops a random set
of trees (numpy's ``default_rng(drop_seed)``, the same draws in the same
order), trains against the scores of the rest, then normalizes: dropped
trees scaled k/(k+1) and the new tree 1/(k+1) (``xgboost_dart_mode``:
k/(k+lr) and lr/(k+lr)); ``uniform_drop``, ``skip_drop`` and ``max_drop``
as in dart.hpp.  The classic loop only.

The train and valid score tensors are kept incrementally: a tree's own
contribution (the folded boost-from-average bias taken out,
``_tree_to_arrays_stub``) is walked on the device over the training and
valid bins (models/predict.py ``predict_bins_tree``) and added with a
factor; ``Tree.scale_contribution`` rescales the host trees and keeps the
bias.
"""

from __future__ import annotations

import numpy as np

from ..models.predict import predict_bins_tree
from .gbdt import GBDT, _tree_to_arrays_stub


class DART(GBDT):
    def __init__(self, config, train_set, objective=None, metrics=None):
        super().__init__(config, train_set, objective, metrics)
        self._drop_rng = np.random.default_rng(config.drop_seed)

    def _add_contrib(self, tree, cls_idx: int, factor: float) -> None:
        """Add ``factor`` x the tree's own contribution to the train and
        valid scores."""
        arrs = _tree_to_arrays_stub(tree, self.train_set, self.device)
        contrib = predict_bins_tree(arrs, self.bins, self.nan_bin_arr,
                                    self.bundle)
        self.scores[:, cls_idx] += contrib * factor
        for vi in range(len(self.valid_sets)):
            vc = predict_bins_tree(arrs, self._valid_bins[vi],
                                   self.nan_bin_arr, self.bundle)
            self.valid_scores[vi][:, cls_idx] += vc * factor

    def train_one_iter(self, grad=None, hess=None) -> bool:
        drop_idx = self._select_drop()
        k = len(drop_idx)
        ktrees = self.num_tree_per_iteration
        for ti in drop_idx:
            self._add_contrib(self.models[ti], ti % ktrees, -1.0)

        start_model = len(self.models)
        finished = super().train_one_iter(grad, hess)

        if k > 0:
            lr = self.shrinkage_rate
            if self.config.xgboost_dart_mode:
                new_scale = lr / (k + lr)
                old_scale = k / (k + lr)
            else:
                new_scale = 1.0 / (k + 1.0)
                old_scale = k / (k + 1.0)
            # the new trees' contribution from lr down to lr * new_scale
            for ti in range(start_model, len(self.models)):
                self._add_contrib(self.models[ti], ti % ktrees,
                                  new_scale - 1.0)
                self.models[ti].scale_contribution(new_scale)
            # the dropped trees scaled down, their smaller share added back
            for ti in drop_idx:
                self.models[ti].scale_contribution(old_scale)
                self._add_contrib(self.models[ti], ti % ktrees, 1.0)
        return finished

    def _select_drop(self):
        n_models = len(self.models)
        if n_models == 0:
            return []
        if self._drop_rng.random() < self.config.skip_drop:
            return []
        rate = self.config.drop_rate
        if self.config.uniform_drop:
            mask = self._drop_rng.random(n_models) < rate
            idx = np.nonzero(mask)[0]
        else:
            k = max(1, int(n_models * rate))
            idx = self._drop_rng.choice(n_models, size=min(k, n_models),
                                        replace=False)
        if self.config.max_drop > 0 and len(idx) > self.config.max_drop:
            idx = self._drop_rng.choice(idx, size=self.config.max_drop,
                                        replace=False)
        return sorted(int(i) for i in idx)
