"""Per-tree prediction over binned features (valid-set score updates).

Counterpart of ``predict_bins_tree`` / ``predict_bins_leaf`` of
``lightgbm_tpu/models/predict.py`` for numeric, un-bundled trees: every row
walks from the root, going left when ``bin == nan_bin ? default_left :
bin <= split_bin``, until it reaches a leaf (children < 0 encode leaves as
``-(leaf + 1)``; an empty tree's -1 children send every row to leaf 0).
Plain PyTorch on the trees' device.  The forest predictors come later.
"""

from __future__ import annotations

import torch

from ..learner.grower import TreeArrays


def predict_bins_leaf(tree: TreeArrays, bins: torch.Tensor,
                      nan_bin: torch.Tensor) -> torch.Tensor:
    """Leaf index (i64 [n]) of every row of u8 ``bins`` [n, F]."""
    n = bins.shape[0]
    rows = torch.arange(n, device=bins.device)
    node = torch.zeros(n, dtype=torch.int64, device=bins.device)
    sf = tree.split_feature.long().clamp(min=0)
    lc, rc = tree.left_child.long(), tree.right_child.long()
    # one step per tree level; a tree of L leaves is at most L - 1 deep
    for _ in range(max(int(tree.leaf_value.shape[0]) - 1, 1)):
        active = node >= 0
        safe = node.clamp(min=0)
        feat = sf[safe]
        col = bins[rows, feat].long()
        go_left = torch.where(col == nan_bin[feat].long(),
                              tree.default_left[safe],
                              col <= tree.split_bin[safe].long())
        nxt = torch.where(go_left, lc[safe], rc[safe])
        node = torch.where(active, nxt, node)
        if not bool((node >= 0).any()):
            break
    return -node - 1


def predict_bins_tree(tree: TreeArrays, bins: torch.Tensor,
                      nan_bin: torch.Tensor) -> torch.Tensor:
    """Leaf VALUE (f32 [n]) of every row for one tree."""
    return tree.leaf_value[predict_bins_leaf(tree, bins, nan_bin)]
