"""Tree arrays shared by the growers.

Counterpart of the ``TreeArrays`` / ``_empty_tree`` pieces of
``lightgbm_tpu/learner/grower.py``.  The strict leaf-wise grower itself is
not ported yet (learner/batch_grower.py raises for ``batch < 2``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TreeArrays(NamedTuple):
    """Struct-of-arrays tree (reference tree.h flat arrays)."""
    split_feature: torch.Tensor   # i32 [L-1] packed feature idx (-1 unused)
    split_bin: torch.Tensor       # i32 [L-1] bin threshold
    default_left: torch.Tensor    # bool [L-1]
    split_cat: torch.Tensor       # bool [L-1] categorical split
    left_child: torch.Tensor      # i32 [L-1]; >=0 node, negative -(leaf+1)
    right_child: torch.Tensor     # i32 [L-1]
    split_gain: torch.Tensor      # f32 [L-1]
    cat_bitset: torch.Tensor      # bool [L-1, B] — bins going left
    internal_value: torch.Tensor  # f32 [L-1] node output before split
    internal_count: torch.Tensor  # f32 [L-1]
    leaf_value: torch.Tensor      # f32 [L]
    leaf_count: torch.Tensor      # f32 [L]
    leaf_weight: torch.Tensor     # f32 [L] sum of hessians
    leaf_depth: torch.Tensor      # i32 [L]
    leaf_path: torch.Tensor       # bool [L, F] features on each leaf's path
    num_leaves: torch.Tensor      # i32 scalar — actual leaves grown


def _empty_tree(num_leaves: int, n_bins: int, num_f: int,
                device=None) -> TreeArrays:
    li = num_leaves - 1

    def full(shape, val, dtype):
        return torch.full(shape, val, dtype=dtype, device=device)

    return TreeArrays(
        split_feature=full((li,), -1, torch.int32),
        split_bin=full((li,), 0, torch.int32),
        default_left=full((li,), False, torch.bool),
        split_cat=full((li,), False, torch.bool),
        left_child=full((li,), -1, torch.int32),
        right_child=full((li,), -1, torch.int32),
        split_gain=full((li,), 0.0, torch.float32),
        cat_bitset=full((li, n_bins), False, torch.bool),
        internal_value=full((li,), 0.0, torch.float32),
        internal_count=full((li,), 0.0, torch.float32),
        leaf_value=full((num_leaves,), 0.0, torch.float32),
        leaf_count=full((num_leaves,), 0.0, torch.float32),
        leaf_weight=full((num_leaves,), 0.0, torch.float32),
        leaf_depth=full((num_leaves,), 0, torch.int32),
        leaf_path=full((num_leaves, num_f), False, torch.bool),
        num_leaves=full((), 1, torch.int32),
    )
