"""Monotone constraints' bin-space boxes: the intermediate and advanced
methods' output bounds.

Counterpart of ``lightgbm_tpu/learner/monotone.py`` (reference
monotone_constraints.hpp:516 ``IntermediateLeafConstraints`` and :858
``AdvancedLeafConstraints``).  Every leaf is a box in bin space (``[lo_f,
hi_f)`` per feature, from its path).  Two distinct leaves whose boxes
intersect in every feature but ``f`` are ordered along ``f``, and a
monotone ``f`` orders their outputs the same way; so a leaf's output
bounds are the min / max of the outputs it must stay below / above,
recomputed from the current outputs after every split.  Categorical
splits leave both children on the parent's box.

min and max are exact, so every function here gives the JAX package's
bits.  :func:`advanced_split_bounds` is batched over the leaves it bounds
and reduces with ``scatter_reduce_`` into [F, B] followed by
``cummin`` / ``cummax``, where the JAX package materialises [L, F, B]
one-hot tensors a leaf.  All of it is device operations with fixed shapes
and no host read: it runs inside a captured round.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: the bound of a leaf that nothing constrains (the JAX package's _INF)
_INF = 1e30


def box_bounds(leaf_lo: torch.Tensor, leaf_hi: torch.Tensor,
               out: torch.Tensor, monotone: torch.Tensor,
               num_leaves) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fresh per-leaf output bounds (lower, upper), f32 [L] each.

    leaf_lo / leaf_hi: i32 [L, F] boxes (hi exclusive; slots not yet used
    hold empty boxes, lo == hi); out: f32 [L] current outputs; monotone:
    int [F] directions; num_leaves: the live leaf count (an int or a 0-d
    tensor)."""
    L, F = leaf_lo.shape
    ids = torch.arange(L, device=leaf_lo.device)
    live = ids < num_leaves
    inter = ((leaf_lo[:, None, :] < leaf_hi[None, :, :])
             & (leaf_lo[None, :, :] < leaf_hi[:, None, :]))   # [L, L, F]
    n_inter = inter.sum(2)                                   # [L, L]
    # apart on f alone: boxes that intersect in every feature (siblings
    # of a categorical split) are ordered along nothing
    only_f_apart = ~inter & (n_inter[:, :, None] == F - 1)
    i_below_j = leaf_hi[:, None, :] <= leaf_lo[None, :, :]
    mono = monotone[None, None, :]
    # out[i] <= out[j]: increasing f and i below j, or decreasing and above
    i_under_j = only_f_apart & (((mono > 0) & i_below_j)
                                | ((mono < 0) & ~i_below_j))
    pair_ok = live[:, None] & live[None, :] & (ids[:, None] != ids[None, :])
    under = i_under_j.any(2) & pair_ok                       # [L, L]
    vals = out[None, :].expand(L, L)
    upper = torch.where(under, vals, _INF).amin(1)
    lower = torch.where(under.t(), vals, -_INF).amax(1)
    return lower, upper


def advanced_split_bounds(leaf_lo: torch.Tensor, leaf_hi: torch.Tensor,
                          out: torch.Tensor, monotone: torch.Tensor,
                          num_leaves, leaves: torch.Tensor, n_bins: int):
    """Per-(split feature, threshold) child output bounds for splitting
    each of M ``leaves`` (int [M]): (lmin_left, lmax_left, lmin_right,
    lmax_right), f32 [M, F, n_bins] each, the JAX package's
    ``advanced_split_bounds`` of every leaf.

    A neighbour j ordered against the leaf along monotone ``fj`` bounds
    the left child [lo_g, t] of a split on g iff lo_g(j) <= t (a prefix
    of thresholds) and the right child (t, hi_g) iff hi_g(j) - 1 > t (a
    suffix); one adjacent along g itself bounds both at every threshold.
    Each bound is a min / max over neighbours reduced into its first (or
    last) threshold, then a running min / max along the bins."""
    L, F = leaf_lo.shape
    M = leaves.shape[0]
    dev = leaf_lo.device
    B = n_bins
    leaves = leaves.long()
    i_lo = leaf_lo[leaves]                                   # [M, F]
    i_hi = leaf_hi[leaves]
    inter = ((leaf_lo[None] < i_hi[:, None, :])
             & (i_lo[:, None, :] < leaf_hi[None]))           # [M, L, F]
    one_apart = inter.sum(2) == F - 1                        # [M, L]
    # the first feature the boxes are apart on (argmax's first max)
    f_apart = torch.argmax((~inter).to(torch.uint8), dim=2)  # [M, L]
    j_hi_f = leaf_hi.t()[f_apart, torch.arange(L, device=dev)[None, :]]
    j_lo_f = leaf_lo.t()[f_apart, torch.arange(L, device=dev)[None, :]]
    i_lo_f = i_lo.gather(1, f_apart)
    i_hi_f = i_hi.gather(1, f_apart)
    j_below = j_hi_f <= i_lo_f
    mono_j = monotone.long()[f_apart]
    ids = torch.arange(L, device=dev)[None, :]
    valid = (one_apart & (ids < num_leaves) & (ids != leaves[:, None])
             & (mono_j != 0) & ((j_hi_f <= i_lo_f) | (j_lo_f >= i_hi_f)))
    # the leaf must stay <= out[j] ("under") or >= it ("over")
    under = valid & (((mono_j > 0) & ~j_below) | ((mono_j < 0) & j_below))
    over = valid & (((mono_j > 0) & j_below) | ((mono_j < 0) & ~j_below))

    same_f = f_apart[..., None] == torch.arange(F, device=dev)  # [M, L, F]
    starts = torch.where(same_f, 0, leaf_lo.clamp(0, B - 1).long()[None])
    # -1 (hi_g(j) <= 1) matches no threshold: the trash column B
    r_pos = torch.where(same_f, B - 1,
                        leaf_hi.clamp(0, B).long()[None] - 2)
    r_pos = torch.where(r_pos < 0, B, r_pos)
    base = ((torch.arange(M, device=dev)[:, None, None] * F
             + torch.arange(F, device=dev)[None, None, :]) * (B + 1))
    vals = out[None, :, None].expand(M, L, F)

    def reduce_at(mask, at, init, how):
        # R[m, g, b] = min / max of out[j] over j in mask[m] with
        # at[m, j, g] == b
        v = torch.where(mask[..., None], vals, init).reshape(-1)
        red = torch.full((M * F * (B + 1),), init, dtype=out.dtype,
                         device=dev)
        red.scatter_reduce_(0, (base + at).reshape(-1), v, reduce=how)
        return red.view(M, F, B + 1)[..., :B]

    def run(x, how):
        return (torch.cummin if how == "amin" else torch.cummax)(
            x, dim=-1).values

    def run_back(x, how):
        return run(x.flip(-1), how).flip(-1)

    lmax_left = run(reduce_at(under, starts, _INF, "amin"), "amin")
    lmax_right = run_back(reduce_at(under, r_pos, _INF, "amin"), "amin")
    lmin_left = run(reduce_at(over, starts, -_INF, "amax"), "amax")
    lmin_right = run_back(reduce_at(over, r_pos, -_INF, "amax"), "amax")
    return lmin_left, lmax_left, lmin_right, lmax_right


def split_boxes(leaf_lo: torch.Tensor, leaf_hi: torch.Tensor,
                parent: torch.Tensor, new_leaf: torch.Tensor,
                feat: torch.Tensor, thr: torch.Tensor,
                is_numerical: torch.Tensor):
    """Split ``parent``'s box into (parent, new_leaf) at bin threshold
    ``thr`` on ``feat`` (left = bins <= thr), in place; a categorical
    split (``is_numerical`` False) keeps both children on the parent's
    box.  parent, new_leaf, feat, thr: int [1] tensors; is_numerical bool
    [1].  Returns (leaf_lo, leaf_hi)."""
    F = leaf_lo.shape[1]
    parent, new_leaf = parent.long(), new_leaf.long()
    p_lo = leaf_lo[parent]                                   # [1, F]
    p_hi = leaf_hi[parent]
    hit = ((torch.arange(F, device=leaf_lo.device)[None, :]
            == feat.long()[:, None]) & is_numerical[:, None])
    cut = (thr.long() + 1)[:, None]
    left_hi = torch.where(hit, torch.minimum(p_hi.long(), cut), p_hi)
    right_lo = torch.where(hit, torch.maximum(p_lo.long(), cut), p_lo)
    leaf_hi.index_put_((parent,), left_hi.to(leaf_hi.dtype))
    leaf_lo.index_put_((new_leaf,), right_lo.to(leaf_lo.dtype))
    leaf_hi.index_put_((new_leaf,), p_hi)
    return leaf_lo, leaf_hi
