"""Tree arrays and the strict leaf-wise grower.

Counterpart of ``lightgbm_tpu/learner/grower.py``: ``TreeArrays`` and
``grow_tree``, the best-first learner a plain ``train()`` runs below 100k
rows (``tpu_split_batch=1``).  Split ``i`` takes the leaf with the largest
cached gain (argmax: the first max), records internal node ``i``, moves
the leaf's rows (the left child keeps the parent's leaf id, the right
child gets ``i + 1``), builds the histogram of the smaller child only
(``lcn <= rcn`` picks the left) in one data pass, derives the sibling as
parent - smaller, and finds both children's best splits, gated by depth.
``tpu_leaf_hist`` picks the data pass: ``masked`` (one full masked pass;
the radix-single kernel under ``hist_kernel=auto`` at >= 128 bins) or
``bucketed`` (the child's rows compacted into a bucket, then the rows
histogram kernel).

The JAX package runs the ``num_leaves - 1`` splits in one ``fori_loop``
with a sticky ``done`` flag.  Here it is a host loop with ONE host read per
split: the chosen leaf, its gain and its children's counts, which end the
loop, pick the smaller child and (under ``bucketed``) its bucket.  The
topology (child links, depths, path features) therefore lives on the host;
the leaf and node values are computed once per tree from the same f32
operands the JAX package uses at each split, so the arrays are bitwise
equal wherever the histograms are.

EFB bundles (``bundle``, a :class:`DeviceBundle`): the data passes and the
histogram state cover the physical bundle columns; each leaf's histogram
is expanded to virtual (per-feature) bins (:func:`_expand_hist`) just
before its best split is found, and the partition reads each row's
virtual bin through the inverse table (:func:`_feature_bin_of_rows`), as
in the JAX package.

Categorical features (``is_cat``, ``SplitHyper.has_categorical``): when a
leaf's best split is found, the bins its split would send left are cached
beside it (:func:`winner_bitset`, from the leaf's own histogram of the
winning feature: the JAX package's split-time bitset, bit for bit, since
the inputs are the same); a categorical split records the bitset in
``cat_bitset``, partitions by ``bitset[bin]`` and gives its children
``lambda_l2 + cat_l2`` when it is a sorted-subset split.

Split constraints (the JAX package's grower.py:371-385, 442-500,
693-840): each leaf carries its output bounds (``leaf_min`` /
``leaf_max``; the basic method tightens the children's at their midpoint
along a monotone split, the intermediate and advanced methods refresh
every leaf's from the bin-space boxes after each split,
learner/monotone.py ``box_bounds``, and advanced hands the children
per-threshold bounds, ``advanced_split_bounds``); a leaf's children take
the smoothed outputs toward its own output and are clipped into its
bounds, so under a constraint the leaf values are kept per split on the
device.  The node keys are the JAX package's: the root's ``split(fold_in(
key, L))``, split ``i``'s ``split(fold_in(key, i), 4)`` (left and right
by-node masks, left and right extra-trees keys), drawn in one launch a
draw family (ops/prng.py ``draw``); interaction constraints mask each
leaf to the sets that hold its whole path (:func:`node_feature_mask`).

Forced splits (the JAX package's grower.py:566-600): split ``i`` takes
schedule entry ``i`` while the entries hold; the prescribed split's stats
(:func:`gather_forced_split`, from the leaf's histogram column, expanded
under EFB) ride the split's one host read, and a categorical forced split
is one-hot.  CEGB (grower.py:352-367, 500-507, 803-826): each leaf's best
split pays :func:`cegb_penalty`, and a split acquires its feature
(:func:`cegb_acquire`).

Supported: numeric and categorical features, serial training, EFB
bundles, row masks, per-tree feature masks, ``max_depth``,
``max_delta_step``, quantized levels (``hist_scale``), monotone
constraints (every method and the penalty), path smoothing, extra trees,
by-node feature sampling, interaction constraints, forced splits and
CEGB.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.histogram import (bins_to_words, histogram_for_leaf_bucketed,
                             histogram_for_leaf_masked, leaf_pass_scale,
                             root_histogram, wants_packed_mirror)
from ..ops import prng
from ..ops.split import (NEG_INF, VAR_CAT_FWD, VAR_CAT_ONEHOT,
                         VAR_NUM_RIGHT, SplitHyper, categorical_left_bitset,
                         find_best_split, leaf_gain, leaf_output,
                         smoothed_output)
from .monotone import advanced_split_bounds, box_bounds, split_boxes

#: the output bound of an unconstrained leaf (the JAX package's
#: ``_INF_BOUND``)
INF_BOUND = 3.0e38


class DeviceBundle(NamedTuple):
    """EFB expansion tables on the device (io/bundling.py ``BundlePlan``,
    io/dataset.py ``device_bundle_arrays``): the physical bin matrix and
    histograms cover bundle columns, these map them back to per-feature
    (virtual) bins."""
    feat_col: torch.Tensor     # i32 [Fv] physical column of each feature
    src_idx: torch.Tensor      # i32 [Fv, B] virtual bin -> bundle bin
    valid: torch.Tensor        # bool [Fv, B]
    default_bin: torch.Tensor  # i32 [Fv] implicit most-frequent bin
    inv_table: torch.Tensor    # i32 [Fv, B] bundle value -> virtual bin


def _totals(sum_g, sum_h, count) -> torch.Tensor:
    """[..., C]: the leaf totals in the histogram's channel order."""
    return torch.stack([sum_g, sum_h, count, torch.zeros_like(count)], -1)


def _expand_hist(hist_b: torch.Tensor, bundle: DeviceBundle, sum_g, sum_h,
                 count) -> torch.Tensor:
    """Bundle-level leaf histograms [M, Fb, B, C] -> virtual [M, Fv, B, C]
    (``sum_g``/``sum_h``/``count``: f32 [M] leaf totals).

    Each feature's stored bins are gathered from its bundle column; the
    implicit default bin is completed from the leaf totals as total -
    rest (the reference's most-freq-bin completion, Dataset::FixHistogram
    dataset.h:760), the JAX package's operations in its order."""
    B = hist_b.shape[-2]
    hv = hist_b[:, bundle.feat_col[:, None], bundle.src_idx]   # [M, Fv, B, C]
    hv = hv * bundle.valid[..., None]
    rest = hv.sum(2)                                          # [M, Fv, C]
    onehot = (torch.arange(B, device=hist_b.device)[None, :]
              == bundle.default_bin[:, None])                 # [Fv, B]
    total = _totals(sum_g, sum_h, count)                      # [M, C]
    return hv + onehot[..., None] * (total[:, None, None, :]
                                     - rest[:, :, None, :])


def _expand_hist_col(hcol: torch.Tensor, bundle: DeviceBundle, feat,
                     sum_g, sum_h, count) -> torch.Tensor:
    """Features' virtual histograms from their bundle columns' histograms
    (the JAX package's one-column form, batched): ``hcol`` [M, B, C],
    ``feat`` i64 [M] and the leaf totals [M] give [M, B, C]; a [B, C]
    column, an int feature and 0-d totals give [B, C]."""
    if hcol.dim() == 2:
        f = torch.full((1,), feat, dtype=torch.int64, device=hcol.device)
        return _expand_hist_col(hcol[None], bundle, f, sum_g.reshape(1),
                                sum_h.reshape(1), count.reshape(1))[0]
    src = bundle.src_idx[feat].long()                         # [M, B]
    hv = hcol.gather(1, src[..., None].expand(-1, -1, hcol.shape[-1])) \
        * bundle.valid[feat][..., None]
    rest = hv.sum(1)                                          # [M, C]
    at_default = (torch.arange(hcol.shape[1], device=hcol.device)[None, :]
                  == bundle.default_bin[feat][:, None])       # [M, B]
    return torch.where(at_default[..., None],
                       hv + (_totals(sum_g, sum_h, count) - rest)[:, None],
                       hv)


def winner_bitset(h_phys: torch.Tensor, sum_g, sum_h, count,
                  res, num_bins: torch.Tensor, is_cat: torch.Tensor,
                  bundle: Optional[DeviceBundle],
                  hp: SplitHyper) -> torch.Tensor:
    """bool [M, B]: the bins going left under each of M leaves' best
    splits ``res`` (a SplitResult), from the leaves' physical histograms
    ``h_phys`` [M, Fb, B, C] and totals [M]; all False for a numeric
    winner (the JAX package's ``winner_bitset``, batched over the leaves:
    both growers cache it when a best split is found).  Device ops only:
    it runs inside a captured round."""
    feat = res.feature.long()
    m = torch.arange(h_phys.shape[0], device=h_phys.device)
    col_of = feat if bundle is None else bundle.feat_col[feat].long()
    hcol = h_phys[m, col_of]                                  # [M, B, C]
    if bundle is not None:
        hcol = _expand_hist_col(hcol, bundle, feat, sum_g, sum_h, count)
    bits = categorical_left_bitset(hcol, num_bins[feat], res.variant,
                                   res.threshold, hp)
    return bits & is_cat[feat][:, None]


class ForcedSplits(NamedTuple):
    """``forcedsplits_filename``'s schedule in BFS order (boosting/gbdt.py
    ``parse_forced_splits``): entry ``i`` is split ``i`` of every tree,
    leaf ``leaf[i]`` on packed feature ``feat[i]`` at bin ``thr[i]``; a
    failed entry ends the schedule.  Host arrays (the strict learner) and
    the same entries on the booster's device, int64 [3, S] (the batched
    rounds read them there, with no host read)."""
    leaf: np.ndarray
    feat: np.ndarray
    thr: np.ndarray
    table: torch.Tensor


def gather_forced_split(hf: torch.Tensor, pg, ph, pc, ft, is_cat_f,
                        nan_bin_f, hp: SplitHyper):
    """The stats of a PRESCRIBED split of one leaf (the JAX package's
    ``gather_forced_split``; reference FeatureHistogram::
    GatherInfoForThreshold, called by ForceSplits
    serial_tree_learner.cpp:620): ``hf`` f32 [B, C] the leaf's virtual
    histogram of the forced feature, ``pg``/``ph``/``pc`` its totals,
    ``ft`` the bin threshold, ``is_cat_f`` / ``nan_bin_f`` the feature's
    (0-d tensors).  A categorical feature sends bin ``ft`` left, a numeric
    one the bins up to ``ft`` but its NaN bin.  Returns (lg, lh, lc, gain,
    ok), 0-d tensors: ``ok`` is the validity the reference checks
    (min_data_in_leaf, min_sum_hessian_in_leaf on both sides, gain > 0).
    The one implementation both growers call."""
    b_i = torch.arange(hp.n_bins, device=hf.device)
    lm = torch.where(is_cat_f, b_i == ft, (b_i <= ft) & (b_i != nan_bin_f))
    lmf = lm.to(hf.dtype)
    lg = (hf[:, 0] * lmf).sum()
    lh = (hf[:, 1] * lmf).sum()
    lc = (hf[:, 2] * lmf).sum()
    rg, rh, rc = pg - lg, ph - lh, pc - lc
    l1, l2 = hp.lambda_l1, hp.lambda_l2
    gain = (leaf_gain(lg, lh, l1, l2) + leaf_gain(rg, rh, l1, l2)
            - leaf_gain(pg, ph, l1, l2) - hp.min_gain_to_split)
    ok = ((lc >= hp.min_data_in_leaf) & (rc >= hp.min_data_in_leaf)
          & (lh >= hp.min_sum_hessian_in_leaf)
          & (rh >= hp.min_sum_hessian_in_leaf) & (gain > 0.0))
    return lg, lh, lc, gain, ok


class CegbState(NamedTuple):
    """Cost-effective gradient boosting (the JAX package's ``CegbInput``;
    reference cost_effective_gradient_boosting.hpp): the penalties
    premultiplied by ``cegb_tradeoff`` and the acquisition state, which
    lives on the booster across every tree and which the growers update
    in place (``used_rows`` None unless lazy penalties are set)."""
    split_pen: torch.Tensor            # f32 0-d
    coupled_pen: torch.Tensor          # f32 [F] once per feature
    lazy_pen: torch.Tensor             # f32 [F] per (row, feature)
    feature_used: torch.Tensor         # bool [F] features in the model
    used_rows: Optional[torch.Tensor]  # bool [n, F] (row, feature) acquired


def cegb_lazy_counts(cegb: CegbState, lor: torch.Tensor,
                     row_mask: Optional[torch.Tensor],
                     slots: int) -> Optional[torch.Tensor]:
    """int32 [slots + 1, F]: for every leaf id below ``slots``, its rows
    (within ``row_mask``) that have not acquired each feature; row
    ``slots`` gathers the masked-out rows.  The JAX package sums a float32
    one-hot product over the rows, exact below 2^24 rows; this integer
    scatter-add is exact at any size and the same in any order (no float
    atomics on the card), so the converted counts are the JAX package's
    for n < 2^24.  None without lazy penalties."""
    if cegb.used_rows is None:
        return None
    idx = lor.long()
    if row_mask is not None:
        idx = torch.where(row_mask, idx, slots)
    F = cegb.used_rows.shape[1]
    return torch.zeros(slots + 1, F, dtype=torch.int32,
                       device=lor.device).index_add_(
        0, idx, (~cegb.used_rows).to(torch.int32))


def cegb_penalty(cegb: CegbState, leaf_count: torch.Tensor,
                 lazy_cnt: Optional[torch.Tensor]) -> torch.Tensor:
    """f32 [M, F]: the CEGB gain penalty of M leaves (DeltaGain): the
    split penalty scaled by each leaf's row count, the coupled penalty of
    the features the model does not use yet and, with lazy penalties, the
    per-row penalty times the leaf's rows that have not acquired the
    feature (``lazy_cnt`` int [M, F]); the JAX package's float32 order."""
    pen = cegb.split_pen * leaf_count[:, None] + torch.where(
        cegb.feature_used, torch.zeros_like(cegb.coupled_pen),
        cegb.coupled_pen)[None, :]
    if lazy_cnt is not None:
        pen = pen + cegb.lazy_pen[None, :] * lazy_cnt.to(torch.float32)
    return pen


def cegb_acquire(cegb: CegbState, lor: torch.Tensor,
                 row_mask: Optional[torch.Tensor], leaves: torch.Tensor,
                 feats: torch.Tensor, valid: torch.Tensor,
                 slots: int) -> None:
    """Splits of ``leaves`` on ``feats`` (where ``valid``; [K] tensors)
    acquire their features: for the model, and (lazy penalties) for every
    row of the split leaf within ``row_mask`` (bagged-out rows do not
    traverse the split, as in the reference's DataPartition); ``lor`` the
    rows' leaves before the split.  In place, device operations only."""
    F = cegb.feature_used.shape[0]
    dev = lor.device
    hit = torch.zeros(F + 1, dtype=torch.bool, device=dev)
    hit.index_fill_(0, torch.where(valid, feats.long(), F), True)
    cegb.feature_used.logical_or_(hit[:F])
    if cegb.used_rows is None:
        return
    leaf_feat = torch.full((slots + 1,), -1, dtype=torch.int64, device=dev)
    leaf_feat.index_put_((torch.where(valid, leaves.long(), slots),),
                         feats.long())
    leaf_feat[slots:].fill_(-1)
    rf = leaf_feat[lor.long().clamp(0, slots)]
    if row_mask is not None:
        rf = torch.where(row_mask, rf, -1)
    cegb.used_rows.logical_or_(
        rf[:, None] == torch.arange(F, device=dev)[None, :])


def _feature_bin_of_rows(bins_t: torch.Tensor,
                         bundle: Optional[DeviceBundle],
                         feat: int) -> torch.Tensor:
    """Virtual bin of every row for feature ``feat`` (the partition's
    column): ``bins_t[feat]`` (u8) without a bundle, else
    ``inv_table[feat, bins_t[feat_col[feat]]]`` (i32).  ``bins_t`` is the
    transposed [F, n] matrix; the column is picked on the device
    (``index_select``), with no host read."""
    if bundle is None:
        return bins_t[feat]
    col = bins_t.index_select(0, bundle.feat_col[feat:feat + 1].long())[0]
    return bundle.inv_table[feat][col.long()]


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


def sample_features_bynode(mask: Optional[torch.Tensor], u: torch.Tensor,
                           frac: float) -> torch.Tensor:
    """bool [M, F]: each node's random feature subset (reference
    col_sampler.hpp feature_fraction_bynode; the JAX package's
    ``sample_features_bynode``, batched): of the allowed features
    (``mask`` bool [F] or [M, F], None for all) keep max(int(allowed *
    frac), 1), those whose uniform (``u`` f32 [M, F], the node key's
    ``uniform(k, (F,))``) is at least the count-th largest.  Equal
    uniforms cannot change the mask: it compares ``u >= kth``."""
    M, F = u.shape
    base = torch.ones(M, F, dtype=torch.bool, device=u.device) \
        if mask is None else mask.expand(M, F)
    u = torch.where(base, u, -1.0)
    cnt = torch.clamp((base.sum(1).to(torch.float32) * frac)
                      .to(torch.int64), min=1)
    kth = torch.sort(u, dim=1).values.gather(1, (F - cnt)[:, None])
    return base & (u >= kth) & (u >= 0)


def node_feature_mask(feature_mask: Optional[torch.Tensor],
                      paths: torch.Tensor,
                      interaction_sets: Optional[torch.Tensor],
                      u_bynode: Optional[torch.Tensor],
                      frac: float) -> Optional[torch.Tensor]:
    """The features M nodes may split on (bool [M, F], or the tree's
    ``feature_mask`` when no node option applies): the tree's mask, and
    the union of the interaction sets (bool [S, F]) that hold each node's
    whole path (``paths`` bool [M, F]; reference col_sampler.hpp:91
    GetByNode) plus the path itself, then the by-node subset drawn from
    ``u_bynode`` (f32 [M, F], or None)."""
    m = feature_mask
    if interaction_sets is not None:
        fits = (interaction_sets[None] | ~paths[:, None, :]).all(2)  # [M, S]
        allowed = (interaction_sets[None] & fits[..., None]).any(1) | paths
        m = allowed if m is None else m & allowed
    if u_bynode is not None:
        m = sample_features_bynode(m, u_bynode, frac)
    return m


def extra_tree_draws(keys: torch.Tensor, path: list, num_f: int,
                     hp: SplitHyper) -> Optional[list]:
    """The extra-trees uniforms of M nodes: for each variant family j (the
    numeric threshold; on categorical data also the one-hot and the
    sorted-subset ones) ``uniform(split(k, 3)[j], (F,))`` of each node's
    key ``k`` (``keys`` and ``path``: ops/prng.py ``draw``'s), one launch
    a family; None without extra trees."""
    if not hp.extra_trees:
        return None
    fams = 3 if hp.has_categorical else 1
    return [prng.draw(keys, num_f, path + [(j, 0)]) for j in range(fams)]


#: columns of the grower's per-leaf best-split table (f32; feature,
#: threshold, the 0/1 default-left flag and the variant are small exact
#: integers)
_GAIN, _FEAT, _THR, _DL, _VAR, _LG, _LH, _LC = range(8)


def _best_rows(res) -> torch.Tensor:
    """A SplitResult of M leaves as the [M, 8] best-split table rows."""
    f32 = torch.float32
    return torch.stack([res.gain, res.feature.to(f32),
                        res.threshold.to(f32), res.default_left.to(f32),
                        res.variant.to(f32), res.left_sum_g,
                        res.left_sum_h, res.left_count], 1)


def grow_tree(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              row_mask: Optional[torch.Tensor], num_bins: torch.Tensor,
              nan_bin: torch.Tensor, feature_mask: Optional[torch.Tensor],
              hp: SplitHyper, hist_scale: Optional[torch.Tensor] = None,
              bins_t: Optional[torch.Tensor] = None,
              bins_words: Optional[torch.Tensor] = None,
              bins_words_t: Optional[torch.Tensor] = None,
              bundle: Optional[DeviceBundle] = None,
              is_cat: Optional[torch.Tensor] = None,
              monotone: Optional[torch.Tensor] = None,
              rng_key: Optional[prng.Key] = None,
              interaction_sets: Optional[torch.Tensor] = None,
              forced: Optional[ForcedSplits] = None,
              cegb: Optional[CegbState] = None
              ) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree, one split per data pass.

    The operands of ``grow_tree_batched`` (learner/batch_grower.py):
    bins u8 [n, Fb]; grad/hess f32 [n] (integer levels when
    ``hist_scale``, f32 [2], is given); row_mask bool [n] or None;
    num_bins/nan_bin i32 [F]; feature_mask bool [F] or None; ``bins_t``,
    ``bins_words`` and ``bins_words_t`` the tree-invariant layouts, derived
    when not passed; ``bundle`` the EFB tables when ``bins`` holds bundle
    columns (F = Fv features over Fb columns; F = Fb without); ``is_cat``
    bool [F], read when ``hp.has_categorical``; ``monotone`` int [F]
    (``hp.use_monotone``); ``rng_key`` the tree's node key (extra trees,
    by-node sampling); ``interaction_sets`` bool [S, F]; ``forced`` the
    forced-split schedule (split ``i`` takes entry ``i`` while the entries
    hold: the prescribed split's stats come from the leaf's histogram,
    :func:`gather_forced_split`, and are read with the split's one host
    read; a failed entry ends the schedule and the split is the best one);
    ``cegb`` the CEGB penalties and acquisition state (updated in place).
    Returns (TreeArrays, leaf_of_row i32 [n]).
    """
    dev = grad.device
    f32, i32 = torch.float32, torch.int32
    n, n_cols = bins.shape
    num_f = n_cols if bundle is None else bundle.feat_col.shape[0]
    L = hp.num_leaves
    l1, l2, mds = hp.lambda_l1, hp.lambda_l2, hp.max_delta_step
    mask_f = torch.ones_like(grad) if row_mask is None else row_mask.to(f32)
    if bins_t is None:
        bins_t = bins.t().contiguous()
    words_t = None
    if wants_packed_mirror(hp.hist_kernel, hp.n_bins):
        if bins_words_t is not None:
            words_t = bins_words_t
        else:
            words_t = (bins_words if bins_words is not None
                       else bins_to_words(bins)).t().contiguous()
    num_bins = num_bins.to(dev)
    nan_bin = nan_bin.to(dev)
    scale_vec = None
    if hist_scale is not None:
        scale_vec = torch.cat([hist_scale.to(f32),
                               torch.ones(2, dtype=f32, device=dev)])

    def scaled(h):
        return h if scale_vec is None else h * scale_vec

    cat = hp.has_categorical
    mono = hp.use_monotone
    use_boxes = mono and hp.monotone_method in ("intermediate", "advanced")
    use_adv = mono and hp.monotone_method == "advanced"
    # leaf outputs that depend on the parent's output or bounds are kept
    # per split; otherwise they are computed once, from the final sums
    track = mono or hp.path_smooth > 0.0
    use_bynode = hp.feature_fraction_bynode < 1.0 and rng_key is not None
    use_rng = rng_key is not None and (hp.extra_trees or use_bynode)
    key_t = torch.tensor([list(rng_key)], dtype=torch.int64, device=dev) \
        if use_rng else None
    mono_h = monotone.cpu().numpy() if mono else None
    if monotone is not None:
        monotone = monotone.to(dev)

    def draws(rows: int, fold: int, by_key, er_key):
        """The by-node and extra-trees uniforms of ``rows`` nodes, whose
        keys are the split keys ``by_key`` and ``er_key`` (ops/prng.py
        ``draw`` steps) of ``fold_in(key, fold)``."""
        if not use_rng:
            return None, None
        keys = key_t.expand(rows, 2)
        ub = prng.draw(keys, num_f, [(fold, 0), by_key]) \
            if use_bynode else None
        return ub, extra_tree_draws(keys, [(fold, 0), er_key], num_f, hp)

    def best_of(h_phys, g_, h_, c_, fm, leaves=None, **con):
        """Best splits of M leaves from their physical histograms: the
        table rows and, on categorical data, the winners' left bins;
        ``leaves`` (i64 [M]) their ids, for CEGB's lazy counts."""
        hv = h_phys if bundle is None else \
            _expand_hist(h_phys, bundle, g_, h_, c_)
        if cegb is not None:
            lazy = cegb_lazy_counts(cegb, lor, row_mask, L)
            con["gain_penalty"] = cegb_penalty(
                cegb, c_, None if lazy is None else lazy[leaves])
        res = find_best_split(hv, g_, h_, c_, num_bins, nan_bin, is_cat,
                              fm, hp, monotone=monotone, **con)
        bits = winner_bitset(h_phys, g_, h_, c_, res, num_bins, is_cat,
                             bundle, hp) if cat else None
        return _best_rows(res), bits

    hk = dict(n_bins=hp.n_bins, hist_dtype=hp.hist_dtype)
    # grad/hess stay the same all tree long: the radix-single kernel's
    # float32 scale is found once, for the root and every masked pass
    pscale = (leaf_pass_scale(grad, hess, hist_kernel=hp.hist_kernel, **hk)
              if hp.leaf_hist == "masked" else None)
    hist0 = scaled(root_histogram(bins_t, grad, hess, row_mask,
                                  hist_kernel=hp.hist_kernel,
                                  bins_words_t=words_t, scale=pscale, **hk))
    g0 = (grad * mask_f).sum()
    h0 = (hess * mask_f).sum()
    c0 = mask_f.sum()
    if hist_scale is not None:
        g0 = g0 * hist_scale[0]
        h0 = h0 * hist_scale[1]

    # device state: histograms, (g, h, count) sums and the cached best
    # split of every leaf
    hist = torch.zeros(L, n_cols, hp.n_bins, hist0.shape[-1], dtype=f32,
                       device=dev)
    hist[0] = hist0
    sums = torch.zeros(L, 3, dtype=f32, device=dev)
    sums[0] = torch.stack([g0, h0, c0])
    best = torch.zeros(L, 8, dtype=f32, device=dev)
    best[:, _GAIN] = NEG_INF
    root_out = leaf_output(g0, h0, l1, l2, mds)
    path_t = torch.zeros(L, num_f, dtype=torch.bool, device=dev)
    # the root's keys: split(fold_in(key, L)), by-node 0, extra trees 1
    ub0, er0 = draws(1, L, (0, 0), (1, 0))
    fm0 = node_feature_mask(feature_mask, path_t[:1], interaction_sets,
                            ub0, hp.feature_fraction_bynode)
    one = torch.ones(1, dtype=f32, device=dev)
    # the monotone penalty's depths, made only where it reads them
    pen = mono and hp.monotone_penalty > 0.0
    lor = torch.zeros(n, dtype=i32, device=dev)
    rows0, bits0 = best_of(
        hist0[None], g0[None], h0[None], c0[None], fm0,
        leaves=torch.zeros(1, dtype=torch.int64, device=dev),
        parent_output=root_out.reshape(1), leaf_min=-INF_BOUND * one,
        leaf_max=INF_BOUND * one,
        depth=torch.zeros(1, dtype=i32, device=dev) if pen else None,
        rand=er0)
    best[0] = rows0[0]
    if track:
        # per-split leaf outputs and (monotone) output bounds
        leaf_val = torch.zeros(L, dtype=f32, device=dev)
        leaf_val[0] = root_out
        leaf_min = torch.full((L,), -INF_BOUND, dtype=f32, device=dev)
        leaf_max = torch.full((L,), INF_BOUND, dtype=f32, device=dev)
    if use_boxes:
        leaf_lo = torch.zeros(L, num_f, dtype=i32, device=dev)
        leaf_hi = torch.zeros(L, num_f, dtype=i32, device=dev)
        leaf_hi[0] = num_bins.to(i32)
    # categorical: each leaf's cached left bins, and the recorded splits'
    bits = cat_bitset = None
    if cat:
        bits = torch.zeros(L, hp.n_bins, dtype=torch.bool, device=dev)
        bits[0] = bits0[0]
        cat_bitset = torch.zeros(L - 1, hp.n_bins, dtype=torch.bool,
                                 device=dev)

    # host state: the topology and the per-node f32 operands
    li = L - 1
    split_feature, split_bin = [-1] * li, [0] * li
    default_left, left_child, right_child = [0] * li, [-1] * li, [-1] * li
    split_cat = [0] * li
    # leaves whose last split was a sorted-subset one (l2 + cat_l2)
    subset_leaf = [False] * L
    node_f32 = np.zeros((4, li), np.float32)   # gain, parent g, h, count
    parent_node, parent_side, depth = [-1] * L, [0] * L, [0] * L
    path = np.zeros((L, num_f), bool)
    n_forced = 0 if forced is None else len(forced.leaf)
    if n_forced:
        # the host copies the forced entries read
        is_cat_h = (np.zeros(num_f, bool) if is_cat is None
                    else is_cat.cpu().numpy())
        nan_bin_h = nan_bin.cpu().numpy()
        col_h = (np.arange(num_f) if bundle is None
                 else bundle.feat_col.cpu().numpy())
    force_failed = False

    i = 0
    while i < li:
        # index_select, not best[bl_t]: a 0-d index tensor would be read
        # back to the host
        bl_t = torch.argmax(best[:, _GAIN]).reshape(1)
        row = best.index_select(0, bl_t)[0]
        s = sums.index_select(0, bl_t)[0]
        pack = torch.cat([bl_t.to(f32), row, s, s - row[_LG:]])
        f_active = i < n_forced and not force_failed
        if f_active:
            # forced entry i: its leaf, feature and threshold are host
            # numbers, its stats come from the leaf's histogram
            fl, ff, ft = (int(forced.leaf[i]), int(forced.feat[i]),
                          int(forced.thr[i]))
            fpack = _forced_pack(hist[fl][int(col_h[ff])], sums[fl], fl, ff,
                                 ft, bool(is_cat_h[ff]), int(nan_bin_h[ff]),
                                 bundle, hp)
            pack = torch.cat([pack, fpack])
        # the split's one host read: leaf, best split, parent and child sums
        # (and the forced entry's, with its validity)
        vals = pack.tolist()
        use_f = f_active and vals[-1] != 0.0
        force_failed = force_failed or (f_active and not use_f)
        if use_f:
            # the prescribed split: its table row and sums
            pack = fpack[:15]
            bl_t = torch.full((1,), fl, dtype=torch.int64, device=dev)
            row = pack[1:9]
            vals = vals[15:30]
        elif f_active:
            vals, pack = vals[:15], pack[:15]
        (blf, gain, featf, thrf, dlf, varf, lg, lh, lcn, pg, ph, pc, rg, rh,
         rcn) = vals
        if not (gain > 0.0 or use_f):
            break
        bl, feat, thr, dl = int(blf), int(featf), int(thrf), dlf != 0.0
        var = int(varf)
        catl = var >= VAR_CAT_ONEHOT
        new_leaf = i + 1

        p, side = parent_node[bl], parent_side[bl]
        if p >= 0:
            (left_child if side == 0 else right_child)[p] = i
        left_child[i], right_child[i] = -(bl + 1), -(new_leaf + 1)
        split_feature[i], split_bin[i], default_left[i] = feat, thr, int(dl)
        node_f32[:, i] = (gain, pg, ph, pc)
        split_cat[i] = int(catl)
        subset_leaf[bl] = subset_leaf[new_leaf] = var >= VAR_CAT_FWD

        # partition: the leaf's rows that go right take the new leaf id
        col = _feature_bin_of_rows(bins_t, bundle, feat)
        if catl:
            if use_f:
                # a forced categorical split is one-hot: bin thr goes left
                bits[bl].copy_(torch.arange(hp.n_bins, device=dev) == thr)
            cat_bitset[i].copy_(bits[bl])
            go_left = bits[bl][col.long()]
        else:
            go_left = torch.where(col == nan_bin[feat], dl, col <= thr)
        if cegb is not None:
            cegb_acquire(cegb, lor, row_mask, bl_t,
                         torch.full((1,), feat, dtype=torch.int64,
                                    device=dev),
                         torch.ones(1, dtype=torch.bool, device=dev), L)
        lor = torch.where((lor == bl) & ~go_left, new_leaf, lor)

        # histogram: a data pass over the smaller child only
        left_small = lcn <= rcn
        smaller = bl if left_small else new_leaf
        if hp.leaf_hist == "masked":
            h_small = histogram_for_leaf_masked(
                bins_t, grad, hess, lor, smaller, row_mask,
                hist_kernel=hp.hist_kernel, bins_words_t=words_t,
                scale=pscale, **hk)
        else:
            h_small = histogram_for_leaf_bucketed(
                bins_t, grad, hess, lor, smaller, min(lcn, rcn), row_mask,
                **hk)
        h_small = scaled(h_small)
        if left_small:
            torch.sub(hist[bl], h_small, out=hist[new_leaf])
            hist[bl].copy_(h_small)
        else:
            hist[new_leaf].copy_(h_small)
            hist[bl].sub_(h_small)
        sums[bl].copy_(pack[6:9])
        sums[new_leaf].copy_(pack[12:15])

        d = depth[bl] + 1
        depth[bl] = depth[new_leaf] = d
        parent_node[bl] = parent_node[new_leaf] = i
        parent_side[bl], parent_side[new_leaf] = 0, 1
        path[bl, feat] = True
        path[new_leaf] = path[bl]
        kid = torch.stack([pack[6:9], pack[12:15]])               # [2, 3]
        con = {}
        if track:
            kid_out, kid_min, kid_max = _constrained_children(
                kid, var, catl, feat, thr, bl, new_leaf, i, row, bl_t,
                leaf_val, leaf_min, leaf_max, hp, mono_h,
                monotone if use_boxes else None,
                (leaf_lo, leaf_hi) if use_boxes else None)
            con = dict(parent_output=kid_out, leaf_min=kid_min,
                       leaf_max=kid_max)
            if use_adv:
                kids_t = torch.cat([bl_t, torch.full_like(bl_t, new_leaf)])
                con["adv_bounds"] = advanced_split_bounds(
                    leaf_lo, leaf_hi, leaf_val, monotone, i + 2, kids_t,
                    hp.n_bins)

        if interaction_sets is not None:
            path_t[bl, feat] = True
            path_t[new_leaf] = path_t[bl]

        # both children's best splits; past max_depth their gains are
        # -inf, as the JAX package's depth gate sets them
        if hp.max_depth > 0 and d >= hp.max_depth:
            best[bl, _GAIN] = NEG_INF
            best[new_leaf, _GAIN] = NEG_INF
        else:
            # split(fold_in(key, i), 4): by-node keys 0 and 1, extra-trees
            # keys 2 and 3 (left, right)
            ub, er = draws(2, i, (0, 1), (2, 1))
            fm = node_feature_mask(
                feature_mask, path_t[bl].expand(2, num_f),
                interaction_sets, ub, hp.feature_fraction_bynode)
            rows, kid_bits = best_of(
                torch.stack([hist[bl], hist[new_leaf]]), kid[:, 0],
                kid[:, 1], kid[:, 2], fm,
                leaves=torch.tensor([bl, new_leaf], device=dev),
                depth=(torch.full((2,), d, dtype=i32, device=dev) if pen
                       else None), rand=er, **con)
            best[bl].copy_(rows[0])
            best[new_leaf].copy_(rows[1])
            if cat:
                bits[bl].copy_(kid_bits[0])
                bits[new_leaf].copy_(kid_bits[1])
        i += 1

    # one upload per dtype: the host-side topology and node operands
    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
            dev, non_blocking=True)

    ints = up([split_feature, split_bin, default_left, left_child,
               right_child, split_cat], np.int32)
    nodes = up(node_f32, np.float32)
    live_node = torch.arange(li, device=dev) < i
    live_leaf = torch.arange(L, device=dev) < i + 1
    zero = torch.zeros((), dtype=f32, device=dev)
    l2_leaf = l2
    if cat:
        # the JAX package's f32 l2 + (subset ? cat_l2 : 0) of each leaf's
        # last split
        l2_leaf = l2 + torch.where(up(subset_leaf, bool), hp.cat_l2, 0.0)
    if track:
        leaf_value = leaf_val
    else:
        leaf_value = torch.where(
            live_leaf, leaf_output(sums[:, 0], sums[:, 1], l1, l2_leaf, mds),
            zero)
    tree = TreeArrays(
        split_feature=ints[0], split_bin=ints[1],
        default_left=ints[2].to(torch.bool),
        split_cat=ints[5].to(torch.bool),
        left_child=ints[3], right_child=ints[4], split_gain=nodes[0],
        cat_bitset=(cat_bitset if cat else torch.zeros(
            li, hp.n_bins, dtype=torch.bool, device=dev)),
        internal_value=torch.where(
            live_node, leaf_output(nodes[1], nodes[2], l1, l2, mds), zero),
        internal_count=nodes[3],
        leaf_value=leaf_value,
        leaf_count=sums[:, 2].clone(), leaf_weight=sums[:, 1].clone(),
        leaf_depth=up(depth, np.int32), leaf_path=up(path, bool),
        num_leaves=torch.full((), i + 1, dtype=i32, device=dev))
    return tree, lor


def _forced_pack(hf, sums_leaf, fl, ff, ft, f_cat, nan_bin_f, bundle,
                 hp) -> torch.Tensor:
    """f32 [16]: forced entry (leaf ``fl``, feature ``ff``, bin ``ft``)
    laid out as the strict learner's split pack (leaf, the best-split
    table row, parent sums, right child's sums), then its validity 0/1.
    ``hf`` [B, C]: the leaf's histogram of the feature's physical column;
    ``sums_leaf`` [3]: its (g, h, count)."""
    dev = hf.device
    f32 = torch.float32
    pg, ph, pc = sums_leaf[0], sums_leaf[1], sums_leaf[2]
    if bundle is not None:
        hf = _expand_hist_col(hf, bundle, ff, pg, ph, pc)
    lg, lh, lc, gain, ok = gather_forced_split(
        hf, pg, ph, pc, ft, torch.tensor(f_cat, device=dev), nan_bin_f, hp)
    var = VAR_CAT_ONEHOT if f_cat else VAR_NUM_RIGHT

    def c(v):
        return torch.full((), v, dtype=f32, device=dev)

    left = torch.stack([lg, lh, lc])
    return torch.cat([torch.stack([c(fl), gain, c(ff), c(ft), c(0.0),
                                   c(var), lg, lh, lc]), sums_leaf,
                      sums_leaf - left, ok.to(f32).reshape(1)])


def _constrained_children(kid, var, catl, feat, thr, bl, new_leaf, i, row,
                          bl_t, leaf_val, leaf_min, leaf_max, hp, mono_h,
                          monotone, boxes):
    """Split ``i``'s children under smoothing or monotone constraints (the
    JAX package's grower.py:693-770): their outputs, smoothed toward the
    parent's and clipped into its bounds, written into ``leaf_val``; the
    basic method's midpoint bounds, or (``boxes``: the intermediate and
    advanced methods' (leaf_lo, leaf_hi), split here) every leaf's bounds
    refreshed from the boxes, written into ``leaf_min`` / ``leaf_max``.
    ``kid`` f32 [2, 3]: the children's (g, h, count); ``row`` the
    parent's best-split table row and ``bl_t`` its leaf id, on the
    device.  Returns the children's (outputs, mins, maxes), f32 [2]
    each."""
    dev = kid.device
    l2_eff = hp.lambda_l2 + torch.full(
        (), hp.cat_l2 if var >= VAR_CAT_FWD else 0.0, dtype=torch.float32,
        device=dev)
    out = smoothed_output(kid[:, 0], kid[:, 1], kid[:, 2], leaf_val[bl],
                          hp.lambda_l1, l2_eff, hp)
    lo, ro = out[0], out[1]
    # copies: the views would follow the writes below
    lmin_p, lmax_p = leaf_min[bl].clone(), leaf_max[bl].clone()
    lmin_l = lmin_r = lmin_p
    lmax_l = lmax_r = lmax_p
    m = 0 if catl or mono_h is None else int(mono_h[feat])
    if hp.use_monotone:
        lo = torch.clamp(lo, lmin_p, lmax_p)
        ro = torch.clamp(ro, lmin_p, lmax_p)
        if boxes is not None:
            # siblings clipped to the parent's range may come out against
            # the split feature's direction: collapse them to the midpoint
            if m != 0:
                inv = (lo > ro) if m > 0 else (lo < ro)
                mid = torch.clamp((lo + ro) * 0.5, lmin_p, lmax_p)
                lo = torch.where(inv, mid, lo)
                ro = torch.where(inv, mid, ro)
        elif m != 0:
            mid = (lo + ro) * 0.5
            if m > 0:
                lmax_l = torch.minimum(lmax_p, mid)
                lmin_r = torch.maximum(lmin_p, mid)
            else:
                lmin_l = torch.maximum(lmin_p, mid)
                lmax_r = torch.minimum(lmax_p, mid)
    leaf_val[bl] = lo
    leaf_val[new_leaf] = ro
    if boxes is not None:
        leaf_lo, leaf_hi = boxes
        split_boxes(leaf_lo, leaf_hi, bl_t, torch.full_like(bl_t, new_leaf),
                    row[_FEAT:_FEAT + 1].long(), row[_THR:_THR + 1].long(),
                    torch.full((1,), not catl, dtype=torch.bool,
                               device=dev))
        lower, upper = box_bounds(leaf_lo, leaf_hi, leaf_val, monotone,
                                  i + 2)
        leaf_min.copy_(lower)
        leaf_max.copy_(upper)
        ids = torch.cat([bl_t, torch.full_like(bl_t, new_leaf)])
        return leaf_val[ids], lower[ids], upper[ids]
    leaf_min[bl], leaf_min[new_leaf] = lmin_l, lmin_r
    leaf_max[bl], leaf_max[new_leaf] = lmax_l, lmax_r
    return (torch.stack([lo, ro]), torch.stack([lmin_l, lmin_r]),
            torch.stack([lmax_l, lmax_r]))
