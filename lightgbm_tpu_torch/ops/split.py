"""Best-split finding from histograms.

Counterpart of ``lightgbm_tpu/ops/split.py`` (reference
src/treelearner/feature_histogram.hpp:832 ``FindBestThresholdSequentially``)
batched over a leading leaf axis: cumulative sums along the bin axis give
every threshold's left-side stats, both missing-value directions are
evaluated as a variant axis, and one flat argmax per leaf picks the winner.
Categorical features (``SplitHyper.has_categorical``) add the JAX package's
three candidate families to the variant axis, which is then five wide: the
one-hot split ``{bin == t}`` up to ``max_cat_to_onehot`` bins, and the
prefixes of the bins sorted by ``g / (h + cat_smooth)``, ascending and
descending (:func:`categorical_left_bitset` turns a winner into the set of
bins going left).  The arithmetic follows the JAX package operation by
operation in f32, so quantized-level histograms (integer sums times
power-of-two scales, exact in any order) give the same splits bit for bit.

The sorts are stable (``jnp.argsort`` is) and their keys are made
canonical (``key + 0.0`` turns -0.0 into +0.0): a CUDA radix sort orders
-0.0 before +0.0, where the JAX package's CPU comparison sort takes them
as equal, so a category whose gradient sum is exactly zero would otherwise
move between the card and the CPU.

Split constraints follow the JAX package's order of operations
(``lightgbm_tpu/ops/split.py:186-400``): each candidate child's output is
the smoothed output (``path_smooth`` pulls it toward the leaf's own
output), clipped into the leaf's monotone bounds (or, under the advanced
method, into per-threshold bounds that replace them); a candidate whose
clipped outputs break its feature's monotone direction is forbidden; the
parent-gain shift is evaluated at the leaf's actual output under
smoothing; extra trees keep one random threshold per feature and variant
family, from uniforms the grower draws (ops/prng.py ``draw``); and
``monotone_penalty`` scales the final gains of monotone features by a
factor that decays with depth before the flat argmax.

Not ported yet: CEGB penalties (the booster rejects them).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SplitHyper:
    """Static split/growth hyperparameters (reference config.h
    learning-control block); the same fields as the JAX package's, so one
    config gives one value of each."""
    num_leaves: int = 31
    max_depth: int = -1
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    max_delta_step: float = 0.0
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_threshold: int = 32
    max_cat_to_onehot: int = 4
    min_data_per_group: int = 100
    use_monotone: bool = False
    monotone_penalty: float = 0.0
    monotone_method: str = "basic"
    extra_trees: bool = False
    feature_fraction_bynode: float = 1.0
    has_categorical: bool = False
    n_bins: int = 256
    rows_per_block: int = 4096
    path_smooth: float = 0.0
    hist_dtype: str = "float32"
    hist_kernel: str = "auto"
    leaf_hist: str = "masked"
    hist_pool_slots: int = 0


#: candidate-variant indices along the last axis of the gain tensor (the
#: JAX package's); all-numeric data stacks only the first two
VAR_NUM_RIGHT = 0    # numerical, missing goes right
VAR_NUM_LEFT = 1     # numerical, missing goes left
VAR_CAT_ONEHOT = 2   # categorical one-hot: {bin == t} left
VAR_CAT_FWD = 3      # categorical sorted-subset, ascending-score prefix
VAR_CAT_BWD = 4      # categorical sorted-subset, descending-score prefix
NUM_VARIANTS = 5


class SplitResult(NamedTuple):
    """Chosen split per leaf (reference split_info.hpp:294 ``SplitInfo``);
    every field has the leaf axis of the input."""
    gain: torch.Tensor          # f32 — improvement; <= 0 means "don't split"
    feature: torch.Tensor       # i32 packed feature index
    threshold: torch.Tensor     # i32 bin threshold (left = bin <= threshold);
                                # sorted-subset variants: prefix length - 1
    default_left: torch.Tensor  # bool — missing goes left
    is_categorical: torch.Tensor  # bool — any categorical variant
    variant: torch.Tensor       # i32 VAR_* of the winner
    left_sum_g: torch.Tensor
    left_sum_h: torch.Tensor
    left_count: torch.Tensor
    right_sum_g: torch.Tensor
    right_sum_h: torch.Tensor
    right_count: torch.Tensor


def _cumsum_bins(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the bin axis (last).  Exact, and so equal to the
    JAX package's matmul scan, on quantized-level histograms."""
    return torch.cumsum(x, dim=-1)


def threshold_l1(s: torch.Tensor, l1: float) -> torch.Tensor:
    """Soft-threshold (reference feature_histogram.hpp ThresholdL1)."""
    if l1 <= 0.0:
        return s
    return torch.sign(s) * torch.clamp(s.abs() - l1, min=0.0)


def leaf_gain(g: torch.Tensor, h: torch.Tensor, l1: float,
              l2: float) -> torch.Tensor:
    t = threshold_l1(g, l1)
    return (t * t) / (h + l2 + 1e-15)


def leaf_output(g: torch.Tensor, h: torch.Tensor, l1: float, l2: float,
                max_delta_step: float = 0.0) -> torch.Tensor:
    """CalculateSplittedLeafOutput (feature_histogram.hpp static)."""
    out = -threshold_l1(g, l1) / (h + l2 + 1e-15)
    if max_delta_step > 0.0:
        out = torch.clamp(out, -max_delta_step, max_delta_step)
    return out


def gain_given_output(g: torch.Tensor, h: torch.Tensor, out: torch.Tensor,
                      l1: float, l2: float) -> torch.Tensor:
    """GetLeafGainGivenOutput (feature_histogram.hpp)."""
    return -(2.0 * threshold_l1(g, l1) * out + (h + l2) * out * out)


def smoothed_output(g: torch.Tensor, h: torch.Tensor, n: torch.Tensor,
                    parent_output, l1: float, l2, hp: SplitHyper
                    ) -> torch.Tensor:
    """Leaf output with max_delta_step clipping and path smoothing toward
    the parent (feature_histogram.hpp CalculateSplittedLeafOutput
    USE_SMOOTHING: out' = (n out + path_smooth parent) / (n +
    path_smooth), as out w + parent (1 - w))."""
    out = leaf_output(g, h, l1, l2, hp.max_delta_step)
    if hp.path_smooth > 0.0:
        w = n / (n + hp.path_smooth)
        out = out * w + parent_output * (1.0 - w)
    return out


def monotone_penalty_factor(depth: torch.Tensor,
                            penalty: float) -> torch.Tensor:
    """f32 [M]: the gain factor of a monotone feature's split at leaf depth
    ``depth`` (reference monotone_constraints.hpp:357
    ComputeMonotoneSplitGainPenalty; the JAX package's float32 steps)."""
    d = depth.to(torch.float32)
    # fills, not torch.tensor: a captured round copies nothing from the host
    p = torch.full((), penalty, dtype=torch.float32, device=d.device)
    eps = torch.full((), 1e-10, dtype=torch.float32, device=d.device)
    one = torch.ones((), dtype=torch.float32, device=d.device)
    return torch.where(
        p >= d + 1.0, eps,
        torch.where(p <= 1.0, one - p / torch.exp2(d) + eps,
                    one - torch.exp2(p - 1.0 - d) + eps))


def find_best_split(hist: torch.Tensor, sum_g: torch.Tensor,
                    sum_h: torch.Tensor, count: torch.Tensor,
                    num_bins: torch.Tensor, nan_bin: torch.Tensor,
                    is_cat: Optional[torch.Tensor],
                    feature_mask: Optional[torch.Tensor],
                    hp: SplitHyper,
                    monotone: Optional[torch.Tensor] = None,
                    parent_output: Optional[torch.Tensor] = None,
                    leaf_min: Optional[torch.Tensor] = None,
                    leaf_max: Optional[torch.Tensor] = None,
                    depth: Optional[torch.Tensor] = None,
                    rand: Optional[Sequence] = None,
                    adv_bounds: Optional[Sequence] = None,
                    gain_penalty: Optional[torch.Tensor] = None
                    ) -> SplitResult:
    """Best (feature, threshold, default direction) of M leaves at once.

    hist: f32 [M, F, B, C>=3] (grad, hess, count); sum_g/sum_h/count: f32
    [M] leaf totals; num_bins/nan_bin: i32 [F]; is_cat: bool [F] (read only
    when ``hp.has_categorical``; None for all-numeric data); feature_mask:
    bool [F], [M, F] (a mask a leaf) or None.

    Split constraints, read where ``hp`` turns them on: monotone int [F]
    (categorical features 0) with ``hp.use_monotone``; parent_output f32
    [M], each leaf's own output (the smoothing target); leaf_min /
    leaf_max f32 [M], the leaves' output bounds; depth int [M] (the
    monotone penalty); rand: with ``hp.extra_trees``, the uniforms f32
    [M, F] of the numeric threshold draw and, on categorical data, of the
    one-hot and the sorted-subset draws (the JAX package's
    ``split(key, 3)`` keys' ``uniform(k, (F,))``); adv_bounds: the
    advanced method's (lmin_left, lmax_left, lmin_right, lmax_right), f32
    [M, F, B] each, which replace the leaf bounds on the numeric
    thresholds; gain_penalty: f32 [M, F], CEGB's per-feature cost of each
    leaf, subtracted from every candidate that is not -inf before the
    argmax (the JAX package's order: after the feature mask, before the
    monotone penalty).
    """
    M, F, B = hist.shape[0], hist.shape[1], hist.shape[2]
    dev = hist.device
    g, h, n = hist[..., 0], hist[..., 1], hist[..., 2]          # [M, F, B]
    bin_idx = torch.arange(B, device=dev)[None, :]              # [1, B]
    nb = num_bins.to(dev).long()[:, None]
    nanb = nan_bin.to(dev).long()[:, None]
    valid_bin = bin_idx < nb                                    # [F, B]
    is_nan = bin_idx == nanb                                    # [F, B]
    zero = torch.zeros((), dtype=hist.dtype, device=dev)

    # base cumulatives exclude the missing bin; its stats ride variant 1
    gl = _cumsum_bins(torch.where(is_nan, zero, g))
    hl = _cumsum_bins(torch.where(is_nan, zero, h))
    nl = _cumsum_bins(torch.where(is_nan, zero, n))
    # a NaN bin with no rows (its count channel is exact) is empty: a
    # subtraction residual in its grad/hess would break the exact tie of
    # the two default directions, which then goes right
    nan_rows = is_nan & (n != 0)
    gm = torch.where(nan_rows, g, zero).sum(-1, keepdim=True)   # [M, F, 1]
    hm = torch.where(nan_rows, h, zero).sum(-1, keepdim=True)
    nm = torch.where(is_nan, n, zero).sum(-1, keepdim=True)
    has_missing = nanb >= 0                                     # [F, 1]

    l1, l2 = hp.lambda_l1, hp.lambda_l2
    mono = hp.use_monotone
    # the closed form g^2 / (h + l2) holds only at the unconstrained
    # optimum: smoothing, clipping and monotone bounds evaluate the gain at
    # the output itself, the parent's at its actual output
    output_path = mono or hp.path_smooth > 0.0 or hp.max_delta_step > 0.0
    if hp.path_smooth > 0.0:
        parent_gain = gain_given_output(sum_g, sum_h, parent_output, l1, l2)
    elif hp.max_delta_step > 0.0:
        po = leaf_output(sum_g, sum_h, l1, l2, hp.max_delta_step)
        parent_gain = gain_given_output(sum_g, sum_h, po, l1, l2)
    else:
        parent_gain = leaf_gain(sum_g, sum_h, l1, l2)
    min_shift = parent_gain + hp.min_gain_to_split              # [M]
    sg = sum_g[:, None, None]
    sh = sum_h[:, None, None]
    sc = count[:, None, None]
    pout = None if parent_output is None else parent_output[:, None, None]
    if mono:
        lmin = leaf_min[:, None, None]
        lmax = leaf_max[:, None, None]
        mono_f = monotone.to(dev)[None, :, None]                # [1, F, 1]

    def variant_gain(gl_v, hl_v, nl_v, l2_v, bnds=None):
        gr = sg - gl_v
        hr = sh - hl_v
        nr = sc - nl_v
        if not output_path:
            gain = (leaf_gain(gl_v, hl_v, l1, l2_v)
                    + leaf_gain(gr, hr, l1, l2_v))
        else:
            lo = smoothed_output(gl_v, hl_v, nl_v, pout, l1, l2_v, hp)
            ro = smoothed_output(gr, hr, nr, pout, l1, l2_v, hp)
            if mono and bnds is not None:
                # advanced: the per-threshold bounds replace the leaf's
                bmin_l, bmax_l, bmin_r, bmax_r = bnds
                lo = torch.clamp(lo, bmin_l, bmax_l)
                ro = torch.clamp(ro, bmin_r, bmax_r)
            elif mono:
                lo = torch.clamp(lo, lmin, lmax)
                ro = torch.clamp(ro, lmin, lmax)
            gain = (gain_given_output(gl_v, hl_v, lo, l1, l2_v)
                    + gain_given_output(gr, hr, ro, l1, l2_v))
            if mono:
                # outputs against the feature's direction: no split
                # (feature_histogram.hpp:788-791)
                bad = ((mono_f > 0) & (lo > ro)) | ((mono_f < 0) & (lo < ro))
                gain = torch.where(bad, torch.full_like(gain, NEG_INF),
                                   gain)
        ok = ((nl_v >= hp.min_data_in_leaf) & (nr >= hp.min_data_in_leaf)
              & (hl_v >= hp.min_sum_hessian_in_leaf)
              & (hr >= hp.min_sum_hessian_in_leaf))
        return torch.where(ok, gain, torch.full_like(gain, NEG_INF))

    # threshold t splits {bin <= t} | {bin > t}; t == last real bin only
    # splits off the missing bin, t at the nan bin itself is invalid
    thr_ok = valid_bin & (bin_idx < nb - 1) & ~is_nan           # [F, B]
    cat = None
    if hp.has_categorical:
        cat = is_cat.to(dev)
        thr_ok = thr_ok & ~cat[:, None]
    neg = torch.full((), NEG_INF, dtype=hist.dtype, device=dev)
    adv = adv_bounds if mono else None
    gain_right = torch.where(thr_ok, variant_gain(gl, hl, nl, l2, adv), neg)
    gain_left = torch.where(thr_ok & has_missing,
                            variant_gain(gl + gm, hl + hm, nl + nm, l2, adv),
                            neg)
    families = [gain_right, gain_left]
    if cat is not None:
        cat_gains, cat_left, k_limit = _categorical_candidates(
            g, h, n, valid_bin, nb[:, 0], cat, sc, variant_gain, hp)
        families += cat_gains
    if hp.extra_trees and rand is not None:
        # one random candidate threshold per feature and variant family
        # (reference feature_histogram.cpp USE_RAND)
        def keep(u, span):
            r = torch.floor(u * span.to(torch.float32)).to(torch.int64)
            return bin_idx == r[..., None]                      # [M, F, B]

        keep_num = keep(rand[0], torch.clamp(nb[:, 0] - 1, min=1))
        families[0] = torch.where(keep_num, families[0], neg)
        families[1] = torch.where(keep_num, families[1], neg)
        if cat is not None:
            families[2] = torch.where(keep(rand[1], nb[:, 0]), families[2],
                                      neg)
            max_thr = torch.clamp(k_limit[..., 0] - 1, min=0)   # [M, F]
            keep_sub = keep(rand[2], max_thr + 1)
            families[3] = torch.where(keep_sub, families[3], neg)
            families[4] = torch.where(keep_sub, families[4], neg)
    V = len(families)
    cand = torch.stack(families, dim=-1)                        # [M, F, B, V]
    if feature_mask is not None:
        fm = feature_mask.to(dev)
        cand = torch.where(fm[..., None, None], cand, neg)
    if gain_penalty is not None:
        # CEGB (cost_effective_gradient_boosting.hpp DeltaGain)
        cand = torch.where(cand > NEG_INF / 2,
                           cand - gain_penalty.to(dev)[:, :, None, None],
                           cand)
    if mono and hp.monotone_penalty > 0.0:
        # the depth-decaying penalty on monotone features, applied to the
        # final gain before the argmax (serial_tree_learner.cpp:994)
        pen = monotone_penalty_factor(depth.to(dev), hp.monotone_penalty)
        pen_f = torch.where(monotone.to(dev)[None, :] != 0, pen[:, None],
                            torch.ones((), dtype=hist.dtype, device=dev))
        final = cand - min_shift[:, None, None, None]
        cand = torch.where(final > 0, final * pen_f[..., None, None], neg)
        min_shift = torch.zeros_like(min_shift)

    flat = cand.reshape(M, -1)
    best = torch.argmax(flat, dim=1)                            # first max
    best_gain_raw = flat.gather(1, best[:, None])[:, 0]
    feat = best // (B * V)
    rem = best % (B * V)
    thr = rem // V
    variant = rem % V
    m_idx = torch.arange(M, device=dev)

    def at(x):
        return x[m_idx, feat, thr]

    # the winner's left-side stats, one row a variant family
    lgs = [at(gl), at(gl) + gm[m_idx, feat, 0]]
    lhs = [at(hl), at(hl) + hm[m_idx, feat, 0]]
    lns = [at(nl), at(nl) + nm[m_idx, feat, 0]]
    if cat is not None:
        lgs.append(at(g))
        lhs.append(at(h))
        lns.append(at(n))
        for glv, hlv, nlv in cat_left:
            lgs.append(at(glv))
            lhs.append(at(hlv))
            lns.append(at(nlv))
    sel = variant[None, :]

    def pick(rows):
        return torch.stack(rows).gather(0, sel)[0]

    lg, lh, ln = pick(lgs), pick(lhs), pick(lns)
    gain = best_gain_raw - min_shift
    return SplitResult(
        gain=torch.where(best_gain_raw <= NEG_INF / 2, neg, gain),
        feature=feat.to(torch.int32), threshold=thr.to(torch.int32),
        default_left=variant == VAR_NUM_LEFT,
        is_categorical=variant >= VAR_CAT_ONEHOT,
        variant=variant.to(torch.int32),
        left_sum_g=lg, left_sum_h=lh, left_count=ln,
        right_sum_g=sum_g - lg, right_sum_h=sum_h - lh,
        right_count=count - ln)


#: the sort key of a bin that is no sorted-subset candidate
_NOT_CANDIDATE = 1e30


def _subset_key(score: torch.Tensor, cand: torch.Tensor,
                descending) -> torch.Tensor:
    """The sort key of the sorted-subset scans: the score (negated for
    ``descending``, a bool or a bool tensor), 1e30 on bins that are no
    candidate, -0.0 made +0.0 (the JAX package's CPU sort takes them as
    equal, a CUDA radix sort does not)."""
    if isinstance(descending, bool):
        signed = -score if descending else score
    else:
        signed = torch.where(descending, -score, score)
    return torch.where(cand, signed,
                       torch.full_like(score, _NOT_CANDIDATE)) + 0.0


def _categorical_candidates(g, h, n, valid_bin, nb, cat, sc, variant_gain,
                            hp: SplitHyper):
    """The JAX package's categorical candidate families (ops/split.py
    :289-333) over [M, F, B]: ([one-hot, ascending, descending] gains,
    [(left g, h, count) cumulatives of the two sorted scans], the prefix
    cap k_limit [M, F, 1]).

    One-hot (reference feature_histogram.cpp:179): ``{bin == t}`` goes
    left on features of at most ``max_cat_to_onehot`` bins, plain
    ``lambda_l2``.  Sorted-subset (feature_histogram.cpp:241-340): the
    bins of count >= ``cat_smooth``, sorted by g / (h + cat_smooth);
    prefixes of either order, capped at min(max_cat_threshold, (used +
    1) // 2), are the left sets, scored with l2 + cat_l2 and gated by
    ``min_data_per_group`` (the left count crosses a multiple of it and
    the right keeps at least as many)."""
    dev = g.device
    bin_idx = torch.arange(g.shape[-1], device=dev)[None, :]
    neg = torch.full((), NEG_INF, dtype=g.dtype, device=dev)
    onehot_ok = cat[:, None] & (nb[:, None] <= hp.max_cat_to_onehot)
    gain_cat = torch.where(valid_bin & onehot_ok,
                           variant_gain(g, h, n, hp.lambda_l2), neg)

    l2c = hp.lambda_l2 + hp.cat_l2
    subset_feat = cat & (nb > hp.max_cat_to_onehot)             # [F]
    cand = valid_bin & subset_feat[:, None] & (n >= hp.cat_smooth)
    used = cand.sum(-1, keepdim=True)                           # [M, F, 1]
    max_num_cat = torch.clamp((used + 1) // 2, max=hp.max_cat_threshold)
    k_limit = torch.minimum(used, max_num_cat)
    score = g / (h + hp.cat_smooth)
    gains, lefts = [gain_cat], []
    for descending in (False, True):
        order = torch.argsort(_subset_key(score, cand, descending), dim=-1,
                              stable=True)
        gs = torch.take_along_dim(g * cand, order, dim=-1)
        hs = torch.take_along_dim(h * cand, order, dim=-1)
        ns = torch.take_along_dim(n * cand, order, dim=-1)
        glv, hlv, nlv = _cumsum_bins(gs), _cumsum_bins(hs), _cumsum_bins(ns)
        ok = bin_idx < k_limit
        if hp.min_data_per_group > 1:
            mdpg = float(hp.min_data_per_group)
            crossed = (torch.floor(nlv / mdpg)
                       > torch.floor((nlv - ns) / mdpg))
            ok = ok & crossed & ((sc - nlv) >= mdpg)
        gains.append(torch.where(ok, variant_gain(glv, hlv, nlv, l2c), neg))
        lefts.append((glv, hlv, nlv))
    return gains, lefts, k_limit


def categorical_left_bitset(hist_f: torch.Tensor, num_bins_f: torch.Tensor,
                            variant: torch.Tensor, threshold: torch.Tensor,
                            hp: SplitHyper) -> torch.Tensor:
    """The bins going LEFT of M categorical splits (the JAX package's
    ``categorical_left_bitset``, batched): bool [M, B].

    hist_f: f32 [M, B, C], each leaf's histogram of its split feature;
    num_bins_f, variant, threshold: [M], the winners' fields.  One-hot:
    {threshold}; sorted-subset: the first ``threshold + 1`` bins of the
    winning direction's order, re-derived from the same histogram as the
    scan (reference feature_histogram.cpp:354-377 writes
    ``cat_threshold``).  Meaningless for a numeric variant (the growers
    mask it with ``is_cat``)."""
    B = hist_f.shape[-2]
    dev = hist_f.device
    g, h, n = hist_f[..., 0], hist_f[..., 1], hist_f[..., 2]
    bin_idx = torch.arange(B, device=dev)[None, :]
    var = variant.to(dev)[:, None]
    thr = threshold.to(dev)[:, None]
    cand = (bin_idx < num_bins_f.to(dev)[:, None]) & (n >= hp.cat_smooth)
    score = g / (h + hp.cat_smooth)
    # one sort a leaf: the argsort of the winner's direction's key
    order = torch.argsort(_subset_key(score, cand, var == VAR_CAT_BWD),
                          dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, bin_idx.expand_as(order).contiguous())
    subset_bits = (rank <= thr) & cand
    onehot_bits = bin_idx == thr
    return torch.where(var == VAR_CAT_ONEHOT, onehot_bits, subset_bits)
