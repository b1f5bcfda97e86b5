"""Best-split finding from histograms.

Counterpart of ``lightgbm_tpu/ops/split.py`` (reference
src/treelearner/feature_histogram.hpp:832 ``FindBestThresholdSequentially``)
for numeric features with missing values, batched over a leading leaf axis:
cumulative sums along the bin axis give every threshold's left-side stats,
both missing-value directions are evaluated as a variant axis, and one flat
argmax per leaf picks the winner.  The arithmetic follows the JAX package
operation by operation in f32, so quantized-level histograms (integer sums
times power-of-two scales, exact in any order) give the same splits bit for
bit.

Not ported yet: categorical splits, monotone constraints, path smoothing,
extra-trees random thresholds and CEGB penalties (the grower rejects the
configurations that need them).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

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


#: candidate-variant indices (the JAX package's first two; the categorical
#: variants 2-4 are never candidates on numeric data)
VAR_NUM_RIGHT = 0    # numerical, missing goes right
VAR_NUM_LEFT = 1     # numerical, missing goes left
NUM_VARIANTS = 2


class SplitResult(NamedTuple):
    """Chosen split per leaf (reference split_info.hpp:294 ``SplitInfo``);
    every field has the leaf axis of the input."""
    gain: torch.Tensor          # f32 — improvement; <= 0 means "don't split"
    feature: torch.Tensor       # i32 packed feature index
    threshold: torch.Tensor     # i32 bin threshold (left = bin <= threshold)
    default_left: torch.Tensor  # bool — missing goes left
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


def find_best_split(hist: torch.Tensor, sum_g: torch.Tensor,
                    sum_h: torch.Tensor, count: torch.Tensor,
                    num_bins: torch.Tensor, nan_bin: torch.Tensor,
                    feature_mask: Optional[torch.Tensor],
                    hp: SplitHyper) -> SplitResult:
    """Best (feature, threshold, default direction) of M leaves at once.

    hist: f32 [M, F, B, C>=3] (grad, hess, count); sum_g/sum_h/count: f32
    [M] leaf totals; num_bins/nan_bin: i32 [F]; feature_mask: bool [F] or
    None.
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
    gm = torch.where(is_nan, g, zero).sum(-1, keepdim=True)     # [M, F, 1]
    hm = torch.where(is_nan, h, zero).sum(-1, keepdim=True)
    nm = torch.where(is_nan, n, zero).sum(-1, keepdim=True)
    has_missing = nanb >= 0                                     # [F, 1]

    l1, l2 = hp.lambda_l1, hp.lambda_l2
    output_path = hp.max_delta_step > 0.0
    if output_path:
        po = leaf_output(sum_g, sum_h, l1, l2, hp.max_delta_step)
        parent_gain = gain_given_output(sum_g, sum_h, po, l1, l2)
    else:
        parent_gain = leaf_gain(sum_g, sum_h, l1, l2)
    min_shift = parent_gain + hp.min_gain_to_split              # [M]
    sg = sum_g[:, None, None]
    sh = sum_h[:, None, None]
    sc = count[:, None, None]

    def variant_gain(gl_v, hl_v, nl_v):
        gr = sg - gl_v
        hr = sh - hl_v
        nr = sc - nl_v
        if not output_path:
            gain = leaf_gain(gl_v, hl_v, l1, l2) + leaf_gain(gr, hr, l1, l2)
        else:
            lo = leaf_output(gl_v, hl_v, l1, l2, hp.max_delta_step)
            ro = leaf_output(gr, hr, l1, l2, hp.max_delta_step)
            gain = (gain_given_output(gl_v, hl_v, lo, l1, l2)
                    + gain_given_output(gr, hr, ro, l1, l2))
        ok = ((nl_v >= hp.min_data_in_leaf) & (nr >= hp.min_data_in_leaf)
              & (hl_v >= hp.min_sum_hessian_in_leaf)
              & (hr >= hp.min_sum_hessian_in_leaf))
        return torch.where(ok, gain, torch.full_like(gain, NEG_INF))

    # threshold t splits {bin <= t} | {bin > t}; t == last real bin only
    # splits off the missing bin, t at the nan bin itself is invalid
    thr_ok = valid_bin & (bin_idx < nb - 1) & ~is_nan           # [F, B]
    neg = torch.full((), NEG_INF, dtype=hist.dtype, device=dev)
    gain_right = torch.where(thr_ok, variant_gain(gl, hl, nl), neg)
    gain_left = torch.where(thr_ok & has_missing,
                            variant_gain(gl + gm, hl + hm, nl + nm), neg)
    cand = torch.stack([gain_right, gain_left], dim=-1)         # [M, F, B, V]
    if feature_mask is not None:
        fm = feature_mask.to(dev)
        cand = torch.where(fm[..., None, None], cand, neg)

    flat = cand.reshape(M, -1)
    best = torch.argmax(flat, dim=1)                            # first max
    best_gain_raw = flat.gather(1, best[:, None])[:, 0]
    feat = best // (B * NUM_VARIANTS)
    rem = best % (B * NUM_VARIANTS)
    thr = rem // NUM_VARIANTS
    variant = rem % NUM_VARIANTS
    m_idx = torch.arange(M, device=dev)
    left_nan = variant == VAR_NUM_LEFT
    lg = torch.where(left_nan, gl[m_idx, feat, thr] + gm[m_idx, feat, 0],
                     gl[m_idx, feat, thr])
    lh = torch.where(left_nan, hl[m_idx, feat, thr] + hm[m_idx, feat, 0],
                     hl[m_idx, feat, thr])
    ln = torch.where(left_nan, nl[m_idx, feat, thr] + nm[m_idx, feat, 0],
                     nl[m_idx, feat, thr])
    gain = best_gain_raw - min_shift
    return SplitResult(
        gain=torch.where(best_gain_raw <= NEG_INF / 2, neg, gain),
        feature=feat.to(torch.int32), threshold=thr.to(torch.int32),
        default_left=left_nan, variant=variant.to(torch.int32),
        left_sum_g=lg, left_sum_h=lh, left_count=ln,
        right_sum_g=sum_g - lg, right_sum_h=sum_h - lh,
        right_count=count - ln)
