"""Batched-round tree growth: K splits per data pass.

Counterpart of ``lightgbm_tpu/learner/batch_grower.py``
(``grow_tree_batched``).  Each round splits the current top-``batch``
leaves by cached gain, applies all K splits in one fused partition pass
(ops/round_fuse.py), builds the K smaller children's histograms in one
masked or compacted pass (ops/histogram.py ``histogram_for_leaves_auto``),
derives the larger siblings by subtraction from the parents, and finds the
2K children's best splits at once.  The arithmetic and every tie-break
(top-k keeps the lower leaf id first, argmax the first candidate) follow
the JAX package, so quantized-level runs grow identical trees.

The JAX package's while-loop becomes a host loop: one ``.item()`` per round
reads how many of the K slots split (the loop's progress test), and the
histogram dispatch reads the compacted row count (ops/histogram.py).  Where
``ladder_profitable`` (``hist_kernel=auto`` at >= 128 bins) and the data
has at least ``_WARMUP_MIN_ROWS`` rows, rounds of width 1, 4, 16, ... < K
run first (the JAX package's warm-up ladder): each width covers the
frontier, so the tree is the same, and the narrow masked passes take the
radix-joint kernel.

Supported here: numeric features, serial training, no bundles, no bounded
histogram pool, row masks, per-tree feature masks, depth limits,
max_delta_step, quantized levels (``hist_scale``).  Not ported yet:
categorical splits, monotone / interaction / forced splits, CEGB, linear
trees, path smoothing, by-node sampling, extra trees, EFB bundles, the
histogram pool, the distributed modes — and the strict leaf-wise grower
that ``batch < 2`` needs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.histogram import (bins_to_words, histogram_for_leaves_auto,
                             ladder_profitable, root_histogram,
                             wants_packed_mirror)
from ..ops.round_fuse import partition_payload
from ..ops.split import NEG_INF, SplitHyper, find_best_split, leaf_output
from ..utils import log
from .grower import TreeArrays

#: rows below which the warm-up ladder is skipped, as in the JAX package
#: (tests patch it on both sides to run the ladder on small data)
_WARMUP_MIN_ROWS = 65536


def check_supported(hp: SplitHyper, batch: int) -> None:
    """Raise ``LightGBMError`` naming the first configuration outside this
    grower's supported set."""
    if batch < 2:
        log.fatal("tpu_split_batch=%d needs the strict leaf-wise grower, "
                  "which lightgbm_tpu_torch does not port yet; set "
                  "tpu_split_batch >= 2" % batch)
    for bad, what in ((hp.has_categorical, "categorical features"),
                      (hp.use_monotone, "monotone_constraints"),
                      (hp.path_smooth > 0.0, "path_smooth"),
                      (hp.extra_trees, "extra_trees"),
                      (hp.feature_fraction_bynode < 1.0,
                       "feature_fraction_bynode"),
                      (hp.hist_pool_slots > 0, "histogram_pool_size")):
        if bad:
            log.fatal(f"{what} is not supported by lightgbm_tpu_torch's "
                      "batched grower yet")


def _put(arr: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> None:
    arr.index_put_((idx,), val.to(arr.dtype))


def grow_tree_batched(bins: torch.Tensor, grad: torch.Tensor,
                      hess: torch.Tensor, row_mask: Optional[torch.Tensor],
                      num_bins: torch.Tensor, nan_bin: torch.Tensor,
                      feature_mask: Optional[torch.Tensor], hp: SplitHyper,
                      batch: int = 8,
                      hist_scale: Optional[torch.Tensor] = None,
                      bins_t: Optional[torch.Tensor] = None,
                      bins_words: Optional[torch.Tensor] = None,
                      bins_words_t: Optional[torch.Tensor] = None
                      ) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree with ``batch`` splits per histogram pass.

    bins: u8 [n, F] row-major; grad/hess: f32 [n] (integer levels when
    ``hist_scale`` (f32 [2], the grad/hess scales) is given); row_mask:
    bool [n] or None; num_bins/nan_bin: i32 [F]; feature_mask: bool [F] or
    None.  ``bins_t`` (u8 [F, n]), ``bins_words`` (i32 [n, ceil(F/4)]) and,
    where the packed kernel may run, ``bins_words_t`` (its transpose) are
    the tree-invariant layouts, derived here when not passed.
    Returns (TreeArrays, leaf_of_row i32 [n]).
    """
    check_supported(hp, batch)
    dev = grad.device
    f32, i32 = torch.float32, torch.int32
    n, num_f = bins.shape
    L = hp.num_leaves
    K = min(batch, L - 1)
    l1, l2, mds = hp.lambda_l1, hp.lambda_l2, hp.max_delta_step
    mask_f = torch.ones_like(grad) if row_mask is None else row_mask.to(f32)
    mask_i = mask_f.to(i32)
    if bins_t is None:
        bins_t = bins.t().contiguous()
    if bins_words is None:
        bins_words = bins_to_words(bins)
    words_t = None
    if wants_packed_mirror(hp.hist_kernel, hp.n_bins):
        words_t = bins_words_t if bins_words_t is not None \
            else bins_words.t().contiguous()
    num_bins = num_bins.to(dev)
    nan_bin = nan_bin.to(dev)
    scale_vec = None
    if hist_scale is not None:
        scale_vec = torch.cat([hist_scale.to(f32),
                               torch.ones(2, dtype=f32, device=dev)])

    def scaled(h):
        return h if scale_vec is None else h * scale_vec

    def child_best(h, g_, h_, c_, depth):
        res = find_best_split(h, g_, h_, c_, num_bins, nan_bin,
                              feature_mask, hp)
        depth_ok = (hp.max_depth <= 0) | (depth < hp.max_depth)
        return res._replace(gain=torch.where(
            depth_ok, res.gain, torch.full_like(res.gain, NEG_INF)))

    hist0 = scaled(root_histogram(bins_t, grad, hess, row_mask,
                                  n_bins=hp.n_bins, hist_dtype=hp.hist_dtype,
                                  hist_kernel=hp.hist_kernel,
                                  bins_words_t=words_t))
    g0 = (grad * mask_f).sum()
    h0 = (hess * mask_f).sum()
    c0 = mask_f.sum()
    if hist_scale is not None:
        g0 = g0 * hist_scale[0]
        h0 = h0 * hist_scale[1]
    root_out = leaf_output(g0, h0, l1, l2, mds)
    best0 = child_best(hist0[None], g0[None], h0[None], c0[None],
                       torch.zeros(1, dtype=i32, device=dev))

    # state arrays carry one trash entry past the end (node index L-1,
    # leaf index L) that the masked scatters of invalid slots aim at — the
    # JAX package's out-of-bounds mode="drop" writes
    NI, NL = L, L + 1

    def full(shape, val, dtype):
        return torch.full(shape, val, dtype=dtype, device=dev)

    split_feature = full((NI,), -1, i32)
    split_bin = full((NI,), 0, i32)
    default_left = full((NI,), False, torch.bool)
    left_child = full((NI,), -1, i32)
    right_child = full((NI,), -1, i32)
    split_gain = full((NI,), 0.0, f32)
    internal_value = full((NI,), 0.0, f32)
    internal_count = full((NI,), 0.0, f32)
    leaf_value = full((NL,), 0.0, f32)
    leaf_count = full((NL,), 0.0, f32)
    leaf_weight = full((NL,), 0.0, f32)
    leaf_depth = full((NL,), 0, i32)
    leaf_value[0] = root_out
    leaf_count[0] = c0
    leaf_weight[0] = h0

    hist = torch.zeros(NL, num_f, hp.n_bins, hist0.shape[-1], dtype=f32,
                       device=dev)
    hist[0] = hist0
    sum_g = full((NL,), 0.0, f32)
    sum_h = full((NL,), 0.0, f32)
    count = full((NL,), 0.0, f32)
    sum_g[0], sum_h[0], count[0] = g0, h0, c0
    best_gain = full((NL,), NEG_INF, f32)
    best_feat = full((NL,), 0, i32)
    best_thr = full((NL,), 0, i32)
    best_dl = full((NL,), False, torch.bool)
    best_lg = full((NL,), 0.0, f32)
    best_lh = full((NL,), 0.0, f32)
    best_lc = full((NL,), 0.0, f32)
    best_gain[0] = best0.gain[0]
    best_feat[0] = best0.feature[0]
    best_thr[0] = best0.threshold[0]
    best_dl[0] = best0.default_left[0]
    best_lg[0] = best0.left_sum_g[0]
    best_lh[0] = best0.left_sum_h[0]
    best_lc[0] = best0.left_count[0]
    parent_node = full((NL,), -1, i32)
    parent_side = full((NL,), 0, i32)
    path_f = full((NL, num_f), False, torch.bool)

    iota_f = torch.arange(num_f, device=dev)
    lor = torch.zeros(n, dtype=i32, device=dev)
    n_splits = 0

    def run_round(Kr: int) -> int:
        """One round of (up to) ``Kr`` splits; returns how many split."""
        nonlocal lor, n_splits
        topg, parents = torch.sort(best_gain[:L], descending=True,
                                   stable=True)       # ties: lower id first
        topg, parents = topg[:Kr], parents[:Kr]
        room = n_splits + torch.arange(Kr, device=dev) < L - 1
        valid = (topg > 0.0) & room
        # the round loop's progress test (the JAX while_loop condition):
        # a round in which no slot splits leaves every array unchanged
        n_valid = int(valid.sum().item())
        if n_valid == 0:
            return 0
        rank = torch.cumsum(valid.to(torch.int64), 0) - 1
        node_ids = n_splits + rank
        new_leaves = node_ids + 1

        # ---- record: one masked scatter per array (parents are distinct
        # top-k leaves, new node/leaf ids are fresh, and a shared
        # grandparent node is written on complementary sides)
        ok = valid
        bl = parents
        feat = best_feat[bl]
        thr = best_thr[bl]
        dl = best_dl[bl]
        pg, ph, pc = sum_g[bl], sum_h[bl], count[bl]
        lg, lh, lcn = best_lg[bl], best_lh[bl], best_lc[bl]
        rg, rh, rcn = pg - lg, ph - lh, pc - lcn
        ni = L - 1
        p, side = parent_node[bl].long(), parent_side[bl]
        nid_m = torch.where(ok, node_ids, ni)
        _put(left_child, torch.where(ok & (p >= 0) & (side == 0), p, ni),
             node_ids)
        _put(left_child, nid_m, -(bl + 1))
        _put(right_child, torch.where(ok & (p >= 0) & (side == 1), p, ni),
             node_ids)
        _put(right_child, nid_m, -(new_leaves + 1))
        lo = leaf_output(lg, lh, l1, l2, mds)
        ro = leaf_output(rg, rh, l1, l2, mds)
        d = leaf_depth[bl] + 1
        idx2 = torch.cat([torch.where(ok, bl, L),
                          torch.where(ok, new_leaves, L)])

        def w2(arr, vb, vn):
            _put(arr, idx2, torch.cat([vb, vn]))

        new_path = path_f[bl] | (feat[:, None] == iota_f[None, :])
        w2(path_f, new_path, new_path)
        _put(split_feature, nid_m, feat)
        _put(split_bin, nid_m, thr)
        _put(default_left, nid_m, dl)
        _put(split_gain, nid_m, best_gain[bl])
        _put(internal_value, nid_m, leaf_output(pg, ph, l1, l2, mds))
        _put(internal_count, nid_m, pc)
        w2(leaf_depth, d, d)
        w2(leaf_value, lo, ro)
        w2(leaf_count, lcn, rcn)
        w2(leaf_weight, lh, rh)
        w2(sum_g, lg, rg)
        w2(sum_h, lh, rh)
        w2(count, lcn, rcn)
        w2(parent_node, node_ids, node_ids)
        w2(parent_side, torch.zeros_like(node_ids),
           torch.ones_like(node_ids))
        _put(best_gain, torch.where(ok, bl, L),
             torch.full_like(lg, NEG_INF))

        # ---- smaller children first: the partition pass emits the next
        # histogram pass's compaction keys and payload for exactly them
        safe_nl = torch.where(valid, new_leaves, L - 1)
        l_cnt = count[parents]
        r_cnt = count[safe_nl]
        smaller = torch.where(l_cnt <= r_cnt, parents, safe_nl)

        # ---- all K partitions in ONE row pass
        feats_k = best_feat[parents]
        lor, sort_key, payload = partition_payload(
            bins_t, bins_words, grad, hess, lor, mask_i, feats_k,
            best_thr[parents], best_dl[parents].to(i32),
            nan_bin[feats_k.long()].to(i32), parents.to(i32),
            new_leaves.to(i32), valid.to(i32), smaller.to(i32))
        n_splits += n_valid

        # ---- ONE widened pass: histograms of the K smaller children
        small_cnt = torch.where(valid, torch.minimum(l_cnt, r_cnt),
                                torch.zeros_like(l_cnt))
        h_small = scaled(histogram_for_leaves_auto(
            bins_t, grad, hess, lor, smaller, row_mask, n_bins=hp.n_bins,
            rows_per_block=hp.rows_per_block, hist_dtype=hp.hist_dtype,
            counts=small_cnt, bins_words=bins_words, sort_key=sort_key,
            hist_kernel=hp.hist_kernel, payload=payload,
            bins_words_t=words_t))
        h_large = hist[parents] - h_small
        left_small = (l_cnt <= r_cnt)[:, None, None, None]
        h_left = torch.where(left_small, h_small, h_large)
        h_right = torch.where(left_small, h_large, h_small)
        _put(hist, torch.where(valid, parents, L), h_left)
        _put(hist, torch.where(valid, safe_nl, L), h_right)

        # ---- best splits of the 2K children at once
        kids = torch.cat([parents, safe_nl])
        res = child_best(torch.cat([h_left, h_right]), sum_g[kids],
                         sum_h[kids], count[kids], leaf_depth[kids])
        tgt = torch.where(torch.cat([valid, valid]), kids, L)
        _put(best_gain, tgt, res.gain)
        _put(best_feat, tgt, res.feature)
        _put(best_thr, tgt, res.threshold)
        _put(best_dl, tgt, res.default_left)
        _put(best_lg, tgt, res.left_sum_g)
        _put(best_lh, tgt, res.left_sum_h)
        _put(best_lc, tgt, res.left_count)
        return n_valid

    progress = True
    if n >= _WARMUP_MIN_ROWS and ladder_profitable(hp.hist_kernel, hp.n_bins):
        kw = 1
        while kw < K:
            if progress and n_splits < L - 1:
                progress = run_round(kw) > 0
            kw *= 4
    while progress and n_splits < L - 1:
        progress = run_round(K) > 0

    tree = TreeArrays(
        split_feature=split_feature[:L - 1], split_bin=split_bin[:L - 1],
        default_left=default_left[:L - 1],
        split_cat=full((L - 1,), False, torch.bool),
        left_child=left_child[:L - 1], right_child=right_child[:L - 1],
        split_gain=split_gain[:L - 1],
        cat_bitset=full((L - 1, hp.n_bins), False, torch.bool),
        internal_value=internal_value[:L - 1],
        internal_count=internal_count[:L - 1],
        leaf_value=leaf_value[:L], leaf_count=leaf_count[:L],
        leaf_weight=leaf_weight[:L], leaf_depth=leaf_depth[:L],
        leaf_path=path_f[:L],
        num_leaves=torch.tensor(1 + n_splits, dtype=i32, device=dev))
    return tree, lor
