"""Batched-round tree growth: K splits per data pass.

Counterpart of ``lightgbm_tpu/learner/batch_grower.py``
(``grow_tree_batched``).  Each round splits the current top-``batch``
leaves by cached gain, applies all K splits in one fused partition pass
(ops/round_fuse.py), builds the K smaller children's histograms in one
masked or compacted pass (ops/histogram.py ``histogram_for_leaves_auto``,
its bucket chosen on the device),
derives the larger siblings by subtraction from the parents, and finds the
2K children's best splits at once.  The arithmetic and every tie-break
(top-k keeps the lower leaf id first, argmax the first candidate) follow
the JAX package, so quantized-level runs grow identical trees.

A round reads nothing back (:class:`BatchedTree`): ``n_splits`` and the
progress test are device tensors and each round is gated by its live
flag.  The JAX package's while-loop becomes a host loop in the classic
loop's :func:`grow_tree_batched`, one ``.item()`` of the progress test a
K-wide round; the fused round loop runs the ladder and then a fixed
budget of K-wide rounds (:func:`full_width_rounds`) with no read at all.
Where
``ladder_profitable`` (``hist_kernel=auto`` at >= 128 bins) and the data
has at least ``_WARMUP_MIN_ROWS`` rows, rounds of width 1, 4, 16, ... < K
run first (the JAX package's warm-up ladder): each width covers the
frontier, so the tree is the same, and the narrow masked passes take the
radix-joint kernel.

With a bounded histogram pool (``SplitHyper.hist_pool_slots`` = P <
num_leaves, the JAX package's ``histogram_pool_size`` translation) the
state holds P histogram slots plus a trash slot, mapped by ``leaf_slot``
/ ``slot_leaf``.  A round then builds the histograms of the extended leaf
set [smaller children, larger children whose parent was evicted] in one
pass, allocates slots (free slots first, then the lowest cached gains;
this round's parent slots locked), and partitions with
``partition_select`` (the pass builds its own compaction keys).  At
``batch=1`` the pooled rounds grow the strict learner's tree.

EFB bundles (``bundle``, learner/grower.py ``DeviceBundle``): the bins,
their word mirror, every histogram pass and the histogram state stay over
the Fb physical bundle columns; the children's histograms are expanded to
virtual bins (``_expand_hist``) just before their best splits are found,
and the round's partition takes the decision-table variant of the fused
kernel (ops/round_fuse.py ``decision_table``): each slot's go-left bit for
every physical bin value of its feature's column, built on the device from
the inverse table.  The JAX package partitions bundled rounds in XLA
instead; the moves are the same.

Categorical features (``is_cat``, ``SplitHyper.has_categorical``): each
leaf's best split carries its variant and the bins it sends left
(learner/grower.py ``winner_bitset``, cached when the split is found, so a
pooled round needs no histogram of an evicted parent); a round records
them in ``split_cat`` / ``cat_bitset``, gives sorted-subset children
``lambda_l2 + cat_l2``, and partitions through the decision-table kernel
(a categorical slot's row of the table is its bitset), as bundled rounds
do.  The JAX package partitions these rounds in XLA; the moves are the
same.

Split constraints (the JAX package's batch_grower.py:114-136, 174-227,
500-800, 993-1075): a round records its K splits in one vectorized pass
with path smoothing and the basic monotone method's clipping and midpoint
bounds.  Under the intermediate and advanced methods each slot's children
are then clipped, written and their boxes split in slot order, every
leaf's bounds refreshed from the boxes after each slot
(learner/monotone.py ``box_bounds``): a later slot sees the outputs of the
earlier ones, so this part stays sequential (K small steps, all device
operations, captured with the round).  The 2K children's best splits get
their outputs, bounds, depths (the monotone penalty), interaction and
by-node masks, the advanced method's per-threshold bounds and the
extra-trees draws; a node's key is ``fold_in(key, node * 2 + side + 1)``
(the root's ``fold_in(key, 0)``), the tree's key words a device tensor,
so a captured round draws fresh keys every replay, one launch a draw
family (ops/prng.py ``draw``).

Forced splits (``forced``, the JAX package's batch_grower.py:230,
397-497, 1114-1126): before the gain rounds a tree runs one K = 1 round a
schedule entry (:meth:`BatchedTree.forced_phase`): the entry at
``n_splits`` is read on the device, its stats gathered at the
prescribed threshold from the leaf's histogram column (under the pool,
from the leaf's rows when its slot was evicted: one pass of the flat
masked kernel over the feature's virtual bins) and staged into the
leaf's cached best split, which the round's record then applies; a failed entry sets the device flag ``force_failed`` and the
remaining forced rounds change nothing.  The warm-up ladder is skipped
after a forced phase.  CEGB (``cegb``, batch_grower.py:125-205, 326-330,
798-834, 1020-1052): each round's splits acquire their features (for the
model, and with lazy penalties for their parents' rows) before the
partition, and the 2K children's best splits take the penalties of the
updated state (learner/grower.py ``cegb_penalty``).

Supported here: numeric and categorical features, serial training, EFB
bundles, row masks, per-tree feature masks, depth limits,
max_delta_step, quantized levels (``hist_scale``), the histogram pool,
monotone constraints (every method and the penalty), path smoothing,
extra trees, by-node sampling, interaction constraints, forced splits and
CEGB (the trees carry ``leaf_path``, which linear trees' fit reads).  Not
ported yet: the distributed modes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.histogram import (bins_to_words, histogram_for_leaves_auto,
                             ladder_profitable, root_histogram,
                             wants_packed_mirror)
from ..ops.round_fuse import (decision_table, partition_payload,
                              partition_payload_table, partition_select,
                              partition_select_table)
from ..ops import prng
from ..ops.hist_kernels import histogram_leaves
from ..ops.split import (NEG_INF, VAR_CAT_FWD, VAR_CAT_ONEHOT, VAR_NUM_RIGHT,
                         SplitHyper, find_best_split, leaf_output,
                         smoothed_output)
from ..utils import log
from .grower import (INF_BOUND, CegbState, DeviceBundle, ForcedSplits,
                     TreeArrays, _expand_hist, _expand_hist_col,
                     cegb_acquire, cegb_lazy_counts, cegb_penalty,
                     extra_tree_draws, gather_forced_split,
                     node_feature_mask, winner_bitset)
from .monotone import advanced_split_bounds, box_bounds, split_boxes

#: rows below which the warm-up ladder is skipped, as in the JAX package
#: (tests patch it on both sides to run the ladder on small data)
_WARMUP_MIN_ROWS = 65536


def pooled(hp: SplitHyper) -> bool:
    """True when the bounded histogram pool is engaged."""
    return 0 < hp.hist_pool_slots < hp.num_leaves


def check_supported(hp: SplitHyper, batch: int) -> None:
    """Raise ``LightGBMError`` naming the first configuration outside this
    grower's supported set."""
    if batch < 2 and not pooled(hp):
        log.fatal("tpu_split_batch=%d without a histogram pool is the "
                  "strict leaf-wise grower's (learner/grower.py)" % batch)
    K = min(max(batch, 1), hp.num_leaves - 1)
    if pooled(hp) and hp.hist_pool_slots < 3 * K + 2:
        log.fatal("hist_pool_slots=%d must be >= 3*batch+2 = %d"
                  % (hp.hist_pool_slots, 3 * K + 2))


def _put(arr: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> None:
    arr.index_put_((idx,), val.to(arr.dtype))


class BatchedTree:
    """One tree's growth state and rounds, with no host read: ``n_splits``
    and ``progress`` are device tensors, each round is gated by its live
    flag (``progress & n_splits < L - 1 & ~stop``; a round that is not
    live changes nothing), the histogram bucket is chosen on the device
    (ops/histogram.py ``histogram_for_leaves_auto``) and every state
    tensor is updated in place, so one round can be captured and replayed
    (boosting/fused_graph.py).  ``stop``: None, or the fused loop's bool
    0-d early-stop flag; ``is_cat``: bool [F], read when
    ``hp.has_categorical``; ``monotone`` int [F] (``hp.use_monotone``);
    ``rng_key`` int64 [2], the tree's node key words on the device (extra
    trees, by-node sampling); ``interaction_sets`` bool [S, F];
    ``forced`` the forced-split schedule (:meth:`round` with ``forced``);
    ``cegb`` the CEGB penalties and acquisition state (updated in place)."""

    def __init__(self, bins: torch.Tensor, grad: torch.Tensor,
                 hess: torch.Tensor, row_mask: Optional[torch.Tensor],
                 num_bins: torch.Tensor, nan_bin: torch.Tensor,
                 feature_mask: Optional[torch.Tensor], hp: SplitHyper,
                 batch: int = 8, hist_scale: Optional[torch.Tensor] = None,
                 bins_t: Optional[torch.Tensor] = None,
                 bins_words: Optional[torch.Tensor] = None,
                 bins_words_t: Optional[torch.Tensor] = None,
                 stop: Optional[torch.Tensor] = None,
                 bundle: Optional[DeviceBundle] = None,
                 is_cat: Optional[torch.Tensor] = None,
                 monotone: Optional[torch.Tensor] = None,
                 rng_key: Optional[torch.Tensor] = None,
                 interaction_sets: Optional[torch.Tensor] = None,
                 forced: Optional[ForcedSplits] = None,
                 cegb: Optional[CegbState] = None):
        check_supported(hp, batch)
        dev = grad.device
        f32, i32 = torch.float32, torch.int32
        n, n_cols = bins.shape
        num_f = n_cols if bundle is None else bundle.feat_col.shape[0]
        L = hp.num_leaves
        self.hp, self.stop, self.bundle = hp, stop, bundle
        self.cat = hp.has_categorical
        self.is_cat = is_cat
        self.n, self.L, self.K = n, L, min(batch, L - 1)
        self.grad, self.hess, self.row_mask = grad, hess, row_mask
        self.feature_mask = feature_mask
        self.mono = hp.use_monotone
        self.boxes = self.mono and hp.monotone_method in ("intermediate",
                                                          "advanced")
        self.adv = self.mono and hp.monotone_method == "advanced"
        self.monotone = None if monotone is None else monotone.to(dev)
        self.isets = interaction_sets
        self.forced, self.cegb = forced, cegb
        self.lor = torch.zeros(n, dtype=i32, device=dev)
        self.use_bynode = (hp.feature_fraction_bynode < 1.0
                           and rng_key is not None)
        self.use_rng = rng_key is not None and (hp.extra_trees
                                                or self.use_bynode)
        self.rng_key = rng_key.reshape(1, 2) if self.use_rng else None
        self.num_f = num_f
        self.mask_f = torch.ones_like(grad) if row_mask is None \
            else row_mask.to(f32)
        self.mask_i = self.mask_f.to(i32)
        if bins_t is None:
            bins_t = bins.t().contiguous()
        if bins_words is None:
            bins_words = bins_to_words(bins)
        self.bins_t, self.bins_words = bins_t, bins_words
        self.words_t = None
        if wants_packed_mirror(hp.hist_kernel, hp.n_bins):
            self.words_t = bins_words_t if bins_words_t is not None \
                else bins_words.t().contiguous()
        self.num_bins = num_bins.to(dev)
        self.nan_bin = nan_bin.to(dev)
        self.scale_vec = None
        if hist_scale is not None:
            self.scale_vec = torch.cat([hist_scale.to(f32),
                                        torch.ones(2, dtype=f32, device=dev)])
        l1, l2, mds = hp.lambda_l1, hp.lambda_l2, hp.max_delta_step

        hist0 = self.scaled(root_histogram(
            bins_t, grad, hess, row_mask, n_bins=hp.n_bins,
            hist_dtype=hp.hist_dtype, hist_kernel=hp.hist_kernel,
            bins_words_t=self.words_t))
        mask_f = self.mask_f
        g0 = (grad * mask_f).sum()
        h0 = (hess * mask_f).sum()
        c0 = mask_f.sum()
        if hist_scale is not None:
            g0 = g0 * hist_scale[0]
            h0 = h0 * hist_scale[1]
        root_out = leaf_output(g0, h0, l1, l2, mds)
        one = torch.ones(1, dtype=f32, device=dev)
        # the root's key: fold_in(key, 0)
        zero_i = torch.zeros(1, dtype=torch.int64, device=dev)
        best0, bits0 = self.child_best(
            hist0[None], g0[None], h0[None], c0[None],
            torch.zeros(1, dtype=i32, device=dev),
            torch.zeros(1, num_f, dtype=torch.bool, device=dev), zero_i,
            zero_i, parent_output=root_out.reshape(1),
            leaf_min=-INF_BOUND * one, leaf_max=INF_BOUND * one)

        # state arrays carry one trash entry past the end (node index L-1,
        # leaf index L) that the masked scatters of invalid slots aim at —
        # the JAX package's out-of-bounds mode="drop" writes
        NI, NL = L, L + 1

        def full(shape, val, dtype):
            return torch.full(shape, val, dtype=dtype, device=dev)

        self.full = full
        self.split_feature = full((NI,), -1, i32)
        self.split_bin = full((NI,), 0, i32)
        self.default_left = full((NI,), False, torch.bool)
        self.left_child = full((NI,), -1, i32)
        self.right_child = full((NI,), -1, i32)
        self.split_gain = full((NI,), 0.0, f32)
        self.internal_value = full((NI,), 0.0, f32)
        self.internal_count = full((NI,), 0.0, f32)
        self.leaf_value = full((NL,), 0.0, f32)
        self.leaf_count = full((NL,), 0.0, f32)
        self.leaf_weight = full((NL,), 0.0, f32)
        self.leaf_depth = full((NL,), 0, i32)
        self.leaf_value[0] = root_out
        self.leaf_count[0] = c0
        self.leaf_weight[0] = h0

        # histogram state: one row per leaf, or P pool slots + a trash slot
        # with the leaf <-> slot maps (trash entries at L and P)
        self.pool = pooled(hp)
        P = self.P = hp.hist_pool_slots
        self.hist = torch.zeros(P + 1 if self.pool else NL, n_cols, hp.n_bins,
                                hist0.shape[-1], dtype=f32, device=dev)
        self.hist[0] = hist0
        if self.pool:
            self.leaf_slot = full((L + 1,), -1, i32)
            self.slot_leaf = full((P + 1,), -1, i32)
            # fills, not scalar assignments: those copy from the host, which
            # a captured round may not do
            self.leaf_slot[0].fill_(0)
            self.slot_leaf[0].fill_(0)
        self.sum_g = full((NL,), 0.0, f32)
        self.sum_h = full((NL,), 0.0, f32)
        self.count = full((NL,), 0.0, f32)
        self.sum_g[0], self.sum_h[0], self.count[0] = g0, h0, c0
        self.best_gain = full((NL,), NEG_INF, f32)
        self.best_feat = full((NL,), 0, i32)
        self.best_thr = full((NL,), 0, i32)
        self.best_dl = full((NL,), False, torch.bool)
        self.best_lg = full((NL,), 0.0, f32)
        self.best_lh = full((NL,), 0.0, f32)
        self.best_lc = full((NL,), 0.0, f32)
        if self.cat:
            # the cached best splits' variants and left bins
            self.best_var = full((NL,), 0, i32)
            self.best_bitset = full((NL, hp.n_bins), False, torch.bool)
            self.best_var[0] = best0.variant[0]
            self.best_bitset[0] = bits0[0]
            self.split_cat = full((NI,), False, torch.bool)
            self.cat_bitset = full((NI, hp.n_bins), False, torch.bool)
        self.best_gain[0] = best0.gain[0]
        self.best_feat[0] = best0.feature[0]
        self.best_thr[0] = best0.threshold[0]
        self.best_dl[0] = best0.default_left[0]
        self.best_lg[0] = best0.left_sum_g[0]
        self.best_lh[0] = best0.left_sum_h[0]
        self.best_lc[0] = best0.left_count[0]
        self.parent_node = full((NL,), -1, i32)
        self.parent_side = full((NL,), 0, i32)
        self.path_f = full((NL, num_f), False, torch.bool)
        if self.mono:
            self.leaf_min = full((NL,), -INF_BOUND, f32)
            self.leaf_max = full((NL,), INF_BOUND, f32)
        if self.boxes:
            # bin-space boxes: the root spans every bin (hi exclusive),
            # unused slots and the trash row hold empty boxes
            self.leaf_lo = full((NL, num_f), 0, i32)
            self.leaf_hi = full((NL, num_f), 0, i32)
            self.leaf_hi[0] = self.num_bins.to(i32)

        self.iota_f = torch.arange(num_f, device=dev)
        self.n_splits = torch.zeros((), dtype=torch.int64, device=dev)
        self.progress = torch.ones((), dtype=torch.bool, device=dev)
        if forced is not None:
            self.force_failed = torch.zeros((), dtype=torch.bool, device=dev)

    def scaled(self, h):
        return h if self.scale_vec is None else h * self.scale_vec

    def child_best(self, h, g_, h_, c_, depth, paths, node_data, leaves,
                   **con):
        """Best splits of M leaves from their physical histograms, and on
        categorical data the bins each sends left (bool [M, B]; else
        None).  ``paths`` bool [M, F]: the leaves' path features;
        ``node_data`` int64 [M]: the fold-in data of their node keys;
        ``leaves`` int64 [M]: their ids (CEGB's lazy counts, over the rows'
        current leaves); ``con``: find_best_split's outputs and bounds."""
        hp = self.hp
        if self.cegb is not None:
            lazy = cegb_lazy_counts(self.cegb, self.lor, self.row_mask,
                                    self.L)
            con["gain_penalty"] = cegb_penalty(
                self.cegb, c_, None if lazy is None else lazy[leaves])
        fm, rand = self.feature_mask, None
        if self.use_rng:
            keys = self.rng_key.expand(node_data.shape[0], 2)
            ub = prng.draw(keys, self.num_f, [node_data]) \
                if self.use_bynode else None
            if ub is not None or self.isets is not None:
                fm = node_feature_mask(fm, paths, self.isets, ub,
                                       hp.feature_fraction_bynode)
            rand = extra_tree_draws(keys, [node_data], self.num_f, hp)
        elif self.isets is not None:
            fm = node_feature_mask(fm, paths, self.isets, None, 1.0)
        hv = h if self.bundle is None else \
            _expand_hist(h, self.bundle, g_, h_, c_)
        res = find_best_split(hv, g_, h_, c_, self.num_bins, self.nan_bin,
                              self.is_cat, fm, hp, monotone=self.monotone,
                              depth=depth, rand=rand, **con)
        bits = winner_bitset(h, g_, h_, c_, res, self.num_bins, self.is_cat,
                             self.bundle, hp) if self.cat else None
        depth_ok = (hp.max_depth <= 0) | (depth < hp.max_depth)
        return res._replace(gain=torch.where(
            depth_ok, res.gain, torch.full_like(res.gain, NEG_INF))), bits

    def live(self) -> torch.Tensor:
        """bool 0-d: the next round may split."""
        live = self.progress & (self.n_splits < self.L - 1)
        return live if self.stop is None else live & ~self.stop

    def growing(self) -> torch.Tensor:
        """bool 0-d: the tree may still grow."""
        return self.progress & (self.n_splits < self.L - 1)

    def _hist(self, leaves, counts, sort_key, payload, live):
        """The K-leaf histogram pass, its bucket chosen on the device."""
        hp = self.hp
        return histogram_for_leaves_auto(
            self.bins_t, self.grad, self.hess, self.lor, leaves,
            self.row_mask, counts=counts, sort_key=sort_key,
            payload=payload, n_bins=hp.n_bins,
            rows_per_block=hp.rows_per_block, hist_dtype=hp.hist_dtype,
            bins_words=self.bins_words, hist_kernel=hp.hist_kernel,
            bins_words_t=self.words_t, live=live)

    def pool_round(self, parents, safe_nl, valid, smaller, l_cnt, r_cnt,
                   small_cnt, left_small, live):
        """The pooled round's histograms and slot allocation (the JAX
        package's, batch_grower.py:929-991): parents whose histogram was
        evicted get both children built directly; returns the children's
        (h_left, h_right)."""
        L, P, dev = self.L, self.P, self.grad.device
        leaf_slot, slot_leaf, hist = self.leaf_slot, self.slot_leaf, self.hist
        Kr = parents.shape[0]
        p_slot = leaf_slot[parents]
        present = (p_slot >= 0) & valid
        larger = torch.where(l_cnt <= r_cnt, safe_nl, parents)
        need_direct = valid & ~present
        large_cnt = torch.where(need_direct, torch.maximum(l_cnt, r_cnt),
                                torch.zeros_like(l_cnt))
        leaves_ext = torch.cat([smaller, torch.where(need_direct, larger,
                                                     L - 1)])
        counts = torch.cat([small_cnt, large_cnt])
        # partition_select's key covers ``smaller`` only: the extended set's
        # compaction key is built in the pass (sort_key None)
        h_ext = self.scaled(self._hist(leaves_ext, counts, None, None, live))
        h_small = h_ext[:Kr]
        h_parent = hist[p_slot.clamp(min=0).long()]
        h_large = torch.where(present[:, None, None, None],
                              h_parent - h_small, h_ext[Kr:])
        h_left = torch.where(left_small, h_small, h_large)
        h_right = torch.where(left_small, h_large, h_small)

        # free slots first, then the lowest cached gains; this round's
        # parent slots are locked (they become the left children's)
        locked = torch.zeros(P + 1, dtype=torch.bool, device=dev)
        locked.index_fill_(0, torch.where(present, p_slot, P).long(), True)
        occ = slot_leaf[:P]
        occ_gain = torch.where(occ >= 0,
                               self.best_gain[occ.clamp(min=0).long()],
                               torch.full_like(self.best_gain[:1],
                                               -float("inf")))
        order = torch.sort(torch.where(locked[:P], float("inf"), occ_gain),
                           stable=True).indices
        req = torch.cat([need_direct, valid])
        pos = torch.cumsum(req.to(torch.int64), 0) - 1
        alloc = torch.where(req, order[pos.clamp(0, P - 1)], P)
        evicted = torch.where(alloc < P, slot_leaf[alloc.clamp(max=P)], -1)
        _put(leaf_slot, torch.where(evicted >= 0, evicted, L).long(),
             torch.full_like(evicted, -1))
        slot_l = torch.where(present, p_slot.long(), alloc[:Kr])
        slot_r = alloc[Kr:]
        tgt_l = torch.where(valid, slot_l, P)
        tgt_r = torch.where(valid, slot_r, P)
        _put(hist, tgt_l, h_left)
        _put(hist, tgt_r, h_right)
        _put(slot_leaf, tgt_l, torch.where(valid, parents, -1))
        _put(slot_leaf, tgt_r, torch.where(valid, safe_nl, -1))
        _put(leaf_slot, torch.where(valid, parents, L), slot_l)
        _put(leaf_slot, torch.where(valid, safe_nl, L), slot_r)
        slot_leaf[P].fill_(-1)
        leaf_slot[L].fill_(-1)
        return h_left, h_right

    def round(self, Kr: int, forced: bool = False):
        """One round of (up to) ``Kr`` splits, gated by :meth:`live`; reads
        nothing back.  ``forced``: a forced-split round (``Kr`` = 1,
        :meth:`_stage_forced`)."""
        hp, L = self.hp, self.L
        dev = self.grad.device
        i32 = torch.int32
        l1, l2, mds = hp.lambda_l1, hp.lambda_l2, hp.max_delta_step
        best_gain, best_feat, best_thr = (self.best_gain, self.best_feat,
                                          self.best_thr)
        sum_g, sum_h, count = self.sum_g, self.sum_h, self.count
        live = self.live()
        use_f = self._stage_forced(live) if forced else None
        topg, parents = torch.sort(best_gain[:L], descending=True,
                                   stable=True)       # ties: lower id first
        topg, parents = topg[:Kr], parents[:Kr]
        if use_f is not None:
            # the forced leaf is the round's only candidate
            fl = self._forced_entry()[0:1]
            parents = torch.where(use_f, fl, parents)
            topg = torch.where(use_f, best_gain[parents], topg)
        n_splits = self.n_splits
        room = n_splits + torch.arange(Kr, device=dev) < L - 1
        valid = (topg > 0.0) & room & live
        if use_f is not None:
            valid = valid & use_f
        n_valid = valid.sum()
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
        dl = self.best_dl[bl]
        pg, ph, pc = sum_g[bl], sum_h[bl], count[bl]
        lg, lh, lcn = self.best_lg[bl], self.best_lh[bl], self.best_lc[bl]
        rg, rh, rcn = pg - lg, ph - lh, pc - lcn
        ni = L - 1
        p, side = self.parent_node[bl].long(), self.parent_side[bl]
        nid_m = torch.where(ok, node_ids, ni)
        _put(self.left_child, torch.where(ok & (p >= 0) & (side == 0), p, ni),
             node_ids)
        _put(self.left_child, nid_m, -(bl + 1))
        _put(self.right_child,
             torch.where(ok & (p >= 0) & (side == 1), p, ni), node_ids)
        _put(self.right_child, nid_m, -(new_leaves + 1))
        l2_eff = l2
        if self.cat:
            # sorted-subset children take l2 + cat_l2 (the JAX package's
            # f32 sum)
            var = self.best_var[bl]
            l2_eff = l2 + torch.where(var >= VAR_CAT_FWD, hp.cat_l2, 0.0)
            _put(self.split_cat, nid_m, self.is_cat[feat.long()])
            _put(self.cat_bitset, nid_m, self.best_bitset[bl])
        # children's outputs: smoothed toward the parent's (read before
        # this round's writes), clipped into its bounds
        pout = self.leaf_value[bl] if hp.path_smooth > 0.0 else None
        lo = smoothed_output(lg, lh, lcn, pout, l1, l2_eff, hp)
        ro = smoothed_output(rg, rh, rcn, pout, l1, l2_eff, hp)
        if self.mono:
            catl = self.is_cat[feat.long()] if self.cat else \
                torch.zeros_like(ok)
            mono_f = self.monotone[feat.long()]
        if self.mono and not self.boxes:
            # basic: clip into the parent's bounds, tighten each child's
            # at the midpoint (the box methods clip slot by slot below)
            lmin_p, lmax_p = self.leaf_min[bl], self.leaf_max[bl]
            lo = torch.clamp(lo, lmin_p, lmax_p)
            ro = torch.clamp(ro, lmin_p, lmax_p)
            inc = ~catl & (mono_f > 0)
            dec = ~catl & (mono_f < 0)
            mid = (lo + ro) * 0.5
            lmax_l = torch.where(inc, torch.minimum(lmax_p, mid), lmax_p)
            lmin_l = torch.where(dec, torch.maximum(lmin_p, mid), lmin_p)
            lmin_r = torch.where(inc, torch.maximum(lmin_p, mid), lmin_p)
            lmax_r = torch.where(dec, torch.minimum(lmax_p, mid), lmax_p)
        d = self.leaf_depth[bl] + 1
        idx2 = torch.cat([torch.where(ok, bl, L),
                          torch.where(ok, new_leaves, L)])

        def w2(arr, vb, vn):
            _put(arr, idx2, torch.cat([vb, vn]))

        new_path = self.path_f[bl] | (feat[:, None] == self.iota_f[None, :])
        w2(self.path_f, new_path, new_path)
        _put(self.split_feature, nid_m, feat)
        _put(self.split_bin, nid_m, thr)
        _put(self.default_left, nid_m, dl)
        _put(self.split_gain, nid_m, best_gain[bl])
        _put(self.internal_value, nid_m, leaf_output(pg, ph, l1, l2, mds))
        _put(self.internal_count, nid_m, pc)
        w2(self.leaf_depth, d, d)
        if not self.boxes:
            w2(self.leaf_value, lo, ro)
        if self.mono and not self.boxes:
            w2(self.leaf_min, lmin_l, lmin_r)
            w2(self.leaf_max, lmax_l, lmax_r)
        w2(self.leaf_count, lcn, rcn)
        w2(self.leaf_weight, lh, rh)
        w2(sum_g, lg, rg)
        w2(sum_h, lh, rh)
        w2(count, lcn, rcn)
        w2(self.parent_node, node_ids, node_ids)
        w2(self.parent_side, torch.zeros_like(node_ids),
           torch.ones_like(node_ids))
        _put(best_gain, torch.where(ok, bl, L),
             torch.full_like(lg, NEG_INF))
        if self.boxes:
            self._record_boxes(ok, bl, new_leaves, feat, thr, catl, lo, ro,
                               mono_f)
        if self.cegb is not None:
            # the round's splits acquire their features, for their parents'
            # rows (the leaves before this round's partition); later slots
            # of the round see them at the next round's penalties, as in
            # the JAX package
            cegb_acquire(self.cegb, self.lor, self.row_mask, parents, feat,
                         valid, L)

        # ---- smaller children first: the partition pass emits the next
        # histogram pass's compaction keys and payload for exactly them
        safe_nl = torch.where(valid, new_leaves, L - 1)
        l_cnt = count[parents]
        r_cnt = count[safe_nl]
        smaller = torch.where(l_cnt <= r_cnt, parents, safe_nl)

        # ---- all K partitions in ONE row pass
        feats_k = best_feat[parents]
        split = (best_thr[parents], self.best_dl[parents].to(i32),
                 self.nan_bin[feats_k.long()].to(i32), parents.to(i32),
                 new_leaves.to(i32), valid.to(i32), smaller.to(i32))
        if self.bundle is not None or self.cat:
            # bundled or categorical: the physical column and go-left
            # table of each slot
            bd = self.bundle
            cols_k, left_tab = decision_table(
                feats_k, *split[:3],
                feat_col=None if bd is None else bd.feat_col,
                inv_table=None if bd is None else bd.inv_table,
                is_cat=self.is_cat if self.cat else None,
                bitsets=self.best_bitset[parents] if self.cat else None)
            tsplit = split[3:]
            if self.pool:
                lor, sort_key = partition_select_table(
                    self.bins_t, self.lor, self.mask_i, cols_k, left_tab,
                    *tsplit)
                payload = None
            else:
                lor, sort_key, payload = partition_payload_table(
                    self.bins_t, self.bins_words, self.grad, self.hess,
                    self.lor, self.mask_i, cols_k, left_tab, *tsplit)
        elif self.pool:
            lor, sort_key = partition_select(self.bins_t, self.lor,
                                             self.mask_i, feats_k, *split)
            payload = None
        else:
            lor, sort_key, payload = partition_payload(
                self.bins_t, self.bins_words, self.grad, self.hess, self.lor,
                self.mask_i, feats_k, *split)
        # in place: a captured round's next replay reads them here.  The
        # progress test (the JAX while_loop condition): a live round in
        # which no slot splits ends the tree
        self.lor.copy_(lor)
        self.n_splits.add_(n_valid)
        self.progress.copy_(torch.where(live, n_valid > 0, self.progress))

        # ---- ONE widened pass: histograms of the K smaller children
        small_cnt = torch.where(valid, torch.minimum(l_cnt, r_cnt),
                                torch.zeros_like(l_cnt))
        left_small = (l_cnt <= r_cnt)[:, None, None, None]
        if not self.pool:
            h_small = self.scaled(self._hist(smaller, small_cnt, sort_key,
                                             payload, live))
            h_large = self.hist[parents] - h_small
            h_left = torch.where(left_small, h_small, h_large)
            h_right = torch.where(left_small, h_large, h_small)
            _put(self.hist, torch.where(valid, parents, L), h_left)
            _put(self.hist, torch.where(valid, safe_nl, L), h_right)
        else:
            h_left, h_right = self.pool_round(
                parents, safe_nl, valid, smaller, l_cnt, r_cnt, small_cnt,
                left_small, live)

        # ---- best splits of the 2K children at once; node keys folded
        # on (split node, side): unique per evaluation
        kids = torch.cat([parents, safe_nl])
        node2 = torch.cat([node_ids, node_ids]) * 2 + torch.cat(
            [torch.ones_like(node_ids), torch.full_like(node_ids, 2)]) \
            if self.use_rng else None
        con = {}
        if hp.path_smooth > 0.0:
            con["parent_output"] = self.leaf_value[kids]
        if self.mono:
            con.update(leaf_min=self.leaf_min[kids],
                       leaf_max=self.leaf_max[kids])
        if self.adv:
            con["adv_bounds"] = advanced_split_bounds(
                self.leaf_lo[:L], self.leaf_hi[:L], self.leaf_value[:L],
                self.monotone, 1 + self.n_splits, kids, hp.n_bins)
        res, bits = self.child_best(
            torch.cat([h_left, h_right]), sum_g[kids], sum_h[kids],
            count[kids], self.leaf_depth[kids],
            self.path_f[kids] if self.isets is not None else None, node2,
            kids, **con)
        tgt = torch.where(torch.cat([valid, valid]), kids, L)
        _put(best_gain, tgt, res.gain)
        _put(best_feat, tgt, res.feature)
        _put(best_thr, tgt, res.threshold)
        _put(self.best_dl, tgt, res.default_left)
        _put(self.best_lg, tgt, res.left_sum_g)
        _put(self.best_lh, tgt, res.left_sum_h)
        _put(self.best_lc, tgt, res.left_count)
        if self.cat:
            _put(self.best_var, tgt, res.variant)
            _put(self.best_bitset, tgt, bits)

    def _forced_entry(self) -> torch.Tensor:
        """int64 [3]: the schedule entry of the next split (leaf, feature,
        threshold), read on the device (clamped to the last entry)."""
        tab = self.forced.table
        i = self.n_splits.clamp(max=tab.shape[1] - 1).reshape(1)
        return tab.index_select(1, i)[:, 0]

    def _forced_column(self, fl: torch.Tensor, ff: torch.Tensor
                       ) -> torch.Tensor:
        """f32 [B, C]: leaf ``fl``'s virtual histogram of feature ``ff``
        ([1] device tensors).  From the histogram state; under the bounded
        pool, where the leaf's slot may have been evicted, from its rows:
        one pass of the flat masked kernel over the feature's virtual bins
        (the JAX package's ``forced_col_hist``), taken where the leaf holds
        no slot."""
        bd, hp = self.bundle, self.hp
        col = ff if bd is None else bd.feat_col.index_select(0, ff).long()
        g_, h_, c_ = (self.sum_g.index_select(0, fl),
                      self.sum_h.index_select(0, fl),
                      self.count.index_select(0, fl))
        if self.pool:
            slot = self.leaf_slot.index_select(0, fl).long()
            resident = (slot >= 0) & (slot < self.P)
            row = slot.clamp(0, self.P)
        else:
            row = fl
        hc = self.hist.index_select(0, row)[0].index_select(0, col)  # [1,B,C]
        if bd is not None:
            hc = _expand_hist_col(hc, bd, ff, g_, h_, c_)
        if not self.pool:
            return hc[0]
        if bd is None:
            colv = self.bins_t.index_select(0, ff)
        else:
            phys = self.bins_t.index_select(0, col)[0].long()
            colv = bd.inv_table.index_select(0, ff)[0][phys][None] \
                .to(torch.uint8)
        lor1 = self.lor if self.row_mask is None else \
            torch.where(self.row_mask, self.lor, -1)
        direct = self.scaled(histogram_leaves(
            colv, self.grad, self.hess, lor1, fl.to(torch.int32),
            n_bins=hp.n_bins, hist_dtype=hp.hist_dtype))[0, 0]
        return torch.where(resident, hc[0], direct)

    def _stage_forced(self, live: torch.Tensor) -> torch.Tensor:
        """The forced round's entry (the JAX package's K = 1 forced body,
        batch_grower.py:397-497): its stats gathered at the prescribed
        threshold from the leaf's histogram column and, where valid,
        staged into the leaf's cached best split, so the round's record
        applies it.  A failed entry sets ``force_failed`` and ends the
        schedule.  Returns bool [1]: the entry is applied."""
        hp, L = self.hp, self.L
        ent = self._forced_entry()
        fl, ff, ft = ent[0:1], ent[1:2], ent[2:3]
        active = ((self.n_splits < self.forced.table.shape[1])
                  & ~self.force_failed & live).reshape(1)
        hf = self._forced_column(fl, ff)
        pg = self.sum_g.index_select(0, fl)[0]
        ph = self.sum_h.index_select(0, fl)[0]
        pc = self.count.index_select(0, fl)[0]
        is_cat_f = (self.is_cat.index_select(0, ff)[0] if self.cat
                    else torch.zeros((), dtype=torch.bool,
                                     device=fl.device))
        nanb = self.nan_bin.index_select(0, ff)[0]
        lg, lh, lc, gain, ok = gather_forced_split(
            hf, pg, ph, pc, ft[0], is_cat_f, nanb, hp)
        use_f = active & ok
        self.force_failed.logical_or_((active & ~ok)[0])
        tgt = torch.where(use_f, fl, L)

        def stage(arr, val):
            _put(arr, tgt, val.reshape(1))

        stage(self.best_gain, gain)
        stage(self.best_feat, ff)
        stage(self.best_thr, ft)
        stage(self.best_dl, torch.zeros_like(use_f))
        stage(self.best_lg, lg)
        stage(self.best_lh, lh)
        stage(self.best_lc, lc)
        if self.cat:
            stage(self.best_var, torch.where(
                is_cat_f, VAR_CAT_ONEHOT, VAR_NUM_RIGHT))
            # one-hot: bin ft goes left
            _put(self.best_bitset, tgt,
                 ((torch.arange(hp.n_bins, device=fl.device) == ft)
                  & is_cat_f)[None])
        return use_f

    def forced_phase(self) -> None:
        """The rounds a tree runs first under forced splits: one K = 1
        forced round a schedule entry (a host number; after a failed entry
        the rounds change nothing), then ``progress`` set again, so the
        gain rounds run whatever the last forced round did (the JAX
        package's forced while-loop and its reset)."""
        if self.forced is None:
            return
        for _ in range(self.forced.table.shape[1]):
            self.round(1, forced=True)
        self.progress.fill_(True)

    def _record_boxes(self, ok, bl, new_leaves, feat, thr, catl, lo, ro,
                      mono_f):
        """The intermediate and advanced methods' record, slot by slot:
        each slot's children clipped into its parent's current bounds
        (siblings against the split feature's direction collapsed to
        their midpoint), written, their boxes split, and every leaf's
        bounds refreshed from the boxes, which the next slot reads (the
        JAX package's sequential branch, batch_grower.py:636-783).
        Invalid slots write the trash row and keep the bounds."""
        L = self.L
        lo_all, hi_all = self.leaf_lo, self.leaf_hi
        for j in range(ok.shape[0]):
            s = slice(j, j + 1)
            ok_j = ok[s]
            tb = torch.where(ok_j, bl[s], L)
            tn = torch.where(ok_j, new_leaves[s], L)
            lmin_p, lmax_p = self.leaf_min[bl[s]], self.leaf_max[bl[s]]
            lo_j = torch.clamp(lo[s], lmin_p, lmax_p)
            ro_j = torch.clamp(ro[s], lmin_p, lmax_p)
            inv = ~catl[s] & (((mono_f[s] > 0) & (lo_j > ro_j))
                              | ((mono_f[s] < 0) & (lo_j < ro_j)))
            mid = torch.clamp((lo_j + ro_j) * 0.5, lmin_p, lmax_p)
            _put(self.leaf_value, tb, torch.where(inv, mid, lo_j))
            _put(self.leaf_value, tn, torch.where(inv, mid, ro_j))
            split_boxes(lo_all, hi_all, tb, tn, feat[s], thr[s], ~catl[s])
            lower, upper = box_bounds(lo_all[:L], hi_all[:L],
                                      self.leaf_value[:L], self.monotone,
                                      new_leaves[s] + 1)
            self.leaf_min[:L].copy_(torch.where(ok_j, lower,
                                                self.leaf_min[:L]))
            self.leaf_max[:L].copy_(torch.where(ok_j, upper,
                                                self.leaf_max[:L]))

    def ladder(self):
        """The warm-up ladder's widths: 1, 4, 16, ... < K where it runs
        (``ladder_profitable`` and at least ``_WARMUP_MIN_ROWS`` rows), a
        fixed host sequence as in the JAX package."""
        out = []
        # skipped after a forced phase: its frontier can pass the widths
        if self.forced is None and self.n >= _WARMUP_MIN_ROWS \
                and ladder_profitable(self.hp.hist_kernel, self.hp.n_bins):
            kw = 1
            while kw < self.K:
                out.append(kw)
                kw *= 4
        return out

    def arrays(self) -> TreeArrays:
        """The tree grown so far (views of the state)."""
        L, hp = self.L, self.hp
        num_leaves = (1 + self.n_splits).to(torch.int32)
        full = self.full
        return TreeArrays(
            split_feature=self.split_feature[:L - 1],
            split_bin=self.split_bin[:L - 1],
            default_left=self.default_left[:L - 1],
            split_cat=(self.split_cat[:L - 1] if self.cat
                       else full((L - 1,), False, torch.bool)),
            left_child=self.left_child[:L - 1],
            right_child=self.right_child[:L - 1],
            split_gain=self.split_gain[:L - 1],
            cat_bitset=(self.cat_bitset[:L - 1] if self.cat
                        else full((L - 1, hp.n_bins), False, torch.bool)),
            internal_value=self.internal_value[:L - 1],
            internal_count=self.internal_count[:L - 1],
            leaf_value=self.leaf_value[:L], leaf_count=self.leaf_count[:L],
            leaf_weight=self.leaf_weight[:L], leaf_depth=self.leaf_depth[:L],
            leaf_path=self.path_f[:L], num_leaves=num_leaves)


def full_width_rounds(num_leaves: int, batch: int, ladder) -> int:
    """Rounds of width K = min(batch, L - 1) that grow a tree to L leaves
    after ``ladder``'s widths when every round splits as many leaves as it
    may (min(K, leaves)): the fused loop's fixed budget a tree."""
    L = num_leaves
    K = min(batch, L - 1)
    leaves = 1
    for kw in ladder:
        leaves += min(kw, leaves, L - leaves)
    r = 0
    while leaves < L:
        leaves += min(K, leaves, L - leaves)
        r += 1
    return r


def grow_tree_batched(bins: torch.Tensor, grad: torch.Tensor,
                      hess: torch.Tensor, row_mask: Optional[torch.Tensor],
                      num_bins: torch.Tensor, nan_bin: torch.Tensor,
                      feature_mask: Optional[torch.Tensor], hp: SplitHyper,
                      batch: int = 8,
                      hist_scale: Optional[torch.Tensor] = None,
                      bins_t: Optional[torch.Tensor] = None,
                      bins_words: Optional[torch.Tensor] = None,
                      bins_words_t: Optional[torch.Tensor] = None,
                      bundle: Optional[DeviceBundle] = None,
                      is_cat: Optional[torch.Tensor] = None,
                      monotone: Optional[torch.Tensor] = None,
                      rng_key: Optional[torch.Tensor] = None,
                      interaction_sets: Optional[torch.Tensor] = None,
                      forced: Optional[ForcedSplits] = None,
                      cegb: Optional[CegbState] = None
                      ) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree with ``batch`` splits per histogram pass.

    bins: u8 [n, F] row-major; grad/hess: f32 [n] (integer levels when
    ``hist_scale`` (f32 [2], the grad/hess scales) is given); row_mask:
    bool [n] or None; num_bins/nan_bin: i32 [F]; feature_mask: bool [F] or
    None.  ``bins_t`` (u8 [F, n]), ``bins_words`` (i32 [n, ceil(F/4)]) and,
    where the packed kernel may run, ``bins_words_t`` (its transpose) are
    the tree-invariant layouts, derived here when not passed.  ``bundle``:
    the EFB tables when ``bins`` holds bundle columns (F then counts the
    virtual features); ``is_cat`` bool [F], read when
    ``hp.has_categorical``; ``monotone``, ``rng_key`` and
    ``interaction_sets`` the split constraints' operands, ``forced`` and
    ``cegb`` forced splits and CEGB (:class:`BatchedTree`).
    Returns (TreeArrays, leaf_of_row i32 [n]).
    """
    tree = BatchedTree(bins, grad, hess, row_mask, num_bins, nan_bin,
                       feature_mask, hp, batch=batch, hist_scale=hist_scale,
                       bins_t=bins_t, bins_words=bins_words,
                       bins_words_t=bins_words_t, bundle=bundle,
                       is_cat=is_cat, monotone=monotone, rng_key=rng_key,
                       interaction_sets=interaction_sets, forced=forced,
                       cegb=cegb)
    tree.forced_phase()
    for kw in tree.ladder():
        tree.round(kw)
    # one host read a K-wide round: the progress test
    while tree.growing().item():
        tree.round(tree.K)
    return tree.arrays(), tree.lor
