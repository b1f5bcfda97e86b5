"""Exclusive Feature Bundling (EFB).

Counterpart of ``lightgbm_tpu/io/bundling.py`` (same NumPy code, so the same
bins give the same plan).  io/dataset.py builds the plan and hands its
tables to the growers (``device_bundle_arrays``; learner/grower.py
``DeviceBundle``).

Design of the reference's feature bundling (reference:
src/io/dataset.cpp:107 ``FindGroups`` greedy conflict-bounded graph coloring,
``FastFeatureBundling`` :246, invoked from ``Dataset::Construct`` :362-366):
mutually-exclusive sparse features share one physical bin column, shrinking
the histogram pass (the dominant cost) from O(F_used) to O(F_bundled)
columns.

Layout differences from the reference are deliberate.  The reference's
``FeatureGroup`` owns per-group bin storage and split finding walks group
offsets; here the packed matrix simply has one uint8 column per bundle, and
two small host-precomputed index tables make the learner bundle-agnostic:

  * ``src_idx[f, b]``  — where virtual (per-feature) bin ``b`` of feature
    ``f`` lives inside its bundle column's histogram.  The per-leaf bundle
    histogram ``[Fb, B, C]`` is expanded to the virtual ``[Fv, B, C]`` by one
    gather, and each feature's *default* (most frequent) bin — which the
    bundle does not store — is reconstructed as ``leaf_total − rest``,
    exactly the reference's most-freq-bin completion
    (``Dataset::FixHistogram``, dataset.h:760).
  * ``inv_table[f, v]`` — bundle column value ``v`` → virtual bin of feature
    ``f`` (default bin when ``v`` belongs to another member).  Used by the
    partition step.

Bundle encoding: column value 0 = every member at its default bin; member
``k`` with non-default bin ``b`` writes ``offset_k + rank_k(b)`` where
``rank_k`` skips the default bin (order-preserving, so numerical thresholds
survive).  Conflicting rows (two members non-default; possible only when
``max_conflict_rate > 0``) keep the first member, like the reference's
first-writer-wins push.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

MAX_BUNDLE_BINS = 256  # uint8 storage


class BundlePlan(NamedTuple):
    """Host-side bundling plan over the packed (used) features."""
    bundles: List[List[int]]      # per bundle: packed feature indices
    feat_col: np.ndarray          # i32 [Fv] — bundle column of each feature
    src_idx: np.ndarray           # i32 [Fv, B] — virtual bin -> bundle bin
    valid: np.ndarray             # bool [Fv, B] — virtual bin stored in bundle
    default_bin: np.ndarray       # i32 [Fv] — most frequent (implicit) bin
    inv_table: np.ndarray         # i32 [Fv, B] — bundle value -> virtual bin
    num_bundles: int

    @property
    def is_trivial(self) -> bool:
        return self.num_bundles == len(self.feat_col)


def plan_bundles(bins: np.ndarray, num_bins: np.ndarray,
                 max_conflict_rate: float = 0.0,
                 sample_cnt: int = 100_000,
                 max_total_bins: int = MAX_BUNDLE_BINS
                 ) -> Optional[BundlePlan]:
    """Greedy conflict-bounded bundling over the binned matrix.

    bins: uint8 [n, Fv] (virtual/used features); num_bins: i32 [Fv].
    ``max_total_bins`` caps a bundle's bin count — pass the dataset's
    pre-EFB device histogram width so bundling can only SHRINK the
    histogram tensor (fewer columns, same bin axis), never widen it.
    Returns None when bundling cannot merge anything (dense data).
    """
    n, num_f = bins.shape
    if num_f < 2:
        return None
    sample = bins if n <= sample_cnt else bins[
        np.random.default_rng(3).choice(n, sample_cnt, replace=False)]
    ns = sample.shape[0]

    # default (most frequent) bin per feature + nonzero masks on the sample
    default_bin = np.zeros(num_f, np.int32)
    nz_masks = []
    nz_counts = np.zeros(num_f, np.int64)
    for f in range(num_f):
        counts = np.bincount(sample[:, f], minlength=int(num_bins[f]))
        default_bin[f] = int(np.argmax(counts))
        m = sample[:, f] != default_bin[f]
        nz_masks.append(m)
        nz_counts[f] = int(m.sum())
    return _plan_from_masks(nz_masks, nz_counts, default_bin, num_bins, ns,
                            max_conflict_rate, max_total_bins)


def plan_bundles_sparse(nz_masks: List[np.ndarray], num_bins: np.ndarray,
                        default_bin: np.ndarray, ns: int,
                        max_conflict_rate: float = 0.0,
                        max_total_bins: int = MAX_BUNDLE_BINS
                        ) -> Optional[BundlePlan]:
    """Bundling plan from per-feature sampled nonzero-row masks — the
    sparse-ingestion entry that never sees a dense [n, F] matrix (reference
    sparse_bin.hpp data feeding FastFeatureBundling).  ``default_bin`` must
    be each feature's zero bin (implicit rows ARE zeros)."""
    if len(nz_masks) < 2:
        return None
    nz_counts = np.array([int(m.sum()) for m in nz_masks], np.int64)
    return _plan_from_masks(list(nz_masks), nz_counts,
                            np.asarray(default_bin, np.int32), num_bins, ns,
                            max_conflict_rate, max_total_bins)


def _plan_from_masks(nz_masks: List[np.ndarray], nz_counts: np.ndarray,
                     default_bin: np.ndarray, num_bins: np.ndarray, ns: int,
                     max_conflict_rate: float,
                     max_total_bins: int) -> Optional[BundlePlan]:
    num_f = len(nz_masks)
    max_total_bins = min(max_total_bins, MAX_BUNDLE_BINS)
    B = MAX_BUNDLE_BINS
    max_conflicts = int(max_conflict_rate * ns)
    # sparsest-last order (reference sorts by conflict degree; nonzero count
    # is the cheap proxy): densest features claim bundles first
    order = np.argsort(-nz_counts, kind="stable")

    bundle_members: List[List[int]] = []
    bundle_mask: List[np.ndarray] = []
    bundle_bins: List[int] = []
    for f in map(int, order):
        extra = int(num_bins[f]) - 1          # bins beyond the default
        placed = False
        # a feature whose non-defaults cover most rows can't bundle usefully
        if nz_counts[f] * 2 < ns:
            for bi in range(len(bundle_members)):
                if bundle_bins[bi] + extra > max_total_bins:
                    continue
                conflicts = int((bundle_mask[bi] & nz_masks[f]).sum())
                if conflicts <= max_conflicts:
                    bundle_members[bi].append(f)
                    bundle_mask[bi] |= nz_masks[f]
                    bundle_bins[bi] += extra
                    placed = True
                    break
        if not placed:
            bundle_members.append([f])
            bundle_mask.append(nz_masks[f].copy())
            bundle_bins.append(1 + extra)

    if len(bundle_members) == num_f:
        return None

    feat_col = np.zeros(num_f, np.int32)
    src_idx = np.zeros((num_f, B), np.int32)
    valid = np.zeros((num_f, B), bool)
    inv_table = np.zeros((num_f, B), np.int32)
    b_idx = np.arange(B)
    for col, members in enumerate(bundle_members):
        if len(members) == 1:
            # singleton: identity layout, default bin stored physically but
            # still reconstructed from totals (same value, one code path)
            f = members[0]
            feat_col[f] = col
            nb = int(num_bins[f])
            valid[f] = (b_idx < nb) & (b_idx != default_bin[f])
            src_idx[f] = np.minimum(b_idx, B - 1)
            inv_table[f] = np.where(b_idx < nb, b_idx, default_bin[f])
            continue
        offset = 0
        for f in members:
            feat_col[f] = col
            nb = int(num_bins[f])
            d = int(default_bin[f])
            # order-preserving rank that skips the default bin
            rank = np.where(b_idx < d, b_idx + 1, b_idx)   # in [1, nb-1]
            stored = (b_idx < nb) & (b_idx != d)
            src_idx[f] = np.where(stored, offset + rank, 0)
            valid[f] = stored
            inv = np.full(B, d, np.int32)
            vbins = b_idx[stored]
            inv[src_idx[f][stored]] = vbins
            inv_table[f] = inv
            offset += nb - 1
    return BundlePlan(bundles=bundle_members, feat_col=feat_col,
                      src_idx=src_idx, valid=valid, default_bin=default_bin,
                      inv_table=inv_table, num_bundles=len(bundle_members))


def apply_bundles(bins: np.ndarray, plan: BundlePlan) -> np.ndarray:
    """Produce the bundled physical matrix uint8 [n, Fb]."""
    n = bins.shape[0]
    out = np.zeros((n, plan.num_bundles), np.uint8)
    for col, members in enumerate(plan.bundles):
        if len(members) == 1:
            out[:, col] = bins[:, members[0]]
            continue
        acc = np.zeros(n, np.int32)
        for f in members:
            v = bins[:, f].astype(np.int64)
            stored = plan.valid[f][v]          # non-default rows
            write = stored & (acc == 0)        # first member wins conflicts
            acc = np.where(write, plan.src_idx[f][v], acc)
        out[:, col] = acc.astype(np.uint8)
    return out
