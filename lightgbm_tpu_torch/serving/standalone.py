"""Standalone bin tables for text-loaded models — serve WITHOUT the
training Dataset.

A trained booster serves through its training ``BinMapper``s
(``Dataset.bin_external_pred``); a model loaded from text has none.
This module rebuilds an equivalent logical bin space from the model
itself: per feature, the sorted unique split thresholds become the bin
boundaries (``searchsorted(ts, v, 'left') <= i  <=>  v <= ts[i]``, an
f64-exact equivalence), categorical features get an identity code map
plus the unseen/NaN sentinel bins of the trained path, and per-node
missing handling is reproduced through the node's ``nanb`` slot exactly
like boosting/gbdt.py ``_forest_bitset_arrays``.

Bin-space decisions are then IDENTICAL to the host raw-space walk
(models/tree.py ``predict_leaf_index``), which is what lets the serving
tier's device leaf indices (the forest kernel's leaves mode,
ops/forest_kernels.py ``forest_leaves``) stay bit for bit against
``Booster.predict`` for text-loaded models too.

Models this table construction cannot represent raise
:class:`StandaloneUnsupported` (the predictor falls back to the host
booster): a feature used with INCONSISTENT per-node missing types (the
bin of a value would need to depend on the node), a feature used both
numerically and categorically, or a categorical range too wide for a
one-hot plane.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..io.binning import K_ZERO_THRESHOLD, MISSING_NONE, MISSING_ZERO
from ..models.tree import _CAT_MASK, _DEFAULT_LEFT_MASK, Tree

#: categorical code range cap for the standalone one-hot plane — wider
#: models (raw category codes in the thousands) fall back to the host
#: walk rather than paying a [Bc, n] plane per request
MAX_CAT_CODE = 4096


class StandaloneUnsupported(Exception):
    """Model shape the standalone bin tables cannot represent."""


class StandaloneBinner:
    """Raw [n, F] f64 -> i32 logical bins for the standalone forest."""

    def __init__(self, num_features: int) -> None:
        self.num_features = num_features
        # per-feature numeric tables (None when the feature is unused
        # or categorical)
        self.thresholds: List[np.ndarray] = [None] * num_features
        self.missing_type: List[int] = [MISSING_NONE] * num_features
        # per-feature categorical max code (None = not categorical)
        self.cat_max: List[int] = [None] * num_features

    # bin layout per numeric feature f with T_f thresholds:
    #   0..T_f      compare bins (bin <= i  <=>  v <= ts[i])
    #   T_f + 1     missing bin (only routed to for ZERO/NAN types)
    def nan_bin(self, f: int) -> int:
        ts = self.thresholds[f]
        return (len(ts) if ts is not None else 0) + 1

    # bin layout per categorical feature f with max code C_f:
    #   0..C_f      identity category codes
    #   C_f + 1     unseen/out-of-range sentinel (no bitset bit -> right)
    #   C_f + 2     NaN sentinel (bit = the node's cat_nan_left)
    def cat_unseen_bin(self, f: int) -> int:
        return self.cat_max[f] + 1

    def cat_nan_bin(self, f: int) -> int:
        return self.cat_max[f] + 2

    def bin(self, X: np.ndarray) -> np.ndarray:
        n = X.shape[0]
        if X.shape[1] != self.num_features:
            from ..utils import log
            log.fatal(f"The number of features in data ({X.shape[1]}) "
                      f"does not match model ({self.num_features})")
        bins = np.zeros((n, self.num_features), np.int32)
        for f in range(self.num_features):
            cmax = self.cat_max[f]
            if cmax is not None:
                v = X[:, f]
                isnan = np.isnan(v)
                # int() truncates toward zero (host walk semantics)
                codes = np.trunc(np.where(isnan, -1.0, v))
                col = np.where((codes >= 0) & (codes <= cmax),
                               codes, float(self.cat_unseen_bin(f)))
                col = np.where(isnan, float(self.cat_nan_bin(f)), col)
                bins[:, f] = col.astype(np.int32)
                continue
            ts = self.thresholds[f]
            if ts is None or len(ts) == 0:
                continue
            v = X[:, f]
            isnan = np.isnan(v)
            col = np.searchsorted(ts, np.where(isnan, 0.0, v),
                                  side="left").astype(np.int32)
            mt = self.missing_type[f]
            if mt == MISSING_ZERO:
                miss = isnan | (np.abs(v) <= K_ZERO_THRESHOLD)
            elif mt == MISSING_NONE:
                # NaN compares as 0.0 (already substituted above)
                miss = np.zeros(n, bool)
            else:  # MISSING_NAN
                miss = isnan
            bins[:, f] = np.where(miss, self.nan_bin(f), col)
        return bins


def build_standalone(trees: Sequence[Tree], num_features: int, k: int):
    """Model trees -> (binner, the fields of a BitsetForest as numpy,
    cat_feats) over the standalone logical bin space.  Mirrors
    boosting/gbdt.py ``forest_bitset_arrays`` with ORIGINAL feature ids
    (no packing) and thresholds indexed into the per-feature tables; the
    fields (masks float32 0/1, the children the forest kernel walks) go
    to the device through models/predict.py ``forest_from_numpy``."""
    from ..boosting.gbdt import _leaf_path_masks

    if not trees:
        raise StandaloneUnsupported("model has no trees")
    binner = StandaloneBinner(num_features)
    num_thr: List[set] = [set() for _ in range(num_features)]
    mtypes: List[set] = [set() for _ in range(num_features)]
    is_cat = np.zeros(num_features, bool)
    is_num = np.zeros(num_features, bool)
    for t in trees:
        nn = max(t.num_leaves - 1, 0)
        for nd in range(nn):
            f = int(t.split_feature[nd])
            if f < 0 or f >= num_features:
                raise StandaloneUnsupported(
                    f"split feature {f} outside the model's feature range")
            dt = int(t.decision_type[nd])
            if dt & _CAT_MASK:
                is_cat[f] = True
                csi = int(t.cat_split_index[nd])
                cats = t.cat_threshold[csi] if 0 <= csi < \
                    len(t.cat_threshold) else []
                cmax = max([int(c) for c in cats], default=0)
                if cmax > MAX_CAT_CODE:
                    raise StandaloneUnsupported(
                        f"categorical feature {f} spans codes up to "
                        f"{cmax} (> {MAX_CAT_CODE}); host fallback")
                binner.cat_max[f] = max(binner.cat_max[f] or 0, cmax)
            else:
                is_num[f] = True
                num_thr[f].add(float(t.threshold[nd]))
                mtypes[f].add((dt >> 2) & 3)
    for f in range(num_features):
        if is_cat[f] and is_num[f]:
            raise StandaloneUnsupported(
                f"feature {f} is used both numerically and categorically")
        if len(mtypes[f]) > 1:
            # one bin table per feature cannot express per-node missing
            # semantics that disagree (a 0.0 row would need different
            # bins at different nodes)
            raise StandaloneUnsupported(
                f"feature {f} has inconsistent per-node missing types "
                f"{sorted(mtypes[f])}; host fallback")
        if is_num[f]:
            binner.thresholds[f] = np.unique(
                np.asarray(sorted(num_thr[f]), np.float64))
            binner.missing_type[f] = next(iter(mtypes[f]))

    L = max(max(t.num_leaves for t in trees), 2)
    ni = L - 1
    T = len(trees)
    cat_feats = tuple(int(f) for f in np.nonzero(is_cat)[0])
    Bc = max((binner.cat_max[f] + 3 for f in cat_feats), default=1)
    C = 1
    cat_nodes = []
    for t in trees:
        nn = max(t.num_leaves - 1, 0)
        nodes = [nd for nd in range(nn) if int(t.decision_type[nd]) & 1]
        cat_nodes.append(nodes)
        C = max(C, len(nodes))
    d = dict(feat=np.zeros((T, ni), np.int32),
             thr=np.zeros((T, ni), np.int32),
             dl=np.zeros((T, ni), bool),
             nanb=np.full((T, ni), -2, np.int32),
             catn=np.full((T, C), ni, np.int32),   # ni = dead pad slot
             catf=np.zeros((T, C), np.int32),
             catb=np.zeros((T, C, Bc), np.float32),
             mpos=np.zeros((T, L, ni), np.float32),
             mneg=np.zeros((T, L, ni), np.float32),
             depth=np.full((T, L), -1, np.int32),
             value=np.zeros((T, L), np.float32),
             cls=np.arange(T, dtype=np.int32) % k,
             left=np.full((T, ni), -1, np.int32),
             right=np.full((T, ni), -1, np.int32))
    for ti, t in enumerate(trees):
        nn = max(t.num_leaves - 1, 0)
        d["value"][ti, :t.num_leaves] = t.leaf_value[:t.num_leaves]
        _leaf_path_masks(t, d["mpos"][ti], d["mneg"][ti], d["depth"][ti])
        d["left"][ti, :nn] = t.left_child[:nn]
        d["right"][ti, :nn] = t.right_child[:nn]
        for nd in range(nn):
            f = int(t.split_feature[nd])
            dt = int(t.decision_type[nd])
            d["feat"][ti, nd] = f
            d["dl"][ti, nd] = bool(dt & _DEFAULT_LEFT_MASK)
            if dt & _CAT_MASK:
                continue
            ts = binner.thresholds[f]
            # the node's threshold came from this very table, so
            # searchsorted recovers its exact index
            d["thr"][ti, nd] = int(np.searchsorted(
                ts, float(t.threshold[nd]), side="left"))
            if binner.missing_type[f] != MISSING_NONE:
                d["nanb"][ti, nd] = binner.nan_bin(f)
        for ci, nd in enumerate(cat_nodes[ti]):
            f = int(t.split_feature[nd])
            d["catn"][ti, ci] = nd
            d["catf"][ti, ci] = f
            csi = int(t.cat_split_index[nd])
            for c in t.cat_threshold[csi]:
                d["catb"][ti, ci, int(c)] = 1.0
            # unseen sentinel stays 0 (right); NaN sentinel carries the
            # node's cat_nan_left (text-loaded models default to right,
            # reference tree.cpp CategoricalDecision)
            if csi < len(t.cat_nan_left) and t.cat_nan_left[csi]:
                d["catb"][ti, ci, binner.cat_nan_bin(f)] = 1.0
    return binner, d, cat_feats
