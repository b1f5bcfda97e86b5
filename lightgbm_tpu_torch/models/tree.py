"""Host-side tree model.

Counterpart of ``lightgbm_tpu/models/tree.py`` (reference:
include/LightGBM/tree.h:26 ``Tree`` flat arrays, src/io/tree.cpp).  Trees are
grown on the device as struct-of-arrays (learner/grower.py ``TreeArrays``) and
finalized here: bin thresholds become real-valued thresholds via the
BinMapper upper bounds, features are remapped from packed to original
indices, and the reference's ``decision_type`` byte (categorical bit,
default-left bit, missing type bits — tree.h decision_type semantics) is
reconstructed so the text model format round-trips with the reference.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..io.binning import (BIN_CATEGORICAL, K_ZERO_THRESHOLD, MISSING_NONE,
                          MISSING_ZERO)

_CAT_MASK = 1        # decision_type bit 0: categorical split
_DEFAULT_LEFT_MASK = 2  # bit 1: missing goes left
# bits 2-3: missing type (none=0, zero=1, nan=2)


def _encode_decision_type(is_cat: bool, default_left: bool,
                          missing_type: int) -> int:
    dt = 0
    if is_cat:
        dt |= _CAT_MASK
    if default_left:
        dt |= _DEFAULT_LEFT_MASK
    dt |= (missing_type & 3) << 2
    return dt


def _decode_decision_type(dt: int):
    return bool(dt & _CAT_MASK), bool(dt & _DEFAULT_LEFT_MASK), (dt >> 2) & 3


class Tree:
    """One decision tree with real-valued thresholds (reference tree.h:26)."""

    def __init__(self, num_leaves: int):
        n = max(num_leaves, 1)
        ni = max(num_leaves - 1, 0)
        self.num_leaves = n
        self.split_feature = np.zeros(ni, np.int32)      # ORIGINAL feature idx
        self.split_gain = np.zeros(ni, np.float32)
        self.threshold = np.zeros(ni, np.float64)        # real-valued
        self.threshold_bin = np.zeros(ni, np.int32)      # bin threshold
        # threshold_bin holds the training bins (a tree grown here), not
        # zeros (a tree read from text, which keeps real thresholds only)
        self.bins_known = False
        self.decision_type = np.zeros(ni, np.int32)
        self.left_child = np.full(ni, -1, np.int32)
        self.right_child = np.full(ni, -1, np.int32)
        self.leaf_value = np.zeros(n, np.float64)
        self.leaf_weight = np.zeros(n, np.float64)
        self.leaf_count = np.zeros(n, np.int64)
        self.internal_value = np.zeros(ni, np.float64)
        self.internal_weight = np.zeros(ni, np.float64)
        self.internal_count = np.zeros(ni, np.int64)
        # categorical: per cat-split list of categories going LEFT
        self.cat_threshold: List[List[int]] = []
        self.cat_split_index = np.full(ni, -1, np.int32)  # split -> cat list idx
        # does a NaN categorical value go left? (training folds cat-NaN into
        # bin 0 = most frequent category; text-loaded models default to right
        # like the reference)
        self.cat_nan_left: List[bool] = []
        self.shrinkage = 1.0
        self.is_linear = False
        # linear leaves (reference tree.h leaf_const_/leaf_coeff_/
        # leaf_features_): per-leaf constant, coefficient list, and the
        # ORIGINAL feature index list the coefficients apply to
        self.leaf_const = np.zeros(n, np.float64)
        self.leaf_features: List[List[int]] = [[] for _ in range(n)]
        self.leaf_coeff: List[List[float]] = [[] for _ in range(n)]
        # boost-from-average bias folded into leaf values (AddBias); tracked
        # so DART drop/rescale and rollback can separate the tree's own
        # contribution from the global init score
        self.bias = 0.0

    # ------------------------------------------------------------- factory
    @classmethod
    def from_arrays(cls, arrays, dataset) -> "Tree":
        """Finalize a ``TreeArrays`` (torch tensors on any device, or numpy
        arrays) against its training Dataset."""
        arrays = type(arrays)(*(a.cpu().numpy() if hasattr(a, "cpu")
                                else np.asarray(a) for a in arrays))
        num_leaves = int(arrays.num_leaves)
        t = cls(num_leaves)
        ni = num_leaves - 1
        if ni == 0:
            t.leaf_value[0] = float(arrays.leaf_value[0])
            t.leaf_count[0] = int(arrays.leaf_count[0])
            t.leaf_weight[0] = float(arrays.leaf_weight[0])
            return t
        sf_packed = np.asarray(arrays.split_feature)[:ni]
        t.threshold_bin = np.asarray(arrays.split_bin)[:ni].astype(np.int32)
        t.bins_known = True
        dl = np.asarray(arrays.default_left)[:ni]
        cat = np.asarray(arrays.split_cat)[:ni]
        t.left_child = np.asarray(arrays.left_child)[:ni].astype(np.int32)
        t.right_child = np.asarray(arrays.right_child)[:ni].astype(np.int32)
        t.split_gain = np.asarray(arrays.split_gain)[:ni]
        t.internal_value = np.asarray(arrays.internal_value)[:ni].astype(np.float64)
        t.internal_count = np.asarray(arrays.internal_count)[:ni].astype(np.int64)
        t.internal_weight = np.zeros(ni)
        t.leaf_value = np.asarray(arrays.leaf_value)[:num_leaves].astype(np.float64)
        t.leaf_count = np.asarray(arrays.leaf_count)[:num_leaves].astype(np.int64)
        t.leaf_weight = np.asarray(arrays.leaf_weight)[:num_leaves].astype(np.float64)

        used = dataset.used_feature_idx
        bitsets = np.asarray(arrays.cat_bitset)[:ni]

        # vectorized numeric finalization: the per-node Python loop below
        # costs ~40 ms/tree at 255 leaves (mapper lookups + method calls
        # per node) — ~20 s of host time over a 500-tree run whose device
        # side is ~480 s.  All-numeric trees (the common case) convert
        # thresholds and decision types with four numpy gathers instead.
        lut = getattr(dataset, "_thr_lut", None)
        if lut is None:
            offs, vals, lens, mtypes, catf = [], [], [], [], []
            for orig in range(len(dataset.mappers)):
                m = dataset.mappers[orig]
                offs.append(len(vals))
                ub = np.asarray(m.bin_upper_bound, np.float64)
                vals.extend(ub.tolist() if m.bin_type != BIN_CATEGORICAL
                            else [0.0])
                lens.append(len(ub) if m.bin_type != BIN_CATEGORICAL else 1)
                mtypes.append(int(m.missing_type))
                catf.append(m.bin_type == BIN_CATEGORICAL)
            lut = dataset._thr_lut = (
                np.asarray(offs, np.int64), np.asarray(vals, np.float64),
                np.asarray(lens, np.int64), np.asarray(mtypes, np.int64),
                np.asarray(catf, bool))
        lut_off, lut_vals, lut_len, lut_mt, lut_cat = lut
        used_arr = np.asarray(used, np.int64)
        node_orig = used_arr[sf_packed.astype(np.int64)]
        node_cat = cat.astype(bool) & lut_cat[node_orig]
        if not node_cat.any():
            t.split_feature[:ni] = node_orig.astype(np.int32)
            idx = np.minimum(t.threshold_bin.astype(np.int64),
                             lut_len[node_orig] - 1)
            # == mapper.bin_to_value: ub[min(bin, len-1)]
            t.threshold[:ni] = lut_vals[lut_off[node_orig] + idx]
            t.decision_type[:ni] = (
                (dl.astype(np.int64) != 0) * _DEFAULT_LEFT_MASK
                | (lut_mt[node_orig] & 3) << 2).astype(t.decision_type.dtype)
            return t

        for i in range(ni):
            pf = int(sf_packed[i])
            orig = used[pf]
            mapper = dataset.mappers[orig]
            t.split_feature[i] = orig
            is_cat = bool(cat[i]) and mapper.bin_type == BIN_CATEGORICAL
            if is_cat:
                t.cat_split_index[i] = len(t.cat_threshold)
                left_bins = np.nonzero(bitsets[i])[0]
                t.cat_threshold.append(
                    [mapper.bin_2_categorical[int(b)] for b in left_bins
                     if int(b) < len(mapper.bin_2_categorical)])
                # NaN was binned as bin 0 (most frequent cat) during training
                t.cat_nan_left.append(bool(bitsets[i][0]))
                t.threshold[i] = float(t.cat_split_index[i])
            else:
                t.threshold[i] = mapper.bin_to_value(int(t.threshold_bin[i]))
            t.decision_type[i] = _encode_decision_type(
                is_cat, bool(dl[i]), mapper.missing_type)
        return t

    def set_linear(self, const: np.ndarray, coeff_dense: np.ndarray,
                   used_feature_idx) -> None:
        """Attach a linear-leaf fit (learner/linear.py, the JAX package's
        ``set_linear``): the dense [L, F_packed] coefficients become each
        leaf's list of nonzero ones with their ORIGINAL feature indices
        (reference SetLeafFeatures / SetLeafCoeffs,
        linear_tree_learner.cpp:373-380)."""
        self.is_linear = True
        self.leaf_const = np.asarray(const, np.float64)[:self.num_leaves]
        cd = np.asarray(coeff_dense, np.float64)
        self.leaf_features = []
        self.leaf_coeff = []
        for l in range(self.num_leaves):
            nz = np.nonzero(cd[l] != 0.0)[0] if l < cd.shape[0] else []
            self.leaf_features.append([int(used_feature_idx[p]) for p in nz])
            self.leaf_coeff.append([float(cd[l, p]) for p in nz])

    # ---------------------------------------------------------- operations
    def apply_shrinkage(self, rate: float) -> None:
        """reference tree.h:188 ``Shrinkage`` (scales linear const/coeffs
        too, tree.cpp:194-205)."""
        self.leaf_value *= rate
        self.internal_value *= rate
        self.shrinkage *= rate
        if self.is_linear:
            self.leaf_const *= rate
            self.leaf_coeff = [[c * rate for c in cs] for cs in self.leaf_coeff]

    def add_bias(self, val: float) -> None:
        """reference tree.h:213 ``AddBias`` (boost-from-average folding)."""
        self.leaf_value += val
        self.internal_value += val
        self.bias += val
        if self.is_linear:
            self.leaf_const += val

    def scale_contribution(self, factor: float) -> None:
        """Scale this tree's own contribution (leaf values minus the folded
        bias) by ``factor``, the bias kept: DART's normalization."""
        self.leaf_value = (self.leaf_value - self.bias) * factor + self.bias
        self.internal_value = (self.internal_value - self.bias) * factor + \
            self.bias
        self.shrinkage *= factor
        if self.is_linear:
            self.leaf_const = (self.leaf_const - self.bias) * factor + \
                self.bias
            self.leaf_coeff = [[c * factor for c in cs]
                               for cs in self.leaf_coeff]

    # ---------------------------------------------------------- prediction
    def predict(self, X: np.ndarray) -> np.ndarray:
        """Vectorized traversal over rows (reference tree.h:137 Predict /
        gbdt_prediction.cpp) — frontier of node ids, numerical + categorical
        decisions with missing handling; linear leaves add coeff·x with NaN
        fallback to the plain output (tree.h:587)."""
        return self.values_from_leaf_index(X, self.predict_leaf_index(X))

    def values_from_leaf_index(self, X: np.ndarray,
                               leaf: np.ndarray) -> np.ndarray:
        """Leaf-index -> f64 output values (the value half of ``predict``),
        linear leaves of loaded models included."""
        base = self.leaf_value[leaf]
        if not self.is_linear:
            return base
        out = self.leaf_const[leaf].copy()
        nan_bad = np.zeros(len(leaf), bool)
        for l in range(self.num_leaves):
            feats = self.leaf_features[l]
            if not feats:
                continue
            rows = leaf == l
            if not rows.any():
                continue
            vals = X[np.ix_(rows, feats)]
            bad = np.isnan(vals).any(axis=1)
            out[rows] += np.nan_to_num(vals) @ np.asarray(self.leaf_coeff[l])
            nan_bad[rows] = bad
        return np.where(nan_bad, base, out)

    def predict_leaf_index(self, X: np.ndarray) -> np.ndarray:
        n = X.shape[0]
        if self.num_leaves == 1:
            return np.zeros(n, np.int32)
        node = np.zeros(n, np.int32)  # >=0 internal; negative ~leaf
        for _ in range(self.num_leaves):  # depth bound
            active = node >= 0
            if not active.any():
                break
            cur = node[active]
            feat = self.split_feature[cur]
            v = X[active, feat]
            thr = self.threshold[cur]
            dt = self.decision_type[cur]
            is_cat = (dt & _CAT_MASK) > 0
            default_left = (dt & _DEFAULT_LEFT_MASK) > 0
            mtype = (dt >> 2) & 3
            isnan = np.isnan(v)
            miss = isnan.copy()
            miss |= (mtype == MISSING_ZERO) & (np.abs(v) <= K_ZERO_THRESHOLD)
            # NaN with missing_type none falls back to 0.0 (reference
            # NumericalDecision kZeroAsMissing fallback)
            v_safe = np.where(isnan, 0.0, v)
            go_left = v_safe <= thr
            if is_cat.any():
                # one pass per categorical split reached, not per row: a
                # finite value goes left when its integer part is in the
                # split's category list, NaN as the split says
                cat_left = np.zeros(len(v), bool)
                ci = np.nonzero(is_cat)[0]
                csi_of = self.cat_split_index[cur[ci]]
                for csi in np.unique(csi_of):
                    at = ci[csi_of == csi]
                    vr = v[at]
                    nan_r = np.isnan(vr)
                    inf_r = np.isinf(vr)
                    if inf_r.any():
                        int(vr[inf_r][0])   # OverflowError, as int(inf) is
                    nan_left = (self.cat_nan_left[csi]
                                if csi < len(self.cat_nan_left) else False)
                    cats = np.asarray(self.cat_threshold[csi], np.float64)
                    cat_left[at] = np.where(
                        nan_r, nan_left,
                        np.isin(np.trunc(np.where(nan_r, 0.0, vr)), cats))
                go_left = np.where(is_cat, cat_left, go_left)
                miss = np.where(is_cat, False, miss)
            use_default = miss & (mtype != MISSING_NONE)
            go_left = np.where(use_default, default_left, go_left)
            nxt = np.where(go_left, self.left_child[cur], self.right_child[cur])
            node[active] = nxt
        return (-node - 1).astype(np.int32)

    # ------------------------------------------------------- serialization
    def to_text(self, tree_id: int) -> str:
        """Reference text format block (gbdt_model_text.cpp Tree section)."""
        ni = self.num_leaves - 1

        def arr(a, fmt="{}"):
            return " ".join(fmt.format(x) for x in a)

        lines = [f"Tree={tree_id}",
                 f"num_leaves={self.num_leaves}",
                 f"num_cat={len(self.cat_threshold)}"]
        if ni > 0:
            lines += [
                f"split_feature={arr(self.split_feature)}",
                f"split_gain={arr(self.split_gain, '{:g}')}",
                f"threshold={arr(self.threshold, '{:.17g}')}",
                f"decision_type={arr(self.decision_type)}",
                f"left_child={arr(self.left_child)}",
                f"right_child={arr(self.right_child)}",
            ]
        lines.append(f"leaf_value={arr(self.leaf_value, '{:.17g}')}")
        if ni > 0:
            lines += [
                f"leaf_weight={arr(self.leaf_weight, '{:.10g}')}",
                f"leaf_count={arr(self.leaf_count)}",
                f"internal_value={arr(self.internal_value, '{:.10g}')}",
                f"internal_weight={arr(self.internal_weight, '{:.10g}')}",
                f"internal_count={arr(self.internal_count)}",
            ]
        if self.cat_threshold:
            # bitset encoding (reference tree.cpp cat_threshold_: 32-bit words)
            boundaries = [0]
            words: List[int] = []
            for cats in self.cat_threshold:
                mx = max(cats) if cats else 0
                nw = mx // 32 + 1
                w = [0] * nw
                for c in cats:
                    w[c // 32] |= (1 << (c % 32))
                words.extend(w)
                boundaries.append(len(words))
            lines.append(f"cat_boundaries={arr(boundaries)}")
            lines.append(f"cat_threshold={arr(words)}")
        lines.append(f"is_linear={int(self.is_linear)}")
        if self.is_linear:
            # reference gbdt_model_text flat layout (tree.cpp:384-400):
            # per-leaf coefficient counts, then flat feature/coeff lists
            nf = [len(c) for c in self.leaf_coeff]
            lines.append(f"leaf_const={arr(self.leaf_const, '{:.17g}')}")
            lines.append(f"num_features={arr(nf)}")
            lines.append("leaf_features="
                         + " ".join(str(f) for fs in self.leaf_features
                                    for f in fs))
            lines.append("leaf_coeff="
                         + " ".join(f"{c:.17g}" for cs in self.leaf_coeff
                                    for c in cs))
        lines.append(f"shrinkage={self.shrinkage:g}")
        lines.append("")
        return "\n".join(lines)

    @classmethod
    def from_text(cls, block: str) -> "Tree":
        kv = {}
        for line in block.strip().splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k.strip()] = v.strip()
        num_leaves = int(kv["num_leaves"])
        t = cls(num_leaves)

        def parse(key, dtype, default=None):
            if key not in kv or kv[key] == "":
                return default
            return np.array(kv[key].split(" "), dtype=dtype)

        ni = num_leaves - 1
        if ni > 0:
            t.split_feature = parse("split_feature", np.int32)
            t.split_gain = parse("split_gain", np.float32,
                                 np.zeros(ni, np.float32))
            t.threshold = parse("threshold", np.float64)
            t.decision_type = parse("decision_type", np.int32,
                                    np.zeros(ni, np.int32))
            t.left_child = parse("left_child", np.int32)
            t.right_child = parse("right_child", np.int32)
            t.leaf_weight = parse("leaf_weight", np.float64, np.zeros(num_leaves))
            t.leaf_count = parse("leaf_count", np.int64,
                                 np.zeros(num_leaves, np.int64))
            t.internal_value = parse("internal_value", np.float64, np.zeros(ni))
            t.internal_weight = parse("internal_weight", np.float64, np.zeros(ni))
            t.internal_count = parse("internal_count", np.int64,
                                     np.zeros(ni, np.int64))
        t.leaf_value = parse("leaf_value", np.float64)
        if int(kv.get("num_cat", 0)) > 0:
            bounds = parse("cat_boundaries", np.int64)
            words = parse("cat_threshold", np.uint32)
            t.cat_threshold = []
            for i in range(len(bounds) - 1):
                cats = []
                for wi in range(int(bounds[i]), int(bounds[i + 1])):
                    w = int(words[wi])
                    base = (wi - int(bounds[i])) * 32
                    for b in range(32):
                        if w & (1 << b):
                            cats.append(base + b)
                t.cat_threshold.append(cats)
            ci = 0
            for i in range(ni):
                if t.decision_type[i] & _CAT_MASK:
                    t.cat_split_index[i] = int(t.threshold[i])
        t.shrinkage = float(kv.get("shrinkage", 1.0))
        t.is_linear = bool(int(kv.get("is_linear", 0)))
        if t.is_linear and "leaf_const" in kv:
            t.leaf_const = parse("leaf_const", np.float64,
                                 np.zeros(num_leaves))
            nf = parse("num_features", np.int64,
                       np.zeros(num_leaves, np.int64))
            flat_f = parse("leaf_features", np.int64, np.zeros(0, np.int64))
            flat_c = parse("leaf_coeff", np.float64, np.zeros(0))
            flat_f = flat_f if flat_f is not None else np.zeros(0, np.int64)
            flat_c = flat_c if flat_c is not None else np.zeros(0)
            t.leaf_features, t.leaf_coeff = [], []
            pos = 0
            for l in range(num_leaves):
                k = int(nf[l]) if l < len(nf) else 0
                t.leaf_features.append([int(f) for f in flat_f[pos:pos + k]])
                t.leaf_coeff.append([float(c) for c in flat_c[pos:pos + k]])
                pos += k
        return t
