"""SHAP feature contributions (TreeSHAP, path-dependent).

Counterpart of ``lightgbm_tpu/models/shap.py`` (reference
src/io/tree.cpp ``Tree::TreeSHAP``, called from gbdt_prediction.cpp:44
``PredictContrib``; Lundberg & Lee's exact polynomial-time tree SHAP).  The
host part is the JAX package's NumPy code, copied: the recursive oracle
(:func:`tree_shap_row`), each tree's path decomposition
(:class:`_TreePaths`), the split decisions of a row block
(:func:`_go_left_matrix`) and the float64 slot recurrences
(:func:`_phi_slots`).  Above ``n x max_leaves > 2,000,000`` (or with
``force_device``) the recurrences run in float32 on a torch device instead,
4,096 rows at a time, as the JAX package's jitted program does: on the
card the hand-written kernel of csrc/shap.cu, on the CPU its plain
PyTorch version (ops/shap_kernels.py).  The output layout is the
reference's: one column per feature plus a last "expected value" column,
summed over all trees.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .tree import _CAT_MASK, _DEFAULT_LEFT_MASK, Tree
from ..io.binning import K_ZERO_THRESHOLD, MISSING_NONE, MISSING_ZERO


class _PathElement:
    __slots__ = ("feature_index", "zero_fraction", "one_fraction",
                 "pweight")

    def __init__(self, feature_index=-1, zero_fraction=0.0, one_fraction=0.0,
                 pweight=0.0):
        self.feature_index = feature_index
        self.zero_fraction = zero_fraction
        self.one_fraction = one_fraction
        self.pweight = pweight

    def copy(self) -> "_PathElement":
        return _PathElement(self.feature_index, self.zero_fraction,
                            self.one_fraction, self.pweight)


def _extend(path: List[_PathElement], zero_fraction: float,
            one_fraction: float, feature_index: int) -> None:
    path.append(_PathElement(feature_index, zero_fraction, one_fraction,
                             1.0 if len(path) == 0 else 0.0))
    d = len(path) - 1
    for i in range(d - 1, -1, -1):
        path[i + 1].pweight += one_fraction * path[i].pweight * (i + 1) / (d + 1)
        path[i].pweight = zero_fraction * path[i].pweight * (d - i) / (d + 1)


def _unwind(path: List[_PathElement], index: int) -> None:
    d = len(path) - 1
    one_fraction = path[index].one_fraction
    zero_fraction = path[index].zero_fraction
    next_one_portion = path[d].pweight
    for i in range(d - 1, -1, -1):
        if one_fraction != 0.0:
            tmp = path[i].pweight
            path[i].pweight = next_one_portion * (d + 1) / \
                ((i + 1) * one_fraction)
            next_one_portion = tmp - path[i].pweight * zero_fraction * \
                (d - i) / (d + 1)
        else:
            path[i].pweight = path[i].pweight * (d + 1) / \
                (zero_fraction * (d - i))
    for i in range(index, d):
        path[i].feature_index = path[i + 1].feature_index
        path[i].zero_fraction = path[i + 1].zero_fraction
        path[i].one_fraction = path[i + 1].one_fraction
    path.pop()


def _unwound_path_sum(path: List[_PathElement], index: int) -> float:
    d = len(path) - 1
    one_fraction = path[index].one_fraction
    zero_fraction = path[index].zero_fraction
    next_one_portion = path[d].pweight
    total = 0.0
    for i in range(d - 1, -1, -1):
        if one_fraction != 0.0:
            tmp = next_one_portion * (d + 1) / ((i + 1) * one_fraction)
            total += tmp
            next_one_portion = path[i].pweight - tmp * zero_fraction * \
                (d - i) / (d + 1)
        elif zero_fraction != 0.0:
            total += (path[i].pweight / zero_fraction) * (d + 1) / (d - i)
    return total


def _decide_left(tree: Tree, node: int, x: np.ndarray) -> bool:
    """Scalar split decision (mirrors Tree.predict_leaf_index semantics)."""
    f = int(tree.split_feature[node])
    v = x[f]
    dt = int(tree.decision_type[node])
    if dt & _CAT_MASK:
        csi = int(tree.cat_split_index[node])
        if np.isnan(v):
            return bool(tree.cat_nan_left[csi]) \
                if csi < len(tree.cat_nan_left) else False
        return int(v) in tree.cat_threshold[csi]
    mtype = (dt >> 2) & 3
    isnan = np.isnan(v)
    miss = isnan or (mtype == MISSING_ZERO and abs(v) <= K_ZERO_THRESHOLD)
    if miss and mtype != MISSING_NONE:
        return bool(dt & _DEFAULT_LEFT_MASK)
    v_safe = 0.0 if isnan else v
    return v_safe <= tree.threshold[node]


def _node_cover(tree: Tree, node: int) -> float:
    if node < 0:
        return max(float(tree.leaf_count[-node - 1]), 1.0)
    return max(float(tree.internal_count[node]), 1.0)


def tree_expected_value(tree: Tree) -> float:
    total = tree.leaf_count.sum()
    if total <= 0:
        return float(tree.leaf_value.mean())
    return float((tree.leaf_value * tree.leaf_count).sum() / total)


def tree_shap_row(tree: Tree, x: np.ndarray, phi: np.ndarray) -> None:
    """Accumulate one tree's SHAP values for one row into ``phi`` (len F+1)."""
    phi[-1] += tree_expected_value(tree)
    if tree.num_leaves == 1:
        return

    def recurse(node: int, path: List[_PathElement], zero_fraction: float,
                one_fraction: float, feature_index: int) -> None:
        path = [p.copy() for p in path]
        _extend(path, zero_fraction, one_fraction, feature_index)
        if node < 0:  # leaf
            leaf_value = float(tree.leaf_value[-node - 1])
            for i in range(1, len(path)):
                w = _unwound_path_sum(path, i)
                el = path[i]
                phi[el.feature_index] += w * (el.one_fraction -
                                              el.zero_fraction) * leaf_value
        else:
            go_left = _decide_left(tree, node, x)
            hot = int(tree.left_child[node] if go_left
                      else tree.right_child[node])
            cold = int(tree.right_child[node] if go_left
                       else tree.left_child[node])
            w = _node_cover(tree, node)
            hot_zero = _node_cover(tree, hot) / w
            cold_zero = _node_cover(tree, cold) / w
            incoming_zero = 1.0
            incoming_one = 1.0
            split_f = int(tree.split_feature[node])
            k = next((i for i in range(len(path))
                      if path[i].feature_index == split_f), -1)
            if k >= 0:
                incoming_zero = path[k].zero_fraction
                incoming_one = path[k].one_fraction
                _unwind(path, k)
            recurse(hot, path, incoming_zero * hot_zero, incoming_one, split_f)
            recurse(cold, path, incoming_zero * cold_zero, 0.0, split_f)

    recurse(0, [], 1.0, 1.0, -1)


# --------------------------------------------------------------------------
# Vectorized TreeSHAP
#
# The recursion above (kept as the small-input/oracle path) is rewritten as
# whole-array recurrences so contribs scale to datasets (reference: the C++
# TreeSHAP in src/io/tree.cpp runs the same per-row algorithm in compiled
# code; a Python per-row walk is interpreter-bound).  Key identity: at each
# leaf the recursion's path state consists of the root dummy element plus ONE
# consolidated element per unique feature on the root->leaf path, with
#   zero_fraction = prod(cover(child_toward_leaf) / cover(node))
#   one_fraction  = prod(row decision at node == direction toward leaf)
# and the extend recurrence is commutative in the elements, so the state can
# be computed slot-by-slot in first-occurrence order for ALL (row, leaf)
# pairs at once.  The extend / unwound-sum loops then run over the slot axis
# with [rows, leaves] array steps.


class _TreePaths:
    """Host-side per-tree decomposition (cached on the Tree instance)."""

    __slots__ = ("S", "feats", "z", "m", "values", "expected",
                 "edge_sort_slot", "edge_node", "edge_dirleft",
                 "edge_seg_starts", "edge_slot_ids", "featoh", "tables")

    def __init__(self, tree: Tree, num_features: int):
        L = tree.num_leaves
        # iterative DFS; path = ordered slots [feat, z, [(node, dir_left)]]
        leaf_slots: List[list] = [None] * L
        if L == 1:
            leaf_slots = [[]]
        else:
            stack = [(0, [])]
            while stack:
                node, slots = stack.pop()
                if node < 0:
                    leaf_slots[-node - 1] = slots
                    continue
                f = int(tree.split_feature[node])
                w = _node_cover(tree, node)
                for child, dir_left in ((int(tree.left_child[node]), True),
                                        (int(tree.right_child[node]), False)):
                    ratio = _node_cover(tree, child) / w
                    new = [s[:] for s in slots]
                    for s in new:
                        s[2] = list(s[2])
                    hit = next((s for s in new if s[0] == f), None)
                    if hit is None:
                        new.append([f, ratio, [(node, dir_left)]])
                    else:
                        hit[1] *= ratio
                        hit[2].append((node, dir_left))
                    stack.append((child, new))
        # the slot axis padded to a multiple of 4 and the leaf axis to a
        # multiple of 32, as in the JAX package (whose jitted program
        # shares shapes across trees); pad leaves carry m=0 / value=0 and
        # contribute exactly nothing
        S = max(1, max(len(s) for s in leaf_slots))
        S = -(-S // 4) * 4
        L = -(-L // 32) * 32
        self.S = S
        self.feats = np.full((L, S), -1, np.int32)
        self.z = np.ones((L, S), np.float64)
        self.m = np.zeros(L, np.int32)
        e_slot, e_node, e_dir = [], [], []
        for li, slots in enumerate(leaf_slots):
            self.m[li] = len(slots)
            for si, (f, zf, edges) in enumerate(slots):
                self.feats[li, si] = f
                self.z[li, si] = zf
                for node, dl in edges:
                    e_slot.append(li * S + si)
                    e_node.append(node)
                    e_dir.append(dl)
        # edges sorted by flat slot id -> segment-AND via minimum.reduceat
        order = np.argsort(np.asarray(e_slot, np.int64), kind="stable") \
            if e_slot else np.zeros(0, np.int64)
        es = np.asarray(e_slot, np.int64)[order]
        self.edge_node = np.asarray(e_node, np.int32)[order]
        self.edge_dirleft = np.asarray(e_dir, bool)[order]
        starts = np.flatnonzero(np.r_[True, es[1:] != es[:-1]]) \
            if es.size else np.zeros(0, np.int64)
        self.edge_seg_starts = starts
        self.edge_slot_ids = es[starts] if es.size else es
        self.edge_sort_slot = es
        self.values = np.zeros(L, np.float64)
        self.values[:tree.num_leaves] = tree.leaf_value[:tree.num_leaves]
        self.expected = tree_expected_value(tree)
        # slot feature -> output column one-hot (pad slots all-zero)
        oh = np.zeros((L, S, num_features + 1), np.float32)
        valid = self.feats >= 0
        li, si = np.nonzero(valid)
        oh[li, si, self.feats[li, si]] = 1.0
        self.featoh = oh
        # the device operands by torch device (ops/shap_kernels.py)
        self.tables = {}


def _paths_of(tree: Tree, num_features: int) -> _TreePaths:
    cached = getattr(tree, "_shap_paths", None)
    if cached is None or cached.featoh.shape[-1] != num_features + 1:
        cached = _TreePaths(tree, num_features)
        tree._shap_paths = cached
    return cached


def _go_left_matrix(tree: Tree, X: np.ndarray) -> np.ndarray:
    """Vectorized split decisions: bool [n, num_internal] (f64 compares,
    mirroring ``_decide_left`` / Tree.predict semantics exactly)."""
    ni = tree.num_leaves - 1
    if ni == 0:
        return np.zeros((X.shape[0], 0), bool)
    xv = X[:, tree.split_feature[:ni]]                     # [n, ni]
    dt = tree.decision_type[:ni]
    mtype = (dt >> 2) & 3
    isnan = np.isnan(xv)
    miss = isnan | ((mtype[None, :] == MISSING_ZERO)
                    & (np.abs(xv) <= K_ZERO_THRESHOLD))
    use_default = miss & (mtype[None, :] != MISSING_NONE)
    gl = np.where(use_default, (dt & _DEFAULT_LEFT_MASK)[None, :] > 0,
                  np.where(isnan, 0.0, xv) <= tree.threshold[None, :][:, :ni])
    for s in np.flatnonzero(dt & _CAT_MASK):
        csi = int(tree.cat_split_index[s])
        cats = np.asarray(tree.cat_threshold[csi], np.int64)
        v = xv[:, s]
        nan_s = np.isnan(v)
        member = np.isin(np.where(nan_s, -1, v).astype(np.int64), cats)
        nl = bool(tree.cat_nan_left[csi]) \
            if csi < len(tree.cat_nan_left) else False
        gl[:, s] = np.where(nan_s, nl, member)
    return gl.astype(bool)


def _one_fractions(tp: _TreePaths, gl: np.ndarray) -> np.ndarray:
    """o [n, L, S] u8: per (row, leaf, slot) AND of toward-leaf decisions."""
    n = gl.shape[0]
    L, S = tp.feats.shape
    o = np.ones((n, L * S), np.uint8)
    if tp.edge_node.size:
        toward = (gl[:, tp.edge_node] == tp.edge_dirleft[None, :]) \
            .astype(np.uint8)                              # [n, E] sorted
        reduced = np.minimum.reduceat(toward, tp.edge_seg_starts, axis=1)
        o[:, tp.edge_slot_ids] = reduced
    return o.reshape(n, L, S)


def _phi_slots(o, z, m, values, S):
    """The extend + unwound-sum recurrences over the slot axis, in numpy
    float64 (the JAX package's NumPy branch).

    o [n, L, S] (0/1), z [L, S], m [L] int, values [L].  Returns
    phi_slots [n, L, S] = per-slot SHAP contribution of every leaf.  The
    float32 device version is ops/shap_kernels.py ``phi_slots_plain`` (and
    the kernel of csrc/shap.cu).
    """
    n, L = o.shape[0], o.shape[1]
    dtype = z.dtype
    # ---- extend: p[pos] over positions 0..S (pos 0 = root dummy element)
    p = np.zeros((n, L, S + 1), dtype)
    p[:, :, 0] = 1.0
    for j in range(S):
        d = j + 1                      # path last-index after this extend
        pos = np.arange(S + 1)
        ck = ((d - pos) / (d + 1.0)).clip(min=0.0).astype(dtype)  # keep coef
        cs = (pos / (d + 1.0)).astype(dtype)                      # shift coef
        p_shift = np.concatenate(
            [np.zeros((n, L, 1), dtype), p[:, :, :-1]], axis=2)
        zj = z[None, :, j, None]
        oj = o[:, :, j, None].astype(dtype)
        p_new = zj * p * ck[None, None, :] + oj * p_shift * cs[None, None, :]
        act = (j < m)[None, :, None]
        p = np.where(act, p_new, p)
    # ---- per-slot unwound path sum (variable path length D = m per leaf)
    D = m.astype(np.int32)             # [L]
    Dp1 = (D + 1).astype(dtype)        # [L]
    p_at_D = np.take_along_axis(p, D[None, :, None].astype(np.int64),
                                axis=2)[:, :, 0]
    phi = np.zeros((n, L, S), dtype)
    for i in range(S):
        oi = o[:, :, i].astype(dtype)              # [n, L] 0/1
        zi = z[None, :, i]                         # [1, L]
        nxt = p_at_D
        tot = np.zeros((n, L), dtype)
        for jj in range(S - 1, -1, -1):
            live = (jj < D)[None, :]               # position exists
            denom_o = (jj + 1.0)
            tmp = nxt * Dp1[None, :] / denom_o     # o==1 branch (oi is 0/1)
            contrib1 = tmp
            nxt_new = p[:, :, jj] - tmp * zi * \
                ((D[None, :] - jj) / Dp1[None, :])
            # dead positions (jj >= D) have p[..jj] == 0, so contrib0 is 0
            # there; the denominator guard only avoids 0/0
            contrib0 = p[:, :, jj] / zi * \
                (Dp1[None, :] / np.maximum(
                    (D[None, :] - jj).astype(dtype), dtype.type(0.5)))
            is_one = oi > 0.5
            step_tot = np.where(is_one, contrib1, contrib0)
            tot = np.where(live, tot + step_tot, tot)
            nxt = np.where(live & is_one, nxt_new, nxt)
        w_i = np.where((i < m)[None, :], tot, 0.0)
        phi[:, :, i] = (oi - zi) * w_i * values[None, :]
    return phi


#: rows of a device chunk (the JAX package's jitted chunk)
_DEVICE_CHUNK_ROWS = 4096
#: n x max_leaves above which the recurrences run on the device
DEVICE_CONTRIB_MIN_WORK = 2_000_000


def predict_contrib(trees: List[Tree], X: np.ndarray, num_features: int,
                    num_tree_per_iteration: int = 1,
                    start_iteration: int = 0,
                    end_iteration: int = -1,
                    force_device: bool = False,
                    device: Optional["torch.device"] = None) -> np.ndarray:
    """SHAP contributions summed over trees (vectorized TreeSHAP).

    Returns ``[n, F + 1]`` for single-output models, ``[n, k * (F + 1)]``
    flattened class-major for ``k``-output models (reference
    PredictContrib layout, c_api.h predict_type=C_API_PREDICT_CONTRIB).

    Small inputs run the recurrences in numpy float64 (bit-comparable to
    the reference's double TreeSHAP).  When ``n x max_leaves`` passes
    ``DEVICE_CONTRIB_MIN_WORK``, or with ``force_device``, they run in
    float32 on ``device`` (a torch device; ``device`` must then be
    given), 4,096 rows a call: the host computes each chunk's split
    decisions (``_go_left_matrix``), the device the segment-AND of the
    one-fractions, the recurrences and the per-feature sums, and the host
    adds each tree's float32 result in float64.
    """
    X = np.asarray(X, np.float64)
    if X.ndim == 1:
        X = X.reshape(1, -1)
    n = X.shape[0]
    k = max(1, num_tree_per_iteration)
    total_iters = len(trees) // k if k else 0
    end = total_iters if end_iteration is None or end_iteration <= 0 else \
        min(total_iters, end_iteration)
    phi = np.zeros((n, k, num_features + 1))
    use_device = force_device or n * max(
        (t.num_leaves for t in trees), default=1) > DEVICE_CONTRIB_MIN_WORK
    if use_device:
        if device is None:
            raise ValueError("predict_contrib on the device needs a device")
        from ..ops import shap_kernels
    for it in range(start_iteration, end):
        for c in range(k):
            t = trees[it * k + c]
            tp = _paths_of(t, num_features)
            phi[:, c, -1] += tp.expected
            if t.num_leaves <= 1:
                continue
            if not use_device:
                featoh64 = tp.featoh.astype(np.float64)
                for r0 in range(0, n, _DEVICE_CHUNK_ROWS):
                    sl = slice(r0, min(n, r0 + _DEVICE_CHUNK_ROWS))
                    gl = _go_left_matrix(t, X[sl])
                    o = _one_fractions(tp, gl)
                    ps = _phi_slots(o, tp.z, tp.m, tp.values, tp.S)
                    phi[sl, c, :] += np.einsum("nls,lsf->nf", ps, featoh64)
            else:
                tables = shap_kernels.tree_tables(tp, device)
                for r0 in range(0, n, _DEVICE_CHUNK_ROWS):
                    sl = slice(r0, min(n, r0 + _DEVICE_CHUNK_ROWS))
                    gl = shap_kernels.go_left_to_device(
                        _go_left_matrix(t, X[sl]), device)
                    out = shap_kernels.tree_shap(tables, gl)
                    phi[sl, c, :] += out.cpu().numpy().astype(np.float64)
    if k == 1:
        return phi[:, 0, :]
    return phi.reshape(n, k * (num_features + 1))
