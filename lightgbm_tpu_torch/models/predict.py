"""Per-tree prediction over binned features (valid-set score updates).

Counterpart of ``predict_bins_tree`` / ``predict_bins_leaf``,
``tree_path_masks`` and ``predict_bins_tree_matmul`` of
``lightgbm_tpu/models/predict.py``.  The walk
(:func:`predict_bins_leaf`): every row walks from the root, going left when
``bin == nan_bin ? default_left : bin <= split_bin`` at a numeric node and
when ``cat_bitset[node, bin]`` at a categorical one (the bin of an EFB
bundle column read through the bundle's inverse table), until it reaches a
leaf (children < 0 encode leaves as ``-(leaf + 1)``; an empty tree's -1
children send every row to leaf 0); it reads back one flag a level.  The
path aggregation (:func:`predict_bins_tree_matmul`), which both training
loops score their valid sets with: each node's decision bit of every row,
then one [L, ni] x [ni, rows] product counts the path conditions a row
meets, and a row belongs to the one leaf whose count is its depth; the
same leaf as the walk, with no host read.  Plain PyTorch on the trees'
device.

The forest predictors (the JAX package's ``predict_numeric_forest``,
``predict_bitset_forest`` and ``predict_forest_leaves``) take every tree of
a model at once, stacked into :class:`ForestArrays` / :class:`BitsetForest`
(boosting/gbdt.py ``_forest_arrays`` / ``_forest_bitset_arrays``, or
:func:`forest_from_numpy`).  The functions here are their plain versions,
the path-count formulation: a tree's decision bits, one
[L, ni] x [ni, n] product counting the path conditions each row meets,
the row's leaf the one whose count is its depth.  The device path runs the
hand-written walk of ops/forest_kernels.py (csrc/forest.cu) instead; it
gives the same leaves and the same float32 sums.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..learner.grower import TreeArrays


def predict_bins_leaf(tree: TreeArrays, bins: torch.Tensor,
                      nan_bin: torch.Tensor, bundle=None) -> torch.Tensor:
    """Leaf index (i64 [n]) of every row of u8 ``bins`` [n, F], or of the
    bundle columns [n, Fb] when ``bundle`` (learner/grower.py
    ``DeviceBundle``) is given."""
    n = bins.shape[0]
    rows = torch.arange(n, device=bins.device)
    node = torch.zeros(n, dtype=torch.int64, device=bins.device)
    sf = tree.split_feature.long().clamp(min=0)
    lc, rc = tree.left_child.long(), tree.right_child.long()
    # one step per tree level; a tree of L leaves is at most L - 1 deep
    for _ in range(max(int(tree.leaf_value.shape[0]) - 1, 1)):
        active = node >= 0
        safe = node.clamp(min=0)
        feat = sf[safe]
        if bundle is None:
            col = bins[rows, feat].long()
        else:
            phys = bins[rows, bundle.feat_col[feat].long()].long()
            col = bundle.inv_table[feat, phys].long()
        go_num = torch.where(tree.split_cat[safe],
                             tree.cat_bitset[safe, col],
                             col <= tree.split_bin[safe].long())
        go_left = torch.where(col == nan_bin[feat].long(),
                              tree.default_left[safe], go_num)
        nxt = torch.where(go_left, lc[safe], rc[safe])
        node = torch.where(active, nxt, node)
        if not bool((node >= 0).any()):
            break
    return -node - 1


def predict_bins_tree(tree: TreeArrays, bins: torch.Tensor,
                      nan_bin: torch.Tensor, bundle=None) -> torch.Tensor:
    """Leaf VALUE (f32 [n]) of every row for one tree."""
    return tree.leaf_value[predict_bins_leaf(tree, bins, nan_bin, bundle)]


def tree_path_masks(tree: TreeArrays):
    """Each leaf's path conditions from a grown tree's arrays, on the
    device with no host read: (mpos bf16 [L, ni], mneg bf16 [L, ni], depth
    i32 [L]), mpos[l, i] = 1 when leaf l lies left of node i, mneg when it
    lies right, depth the number of its ancestors (0 for leaves the tree
    does not use).  Child pointers invert into parent pointers (node
    validity is ``i < num_leaves - 1``, so a valid node's ``-1`` child
    really is leaf 0); the JAX package then walks every leaf up in a loop
    bounded by the tree's depth, here the ancestor sets double instead:
    after step s each node holds its ancestors up to 2^s levels above, so
    ``ni.bit_length()`` steps, a bound fixed by the shapes, cover any
    tree."""
    ni = tree.left_child.shape[0]
    L = ni + 1
    dev = tree.left_child.device
    i64 = torch.int64
    iota_n = torch.arange(ni, device=dev)
    valid_node = iota_n < tree.num_leaves.to(i64) - 1
    lc, rc = tree.left_child.long(), tree.right_child.long()

    def parents(count, is_child, index):
        """Parent and side (1: right) of each of ``count`` entries plus a
        trash entry at ``count``, from the valid nodes' children."""
        par = torch.full((count + 1,), count, dtype=i64, device=dev)
        side = torch.zeros(count + 1, dtype=torch.bool, device=dev)
        for child, is_right in ((lc, False), (rc, True)):
            tgt = torch.where(valid_node & is_child(child), index(child),
                              count)
            par.index_put_((tgt,), iota_n)
            if is_right:
                side.index_put_((tgt,), torch.ones_like(tgt, dtype=torch.bool))
        par[count].fill_(count)
        return par, side

    # nodes: row ni is "no node" (all-false masks, its own parent)
    node_par, node_side = parents(ni, lambda c: c >= 0, lambda c: c)
    col = torch.arange(ni, device=dev)
    first = node_par[:, None] == col[None, :]                  # [ni+1, ni]
    pos = first & ~node_side[:, None]
    neg = first & node_side[:, None]
    jump = node_par
    for _ in range(max(ni.bit_length(), 1)):
        pos = pos | pos[jump]
        neg = neg | neg[jump]
        jump = jump[jump]
    leaf_par, leaf_side = parents(L, lambda c: c < 0, lambda c: -c - 1)
    lp = torch.where(leaf_par[:L] < ni, leaf_par[:L], ni)
    first_l = lp[:, None] == col[None, :]
    mpos = (first_l & ~leaf_side[:L, None]) | pos[lp]
    mneg = (first_l & leaf_side[:L, None]) | neg[lp]
    depth = (mpos.sum(1) + mneg.sum(1)).to(torch.int32)
    return mpos.to(torch.bfloat16), mneg.to(torch.bfloat16), depth


#: row-block width of predict_bins_tree_matmul: bounds the [ni, rows]
#: decision bits and the [L, rows] counts (the JAX package's block)
_MATMUL_VALID_BLOCK = 131_072


def predict_bins_tree_matmul(tree: TreeArrays, bins_t: torch.Tensor,
                             nan_bin: torch.Tensor,
                             has_categorical: bool = False) -> torch.Tensor:
    """Leaf VALUE (f32 [n]) of every row for one tree, by path aggregation
    (:func:`predict_bins_leaf_matmul`): :func:`predict_bins_tree`'s values,
    bit for bit, with no host read."""
    return tree.leaf_value[predict_bins_leaf_matmul(tree, bins_t, nan_bin,
                                                    has_categorical)]


def predict_bins_leaf_matmul(tree: TreeArrays, bins_t: torch.Tensor,
                             nan_bin: torch.Tensor,
                             has_categorical: bool = False) -> torch.Tensor:
    """Leaf index (i64 [n]) of every row for one tree, by path
    aggregation: :func:`predict_bins_leaf`'s leaves, with no host read.

    ``bins_t``: u8 [F, n], the transposed valid bins.  A node's decision
    bit is one gather of its feature's row (``has_categorical``: at a
    categorical node, a gather of its bitset at those bins, one [ni, B]
    table); per block of rows one product
    (mpos - mneg) [L, ni] x bits [ni, rows] plus each leaf's count of
    right-hand conditions gives the conditions every row meets on every
    leaf's path, small integers, exact (bfloat16 up to 256 leaves, float32
    above); the row's leaf is the one used leaf whose count equals its
    depth."""
    n = bins_t.shape[1]
    dev = bins_t.device
    mpos, mneg, depth = tree_path_masks(tree)
    L = depth.shape[0]
    mm = torch.bfloat16 if L <= 256 else torch.float32
    diff = (mpos.float() - mneg.float()).to(mm)                 # [L, ni]
    base = mneg.float().sum(1)
    used = torch.arange(L, device=dev) < tree.num_leaves.long()
    want = torch.where(used, depth, -1)
    feat = tree.split_feature.long().clamp(min=0)
    thr = tree.split_bin.to(torch.int32)[:, None]
    dl = tree.default_left[:, None]
    nanb = nan_bin.to(dev)[feat].to(torch.int32)[:, None]
    outs = []
    for b0 in range(0, n, _MATMUL_VALID_BLOCK):
        cols = bins_t[:, b0:b0 + _MATMUL_VALID_BLOCK][feat].to(torch.int32)
        go = cols <= thr                                        # [ni, rows]
        if has_categorical:
            go = torch.where(tree.split_cat[:, None],
                             tree.cat_bitset.gather(1, cols.long()), go)
        go = torch.where(cols == nanb, dl, go)
        counts = torch.matmul(diff, go.to(mm)).float() + base[:, None]
        sel = counts.to(torch.int32) == want[:, None]           # [L, rows]
        outs.append(sel.to(torch.uint8).argmax(0))
    if not outs:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    return outs[0] if len(outs) == 1 else torch.cat(outs)


# ---------------------------------------------------------------- forests

class ForestArrays(NamedTuple):
    """Stacked per-tree operands of an all-numeric forest (the JAX
    package's ``ForestArrays``), built by boosting/gbdt.py
    ``_forest_arrays``.  ``left`` / ``right`` are the port's: the children
    the forest kernel walks (model text encoding, ``-(leaf + 1)`` for a
    leaf; -1 on a tree's padded nodes, so an empty tree sends every row to
    leaf 0).  The plain versions read only the JAX package's fields."""
    feat: torch.Tensor     # i32 [T, ni] packed split feature per node
    thr: torch.Tensor      # i32 [T, ni] bin threshold per node
    dl: torch.Tensor       # bool [T, ni] missing default-left
    nanb: torch.Tensor     # i32 [T, ni] nan bin of the node's feature
    mpos: torch.Tensor     # bf16 [T, L, ni] 1 where leaf's path goes LEFT
    mneg: torch.Tensor     # bf16 [T, L, ni] 1 where leaf's path goes RIGHT
    depth: torch.Tensor    # i32 [T, L] path length (-1 for dead leaf slots)
    value: torch.Tensor    # f32 [T, L] leaf values (shrunk, bias included)
    cls: torch.Tensor      # i32 [T] score column (tree index % num_class)
    left: Optional[torch.Tensor] = None    # i32 [T, ni] left child
    right: Optional[torch.Tensor] = None   # i32 [T, ni] right child


class BitsetForest(NamedTuple):
    """Stacked operands of ANY forest (the JAX package's ``BitsetForest``):
    decisions in LOGICAL bin space (io/dataset.py ``bin_external_pred``),
    numeric nodes threshold compares, true categorical nodes bitsets over
    the categorical bin range Bc (the widest categorical feature plus the
    unseen / NaN sentinel bins).  Built by boosting/gbdt.py
    ``_forest_bitset_arrays``; ``left`` / ``right`` as in
    :class:`ForestArrays`."""
    feat: torch.Tensor     # i32 [T, ni] packed LOGICAL feature per node
    thr: torch.Tensor      # i32 [T, ni] logical-bin threshold per node
    dl: torch.Tensor       # bool [T, ni] missing default-left
    nanb: torch.Tensor     # i32 [T, ni] nan bin of the node's feature
    catn: torch.Tensor     # i32 [T, C] cat node ids (ni = dead pad slot)
    catf: torch.Tensor     # i32 [T, C] cat node's packed feature
    catb: torch.Tensor     # bf16 [T, C, Bc] bin membership incl sentinels
    mpos: torch.Tensor     # bf16 [T, L, ni] 1 where leaf's path goes LEFT
    mneg: torch.Tensor     # bf16 [T, L, ni] 1 where leaf's path goes RIGHT
    depth: torch.Tensor    # i32 [T, L] path length (-1 for dead leaf slots)
    value: torch.Tensor    # f32 [T, L] leaf values (shrunk, bias included)
    cls: torch.Tensor      # i32 [T] score column (tree index % num_class)
    left: Optional[torch.Tensor] = None    # i32 [T, ni] left child
    right: Optional[torch.Tensor] = None   # i32 [T, ni] right child


class LinearLeaves(NamedTuple):
    """Linear-leaf extension of :func:`predict_bitset_forest` (the JAX
    package's ``LinearLeaves``): a leaf outputs const + x . coeff, or its
    plain value when one of its features is NaN."""
    const: torch.Tensor     # f32 [T, L] leaf intercept
    coeff: torch.Tensor     # f32 [T, L, Fr] dense coefficients (raw cols)
    featmask: torch.Tensor  # bf16 [T, L, Fr] 1 where the leaf uses the col


_INT_FIELDS = ("feat", "thr", "nanb", "depth", "cls", "catn", "catf",
               "left", "right")
_BF16_FIELDS = ("mpos", "mneg", "catb", "featmask")


def forest_from_numpy(d: Mapping[str, Any],
                      device: torch.device = torch.device("cpu")):
    """:class:`ForestArrays`, :class:`BitsetForest` or
    :class:`LinearLeaves` from a mapping of field name -> array-like (for
    example the fields of the JAX package's ``_forest_arrays`` /
    ``_forest_bitset_arrays`` results after ``np.asarray``): a mapping
    with ``const`` is linear leaves, one with ``catn`` a bitset forest,
    any other a numeric forest.  Integer fields become i32, ``dl`` bool,
    the 0/1 masks bf16 and the rest f32; ``left`` / ``right`` are
    optional."""
    kind = LinearLeaves if "const" in d else \
        BitsetForest if "catn" in d else ForestArrays

    def conv(name, a):
        a = np.asarray(a)
        if name in _INT_FIELDS:
            return torch.as_tensor(a.astype(np.int32), device=device)
        if name == "dl":
            return torch.as_tensor(a.astype(bool), device=device)
        t = torch.as_tensor(a.astype(np.float32), device=device)
        return t.to(torch.bfloat16) if name in _BF16_FIELDS else t

    return kind(**{f: conv(f, d[f]) for f in kind._fields
                   if d.get(f) is not None})


def _count_dtype(device: torch.device, L: int) -> torch.dtype:
    """Operand type of the path-count products.  The operands and the
    counts are small integers (a count is at most a leaf's depth, below
    L), exact in either type: bfloat16 on the card up to 256 leaves (the
    tensor cores), float32 on the CPU and above 256 leaves."""
    return torch.bfloat16 if device.type == "cuda" and L <= 256 \
        else torch.float32


def _leaf_onehot(feat, thr, dl, nanb, mpos, mneg, depth, bins_t,
                 cat=None) -> torch.Tensor:
    """Bool leaf one-hot [L, n] of ONE stacked tree over ``bins_t`` [F, n]
    (the JAX package's ``_leaf_onehot``): a node's decision bit is one row
    gather of its feature, ``bin == nanb ? dl : bin <= thr``; a row is in
    leaf l when the path conditions it meets, counted by one
    (mpos - mneg) [L, ni] x bits [ni, n] product plus l's count of
    right-hand conditions, equal l's depth.  ``cat``: (catn, catf, catb,
    cat_feats) of a :class:`BitsetForest` tree; a categorical node's bit
    is ``catb[c, bin]`` (0 outside [0, Bc)), one one-hot product per
    categorical feature, set over the numeric bit (pad slots ``catn = ni``
    dropped)."""
    L, ni = mpos.shape
    mm = _count_dtype(bins_t.device, L)
    cols = bins_t[feat.long()]                              # [ni, n]
    go = torch.where(cols == nanb[:, None], dl[:, None],
                     cols <= thr[:, None])
    if cat is not None:
        catn, catf, catb, cat_feats = cat
        Bc = catb.shape[-1]
        iota = torch.arange(Bc, device=bins_t.device)
        cbits = torch.zeros(catn.shape[0], bins_t.shape[1],
                            dtype=torch.float32, device=bins_t.device)
        for cf in cat_feats:
            oh = (bins_t[cf][None, :] == iota[:, None]).to(mm)  # [Bc, n]
            sel_cf = (catf == cf).to(mm)[:, None]
            cbits += torch.matmul(catb.to(mm) * sel_cf, oh).float()
        ok = catn < ni
        go[catn[ok].long()] = cbits[ok] > 0.5
    diff = (mpos.float() - mneg.float()).to(mm)
    want = depth.float() - mneg.float().sum(1)          # depth - right conds
    counts = torch.matmul(diff, go.to(mm))              # [L, n] exact ints
    return (counts == want[:, None]) & (depth[:, None] >= 0)


def _leaf_of(sel: torch.Tensor) -> torch.Tensor:
    """The leaf index (i64 [n]) of each row of a leaf one-hot: the one
    live leaf that matches (0 where none does)."""
    return sel.to(torch.uint8).argmax(0)


def _tree_ops(f, t: int):
    """Tree ``t``'s operands of ``_leaf_onehot`` from a stacked forest."""
    return (f.feat[t], f.thr[t], f.dl[t], f.nanb[t], f.mpos[t], f.mneg[t],
            f.depth[t])


def predict_numeric_forest(fa: ForestArrays, bins_t: torch.Tensor,
                           k: int) -> torch.Tensor:
    """f32 [n, k] raw scores of an all-numeric stacked forest over
    ``bins_t`` [F, n] (u8 or i32 bins), the plain version of the JAX
    package's ``predict_numeric_forest``: :func:`predict_bitset_forest`
    with no categorical feature.  (The JAX package's ``int8`` operand
    option is the serving tier's and is not here.)"""
    return predict_bitset_forest(fa, bins_t, k)


def predict_bitset_forest(fb: BitsetForest, bins_t: torch.Tensor, k: int,
                          cat_feats: tuple = (),
                          lin: Optional[LinearLeaves] = None,
                          raw: Optional[torch.Tensor] = None,
                          raw_nan: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """f32 [n, k] raw scores of ANY stacked forest, the plain version of
    the JAX package's ``predict_bitset_forest``: ``bins_t`` i32 [F, n]
    LOGICAL bins (``bin_external_pred``), ``cat_feats`` the packed
    categorical features (none: a :class:`ForestArrays` over u8 bins
    serves as well).  The trees run in order, each tree's leaf values
    added into column ``cls`` in float32 (``out.at[:, cls].add``); a row
    matches exactly one leaf, so a tree's contribution is that leaf's
    value, as the JAX package's sum over the one-hot gives it.  ``lin`` /
    ``raw`` (f32 [n, Fr], NaN zeroed) / ``raw_nan`` ([Fr, n], 1 where
    NaN): linear leaves, const + raw . coeff per leaf, the plain leaf
    value where one of the leaf's features is NaN and for a leaf with no
    feature; the products are added one feature after another in index
    order and then the constant, the additions of csrc/forest.cu's linear
    mode in its order (the same bits)."""
    n = bins_t.shape[1]
    out = torch.zeros(n, k, dtype=torch.float32, device=bins_t.device)
    zero = torch.zeros((), dtype=torch.float32, device=bins_t.device)
    for t, c in enumerate(fb.cls.tolist()):
        cat = (fb.catn[t], fb.catf[t], fb.catb[t], cat_feats) \
            if cat_feats else None
        sel = _leaf_onehot(*_tree_ops(fb, t), bins_t, cat=cat)
        leaf = _leaf_of(sel)
        if lin is None:
            contrib = fb.value[t][leaf]
        else:
            use = lin.featmask[t].float()[leaf] > 0.5            # [n, Fr]
            coef = lin.coeff[t][leaf]
            acc = torch.zeros(n, dtype=torch.float32, device=bins_t.device)
            for f in range(use.shape[1]):
                acc = acc + torch.where(use[:, f], coef[:, f] * raw[:, f],
                                        zero)
            nan_bad = (use & (raw_nan.t() > 0.5)).any(1)
            contrib = torch.where(use.any(1) & ~nan_bad,
                                  acc + lin.const[t][leaf],
                                  fb.value[t][leaf])
        out[:, c] += torch.where(sel.any(0), contrib, 0.0)
    return out


def predict_forest_leaves(f, bins_t: torch.Tensor,
                          cat_feats: tuple = ()) -> torch.Tensor:
    """i32 [T, n]: the leaf every row reaches in every tree of a stacked
    forest (:class:`BitsetForest`, or :class:`ForestArrays` with no
    categorical nodes), the plain version of the JAX package's
    ``predict_forest_leaves``.  The counts are exact, so the leaf does not
    depend on padding or on the operand type."""
    out = []
    for t in range(f.feat.shape[0]):
        cat = (f.catn[t], f.catf[t], f.catb[t], cat_feats) \
            if cat_feats else None
        out.append(_leaf_of(_leaf_onehot(*_tree_ops(f, t), bins_t,
                                         cat=cat)).to(torch.int32))
    if not out:
        return torch.zeros(0, bins_t.shape[1], dtype=torch.int32,
                           device=bins_t.device)
    return torch.stack(out)
