"""Per-tree prediction over binned features (valid-set score updates).

Counterpart of ``predict_bins_tree`` / ``predict_bins_leaf``,
``tree_path_masks`` and ``predict_bins_tree_matmul`` of
``lightgbm_tpu/models/predict.py`` for numeric, un-bundled trees.  The walk
(:func:`predict_bins_leaf`): every row walks from the root, going left when
``bin == nan_bin ? default_left : bin <= split_bin``, until it reaches a
leaf (children < 0 encode leaves as ``-(leaf + 1)``; an empty tree's -1
children send every row to leaf 0); it reads back one flag a level.  The
path aggregation (:func:`predict_bins_tree_matmul`), which both training
loops score their valid sets with: each node's decision bit of every row,
then one [L, ni] x [ni, rows] product counts the path conditions a row
meets, and a row belongs to the one leaf whose count is its depth; the
same leaf as the walk, with no host read.  Plain PyTorch on the trees'
device.  The forest predictors come later.
"""

from __future__ import annotations

import torch

from ..learner.grower import TreeArrays


def predict_bins_leaf(tree: TreeArrays, bins: torch.Tensor,
                      nan_bin: torch.Tensor) -> torch.Tensor:
    """Leaf index (i64 [n]) of every row of u8 ``bins`` [n, F]."""
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
        col = bins[rows, feat].long()
        go_left = torch.where(col == nan_bin[feat].long(),
                              tree.default_left[safe],
                              col <= tree.split_bin[safe].long())
        nxt = torch.where(go_left, lc[safe], rc[safe])
        node = torch.where(active, nxt, node)
        if not bool((node >= 0).any()):
            break
    return -node - 1


def predict_bins_tree(tree: TreeArrays, bins: torch.Tensor,
                      nan_bin: torch.Tensor) -> torch.Tensor:
    """Leaf VALUE (f32 [n]) of every row for one tree."""
    return tree.leaf_value[predict_bins_leaf(tree, bins, nan_bin)]


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
                             nan_bin: torch.Tensor) -> torch.Tensor:
    """Leaf VALUE (f32 [n]) of every row for one tree, by path aggregation:
    :func:`predict_bins_tree`'s values, bit for bit, with no host read.

    ``bins_t``: u8 [F, n], the transposed valid bins.  A node's decision
    bit is one gather of its feature's row; per block of rows one product
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
    value = tree.leaf_value
    outs = []
    for b0 in range(0, n, _MATMUL_VALID_BLOCK):
        cols = bins_t[:, b0:b0 + _MATMUL_VALID_BLOCK][feat].to(torch.int32)
        go = torch.where(cols == nanb, dl, cols <= thr)         # [ni, rows]
        counts = torch.matmul(diff, go.to(mm)).float() + base[:, None]
        sel = counts.to(torch.int32) == want[:, None]           # [L, rows]
        outs.append(value[sel.to(torch.uint8).argmax(0)])
    if not outs:
        return torch.zeros(0, dtype=value.dtype, device=dev)
    return outs[0] if len(outs) == 1 else torch.cat(outs)
