"""Fused batched-round partition, with or without the next round's payload.

Counterpart of ``lightgbm_tpu/ops/round_fuse.py``: :func:`partition_payload`
applies the K splits of a round in one row pass and, in the same pass,
emits the compaction sort key and the [n, W+3] payload that the next
histogram pass gathers (ops/histogram.py ``histogram_for_leaves_auto``);
:func:`partition_select` is the same pass without the payload (the bounded
histogram pool's rounds).  On CUDA tensors they launch ``csrc/partition.cu``
(one launch a call), which replaces the TPU kernels
``partition_payload_pallas`` and ``partition_select_pallas``; on CPU tensors
they run their plain versions.

The decision-table variants (:func:`partition_payload_table`,
:func:`partition_select_table`; EFB-bundled and categorical rounds) take,
in place of each slot's feature, threshold, default direction and NaN bin,
the physical column it reads and a u8 [K, B] table of the go-left bit of
every bin value of that column (:func:`decision_table` builds it on the
device, through the inverse table of the bundle plan where there is one;
a categorical slot's row is its bitset).  The same kernel runs them (a
template flag of ``csrc/partition.cu``); the JAX package partitions
bundled and categorical rounds in XLA, with the same moves.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import log
from . import cuda_lib
from .hist_kernels import _c

#: CUDA launches of each kernel in this process (read by chip_smoke.py):
#: the numeric and the decision-table variants
launches = 0
select_launches = 0
table_launches = 0
select_table_launches = 0


def partition_payload_plain(bins_t, bins_words, grad, hess, lor, mask, feats,
                            thr, dl, nanb, parents, new_leaves, validk,
                            smaller) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Plain version of :func:`partition_payload` (the JAX package's XLA
    partition math, with its i32 0/1 arithmetic)."""
    return _with_payload(_select_plain(bins_t, lor, mask, feats, thr, dl,
                                       nanb, parents, new_leaves, validk,
                                       smaller), bins_words, grad, hess)


def _columns(bins_t, feats) -> torch.Tensor:
    """i32 [K, n]: each slot's column of every row, 0 for a column outside
    [0, F) (as the TPU one-hot gives)."""
    num_f = bins_t.shape[0]
    fk = feats.long()
    in_range = (fk >= 0) & (fk < num_f)
    return torch.where(in_range[:, None],
                       bins_t[fk.clamp(0, max(num_f - 1, 0))].to(torch.int32),
                       torch.zeros((), dtype=torch.int32,
                                   device=bins_t.device))


def _select_plain(bins_t, lor, mask, feats, thr, dl, nanb, parents,
                  new_leaves, validk, smaller):
    """The partition math both plain versions share: (new_lor, sort_key,
    the bagging-masked new leaf map)."""
    cols = _columns(bins_t, feats)                                # [K, n]
    isnan = (cols == nanb[:, None]).to(torch.int32)
    le = (cols <= thr[:, None]).to(torch.int32)
    go_left = isnan * dl[:, None] + (1 - isnan) * le
    return _moves(go_left, lor, mask, parents, new_leaves, validk, smaller)


def _table_plain(bins_t, lor, mask, cols, left_tab, parents, new_leaves,
                 validk, smaller):
    """:func:`_select_plain` with the slots' go-left bits read from
    ``left_tab`` at each row's bin of column ``cols[k]`` (a bin at or past
    the table's width goes right)."""
    tab = torch.nn.functional.pad(left_tab, (0, 256 - left_tab.shape[1]))
    go_left = tab.gather(1, _columns(bins_t, cols).long()).to(torch.int32)
    return _moves(go_left, lor, mask, parents, new_leaves, validk, smaller)


def _moves(go_left, lor, mask, parents, new_leaves, validk, smaller):
    """The rows' moves from the slots' go-left bits i32 [K, n]."""
    n = lor.shape[0]
    in_par = (lor[None, :] == parents[:, None]).to(torch.int32) \
        * validk[:, None]
    move = in_par * (1 - go_left)
    tgt = (move * new_leaves[:, None]).sum(0).to(torch.int32)
    new_lor = torch.where(move.sum(0) > 0, tgt, lor)
    lor_m = torch.where(mask != 0, new_lor, torch.full_like(new_lor, -1))
    selv = (lor_m[None, :] == smaller[:, None]).any(0)
    row = torch.arange(n, dtype=torch.int32, device=lor.device)
    key = torch.where(selv, row, row | (1 << 30))
    return new_lor, key, lor_m


def partition_select_plain(bins_t, lor, mask, feats, thr, dl, nanb, parents,
                           new_leaves, validk, smaller
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`partition_select`."""
    return _select_plain(bins_t, lor, mask, feats, thr, dl, nanb, parents,
                         new_leaves, validk, smaller)[:2]


def _with_payload(moved, bins_words, grad, hess):
    new_lor, key, lor_m = moved
    payload = torch.cat([bins_words,
                         grad.contiguous().view(torch.int32)[:, None],
                         hess.contiguous().view(torch.int32)[:, None],
                         lor_m[:, None]], dim=1)
    return new_lor, key, payload


def partition_payload_table_plain(bins_t, bins_words, grad, hess, lor, mask,
                                  cols, left_tab, parents, new_leaves,
                                  validk, smaller):
    """Plain version of :func:`partition_payload_table`."""
    return _with_payload(_table_plain(bins_t, lor, mask, cols, left_tab,
                                      parents, new_leaves, validk, smaller),
                         bins_words, grad, hess)


def partition_select_table_plain(bins_t, lor, mask, cols, left_tab, parents,
                                 new_leaves, validk, smaller):
    """Plain version of :func:`partition_select_table`."""
    return _table_plain(bins_t, lor, mask, cols, left_tab, parents,
                        new_leaves, validk, smaller)[:2]


def decision_table(feats, thr, dl, nanb, *, feat_col=None, inv_table=None,
                   is_cat=None, bitsets=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decision-table variants' operands for K splits: (cols i32 [K],
    left_tab u8 [K, B]).  Slot k reads physical column cols[k] =
    feat_col[feats[k]] (``feats[k]`` without a bundle) and sends bin value
    v left when left_tab[k, v], which for iv = inv_table[feats[k], v] (the
    feature's virtual bin of bundle value v; iv = v without a bundle) is
    ``bitsets[k, iv]`` on a categorical feature (``is_cat`` bool [F],
    ``bitsets`` bool [K, B]) and ``iv == nanb[k] ? dl[k] : iv <= thr[k]``
    otherwise.  B is the bitsets' or the inverse table's width.  A feature
    outside [0, F) reads its table row at the clamped feature and column
    -1, which the kernel reads as bin 0 (the numeric kernel's rule; only
    invalid slots carry such features).  Indexing ops on device tensors
    only: it runs inside a captured round."""
    fk = feats.long()
    if feat_col is not None:
        num_f, B = inv_table.shape
    else:
        num_f, B = is_cat.shape[0], bitsets.shape[1]
    fc = fk.clamp(0, num_f - 1)
    if inv_table is not None:
        iv = inv_table[fc]                                        # [K, B]
        col = feat_col[fc]
    else:
        iv = torch.arange(B, device=fk.device).expand(fk.shape[0], B)
        col = fc
    left = torch.where(iv == nanb[:, None], dl[:, None] != 0,
                       iv <= thr[:, None])
    if is_cat is not None:
        left = torch.where(is_cat[fc][:, None],
                           bitsets.gather(1, iv.long()), left)
    cols = torch.where((fk >= 0) & (fk < num_f), col,
                       torch.full_like(col, -1))
    return cols.to(torch.int32), left.to(torch.uint8)


def partition_payload(bins_t, bins_words, grad, hess, lor, mask, feats, thr,
                      dl, nanb, parents, new_leaves, validk, smaller
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Move rows to their split side for K splits at once.

    bins_t: u8 [F, n]; bins_words: i32 [n, W] (``bins_to_words``);
    grad/hess: f32 [n]; lor: i32 [n] current leaf map; mask: i32 [n] 1/0
    bagging mask; per-slot i32 [K] descriptors: feats/thr/nanb (split
    feature, bin threshold, NaN bin), dl (default-left 0/1), parents
    (leaf split by the slot), new_leaves (its right child), validk (0/1),
    smaller (the leaves the NEXT histogram pass compacts).

    Returns (new_lor i32 [n], sort_key i32 [n], payload i32 [n, W+3]) with
    sort_key = (masked new leaf in ``smaller``) ? row : row | 2^30 and
    payload rows [words, grad bits, hess bits, masked new leaf].

    Precondition: ``bins_words == bins_to_words(bins_t.T)``, as both
    packages' growers keep them.  The kernel takes each row's split column
    from its words (byte ``f & 3`` of word ``f >> 2``; 0 for a feature
    outside [0, F), the padding bytes included) and does not read
    ``bins_t``; the plain version reads ``bins_t``.
    """
    if not bins_t.is_cuda:
        return partition_payload_plain(bins_t, bins_words, grad, hess, lor,
                                       mask, feats, thr, dl, nanb, parents,
                                       new_leaves, validk, smaller)
    global launches
    out = _launch_payload("partition_payload", bins_t, bins_words, grad,
                          hess, lor, mask, (feats, thr, dl, nanb, parents,
                                            new_leaves, validk, smaller))
    launches += 1
    return out


def partition_payload_table(bins_t, bins_words, grad, hess, lor, mask, cols,
                            left_tab, parents, new_leaves, validk, smaller
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """:func:`partition_payload` with slot k's rows going left when
    ``left_tab[k, bin]`` (u8 [K, B], B <= 256; a bin >= B goes right), the
    bin read from physical column ``cols[k]`` (i32 [K]; 0 outside [0, F)):
    the decision-table variant (:func:`decision_table`)."""
    if not bins_t.is_cuda:
        return partition_payload_table_plain(
            bins_t, bins_words, grad, hess, lor, mask, cols, left_tab,
            parents, new_leaves, validk, smaller)
    global table_launches
    out = _launch_payload("partition_payload_table", bins_t, bins_words,
                          grad, hess, lor, mask,
                          (cols, None, None, None, parents, new_leaves,
                           validk, smaller), left_tab)
    table_launches += 1
    return out


def _launch_payload(what, bins_t, bins_words, grad, hess, lor, mask, desc,
                    left_tab=None):
    num_f, n = bins_t.shape
    W = bins_words.shape[1]
    desc = _checked(what, bins_t, lor, mask, desc, left_tab,
                    (bins_words, grad, hess))
    if (bins_words.dtype != torch.int32 or grad.dtype != torch.float32
            or hess.dtype != torch.float32):
        log.fatal(f"{what} kernel takes i32 words and f32 grad/hess")
    if bins_words.shape[0] != n or grad.shape != (n,) or hess.shape != (n,):
        log.fatal(f"{what}: row operands must all have n rows")
    if 4 * W < num_f:
        log.fatal(f"{what}: {W} words cannot hold {num_f} features")
    bins_words, grad, hess, lor, mask = _c(bins_words, grad, hess, lor, mask)
    out_lor, out_key = _outputs(n, lor.device)
    out_pay = torch.empty(n, W + 3, dtype=torch.int32, device=lor.device)
    code = cuda_lib.load("partition").lgbt_partition_payload(
        n, num_f, bins_words.data_ptr(), W, grad.data_ptr(), hess.data_ptr(),
        lor.data_ptr(), mask.data_ptr(), *_ptrs(desc), out_lor.data_ptr(),
        out_key.data_ptr(), out_pay.data_ptr(), cuda_lib.stream_handle(lor))
    cuda_lib.check(code, what)
    return out_lor, out_key, out_pay


def _checked(what, bins_t, lor, mask, desc, left_tab=None, rows=()) -> list:
    """Check the operands both kernels share (and the devices of
    ``rows``); the kernel's arguments from the eight [K] slot descriptors
    (None for the three the decision-table variant does not take), K and
    the table: each descriptor a contiguous i32 tensor (the kernel reads
    them in place: no launch to stack them), the table and its width (None
    and 0 for the numeric variant).  :func:`_ptrs` turns them into C
    arguments; the caller keeps the list alive through the launch."""
    n = bins_t.shape[1]
    K = desc[0].shape[0]
    if (bins_t.dtype != torch.uint8 or lor.dtype != torch.int32
            or mask.dtype != torch.int32):
        log.fatal(f"{what} kernel takes u8 bins and an i32 leaf map and "
                  f"mask")
    if lor.shape != (n,) or mask.shape != (n,):
        log.fatal(f"{what}: row operands must all have n rows")
    if any(d is not None and d.shape != (K,) for d in desc):
        log.fatal(f"{what}: the slot descriptors must all be [K]")
    if n >= (1 << 30) or K > 1024:
        log.fatal(f"{what}: needs n < 2^30 rows and K <= 1024 slots (got "
                  f"n={n}, K={K})")
    tab = () if left_tab is None else (left_tab,)
    if left_tab is not None and (
            left_tab.dtype != torch.uint8 or left_tab.dim() != 2
            or left_tab.shape[0] != K or not 1 <= left_tab.shape[1] <= 256):
        log.fatal(f"{what}: the decision table must be u8 [K, B], "
                  f"1 <= B <= 256")
    # device indices, not torch.device objects: this runs once per round
    dev = bins_t.get_device()
    if any(t is not None and t.get_device() != dev
           for t in (lor, mask, *rows, *desc, *tab)):
        log.fatal(f"{what}: all operands must be on one device")
    args = [d if d is None or (d.dtype == torch.int32 and d.is_contiguous())
            else d.to(torch.int32).contiguous() for d in desc]
    if left_tab is None:
        return args + [K, None, 0]
    return args + [K, left_tab.contiguous(), left_tab.shape[1]]


def _ptrs(args) -> list:
    return [a.data_ptr() if isinstance(a, torch.Tensor) else
            (0 if a is None else a) for a in args]


def _outputs(n: int, dev: torch.device):
    return (torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev))


def partition_select(bins_t, lor, mask, feats, thr, dl, nanb, parents,
                     new_leaves, validk, smaller
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`partition_payload` without the payload: the same operands
    minus ``bins_words``/``grad``/``hess``; returns (new_lor i32 [n],
    sort_key i32 [n])."""
    if not bins_t.is_cuda:
        return partition_select_plain(bins_t, lor, mask, feats, thr, dl,
                                      nanb, parents, new_leaves, validk,
                                      smaller)
    global select_launches
    out = _launch_select("partition_select", bins_t, lor, mask,
                         (feats, thr, dl, nanb, parents, new_leaves, validk,
                          smaller))
    select_launches += 1
    return out


def partition_select_table(bins_t, lor, mask, cols, left_tab, parents,
                           new_leaves, validk, smaller
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`partition_select`'s decision-table variant (the operands of
    :func:`partition_payload_table` minus the payload's)."""
    if not bins_t.is_cuda:
        return partition_select_table_plain(bins_t, lor, mask, cols,
                                            left_tab, parents, new_leaves,
                                            validk, smaller)
    global select_table_launches
    out = _launch_select("partition_select_table", bins_t, lor, mask,
                         (cols, None, None, None, parents, new_leaves,
                          validk, smaller), left_tab)
    select_table_launches += 1
    return out


def _launch_select(what, bins_t, lor, mask, desc, left_tab=None):
    num_f, n = bins_t.shape
    desc = _checked(what, bins_t, lor, mask, desc, left_tab)
    bins_t, lor, mask = _c(bins_t, lor, mask)
    out_lor, out_key = _outputs(n, lor.device)
    code = cuda_lib.load("partition").lgbt_partition_select(
        bins_t.data_ptr(), n, num_f, lor.data_ptr(), mask.data_ptr(),
        *_ptrs(desc), out_lor.data_ptr(), out_key.data_ptr(),
        cuda_lib.stream_handle(lor))
    cuda_lib.check(code, what)
    return out_lor, out_key
