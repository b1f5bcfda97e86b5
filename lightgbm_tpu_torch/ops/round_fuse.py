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
Numeric, non-bundled splits only, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import log
from . import cuda_lib
from .hist_kernels import _c

#: CUDA launches of each kernel in this process (read by chip_smoke.py)
launches = 0
select_launches = 0


def partition_payload_plain(bins_t, bins_words, grad, hess, lor, mask, feats,
                            thr, dl, nanb, parents, new_leaves, validk,
                            smaller) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Plain version of :func:`partition_payload` (the JAX package's XLA
    partition math, with its i32 0/1 arithmetic)."""
    new_lor, key, lor_m = _select_plain(bins_t, lor, mask, feats, thr, dl,
                                        nanb, parents, new_leaves, validk,
                                        smaller)
    payload = torch.cat([bins_words,
                         grad.contiguous().view(torch.int32)[:, None],
                         hess.contiguous().view(torch.int32)[:, None],
                         lor_m[:, None]], dim=1)
    return new_lor, key, payload


def _select_plain(bins_t, lor, mask, feats, thr, dl, nanb, parents,
                  new_leaves, validk, smaller):
    """The partition math both plain versions share: (new_lor, sort_key,
    the bagging-masked new leaf map)."""
    num_f, n = bins_t.shape
    fk = feats.long()
    in_range = (fk >= 0) & (fk < num_f)
    cols = torch.where(in_range[:, None],
                       bins_t[fk.clamp(0, max(num_f - 1, 0))].to(torch.int32),
                       torch.zeros((), dtype=torch.int32,
                                   device=bins_t.device))         # [K, n]
    isnan = (cols == nanb[:, None]).to(torch.int32)
    le = (cols <= thr[:, None]).to(torch.int32)
    go_left = isnan * dl[:, None] + (1 - isnan) * le
    in_par = (lor[None, :] == parents[:, None]).to(torch.int32) \
        * validk[:, None]
    move = in_par * (1 - go_left)
    tgt = (move * new_leaves[:, None]).sum(0).to(torch.int32)
    new_lor = torch.where(move.sum(0) > 0, tgt, lor)
    lor_m = torch.where(mask != 0, new_lor, torch.full_like(new_lor, -1))
    selv = (lor_m[None, :] == smaller[:, None]).any(0)
    row = torch.arange(n, dtype=torch.int32, device=bins_t.device)
    key = torch.where(selv, row, row | (1 << 30))
    return new_lor, key, lor_m


def partition_select_plain(bins_t, lor, mask, feats, thr, dl, nanb, parents,
                           new_leaves, validk, smaller
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`partition_select`."""
    return _select_plain(bins_t, lor, mask, feats, thr, dl, nanb, parents,
                         new_leaves, validk, smaller)[:2]


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
    num_f, n = bins_t.shape
    W = bins_words.shape[1]
    desc = _checked("partition_payload", bins_t, lor, mask,
                    (feats, thr, dl, nanb, parents, new_leaves, validk,
                     smaller), (bins_words, grad, hess))
    if (bins_words.dtype != torch.int32 or grad.dtype != torch.float32
            or hess.dtype != torch.float32):
        log.fatal("partition_payload kernel takes i32 words and f32 "
                  "grad/hess")
    if bins_words.shape[0] != n or grad.shape != (n,) or hess.shape != (n,):
        log.fatal("partition_payload: row operands must all have n rows")
    if 4 * W < num_f:
        log.fatal(f"partition_payload: {W} words cannot hold {num_f} "
                  f"features")
    bins_words, grad, hess, lor, mask = _c(bins_words, grad, hess, lor, mask)
    out_lor, out_key = _outputs(n, lor.device)
    out_pay = torch.empty(n, W + 3, dtype=torch.int32, device=lor.device)
    code = cuda_lib.load("partition").lgbt_partition_payload(
        n, num_f, bins_words.data_ptr(), W, grad.data_ptr(), hess.data_ptr(),
        lor.data_ptr(), mask.data_ptr(), *[d.data_ptr() for d in desc],
        len(feats), out_lor.data_ptr(), out_key.data_ptr(),
        out_pay.data_ptr(), cuda_lib.stream_handle(lor))
    cuda_lib.check(code, "partition_payload")
    launches += 1
    return out_lor, out_key, out_pay


def _checked(what, bins_t, lor, mask, desc, rows=()) -> list:
    """Check the operands both kernels share (and the devices of ``rows``);
    the eight [K] slot descriptors as contiguous i32 (the kernel reads them
    in place: no launch to stack them)."""
    n = bins_t.shape[1]
    K = desc[0].shape[0]
    if (bins_t.dtype != torch.uint8 or lor.dtype != torch.int32
            or mask.dtype != torch.int32):
        log.fatal(f"{what} kernel takes u8 bins and an i32 leaf map and "
                  f"mask")
    if lor.shape != (n,) or mask.shape != (n,):
        log.fatal(f"{what}: row operands must all have n rows")
    if any(d.shape != (K,) for d in desc):
        log.fatal(f"{what}: the slot descriptors must all be [K]")
    if n >= (1 << 30) or K > 1024:
        log.fatal(f"{what}: needs n < 2^30 rows and K <= 1024 slots (got "
                  f"n={n}, K={K})")
    # device indices, not torch.device objects: this runs once per round
    dev = bins_t.get_device()
    if any(t.get_device() != dev for t in (lor, mask, *rows, *desc)):
        log.fatal(f"{what}: all operands must be on one device")
    return [d if d.dtype == torch.int32 and d.is_contiguous()
            else d.to(torch.int32).contiguous() for d in desc]


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
    num_f, n = bins_t.shape
    desc = _checked("partition_select", bins_t, lor, mask,
                    (feats, thr, dl, nanb, parents, new_leaves, validk,
                     smaller))
    bins_t, lor, mask = _c(bins_t, lor, mask)
    out_lor, out_key = _outputs(n, lor.device)
    code = cuda_lib.load("partition").lgbt_partition_select(
        bins_t.data_ptr(), n, num_f, lor.data_ptr(), mask.data_ptr(),
        *[d.data_ptr() for d in desc], len(feats), out_lor.data_ptr(),
        out_key.data_ptr(), cuda_lib.stream_handle(lor))
    cuda_lib.check(code, "partition_select")
    select_launches += 1
    return out_lor, out_key
