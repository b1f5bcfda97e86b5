"""Fused batched-round partition with the next round's compaction payload.

Counterpart of ``lightgbm_tpu/ops/round_fuse.py``: :func:`partition_payload`
applies the K splits of a round in one row pass and, in the same pass,
emits the compaction sort key and the [n, W+3] payload that the next
histogram pass gathers (ops/histogram.py ``histogram_for_leaves_auto``).
On CUDA tensors it launches ``csrc/partition.cu``, which replaces the TPU
kernel ``partition_payload_pallas``; on CPU tensors it runs
:func:`partition_payload_plain`.  Numeric, non-bundled splits only, as in
the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import log
from . import cuda_lib

#: CUDA launches of the kernel in this process (read by chip_smoke.py)
launches = 0


def partition_payload_plain(bins_t, bins_words, grad, hess, lor, mask, feats,
                            thr, dl, nanb, parents, new_leaves, validk,
                            smaller) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Plain version of :func:`partition_payload` (the JAX package's XLA
    partition math, with its i32 0/1 arithmetic)."""
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
    payload = torch.cat([bins_words,
                         grad.contiguous().view(torch.int32)[:, None],
                         hess.contiguous().view(torch.int32)[:, None],
                         lor_m[:, None]], dim=1)
    return new_lor, key, payload


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
    """
    if not bins_t.is_cuda:
        return partition_payload_plain(bins_t, bins_words, grad, hess, lor,
                                       mask, feats, thr, dl, nanb, parents,
                                       new_leaves, validk, smaller)
    global launches
    num_f, n = bins_t.shape
    W = bins_words.shape[1]
    desc = torch.stack([feats, thr, dl, nanb, parents, new_leaves, validk,
                        smaller]).to(torch.int32).contiguous()     # [8, K]
    K = desc.shape[1]
    dev = bins_t.device
    if (bins_t.dtype != torch.uint8 or bins_words.dtype != torch.int32
            or grad.dtype != torch.float32 or hess.dtype != torch.float32
            or lor.dtype != torch.int32 or mask.dtype != torch.int32):
        log.fatal("partition_payload kernel takes u8 bins, i32 words, f32 "
                  "grad/hess and i32 leaf map and mask")
    if bins_words.shape[0] != n or any(
            t.shape != (n,) for t in (grad, hess, lor, mask)):
        log.fatal("partition_payload: row operands must all have n rows")
    if n >= (1 << 30) or K > 1024:
        log.fatal(f"partition_payload: needs n < 2^30 rows and K <= 1024 "
                  f"slots (got n={n}, K={K})")
    if any(t.device != dev for t in (bins_words, grad, hess, lor, mask,
                                     desc)):
        log.fatal("partition_payload: all operands must be on one device")
    bins_t, bins_words, grad, hess, lor, mask = (
        t.contiguous() for t in (bins_t, bins_words, grad, hess, lor, mask))
    out_lor = torch.empty(n, dtype=torch.int32, device=dev)
    out_key = torch.empty(n, dtype=torch.int32, device=dev)
    out_pay = torch.empty(n, W + 3, dtype=torch.int32, device=dev)
    lib = cuda_lib.load("partition")
    code = lib.lgbt_partition_payload(
        bins_t.data_ptr(), n, num_f, bins_words.data_ptr(), W,
        grad.data_ptr(), hess.data_ptr(), lor.data_ptr(), mask.data_ptr(),
        desc.data_ptr(), K, out_lor.data_ptr(), out_key.data_ptr(),
        out_pay.data_ptr(), cuda_lib.stream_handle(bins_t))
    cuda_lib.check(code, "partition_payload")
    launches += 1
    return out_lor, out_key, out_pay
