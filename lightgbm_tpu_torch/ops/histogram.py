"""Gradient/hessian histogram construction (dispatch layer).

Counterpart of ``lightgbm_tpu/ops/histogram.py`` under
``hist_kernel=onehot``, the flat bit-identity reference mode every other
mode of the JAX package must match.  The root pass and the full masked
passes run the masked K-leaf kernel (ops/hist_kernels.py
``histogram_leaves``); a round whose selected rows fit a bucket compacts
them (sort on the packed ``row | 2^30`` key + one row gather of the i32
payload) and runs the payload kernel on the bucket.

Not ported yet: ``hist_kernel=auto|packed|radix2`` and their radix /
packed-compare kernels (``resolve_hist_kernel`` names them), and the
distributed all-reduce (``reduce_hist`` is the serial no-op).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..utils import log
from .hist_kernels import histogram_leaves, histogram_payload

NUM_CHANNELS = 4  # grad, hess, count, pad

HIST_KERNELS = ("auto", "onehot", "packed", "radix2")
#: JAX-package kernels each unported mode needs (ops/hist_pallas.py)
_UNPORTED = {
    "auto": "histogram_radix_single_pallas, histogram_radix_joint_pallas, "
            "histogram_leaves_radix2_pallas, histogram_leaves_packed_pallas",
    "packed": "histogram_leaves_packed_pallas",
    "radix2": "histogram_leaves_radix2_pallas",
}


def resolve_hist_kernel(name) -> str:
    """Validate ``hist_kernel``: only ``onehot`` is ported."""
    n = str(name or "auto").strip().lower()
    if n not in HIST_KERNELS:
        log.fatal("unknown hist_kernel=%r (expected one of %s)"
                  % (name, "/".join(HIST_KERNELS)))
    if n != "onehot":
        log.fatal("hist_kernel=%s is not supported by lightgbm_tpu_torch yet "
                  "(its kernels %s are not ported); set hist_kernel=onehot"
                  % (n, _UNPORTED[n]))
    return n


def reduce_hist(hist: torch.Tensor, axis_name: Optional[str] = None
                ) -> torch.Tensor:
    """Cross-device histogram reduction: the serial no-op."""
    if axis_name is not None:
        log.fatal("distributed histogram reduction is not ported yet")
    return hist


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def bins_to_words(bins_rows: torch.Tensor) -> torch.Tensor:
    """u8 [n, F] row-major bins -> i32 [n, ceil(F/4)] word view (each word
    packs 4 bin bytes little-endian).  Tree-invariant."""
    n, num_f = bins_rows.shape
    pad = (-num_f) % 4
    if pad:
        bins_rows = torch.cat([bins_rows, bins_rows.new_zeros(n, pad)], 1)
    return bins_rows.contiguous().view(torch.int32)


def histogram_for_leaves_masked(bins_t: torch.Tensor, grad: torch.Tensor,
                                hess: torch.Tensor,
                                leaf_of_row: torch.Tensor,
                                leaves: torch.Tensor,
                                row_mask: Optional[torch.Tensor] = None, *,
                                n_bins: int = 256,
                                hist_dtype: str = "float32",
                                hist_kernel: str = "onehot") -> torch.Tensor:
    """Histograms of K leaves in ONE data pass -> f32 [K, F, B, 4] (the flat
    one-hot branch).  ``row_mask`` (bool [n]) excludes rows."""
    resolve_hist_kernel(hist_kernel)
    lor = leaf_of_row.to(torch.int32)
    if row_mask is not None:
        lor = torch.where(row_mask, lor, torch.full_like(lor, -1))
    return histogram_leaves(bins_t, grad, hess, lor,
                            leaves.to(torch.int32), n_bins=n_bins,
                            hist_dtype=hist_dtype)


def root_histogram(bins_t: torch.Tensor, grad: torch.Tensor,
                   hess: torch.Tensor,
                   row_mask: Optional[torch.Tensor] = None, *,
                   n_bins: int = 256, hist_dtype: str = "float32",
                   hist_kernel: str = "onehot") -> torch.Tensor:
    """Root histogram f32 [F, B, 4]: the K=1 masked pass over leaf 0."""
    lor = torch.zeros(grad.shape, dtype=torch.int32, device=grad.device)
    leaves = torch.zeros(1, dtype=torch.int32, device=grad.device)
    return histogram_for_leaves_masked(
        bins_t, grad, hess, lor, leaves, row_mask, n_bins=n_bins,
        hist_dtype=hist_dtype, hist_kernel=hist_kernel)[0]


def histogram_for_leaves_auto(bins_t: torch.Tensor, grad: torch.Tensor,
                              hess: torch.Tensor, leaf_of_row: torch.Tensor,
                              leaves: torch.Tensor,
                              row_mask: Optional[torch.Tensor] = None, *,
                              n_bins: int = 256, rows_per_block: int = 2048,
                              hist_dtype: str = "float32",
                              buckets: Sequence[int] = (4, 8, 16, 64),
                              counts: Optional[torch.Tensor] = None,
                              bins_words: Optional[torch.Tensor] = None,
                              sort_key: Optional[torch.Tensor] = None,
                              hist_kernel: str = "onehot",
                              payload: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """K-leaf histograms with frontier compaction -> f32 [K, F, B, 4].

    When the rows of ``leaves`` fit a bucket of n/4, n/8, n/16 or n/64 rows
    (rounded up to ``min(rows_per_block, 2048)``), they are compacted — the
    first ``cnt`` entries of the sorted ``row | 2^30`` keys are exactly the
    selected rows in order — and one gather of the payload feeds the
    payload kernel; otherwise one full masked pass runs.  Exact either way.

    ``counts`` (f32 [K]): the caller's masked row count per slot;
    ``bins_words``: ``bins_to_words`` of the row-major bins, hoisted by the
    caller; ``sort_key``/``payload``: the keys and payload the fused
    partition kernel already emitted (ops/round_fuse.py).
    """
    resolve_hist_kernel(hist_kernel)
    n = grad.shape[0]
    dev = grad.device
    leaves = leaves.to(torch.int32)
    lor = leaf_of_row.to(torch.int32)
    if row_mask is not None:
        lor = torch.where(row_mask, lor, torch.full_like(lor, -1))
    if n >= (1 << 30):
        log.fatal("compaction packing needs n < 2^30 rows")
    num_f = bins_t.shape[0]
    sel = None
    if counts is not None:
        cnt = counts.sum().to(torch.int32)
    else:
        sel = (lor[None, :] == leaves[:, None]).any(0)
        cnt = sel.sum().to(torch.int32)

    blk = min(rows_per_block, 2048)
    sizes = []
    for d in buckets:
        s = _round_up(max(n // d, 1), blk)
        if s < n and s not in sizes:
            sizes.append(s)
    # the JAX package picks the branch on the device (lax.switch); here it is
    # a host branch, so this .item() is the one host sync of a round
    c = int(cnt.item())
    S = 0
    for s in sizes:  # descending: the smallest bucket that fits wins
        if c <= s:
            S = s
    if S == 0:
        return histogram_for_leaves_masked(
            bins_t, grad, hess, lor, leaves, None, n_bins=n_bins,
            hist_dtype=hist_dtype, hist_kernel=hist_kernel)
    if sort_key is None:
        if sel is None:
            sel = (lor[None, :] == leaves[:, None]).any(0)
        rows = torch.arange(n, dtype=torch.int32, device=dev)
        sort_key = torch.where(sel, rows, rows | (1 << 30))
    if payload is None:
        if bins_words is None:
            bins_words = bins_to_words(bins_t.t())
        payload = torch.cat([bins_words,
                             grad.contiguous().view(torch.int32)[:, None],
                             hess.contiguous().view(torch.int32)[:, None],
                             lor[:, None]], dim=1)
    idxc = torch.sort(sort_key).values[:S] & ((1 << 30) - 1)
    pc = payload[idxc.long()]                                   # [S, W+3]
    return histogram_payload(pc, leaves, cnt.reshape(1), num_f=num_f,
                             n_bins=n_bins, hist_dtype=hist_dtype)
