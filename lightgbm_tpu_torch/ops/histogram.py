"""Gradient/hessian histogram construction (dispatch layer).

Counterpart of ``lightgbm_tpu/ops/histogram.py``.  ``hist_kernel`` picks
the masked-pass kernel exactly as the JAX package's dispatch does (the
rules below are copied, not imported):

* ``auto`` (the default): at a bin count that is a multiple of 16 and
  >= 128, the root pass takes ``histogram_radix_single``, a masked pass of
  K <= 4 leaves ``histogram_radix_joint`` and a wider one
  ``histogram_leaves_radix2``; below 128 bins every masked pass, the root
  included, takes ``histogram_leaves_packed`` over the resident packed
  mirror;
* ``onehot``: the flat ``histogram_leaves`` everywhere;
* ``packed`` / ``radix2``: their kernel where its shape rules hold, flat
  otherwise.

All kernels compute the same histogram (bitwise in int8 mode).  A round
whose selected rows fit a bucket compacts them (sort on the packed
``row | 2^30`` key + one row gather of the i32 payload) and runs the
payload kernel on the bucket instead of a masked pass.

The JAX package's perf A/B environment hatches (``LGBMTPU_NO_RADIX``,
``LGBMTPU_NO_RADIX2``, ``LGBMTPU_NO_PACKED``) are not ported: dispatch
behaves as if they were unset.  Not ported either: the distributed
all-reduce (``reduce_hist`` is the serial no-op).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..utils import log
from .hist_kernels import (RADIX_JOINT_MAX_LEAVES, histogram_leaves,
                           histogram_leaves_packed, histogram_leaves_radix2,
                           histogram_payload, histogram_radix_joint,
                           histogram_radix_single)

NUM_CHANNELS = 4  # grad, hess, count, pad

HIST_KERNELS = ("auto", "onehot", "packed", "radix2")

#: accumulator budget of the TPU radix2 kernel; it decides dispatch only
#: (``radix2_pick_p``), so the port keeps the JAX package's rule
_RADIX2_ACC_BYTES = 8 << 20


def resolve_hist_kernel(name) -> str:
    """Validate a ``hist_kernel`` value; LightGBMError names the key."""
    n = str(name or "auto").strip().lower()
    if n not in HIST_KERNELS:
        log.fatal("unknown hist_kernel=%r (expected one of %s)"
                  % (name, "/".join(HIST_KERNELS)))
    return n


def _radix_ok(n_bins: int) -> bool:
    """The radix kernels take a bin count that is a multiple of 16, and
    ``auto`` uses them from 128 bins up."""
    return n_bins % 16 == 0 and n_bins >= 128


def radix2_pick_p(num_f: int, K: int, n_bins: int) -> int:
    """The TPU radix2 kernel's feature group width: the largest p in (4, 2)
    whose accumulator fits ``_RADIX2_ACC_BYTES``; 0 = does not fit (the
    pass falls back to the flat kernel)."""
    for p in (4, 2):
        f_pad = _round_up(num_f, p)
        if 3 * K * f_pad * n_bins * p * 4 <= _RADIX2_ACC_BYTES:
            return p
    return 0


def wants_packed_mirror(hist_kernel, n_bins: int) -> bool:
    """True when the masked passes may take the packed kernel: the
    callers' cue to keep the transposed word mirror resident."""
    hk = resolve_hist_kernel(hist_kernel)
    if hk == "packed":
        return True
    return hk == "auto" and not _radix_ok(n_bins)


def ladder_profitable(hist_kernel, n_bins: int) -> bool:
    """True when the grower's width-quadrupling warm-up ladder runs: only
    where a K <= 4 masked pass takes the radix-joint kernel (``auto`` at
    >= 128 bins).  The ladder never changes the tree (each width covers
    the frontier); it only changes which kernels build it."""
    return resolve_hist_kernel(hist_kernel) == "auto" and _radix_ok(n_bins)


def _masked_kernel_for(hk: str, n_bins: int, K: int, num_f: int,
                       have_words: bool) -> str:
    """The masked-pass kernel of a mode: flat / packed / radix2 /
    radix_joint (the JAX package's rule)."""
    radix2_fits = (n_bins % 16 == 0 and n_bins >= 16
                   and radix2_pick_p(num_f, K, n_bins) > 0)
    if hk == "packed":
        return "packed" if have_words else "flat"
    if hk == "radix2":
        return "radix2" if radix2_fits else "flat"
    if hk == "auto":
        if _radix_ok(n_bins):
            if K <= RADIX_JOINT_MAX_LEAVES:
                return "radix_joint"
            if radix2_fits:
                return "radix2"
        elif have_words:
            return "packed"
    return "flat"


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
                                hist_kernel: str = "auto",
                                bins_words_t: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Histograms of K leaves in ONE data pass -> f32 [K, F, B, 4].
    ``row_mask`` (bool [n]) excludes rows; ``bins_words_t`` is the
    resident transposed packed mirror [W, n] the packed kernel reads."""
    hk = resolve_hist_kernel(hist_kernel)
    num_f = bins_t.shape[0]
    leaves = leaves.to(torch.int32)
    lor = leaf_of_row.to(torch.int32)
    if row_mask is not None:
        lor = torch.where(row_mask, lor, torch.full_like(lor, -1))
    kern = _masked_kernel_for(hk, n_bins, leaves.shape[0], num_f,
                              bins_words_t is not None)
    kw = dict(n_bins=n_bins, hist_dtype=hist_dtype)
    if kern == "radix_joint":
        return histogram_radix_joint(bins_t, grad, hess, lor, leaves, **kw)
    if kern == "radix2":
        return histogram_leaves_radix2(bins_t, grad, hess, lor, leaves, **kw)
    if kern == "packed":
        return histogram_leaves_packed(bins_words_t, grad, hess, lor, leaves,
                                       num_f=num_f, **kw)
    return histogram_leaves(bins_t, grad, hess, lor, leaves, **kw)


def root_histogram(bins_t: torch.Tensor, grad: torch.Tensor,
                   hess: torch.Tensor,
                   row_mask: Optional[torch.Tensor] = None, *,
                   n_bins: int = 256, hist_dtype: str = "float32",
                   hist_kernel: str = "auto",
                   bins_words_t: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Root histogram f32 [F, B, 4]: the single-leaf masked pass over leaf
    0, which under ``auto`` at >= 128 bins is the radix-single kernel."""
    hk = resolve_hist_kernel(hist_kernel)
    lor = torch.zeros(grad.shape, dtype=torch.int32, device=grad.device)
    if row_mask is not None:
        lor = torch.where(row_mask, lor, torch.full_like(lor, -1))
    if hk == "auto" and _radix_ok(n_bins):
        return histogram_radix_single(bins_t, grad, hess, lor,
                                      n_bins=n_bins, hist_dtype=hist_dtype)
    leaves = torch.zeros(1, dtype=torch.int32, device=grad.device)
    return histogram_for_leaves_masked(
        bins_t, grad, hess, lor, leaves, None, n_bins=n_bins,
        hist_dtype=hist_dtype, hist_kernel=hk, bins_words_t=bins_words_t)[0]


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
                              hist_kernel: str = "auto",
                              payload: Optional[torch.Tensor] = None,
                              bins_words_t: Optional[torch.Tensor] = None
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
    partition kernel already emitted (ops/round_fuse.py);
    ``hist_kernel``/``bins_words_t``: the full pass's kernel choice and
    packed mirror (``histogram_for_leaves_masked``).
    """
    hist_kernel = resolve_hist_kernel(hist_kernel)
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
            hist_dtype=hist_dtype, hist_kernel=hist_kernel,
            bins_words_t=bins_words_t)
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
