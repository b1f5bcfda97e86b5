"""Masked K-leaf histogram kernels and their plain PyTorch versions.

Counterpart of ``lightgbm_tpu/ops/hist_pallas.py``, one wrapper per TPU
kernel:

* :func:`histogram_leaves` — the masked K-leaf (grad, hess, count)
  histogram from the transposed bin matrix, replacing
  ``_histogram_leaves_impl`` (``histogram_leaves_pallas``), csrc/hist.cu;
* :func:`histogram_payload` — the same histogram straight from the
  compacted i32 payload, replacing ``histogram_payload_pallas``,
  csrc/hist.cu;
* :func:`histogram_radix_single` — the root pass (rows with leaf < 0
  excluded), replacing ``histogram_radix_single_pallas``, csrc/radix.cu;
* :func:`histogram_radix_joint` — the masked pass of G <= 4 leaves,
  replacing ``histogram_radix_joint_pallas``, csrc/radix.cu;
* :func:`histogram_leaves_radix2` — the masked pass of K leaves at a bin
  count that is a multiple of 16, replacing
  ``histogram_leaves_radix2_pallas``, csrc/radix.cu;
* :func:`histogram_leaves_packed` — the masked pass from the transposed
  packed word mirror, replacing ``histogram_leaves_packed_pallas``,
  csrc/packed.cu.

Each returns f32 [K, F, B, 4] ([F, B, 4] for the root pass; channel 3
zero; a slot repeating an earlier slot's leaf gets a copy).  On CUDA
tensors a wrapper launches its kernel (or raises); on CPU tensors it runs
its plain version.  ``hist_dtype`` picks the arithmetic: ``int8`` (integer
gradient levels, exact int32 sums), ``float32``, or ``bfloat16`` (values
rounded to bf16, f32 sums).  The radix and packed kernels compute what the
TPU kernels compute, not their nibble or SWAR formulation, so their plain
versions are the flat histogram's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils import log
from . import cuda_lib

#: CUDA launches of each kernel in this process (read by chip_smoke.py)
leaves_launches = 0
payload_launches = 0
radix_single_launches = 0
radix_joint_launches = 0
radix2_launches = 0
packed_launches = 0

_MODES = {"int8": 0, "float32": 1, "bfloat16": 2}


def _mode(hist_dtype: str) -> int:
    m = _MODES.get(str(hist_dtype))
    if m is None:
        log.fatal(f"hist_dtype={hist_dtype!r} is not supported by the "
                  f"histogram kernels (expected one of {sorted(_MODES)})")
    return m


def _hist_plain(bin_of: Callable[[int], torch.Tensor], num_f: int,
                grad: torch.Tensor, hess: torch.Tensor, lor: torch.Tensor,
                row_ok: Optional[torch.Tensor], leaves: torch.Tensor,
                n_bins: int, hist_dtype: str) -> torch.Tensor:
    """The arithmetic both kernels share, one feature at a time:
    each selected row adds (grad, hess, 1) to the cell (first slot of its
    leaf, feature, bin); excluded rows add nothing (NaN-safe)."""
    mode = _mode(hist_dtype)
    dev = grad.device
    K = leaves.shape[0]
    if K == 0:
        return torch.zeros(0, num_f, n_bins, 4, device=dev)
    eq = lor[None, :] == leaves[:, None]                          # [K, n]
    if row_ok is not None:
        eq = eq & row_ok[None, :]
    sel = eq.any(0)
    slot = eq.to(torch.uint8).argmax(0).long()                    # first
    if mode == 0:
        def lvl(v):
            return v.to(torch.int32).to(torch.int8).to(torch.int64)
        vals = torch.stack([lvl(grad), lvl(hess),
                            torch.ones_like(lor, dtype=torch.int64)], 1)
        vals = torch.where(sel[:, None], vals, torch.zeros_like(vals))
    else:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        vals = torch.stack([torch.where(sel, grad, zero),
                            torch.where(sel, hess, zero),
                            sel.to(torch.float32)], 1)
        if mode == 2:
            vals = vals.to(torch.bfloat16).to(torch.float32)
    cells = K * num_f * n_bins
    acc = torch.zeros(cells + 1, 3, dtype=vals.dtype, device=dev)
    for f in range(num_f):
        b = bin_of(f).long()
        ok = sel & (b < n_bins)
        idx = torch.where(ok, (slot * num_f + f) * n_bins + b,
                          torch.full_like(b, cells))           # trash row
        acc.index_add_(0, idx, vals)
    out = torch.zeros(K, num_f, n_bins, 4, dtype=torch.float32, device=dev)
    out[..., :3] = acc[:cells].reshape(K, num_f, n_bins, 3).to(torch.float32)
    first = (leaves[:, None] == leaves[None, :]).to(torch.uint8).argmax(1)
    return out[first]


def histogram_leaves_plain(bins_t: torch.Tensor, grad: torch.Tensor,
                           hess: torch.Tensor, leaf_of_row: torch.Tensor,
                           leaves: torch.Tensor, *, n_bins: int,
                           hist_dtype: str = "float32") -> torch.Tensor:
    """Plain version of :func:`histogram_leaves`."""
    return _hist_plain(lambda f: bins_t[f], bins_t.shape[0], grad, hess,
                       leaf_of_row, None, leaves, n_bins, hist_dtype)


def histogram_leaves(bins_t: torch.Tensor, grad: torch.Tensor,
                     hess: torch.Tensor, leaf_of_row: torch.Tensor,
                     leaves: torch.Tensor, *, n_bins: int,
                     hist_dtype: str = "float32") -> torch.Tensor:
    """Masked multi-leaf histogram f32 [K, F, n_bins, 4].

    bins_t: u8 [F, n] (transposed, the resident training layout);
    grad/hess: f32 [n]; leaf_of_row: i32 [n] (rows whose leaf is not in
    ``leaves`` are excluded, e.g. -1 for rows out of the bag); leaves: i32
    [K] (dummy slots may repeat a leaf).
    """
    if not bins_t.is_cuda:
        return histogram_leaves_plain(bins_t, grad, hess, leaf_of_row,
                                      leaves, n_bins=n_bins,
                                      hist_dtype=hist_dtype)
    global leaves_launches
    mode = _mode(hist_dtype)
    num_f, n = bins_t.shape
    K = leaves.shape[0]
    dev = bins_t.device
    if (bins_t.dtype != torch.uint8 or grad.dtype != torch.float32
            or hess.dtype != torch.float32
            or leaf_of_row.dtype != torch.int32
            or leaves.dtype != torch.int32):
        log.fatal("histogram_leaves kernel takes u8 bins, f32 grad/hess, "
                  "i32 leaf ids")
    if grad.shape != (n,) or hess.shape != (n,) or leaf_of_row.shape != (n,):
        log.fatal("histogram_leaves: grad/hess/leaf_of_row must be [n]")
    if any(t.device != dev for t in (grad, hess, leaf_of_row, leaves)):
        log.fatal("histogram_leaves: all operands must be on one device")
    if not 1 <= n_bins <= 256:
        log.fatal(f"histogram_leaves: n_bins={n_bins} outside [1, 256]")
    bins_t, grad, hess = (t.contiguous() for t in (bins_t, grad, hess))
    leaf_of_row, leaves = leaf_of_row.contiguous(), leaves.contiguous()
    scratch = torch.zeros(K * num_f * n_bins * 3, device=dev,
                          dtype=torch.int32 if mode == 0 else torch.float32)
    out = torch.empty(K, num_f, n_bins, 4, dtype=torch.float32, device=dev)
    lib = cuda_lib.load("hist")
    code = lib.lgbt_hist_leaves(
        bins_t.data_ptr(), n, num_f, grad.data_ptr(), hess.data_ptr(),
        leaf_of_row.data_ptr(), leaves.data_ptr(), K, n_bins, mode,
        scratch.data_ptr(), out.data_ptr(), cuda_lib.stream_handle(bins_t))
    cuda_lib.check(code, "histogram_leaves")
    leaves_launches += 1
    return out


def histogram_payload_plain(payload: torch.Tensor, leaves: torch.Tensor,
                            cnt: torch.Tensor, *, num_f: int, n_bins: int,
                            hist_dtype: str = "float32") -> torch.Tensor:
    """Plain version of :func:`histogram_payload`."""
    S, wp3 = payload.shape
    W = wp3 - 3
    pos_ok = torch.arange(S, device=payload.device) < cnt.reshape(())
    g = payload[:, W].contiguous().view(torch.float32)
    h = payload[:, W + 1].contiguous().view(torch.float32)

    def bin_of(f):
        return (payload[:, f // 4] >> (8 * (f % 4))) & 255

    return _hist_plain(bin_of, num_f, g, h, payload[:, W + 2], pos_ok,
                       leaves, n_bins, hist_dtype)


def histogram_payload(payload: torch.Tensor, leaves: torch.Tensor,
                      cnt: torch.Tensor, *, num_f: int, n_bins: int,
                      hist_dtype: str = "float32") -> torch.Tensor:
    """Masked multi-leaf histogram f32 [K, num_f, n_bins, 4] from the
    compaction payload i32 [S, W+3] (per row: W words of 4 little-endian
    bin bytes, grad bits, hess bits, leaf id).  Rows at positions >=
    ``cnt`` (i32 [1], read on the device: no host sync) are excluded."""
    if not payload.is_cuda:
        return histogram_payload_plain(payload, leaves, cnt, num_f=num_f,
                                       n_bins=n_bins, hist_dtype=hist_dtype)
    global payload_launches
    mode = _mode(hist_dtype)
    S, wp3 = payload.shape
    W = wp3 - 3
    K = leaves.shape[0]
    dev = payload.device
    if (payload.dtype != torch.int32 or leaves.dtype != torch.int32
            or cnt.dtype != torch.int32 or cnt.numel() != 1):
        log.fatal("histogram_payload kernel takes an i32 payload, i32 leaf "
                  "ids and an i32 [1] row count")
    if W < 1 or 4 * W < num_f:
        log.fatal(f"histogram_payload: payload width {wp3} cannot hold "
                  f"{num_f} features")
    if leaves.device != dev or cnt.device != dev:
        log.fatal("histogram_payload: all operands must be on one device")
    if not 1 <= n_bins <= 256:
        log.fatal(f"histogram_payload: n_bins={n_bins} outside [1, 256]")
    payload, leaves, cnt = (t.contiguous() for t in (payload, leaves, cnt))
    scratch = torch.zeros(K * num_f * n_bins * 3, device=dev,
                          dtype=torch.int32 if mode == 0 else torch.float32)
    out = torch.empty(K, num_f, n_bins, 4, dtype=torch.float32, device=dev)
    lib = cuda_lib.load("hist")
    code = lib.lgbt_hist_payload(
        payload.data_ptr(), S, W, num_f, leaves.data_ptr(), K,
        cnt.data_ptr(), n_bins, mode, scratch.data_ptr(), out.data_ptr(),
        cuda_lib.stream_handle(payload))
    cuda_lib.check(code, "histogram_payload")
    payload_launches += 1
    return out


def _check_pass(what: str, n: int, grad: torch.Tensor, hess: torch.Tensor,
                lor: torch.Tensor, leaves: Optional[torch.Tensor],
                n_bins: int, dev: torch.device) -> None:
    """The checks every row-pass wrapper makes before it launches."""
    if (grad.dtype != torch.float32 or hess.dtype != torch.float32
            or lor.dtype != torch.int32
            or (leaves is not None and leaves.dtype != torch.int32)):
        log.fatal(f"{what} kernel takes f32 grad/hess and i32 leaf ids")
    if grad.shape != (n,) or hess.shape != (n,) or lor.shape != (n,):
        log.fatal(f"{what}: grad/hess/leaf_of_row must be [n]")
    ops = (grad, hess, lor) + ((leaves,) if leaves is not None else ())
    if any(t.device != dev for t in ops):
        log.fatal(f"{what}: all operands must be on one device")
    if not 1 <= n_bins <= 256:
        log.fatal(f"{what}: n_bins={n_bins} outside [1, 256]")


def _buffers(K: int, num_f: int, n_bins: int, mode: int,
             dev: torch.device):
    """Zeroed global accumulator and the f32 [K, F, B, 4] output."""
    scratch = torch.zeros(K * num_f * n_bins * 3, device=dev,
                          dtype=torch.int32 if mode == 0 else torch.float32)
    out = torch.empty(K, num_f, n_bins, 4, dtype=torch.float32, device=dev)
    return scratch, out


def _c(*ts):
    return tuple(t.contiguous() for t in ts)


def histogram_radix_single_plain(bins_t: torch.Tensor, grad: torch.Tensor,
                                 hess: torch.Tensor, lor: torch.Tensor, *,
                                 n_bins: int,
                                 hist_dtype: str = "float32"
                                 ) -> torch.Tensor:
    """Plain version of :func:`histogram_radix_single`."""
    sel = torch.where(lor >= 0, 0, -1).to(torch.int32)
    leaves = torch.zeros(1, dtype=torch.int32, device=lor.device)
    return histogram_leaves_plain(bins_t, grad, hess, sel, leaves,
                                  n_bins=n_bins, hist_dtype=hist_dtype)[0]


def histogram_radix_single(bins_t: torch.Tensor, grad: torch.Tensor,
                           hess: torch.Tensor, lor: torch.Tensor, *,
                           n_bins: int,
                           hist_dtype: str = "float32") -> torch.Tensor:
    """Root-pass histogram f32 [F, n_bins, 4] over every row whose
    ``lor`` (i32 [n]) is >= 0.  bins_t: u8 [F, n]; grad/hess: f32 [n]."""
    if not bins_t.is_cuda:
        return histogram_radix_single_plain(bins_t, grad, hess, lor,
                                            n_bins=n_bins,
                                            hist_dtype=hist_dtype)
    global radix_single_launches
    mode = _mode(hist_dtype)
    num_f, n = bins_t.shape
    if bins_t.dtype != torch.uint8:
        log.fatal("histogram_radix_single kernel takes u8 bins")
    _check_pass("histogram_radix_single", n, grad, hess, lor, None, n_bins,
                bins_t.device)
    bins_t, grad, hess, lor = _c(bins_t, grad, hess, lor)
    scratch, out = _buffers(1, num_f, n_bins, mode, bins_t.device)
    code = cuda_lib.load("radix").lgbt_hist_radix_single(
        bins_t.data_ptr(), n, num_f, grad.data_ptr(), hess.data_ptr(),
        lor.data_ptr(), n_bins, mode, scratch.data_ptr(), out.data_ptr(),
        cuda_lib.stream_handle(bins_t))
    cuda_lib.check(code, "histogram_radix_single")
    radix_single_launches += 1
    return out[0]


def _radix_masked(entry: str, what: str, bins_t, grad, hess, lor, leaves,
                  n_bins, hist_dtype):
    mode = _mode(hist_dtype)
    num_f, n = bins_t.shape
    K = leaves.shape[0]
    if bins_t.dtype != torch.uint8:
        log.fatal(f"{what} kernel takes u8 bins")
    _check_pass(what, n, grad, hess, lor, leaves, n_bins, bins_t.device)
    bins_t, grad, hess, lor, leaves = _c(bins_t, grad, hess, lor, leaves)
    scratch, out = _buffers(K, num_f, n_bins, mode, bins_t.device)
    code = getattr(cuda_lib.load("radix"), entry)(
        bins_t.data_ptr(), n, num_f, grad.data_ptr(), hess.data_ptr(),
        lor.data_ptr(), leaves.data_ptr(), K, n_bins, mode,
        scratch.data_ptr(), out.data_ptr(), cuda_lib.stream_handle(bins_t))
    cuda_lib.check(code, what)
    return out


#: the joint kernel keeps its leaf ids in registers
RADIX_JOINT_MAX_LEAVES = 4

histogram_radix_joint_plain = histogram_leaves_plain
histogram_leaves_radix2_plain = histogram_leaves_plain


def histogram_radix_joint(bins_t: torch.Tensor, grad: torch.Tensor,
                          hess: torch.Tensor, leaf_of_row: torch.Tensor,
                          leaves: torch.Tensor, *, n_bins: int,
                          hist_dtype: str = "float32") -> torch.Tensor:
    """Masked histogram f32 [G, F, n_bins, 4] of G <= 4 leaves (the
    operands of :func:`histogram_leaves`)."""
    if not bins_t.is_cuda:
        return histogram_radix_joint_plain(bins_t, grad, hess, leaf_of_row,
                                           leaves, n_bins=n_bins,
                                           hist_dtype=hist_dtype)
    global radix_joint_launches
    if not 1 <= leaves.shape[0] <= RADIX_JOINT_MAX_LEAVES:
        log.fatal(f"histogram_radix_joint takes 1 to "
                  f"{RADIX_JOINT_MAX_LEAVES} leaves, got {leaves.shape[0]}")
    out = _radix_masked("lgbt_hist_radix_joint", "histogram_radix_joint",
                        bins_t, grad, hess, leaf_of_row, leaves, n_bins,
                        hist_dtype)
    radix_joint_launches += 1
    return out


def histogram_leaves_radix2(bins_t: torch.Tensor, grad: torch.Tensor,
                            hess: torch.Tensor, leaf_of_row: torch.Tensor,
                            leaves: torch.Tensor, *, n_bins: int,
                            hist_dtype: str = "float32") -> torch.Tensor:
    """Masked histogram f32 [K, F, n_bins, 4] of K leaves (the operands of
    :func:`histogram_leaves`)."""
    if not bins_t.is_cuda:
        return histogram_leaves_radix2_plain(bins_t, grad, hess, leaf_of_row,
                                             leaves, n_bins=n_bins,
                                             hist_dtype=hist_dtype)
    global radix2_launches
    out = _radix_masked("lgbt_hist_radix2", "histogram_leaves_radix2",
                        bins_t, grad, hess, leaf_of_row, leaves, n_bins,
                        hist_dtype)
    radix2_launches += 1
    return out


def histogram_leaves_packed_plain(words_t: torch.Tensor, grad: torch.Tensor,
                                  hess: torch.Tensor,
                                  leaf_of_row: torch.Tensor,
                                  leaves: torch.Tensor, *, num_f: int,
                                  n_bins: int, hist_dtype: str = "float32"
                                  ) -> torch.Tensor:
    """Plain version of :func:`histogram_leaves_packed`."""
    def bin_of(f):
        return (words_t[f // 4] >> (8 * (f % 4))) & 255

    return _hist_plain(bin_of, num_f, grad, hess, leaf_of_row, None, leaves,
                       n_bins, hist_dtype)


def histogram_leaves_packed(words_t: torch.Tensor, grad: torch.Tensor,
                            hess: torch.Tensor, leaf_of_row: torch.Tensor,
                            leaves: torch.Tensor, *, num_f: int, n_bins: int,
                            hist_dtype: str = "float32") -> torch.Tensor:
    """Masked histogram f32 [K, num_f, n_bins, 4] from the transposed
    packed mirror words_t i32 [W, n] (byte j of word w, little-endian, is
    the bin of feature 4w + j; features >= num_f are dropped)."""
    if not words_t.is_cuda:
        return histogram_leaves_packed_plain(words_t, grad, hess,
                                             leaf_of_row, leaves,
                                             num_f=num_f, n_bins=n_bins,
                                             hist_dtype=hist_dtype)
    global packed_launches
    mode = _mode(hist_dtype)
    W, n = words_t.shape
    K = leaves.shape[0]
    if words_t.dtype != torch.int32:
        log.fatal("histogram_leaves_packed kernel takes i32 words")
    if W < 1 or 4 * W < num_f:
        log.fatal(f"histogram_leaves_packed: {W} words cannot hold {num_f} "
                  f"features")
    _check_pass("histogram_leaves_packed", n, grad, hess, leaf_of_row,
                leaves, n_bins, words_t.device)
    words_t, grad, hess, leaf_of_row, leaves = _c(words_t, grad, hess,
                                                  leaf_of_row, leaves)
    scratch, out = _buffers(K, num_f, n_bins, mode, words_t.device)
    code = cuda_lib.load("packed").lgbt_hist_packed(
        words_t.data_ptr(), W, n, num_f, grad.data_ptr(), hess.data_ptr(),
        leaf_of_row.data_ptr(), leaves.data_ptr(), K, n_bins, mode,
        scratch.data_ptr(), out.data_ptr(), cuda_lib.stream_handle(words_t))
    cuda_lib.check(code, "histogram_leaves_packed")
    packed_launches += 1
    return out
