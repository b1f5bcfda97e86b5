"""Masked K-leaf histogram kernels and their plain PyTorch versions.

Counterpart of ``lightgbm_tpu/ops/hist_pallas.py`` for the two kernels the
``hist_kernel=onehot`` training path runs:

* :func:`histogram_leaves` — the masked K-leaf (grad, hess, count)
  histogram from the transposed bin matrix, replacing
  ``_histogram_leaves_impl`` (``histogram_leaves_pallas``);
* :func:`histogram_payload` — the same histogram straight from the
  compacted i32 payload, replacing ``histogram_payload_pallas``.

Both return f32 [K, F, B, 4] (channel 3 zero; a slot repeating an earlier
slot's leaf gets a copy).  On CUDA tensors they launch ``csrc/hist.cu``;
on CPU tensors they run the plain versions.  ``hist_dtype`` picks the
arithmetic: ``int8`` (integer gradient levels, exact int32 sums),
``float32``, or ``bfloat16`` (values rounded to bf16, f32 sums).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils import log
from . import cuda_lib

#: CUDA launches of each kernel in this process (read by chip_smoke.py)
leaves_launches = 0
payload_launches = 0

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
