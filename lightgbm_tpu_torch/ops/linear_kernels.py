"""The linear-tree kernels: each leaf's normal equations and the linear
leaf scores.

:func:`normal_equations` and :func:`leaf_scores` are the two row passes of
``lightgbm_tpu/learner/linear.py`` (``fit_linear_leaves``'s blockwise
one-hot contraction and ``linear_leaf_scores``; XLA there, no
``pallas_call``).  On a CUDA tensor each launches its entry of
csrc/linear.cu, one launch a call (``normal_launches`` /
``score_launches``); on a CPU tensor it runs its plain version
(:func:`normal_equations_plain`, :func:`leaf_scores_plain`).

A leaf's linear model reads the raw values of at most 16 numeric path
features; ``feat`` i32/i64 [L, Kf] lists them in increasing order, the
number of features F where a leaf has fewer (learner/linear.py
``leaf_features``).  A row whose values of its leaf's features hold a NaN
leaves the fit (weight 0) and scores the plain leaf value.

The scores kernel adds the products in the plain version's order, so the
two give the same bits.  The normal equations kernel sums each leaf's rows
in 2,048-row chunks and the chunks in order, the plain version in one
scatter-add pass: they agree to float32 rounding, not bit for bit; each is
the same every call on the card (no float atomics in the kernel).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import log
from . import cuda_lib

#: launches of csrc/linear.cu's kernels in this process (chip_smoke.py
#: resets and reads them)
normal_launches = 0
score_launches = 0

#: rows a block of the normal-equations kernel sums (csrc/linear.cu kChunk)
CHUNK = 2048
#: the most features a leaf's linear model takes
MAX_FEATURES = 16


def _rows_x(raw: torch.Tensor, lor: torch.Tensor,
            feat: torch.Tensor) -> torch.Tensor:
    """f32 [n, Kf]: each row's raw values of its leaf's features (0 at the
    pad index F)."""
    n, F = raw.shape
    raw_pad = torch.cat([raw, torch.zeros(n, 1, dtype=raw.dtype,
                                          device=raw.device)], 1)
    return raw_pad.gather(1, feat.long()[lor.long()])


def normal_equations_plain(raw: torch.Tensor, lor: torch.Tensor,
                           feat: torch.Tensor, grad: torch.Tensor,
                           hess: torch.Tensor,
                           row_mask: Optional[torch.Tensor],
                           block: int = 1 << 16
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """:func:`normal_equations`'s plain version: x = [values | 1], the
    weight 0 for a row with a NaN value (or out of ``row_mask``), and per
    leaf sum h w x x^T, sum g w x, sum w by scatter-adds over blocks of
    ``block`` rows (in row order on the CPU); the products rounded as the
    JAX package rounds them, (x_i x_j) (h w); in ``raw``'s type (float64
    inputs give a float64 reference)."""
    n = raw.shape[0]
    L, Kf = feat.shape
    D = Kf + 1
    dev, dt = raw.device, raw.dtype
    xthx = torch.zeros(L, D * D, dtype=dt, device=dev)
    xtg = torch.zeros(L, D, dtype=dt, device=dev)
    cnt = torch.zeros(L, dtype=dt, device=dev)
    for r0 in range(0, n, block):
        sl = slice(r0, min(n, r0 + block))
        lr = lor[sl].long()
        x = _rows_x(raw[sl], lr, feat)
        w = (~torch.isnan(x).any(1)).to(dt)
        if row_mask is not None:
            w = w * row_mask[sl].to(dt)
        xx = torch.cat([torch.nan_to_num(x, nan=0.0),
                        torch.ones_like(x[:, :1])], 1)
        gb = grad[sl] * w
        hb = hess[sl] * w
        outer = (xx[:, :, None] * xx[:, None, :]) * hb[:, None, None]
        xthx.index_add_(0, lr, outer.reshape(-1, D * D))
        xtg.index_add_(0, lr, xx * gb[:, None])
        cnt.index_add_(0, lr, w)
    return xthx.reshape(L, D, D), xtg, cnt


def normal_equations(raw: torch.Tensor, lor: torch.Tensor,
                     feat: torch.Tensor, grad: torch.Tensor,
                     hess: torch.Tensor, row_mask: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every leaf's normal equations of its ridge model: (XtHX f32
    [L, D, D], Xtg f32 [L, D], usable rows f32 [L]), D = Kf + 1.  ``raw``
    f32 [n, F] (NaN kept), ``lor`` int [n] leaf ids in [0, L), ``feat``
    int [L, Kf] (F: no feature), ``grad``/``hess`` f32 [n], ``row_mask``
    bool [n] or None.  One launch of csrc/linear.cu's ``lgbt_linear_normal``
    on CUDA tensors (after a stable sort of the rows by leaf and their
    per-leaf runs, device operations with no host read), the plain version
    on CPU tensors."""
    if not raw.is_cuda:
        return normal_equations_plain(raw, lor, feat, grad, hess, row_mask)
    global normal_launches
    n, F = raw.shape
    L, Kf = feat.shape
    D = Kf + 1
    if (raw.dtype != torch.float32 or raw.stride(1) != 1 or D > 17
            or grad.dtype != torch.float32 or hess.dtype != torch.float32):
        log.fatal("linear normal equations take f32 raw [n, F] (rows "
                  "contiguous), at most 16 features a leaf and f32 grad / "
                  "hess")
    dev = raw.device
    lr = lor.long()
    order = torch.sort(lr, stable=True).indices.to(torch.int32)
    lengths = torch.zeros(L, dtype=torch.int64, device=dev).index_add_(
        0, lr, torch.ones_like(lr))
    seg_start = torch.cumsum(lengths, 0) - lengths
    nchunks = (lengths + CHUNK - 1) // CHUNK
    chunk_start = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                             torch.cumsum(nchunks, 0)]).to(torch.int32)
    E = D * (D + 1) // 2 + D + 1
    grid = (n + CHUNK - 1) // CHUNK + L
    partial = torch.empty(grid, E, dtype=torch.float32, device=dev)
    done = torch.zeros(L, dtype=torch.int32, device=dev)
    xthx = torch.zeros(L, D, D, dtype=torch.float32, device=dev)
    xtg = torch.zeros(L, D, dtype=torch.float32, device=dev)
    cnt = torch.zeros(L, dtype=torch.float32, device=dev)
    feat32 = feat.to(torch.int32).contiguous()
    g, h = grad.contiguous(), hess.contiguous()
    mask = None if row_mask is None else \
        row_mask.to(torch.uint8).contiguous()
    code = cuda_lib.load("linear").lgbt_linear_normal(
        raw.data_ptr(), raw.stride(0), F, n, order.data_ptr(),
        seg_start.data_ptr(), lengths.data_ptr(), chunk_start.data_ptr(), L,
        feat32.data_ptr(), Kf, g.data_ptr(), h.data_ptr(),
        0 if mask is None else mask.data_ptr(), partial.data_ptr(), grid,
        done.data_ptr(), xthx.data_ptr(), xtg.data_ptr(), cnt.data_ptr(),
        cuda_lib.stream_handle(raw))
    if code:
        cuda_lib.check(code, "linear normal equations")
    normal_launches += 1
    return xthx, xtg, cnt


def leaf_scores_plain(raw: torch.Tensor, lor: torch.Tensor,
                      feat: torch.Tensor, coef: torch.Tensor,
                      const: torch.Tensor,
                      leaf_value: torch.Tensor) -> torch.Tensor:
    """:func:`leaf_scores`'s plain version: the used products (nonzero
    coefficients) added one feature after another in the leaf's order,
    then the constant."""
    lr = lor.long()
    x = _rows_x(raw, lr, feat)
    c = coef[lr]
    use = c != 0.0
    bad = (torch.isnan(x) & use).any(1)
    xv = torch.nan_to_num(x, nan=0.0)
    acc = torch.zeros(raw.shape[0], dtype=torch.float32, device=raw.device)
    zero = torch.zeros((), dtype=torch.float32, device=raw.device)
    for j in range(feat.shape[1]):
        acc = acc + torch.where(use[:, j], c[:, j] * xv[:, j], zero)
    return torch.where(bad, leaf_value[lr], acc + const[lr])


def leaf_scores(raw: torch.Tensor, lor: torch.Tensor, feat: torch.Tensor,
                coef: torch.Tensor, const: torch.Tensor,
                leaf_value: torch.Tensor) -> torch.Tensor:
    """f32 [n]: each row's linear leaf output, ``const[l] + coef[l] . x``
    over the leaf's features with a nonzero coefficient (``feat`` / ``coef``
    [L, Kf], ``const`` / ``leaf_value`` f32 [L], ``lor`` the rows' leaves);
    ``leaf_value[l]`` where one of those values is NaN.  One launch of
    csrc/linear.cu's ``lgbt_linear_scores`` on CUDA tensors, the plain
    version on CPU tensors; the same bits."""
    if not raw.is_cuda:
        return leaf_scores_plain(raw, lor, feat, coef, const, leaf_value)
    global score_launches
    n = raw.shape[0]
    L, Kf = feat.shape
    if raw.dtype != torch.float32 or raw.stride(1) != 1:
        log.fatal("linear leaf scores take f32 raw [n, F] (rows contiguous)")
    lor32 = lor.to(torch.int32).contiguous()
    feat32 = feat.to(torch.int32).contiguous()
    coef32 = coef.to(torch.float32).contiguous()
    cst = const.to(torch.float32).contiguous()
    lv = leaf_value.to(torch.float32).contiguous()
    out = torch.empty(n, dtype=torch.float32, device=raw.device)
    code = cuda_lib.load("linear").lgbt_linear_scores(
        raw.data_ptr(), raw.stride(0), lor32.data_ptr(), n,
        feat32.data_ptr(), coef32.data_ptr(), Kf, cst.data_ptr(),
        lv.data_ptr(), out.data_ptr(), cuda_lib.stream_handle(raw))
    if code:
        cuda_lib.check(code, "linear leaf scores")
    score_launches += 1
    return out
