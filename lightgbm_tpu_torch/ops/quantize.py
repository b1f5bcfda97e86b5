"""Gradient quantization (``use_quantized_grad``).

Counterpart of ``lightgbm_tpu/ops/quantize.py`` (reference
src/treelearner/gradient_discretizer.cpp ``DiscretizeGradients``).  Gradients
become INTEGER LEVELS carried in f32 (grad in [-levels/2, levels/2], hess in
[0, levels]) with power-of-two per-tree scales, so histogram sums of levels
are exact in any summation order and one scale multiply restores real units.
``renew_leaf_values`` recomputes leaf outputs from the true gradients
(reference ``RenewIntGradTreeOutput``).

Stochastic rounding draws its uniforms from ops/prng.py, the threefry bits
of ``jax.random``, so a seed rounds every gradient as the JAX package does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import prng


def _pow2_ceil(x: torch.Tensor) -> torch.Tensor:
    """Smallest power of two >= x (positive finite x), as
    ``exp2(ceil(log2(x)))`` in f32 like the JAX package."""
    return torch.exp2(torch.ceil(torch.log2(x)))


def discretize_gradients_levels(grad: torch.Tensor, hess: torch.Tensor,
                                key: Optional[prng.Key] = None, *,
                                n_levels: int = 4, stochastic: bool = False,
                                constant_hessian: bool = False
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor, torch.Tensor]:
    """(g_levels, h_levels, g_scale, h_scale) with real ~= level * scale.

    ``stochastic`` rounds ``floor(x / scale + u)`` with ``u`` uniform from
    the two halves of ``split(key)`` (grad, hess), the JAX package's draw."""
    max_g = grad.abs().max()
    max_h = hess.abs().max()
    tiny = torch.tensor(1e-20, dtype=torch.float32, device=grad.device)
    g_scale = _pow2_ceil(torch.maximum(max_g / (n_levels // 2), tiny))
    h_scale = _pow2_ceil(torch.maximum(
        max_h if constant_hessian else max_h / n_levels, tiny))
    if stochastic:
        kg, kh = prng.split(key)
        n = grad.shape[0]
        return (torch.floor(grad / g_scale + prng.uniform(kg, n, grad.device)),
                torch.floor(hess / h_scale + prng.uniform(kh, n, hess.device)),
                g_scale, h_scale)
    return (torch.round(grad / g_scale), torch.round(hess / h_scale),
            g_scale, h_scale)


def renew_leaf_values(leaf_of_row: torch.Tensor, grad: torch.Tensor,
                      hess: torch.Tensor, row_mask: Optional[torch.Tensor],
                      num_leaves: int, lambda_l1: float,
                      lambda_l2: float) -> torch.Tensor:
    """Exact leaf outputs from TRUE gradients:
    out[l] = -T(sum g_l) / (sum h_l + l2) with the L1 soft-threshold T.

    On the CPU the sums scatter in row order (the order of the JAX
    package's scatter-add there).  On the card a float scatter-add sums in
    the atomics' order, which changes from run to run; there the rows are
    stably sorted by leaf and each leaf's run is reduced as one segment, an
    order fixed by the data alone, so two trainings give the same leaves."""
    L = num_leaves
    lor = leaf_of_row.long()
    zero = torch.zeros((), dtype=grad.dtype, device=grad.device)
    if row_mask is None:
        gm, hm = grad, hess
    else:
        gm = torch.where(row_mask, grad, zero)
        hm = torch.where(row_mask, hess, zero)
    if grad.is_cuda:
        gsum, hsum = leaf_sums_sorted(lor, gm, hm, L)
    else:
        gsum = torch.zeros(L, dtype=grad.dtype, device=grad.device) \
            .index_add_(0, lor, gm)
        hsum = torch.zeros(L, dtype=hess.dtype, device=hess.device) \
            .index_add_(0, lor, hm)
    t = torch.sign(gsum) * torch.clamp(gsum.abs() - lambda_l1, min=0.0)
    return -t / (hsum + lambda_l2 + 1e-15)


def leaf_sums_sorted(lor: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                     num_leaves: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-leaf sums of ``g`` and ``h`` in an order fixed by the data: a
    stable sort of the rows by leaf, then one segment reduction per leaf
    (no float atomics).  ``lor``: int64 leaf of each row, in
    [0, num_leaves).  No host sync: the segment lengths are an integer
    scatter-add (exact in any order; ``bincount`` would read the max back),
    and they are valid by construction, so ``segment_reduce`` skips its
    checks (``unsafe``), which would read them back too."""
    order = torch.sort(lor, stable=True).indices
    lengths = torch.zeros(num_leaves, dtype=torch.int64, device=lor.device) \
        .index_add_(0, lor, torch.ones_like(lor))

    def seg(v):
        return torch.segment_reduce(v[order], "sum", lengths=lengths,
                                    unsafe=True, initial=0.0)

    return seg(g), seg(h)
