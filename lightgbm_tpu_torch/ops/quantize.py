"""Gradient quantization (``use_quantized_grad``).

Counterpart of ``lightgbm_tpu/ops/quantize.py`` (reference
src/treelearner/gradient_discretizer.cpp ``DiscretizeGradients``).  Gradients
become INTEGER LEVELS carried in f32 (grad in [-levels/2, levels/2], hess in
[0, levels]) with power-of-two per-tree scales, so histogram sums of levels
are exact in any summation order and one scale multiply restores real units.
``renew_leaf_values`` recomputes leaf outputs from the true gradients
(reference ``RenewIntGradTreeOutput``).

Only deterministic rounding is ported: stochastic rounding draws from jax's
threefry generator, whose bits this package does not reproduce yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import log


def _pow2_ceil(x: torch.Tensor) -> torch.Tensor:
    """Smallest power of two >= x (positive finite x), as
    ``exp2(ceil(log2(x)))`` in f32 like the JAX package."""
    return torch.exp2(torch.ceil(torch.log2(x)))


def discretize_gradients_levels(grad: torch.Tensor, hess: torch.Tensor, *,
                                n_levels: int = 4, stochastic: bool = False,
                                constant_hessian: bool = False
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor, torch.Tensor]:
    """(g_levels, h_levels, g_scale, h_scale) with real ~= level * scale."""
    if stochastic:
        log.fatal("stochastic_rounding=true is not supported by "
                  "lightgbm_tpu_torch yet (it needs jax's threefry bits); "
                  "set stochastic_rounding=false")
    max_g = grad.abs().max()
    max_h = hess.abs().max()
    tiny = torch.tensor(1e-20, dtype=torch.float32, device=grad.device)
    g_scale = _pow2_ceil(torch.maximum(max_g / (n_levels // 2), tiny))
    h_scale = _pow2_ceil(torch.maximum(
        max_h if constant_hessian else max_h / n_levels, tiny))
    return (torch.round(grad / g_scale), torch.round(hess / h_scale),
            g_scale, h_scale)


def renew_leaf_values(leaf_of_row: torch.Tensor, grad: torch.Tensor,
                      hess: torch.Tensor, row_mask: Optional[torch.Tensor],
                      num_leaves: int, lambda_l1: float,
                      lambda_l2: float) -> torch.Tensor:
    """Exact leaf outputs from TRUE gradients:
    out[l] = -T(sum g_l) / (sum h_l + l2) with the L1 soft-threshold T.

    The sums scatter in row order on the CPU (the order of the JAX
    package's scatter-add there); on the card the order is the atomics'."""
    L = num_leaves
    lor = leaf_of_row.long()
    zero = torch.zeros((), dtype=grad.dtype, device=grad.device)
    if row_mask is None:
        gm, hm = grad, hess
    else:
        gm = torch.where(row_mask, grad, zero)
        hm = torch.where(row_mask, hess, zero)
    gsum = torch.zeros(L, dtype=grad.dtype, device=grad.device) \
        .index_add_(0, lor, gm)
    hsum = torch.zeros(L, dtype=hess.dtype, device=hess.device) \
        .index_add_(0, lor, hm)
    t = torch.sign(gsum) * torch.clamp(gsum.abs() - lambda_l1, min=0.0)
    return -t / (hsum + lambda_l2 + 1e-15)
