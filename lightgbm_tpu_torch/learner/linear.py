"""Linear models in the leaves (``linear_tree=true``).

Counterpart of ``lightgbm_tpu/learner/linear.py`` (reference
src/treelearner/linear_tree_learner.cpp:180 ``CalculateLinear``: a ridge
regression per leaf over the leaf's numeric path features, Eq. 3 of the
GBDT-PL paper, coeffs = -(XtHX + lambda I)^-1 Xtg with X = [raw path
features | 1]).  :func:`fit_linear_leaves` takes each leaf's first 16
numeric path features in index order, accumulates every leaf's normal
equations in one row pass (ops/linear_kernels.py ``normal_equations``: the
hand-written kernel of csrc/linear.cu on the card), regularizes them and
solves all leaves at once; :func:`linear_leaf_scores` is the per-row
output (``leaf_scores``, the same kernel file's second entry).

Rows with a NaN in their leaf's features leave the fit and score the plain
leaf output (reference tree.h:587-606).  A leaf with fewer usable rows
than unknowns, no numeric path feature, or a solve that fails keeps
coefficient 0 and its constant output (linear_tree_learner.cpp:330-338).
The solve is ``torch.linalg.solve_ex``, a library call as the JAX
package's ``jnp.linalg.solve`` is: it reports a singular system in
``info`` instead of raising (and reading back), and such a leaf is treated
as the JAX package treats a non-finite solution.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.linear_kernels import MAX_FEATURES, leaf_scores, normal_equations


def leaf_features(mask: torch.Tensor, max_feats: int) -> torch.Tensor:
    """int64 [L, K]: the first ``max_feats`` (K = min(max_feats, F))
    features set in each row of ``mask`` bool [L, F], in increasing order,
    F where a row has fewer (``jnp.nonzero(size=K, fill_value=F)``)."""
    L, F = mask.shape
    K = min(max_feats, F)
    idx = torch.where(mask, torch.arange(F, device=mask.device), F)
    return torch.sort(idx, dim=1).values[:, :K]


def fit_linear_leaves(raw: torch.Tensor, leaf_of_row: torch.Tensor,
                      leaf_path: torch.Tensor, is_numeric: torch.Tensor,
                      grad: torch.Tensor, hess: torch.Tensor,
                      row_mask: Optional[torch.Tensor],
                      leaf_value: torch.Tensor, linear_lambda: float,
                      max_feats: int = MAX_FEATURES
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One linear model per leaf.  ``raw`` f32 [n, F] (NaN kept);
    ``leaf_path`` bool [L, F]; ``is_numeric`` bool [F]; ``grad``/``hess``
    f32 [n] (the true gradients); ``row_mask`` bool [n] or None;
    ``leaf_value`` f32 [L], the fallback constants.  Returns (const f32
    [L], coeff f32 [L, F] dense over the packed features, zero where
    unused), the JAX package's outputs."""
    num_f = raw.shape[1]
    L = leaf_path.shape[0]
    dev = raw.device
    feat = leaf_features(leaf_path & is_numeric.to(dev)[None, :], max_feats)
    K = feat.shape[1]
    active = feat < num_f                                        # [L, K]
    n_active = active.sum(1)
    xthx, xtg, cnt = normal_equations(raw, leaf_of_row, feat, grad, hess,
                                      row_mask)
    # regularize, and make the unused dimensions identity rows with a zero
    # right-hand side (coefficient 0), so one batched solve covers every
    # leaf's variable count
    D = K + 1
    am = torch.cat([active, torch.ones(L, 1, dtype=torch.bool, device=dev)],
                   1)
    lam = torch.cat([torch.full((K,), float(linear_lambda),
                                dtype=torch.float32, device=dev),
                     torch.zeros(1, dtype=torch.float32, device=dev)])
    a = xthx + torch.diag(lam)[None]
    pair = am[:, :, None] & am[:, None, :]
    eye = torch.eye(D, dtype=torch.float32, device=dev)[None]
    a = torch.where(pair, a, eye)
    b = torch.where(am, -xtg, torch.zeros_like(xtg))
    coefs, info = torch.linalg.solve_ex(a, b[..., None])
    coefs = coefs[..., 0]                                        # [L, D]
    finite = torch.isfinite(coefs).all(1) & (info == 0)
    ok = (cnt >= (n_active + 1).to(cnt.dtype)) & finite & (n_active > 0)
    const = torch.where(ok, coefs[:, K], leaf_value)
    coeff_k = torch.where(ok[:, None] & active, coefs[:, :K],
                          torch.zeros_like(coefs[:, :K]))
    coeff = torch.zeros(L, num_f + 1, dtype=torch.float32, device=dev)
    coeff.scatter_(1, feat, coeff_k)
    return const, coeff[:, :num_f]


def linear_leaf_scores(raw: torch.Tensor, leaf_of_row: torch.Tensor,
                       const: torch.Tensor, coeff: torch.Tensor,
                       leaf_value: torch.Tensor,
                       max_feats: int = MAX_FEATURES) -> torch.Tensor:
    """f32 [n]: each row's linear-tree output, ``const[leaf] +
    coeff[leaf] . raw`` over the leaf's nonzero coefficients (at most
    ``max_feats`` a leaf, as :func:`fit_linear_leaves` makes them), the
    plain ``leaf_value[leaf]`` where one of their values is NaN (reference
    tree.h:587 Predict, linear branch).  ``coeff`` f32 [L, F] dense."""
    feat = leaf_features(coeff != 0.0, max_feats)
    coef_k = torch.cat([coeff, torch.zeros_like(coeff[:, :1])], 1) \
        .gather(1, feat)
    return leaf_scores(raw, leaf_of_row, feat, coef_k, const, leaf_value)
