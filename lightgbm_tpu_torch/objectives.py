"""Objective functions (gradient/hessian providers).

Counterpart of ``lightgbm_tpu/objectives.py`` for ``regression`` (L2) and
``binary`` (reference regression_objective.hpp RegressionL2loss,
binary_objective.hpp BinaryLogloss).  Gradients are torch ops on the score
tensor's device, with the JAX package's f32 operation order; init scores
come from the same float64 NumPy code.  Other objectives are not ported
yet and are rejected by name.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config
from .io.dataset import Metadata
from .utils import log


class ObjectiveFunction:
    """Base interface (reference objective_function.h:19)."""

    num_model_per_iteration: int = 1
    need_renew_tree_output: bool = False
    is_constant_hessian: bool = False
    need_convert_output: bool = False

    def __init__(self, config: Config):
        self.config = config
        self.metadata: Optional[Metadata] = None
        self.num_data = 0
        self.device = torch.device("cpu")

    def init(self, metadata: Metadata, num_data: int,
             device: torch.device = torch.device("cpu")) -> None:
        self.metadata = metadata
        self.num_data = num_data
        self.device = device
        self._label = torch.as_tensor(np.asarray(metadata.label, np.float32),
                                      device=device)
        self._weight = None if metadata.weight is None else torch.as_tensor(
            np.asarray(metadata.weight, np.float32), device=device)

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    def convert_output(self, raw: torch.Tensor) -> torch.Tensor:
        return raw

    def _apply_weight(self, g, h):
        if self._weight is not None:
            return g * self._weight, h * self._weight
        return g, h

    @property
    def name(self) -> str:
        return type(self).NAME  # type: ignore[attr-defined]


class RegressionL2Loss(ObjectiveFunction):
    """reference regression_objective.hpp RegressionL2loss."""
    NAME = "regression"
    is_constant_hessian = True

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        if self.config.reg_sqrt:
            lbl = np.asarray(metadata.label, np.float64)
            self._label = torch.as_tensor(
                (np.sign(lbl) * np.sqrt(np.abs(lbl))).astype(np.float32),
                device=device)
        self.need_convert_output = bool(self.config.reg_sqrt)

    def get_gradients(self, score):
        g = score - self._label
        h = torch.ones_like(score)
        return self._apply_weight(g, h)

    def boost_from_score(self, class_id=0):
        lbl = self._label.cpu().numpy().astype(np.float64)
        w = None if self._weight is None else \
            self._weight.cpu().numpy().astype(np.float64)
        return float(np.average(lbl, weights=w))

    def convert_output(self, raw):
        if self.config.reg_sqrt:
            return torch.sign(raw) * raw * raw
        return raw


class BinaryLogloss(ObjectiveFunction):
    """reference binary_objective.hpp BinaryLogloss."""
    NAME = "binary"
    need_convert_output = True

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        lbl = np.asarray(metadata.label)
        if not np.isin(np.unique(lbl), (0, 1)).all():
            log.fatal("Binary objective requires 0/1 labels")
        # label weights (is_unbalance / scale_pos_weight,
        # binary_objective.hpp ctor)
        w = None if metadata.weight is None else np.asarray(metadata.weight)
        cnt_pos = float((lbl == 1).sum() if w is None else w[lbl == 1].sum())
        cnt_neg = float((lbl == 0).sum() if w is None else w[lbl == 0].sum())
        lw_pos, lw_neg = 1.0, 1.0
        if self.config.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                lw_neg = cnt_pos / cnt_neg
            else:
                lw_pos = cnt_neg / cnt_pos
        lw_pos *= self.config.scale_pos_weight
        self._lw_pos, self._lw_neg = lw_pos, lw_neg
        self._cnt_pos, self._cnt_neg = cnt_pos, cnt_neg
        self._sign = torch.as_tensor(
            np.where(lbl == 1, 1.0, -1.0).astype(np.float32), device=device)

    def get_gradients(self, score):
        s = self.config.sigmoid
        z = self._sign * s * score
        resp = -self._sign * s / (1.0 + torch.exp(z))
        lw = torch.where(self._sign > 0,
                         torch.tensor(self._lw_pos, dtype=torch.float32,
                                      device=score.device),
                         torch.tensor(self._lw_neg, dtype=torch.float32,
                                      device=score.device))
        g = resp * lw
        h = resp.abs() * (s - resp.abs()) * lw
        return self._apply_weight(g, h)

    def boost_from_score(self, class_id=0):
        s = self.config.sigmoid
        tot = self._cnt_pos * self._lw_pos + self._cnt_neg * self._lw_neg
        if tot <= 0:
            return 0.0
        p = np.clip(self._cnt_pos * self._lw_pos / tot, 1e-15, 1 - 1e-15)
        init = np.log(p / (1.0 - p)) / s
        log.info(f"[binary:BoostFromScore]: pavg={p:.6f} -> "
                 f"initscore={init:.6f}")
        return float(init)

    def convert_output(self, raw):
        return 1.0 / (1.0 + torch.exp(-self.config.sigmoid * raw))


_OBJECTIVES = {
    "regression": RegressionL2Loss,
    "binary": BinaryLogloss,
}


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """Factory (reference objective_function.cpp)."""
    name = config.objective
    if name == "none":
        return None
    cls = _OBJECTIVES.get(name)
    if cls is None:
        log.fatal(f"objective={name} is not supported by lightgbm_tpu_torch "
                  f"yet (ported: {', '.join(sorted(_OBJECTIVES))})")
    return cls(config)
