"""Carry state across from ``lightgbm_tpu`` to this package.

* :func:`tree_arrays_from_numpy` turns the JAX package's ``TreeArrays``
  fields (given as numpy arrays, e.g. ``jax.device_get(arrays)._asdict()``)
  into this package's ``TreeArrays`` on a torch device;
* :func:`booster_from_model_string` loads a model text written by
  ``lightgbm_tpu`` (the formats are the same) into a predict-only Booster.

Both take plain data, so this module imports neither package's jax side.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .basic import Booster
from .learner.grower import TreeArrays


def tree_arrays_from_numpy(d: Mapping[str, Any],
                           device: torch.device = torch.device("cpu")
                           ) -> TreeArrays:
    """``TreeArrays`` from a mapping of field name -> array-like."""
    return TreeArrays(**{f: torch.as_tensor(np.array(d[f]), device=device)
                         for f in TreeArrays._fields})


def booster_from_model_string(text: str) -> Booster:
    """A predict-only Booster from ``lightgbm_tpu`` model text."""
    return Booster(model_str=text)
