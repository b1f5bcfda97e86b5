"""Carry state across from ``lightgbm_tpu`` to this package.

* :func:`tree_arrays_from_numpy` turns the JAX package's ``TreeArrays``
  fields (given as numpy arrays, e.g. ``jax.device_get(arrays)._asdict()``)
  into this package's ``TreeArrays`` on a torch device;
* :func:`tree_from_numpy` makes a host ``Tree`` of them, with the linear
  leaves of a ``fit_linear_leaves`` result (const [L], dense coeff [L, F])
  attached as the JAX package's ``Tree.set_linear`` attaches them;
* :func:`booster_from_model_string` loads a model text written by
  ``lightgbm_tpu`` (the formats are the same; linear leaves included) into
  a predict-only Booster.

A stacked forest of the JAX package (``_forest_arrays`` /
``_forest_bitset_arrays``, linear leaves included) carries over through
models/predict.py ``forest_from_numpy``.

Both take plain data, so this module imports neither package's jax side.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .basic import Booster
from .learner.grower import TreeArrays
from .models.tree import Tree


def tree_arrays_from_numpy(d: Mapping[str, Any],
                           device: torch.device = torch.device("cpu")
                           ) -> TreeArrays:
    """``TreeArrays`` from a mapping of field name -> array-like."""
    return TreeArrays(**{f: torch.as_tensor(np.array(d[f]), device=device)
                         for f in TreeArrays._fields})


def tree_from_numpy(d: Mapping[str, Any], dataset, linear=None) -> Tree:
    """A host ``Tree`` from the JAX package's ``TreeArrays`` fields ``d``
    (numpy), grown on ``dataset`` (this package's inner Dataset, binned as
    the JAX one was), with ``linear`` = (const [L], coeff [L, F_packed]),
    the JAX package's ``fit_linear_leaves`` outputs, attached (unshrunk,
    as the booster attaches them before its shrinkage)."""
    tree = Tree.from_arrays(tree_arrays_from_numpy(d), dataset)
    if linear is not None:
        tree.set_linear(np.asarray(linear[0], np.float64),
                        np.asarray(linear[1], np.float64),
                        dataset.used_feature_idx)
    return tree


def booster_from_model_string(text: str) -> Booster:
    """A predict-only Booster from ``lightgbm_tpu`` model text."""
    return Booster(model_str=text)
