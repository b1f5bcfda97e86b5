"""User-facing ``Dataset`` and ``Booster``.

Counterpart of ``lightgbm_tpu/basic.py`` (reference python-package
lightgbm/basic.py — ``Dataset`` :1764 lazy construction with reference
alignment, ``Booster`` :3586) for dense numeric input: lazy Dataset
construction, valid sets binned against their training reference, Booster
train / eval / predict / save / load with the same model text format.
Booster(model_str=...) and Booster(model_file=...) load the JAX package's
model text as well as this package's.

Not here yet: file / pandas-categorical / sparse / Sequence input, binary
datasets, continued training, refit, SHAP contributions, dump/plot helpers.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence as TSeq, Union

import numpy as np

from .boosting import create_boosting
from .config import Config, normalize_params
from .io.dataset import Dataset as _InnerDataset
from .models.model_io import (model_to_string, objective_to_string,
                              parse_model_string)
from .models.tree import Tree
from .utils import log


def _objective_string_transform(out: np.ndarray, obj_str: str) -> np.ndarray:
    """Raw scores [n, k] -> output space from a model-text objective string
    like ``"binary sigmoid:1"`` (the ported objectives)."""
    obj_tokens = obj_str.split(" ")
    obj = obj_tokens[0]
    if obj == "binary":
        sig = 1.0
        for tok in obj_tokens[1:]:
            if tok.startswith("sigmoid:"):
                sig = float(tok.split(":")[1])
        return 1.0 / (1.0 + np.exp(-sig * out))
    if obj == "regression" and "sqrt" in obj_tokens[1:]:
        return np.sign(out) * out * out
    return out


class Dataset:
    """Lazily-constructed binned dataset (reference basic.py:1764)."""

    def __init__(self, data: Any, label: Optional[TSeq[float]] = None,
                 reference: Optional["Dataset"] = None,
                 weight: Optional[TSeq[float]] = None,
                 group: Optional[TSeq[int]] = None,
                 init_score: Optional[TSeq[float]] = None,
                 feature_name: Union[str, List[str], None] = "auto",
                 categorical_feature: Union[str, List, None] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        self.free_raw_data = free_raw_data
        self._inner: Optional[_InnerDataset] = None

    def construct(self) -> "Dataset":
        if self._inner is not None:
            return self
        params = dict(self.params)
        ref_inner = None
        if self.reference is not None:
            self.reference.construct()
            ref_inner = self.reference._inner
            params = {**self.reference.params, **params}
        if isinstance(self.data, (str, bytes)) or hasattr(self.data,
                                                          "__fspath__"):
            log.fatal("file input is not supported by lightgbm_tpu_torch "
                      "yet; pass a dense matrix")
        cfg = Config(params)
        fn = None if self.feature_name in ("auto", None) \
            else list(self.feature_name)
        cat = None if self.categorical_feature in ("auto", None) else \
            list(self.categorical_feature)
        self._inner = _InnerDataset.from_data(
            self.data, label=self.label, config=cfg, weight=self.weight,
            group=self.group, init_score=self.init_score, feature_names=fn,
            categorical_feature=cat, reference=ref_inner)
        if self.free_raw_data:
            self.data = None
        return self

    def create_valid(self, data, label=None, **kwargs) -> "Dataset":
        return Dataset(data, label=label, reference=self, **kwargs)

    @property
    def inner(self) -> _InnerDataset:
        self.construct()
        return self._inner  # type: ignore[return-value]

    def num_data(self) -> int:
        return self.inner.num_data

    def num_feature(self) -> int:
        return self.inner.num_total_features

    def get_label(self) -> np.ndarray:
        return self.inner.metadata.label


class Booster:
    """Trained/trainable model handle (reference basic.py:3586)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = normalize_params(params)
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._gbdt = None
        self._loaded: Optional[Dict[str, Any]] = None
        self.train_set = train_set
        if model_file is not None:
            try:
                with open(model_file) as f:
                    model_str = f.read()
            except OSError as e:
                raise log.LightGBMError(
                    f"cannot read model file {str(model_file)!r}: "
                    f"{type(e).__name__}: {e}") from e
        if model_str is not None:
            try:
                self._loaded = parse_model_string(model_str)
            except log.LightGBMError:
                raise
            except Exception as e:
                raise log.LightGBMError(
                    f"failed to parse model string: {type(e).__name__}: {e}"
                ) from e
            return
        if train_set is None:
            log.fatal("Booster requires train_set or a model to load")
        train_set.params = {**train_set.params, **self.params}
        train_set.construct()
        self._gbdt = create_boosting(Config(self.params), train_set.inner)

    # ------------------------------------------------------------ training
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        data.construct()
        self._gbdt.add_valid(data.inner, name)
        return self

    def update(self) -> bool:
        """One boosting round (reference LGBM_BoosterUpdateOneIter)."""
        return self._gbdt.train_one_iter()

    @property
    def current_iteration(self):
        return self._gbdt.current_iteration

    def num_trees(self) -> int:
        return self._gbdt.num_trees() if self._gbdt else \
            len(self._loaded["trees"])

    def num_model_per_iteration(self) -> int:
        return self._gbdt.num_tree_per_iteration if self._gbdt else \
            self._loaded["num_tree_per_iteration"]

    # ---------------------------------------------------------- evaluation
    def eval_train(self):
        return self._gbdt.eval_train()

    def eval_valid(self):
        return self._gbdt.eval_valid()

    # ---------------------------------------------------------- prediction
    def predict(self, data: Any, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False) -> np.ndarray:
        X = np.asarray(data, np.float64)
        if num_iteration is None:
            num_iteration = self.best_iteration if self.best_iteration > 0 \
                else -1
        if self._gbdt is not None:
            return self._gbdt.predict(X, raw_score=raw_score,
                                      start_iteration=start_iteration,
                                      num_iteration=num_iteration)
        return self._predict_loaded(X, start_iteration, num_iteration,
                                    raw_score)

    def _predict_loaded(self, X, start_iteration, num_iteration,
                        raw_score) -> np.ndarray:
        trees = self._loaded["trees"]
        k = self._loaded["num_tree_per_iteration"]
        total_iters = len(trees) // k if k else 0
        end = total_iters if num_iteration is None or num_iteration <= 0 \
            else min(total_iters, start_iteration + num_iteration)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        out = np.zeros((X.shape[0], k))
        for it in range(start_iteration, end):
            for c in range(k):
                out[:, c] += trees[it * k + c].predict(X)
        if not raw_score:
            out = _objective_string_transform(out, self._loaded["objective"])
        return out[:, 0] if k == 1 else out

    def _get_trees(self) -> List[Tree]:
        return self._gbdt.models if self._gbdt is not None \
            else self._loaded["trees"]

    # ------------------------------------------------------------- im/export
    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        if self._gbdt is None:
            d = self._loaded
            return model_to_string(
                d["trees"], num_class=d["num_class"],
                num_tree_per_iteration=d["num_tree_per_iteration"],
                max_feature_idx=d["max_feature_idx"],
                objective_str=d["objective"], feature_names=d["feature_names"],
                feature_infos=d["feature_infos"], params={},
                pandas_categorical=d.get("pandas_categorical"))
        g = self._gbdt
        ds = g.train_set
        k = g.num_tree_per_iteration
        if num_iteration is None:
            num_iteration = self.best_iteration if self.best_iteration > 0 \
                else -1
        total_iters = len(g.models) // k
        end = total_iters if num_iteration <= 0 else \
            min(total_iters, start_iteration + num_iteration)
        trees = [g.models[it * k + c] for it in range(start_iteration, end)
                 for c in range(k)]
        feature_infos = []
        for j in range(ds.num_total_features):
            m = ds.mappers[j]
            if m.is_trivial():
                feature_infos.append("none")
            elif m.bin_type == 1:
                feature_infos.append(
                    ":".join(str(c) for c in m.bin_2_categorical) or "none")
            else:
                feature_infos.append(f"[{m.min_val:g}:{m.max_val:g}]")
        obj_str = objective_to_string(g.objective.NAME, g.config)
        return model_to_string(
            trees, num_class=g.num_class, num_tree_per_iteration=k,
            max_feature_idx=ds.num_total_features - 1, objective_str=obj_str,
            feature_names=ds.feature_names, feature_infos=feature_infos,
            params=g.config._explicit, pandas_categorical=None)

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        with open(filename, "w") as f:
            f.write(self.model_to_string(num_iteration, start_iteration))
        return self

    def feature_name(self) -> List[str]:
        if self._gbdt is not None:
            return self._gbdt.train_set.feature_names
        return self._loaded["feature_names"]

    def num_feature(self) -> int:
        return len(self.feature_name())
