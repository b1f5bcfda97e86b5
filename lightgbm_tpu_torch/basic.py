"""User-facing ``Dataset`` and ``Booster``.

Counterpart of ``lightgbm_tpu/basic.py`` (reference python-package
lightgbm/basic.py — ``Dataset`` :1764 lazy construction with reference
alignment, ``Booster`` :3586) for dense numeric input: lazy Dataset
construction, valid sets binned against their training reference, Booster
train / eval / predict / save / load with the same model text format.
Booster(model_str=...) and Booster(model_file=...) load the JAX package's
model text as well as this package's.

``Booster.predict`` has the JAX package's surface: raw or converted
scores, ``pred_leaf``, ``pred_contrib`` (TreeSHAP, models/shap.py) and
prediction early stopping (``pred_early_stop`` / ``_freq`` / ``_margin``).

The training surface (the JAX package's): ``Booster.update(train_set,
fobj)`` with custom gradients, continued training (a Dataset's predictor
gives its init score, ``Booster.__init__`` merges the init model's trees),
``rollback_one_iter``, ``refit`` / ``refit_from_leaf_preds``,
``reset_parameter``, ``eval`` with custom metrics, ``telemetry``, and
``Dataset.subset`` with the field accessors.

Not here yet: file / pandas-categorical / sparse / Sequence input (also at
predict time), binary datasets, the model-inspection methods,
``merge_models``, ``shuffle_models``, ``reset_training_data``, dump/plot
helpers.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence as TSeq, Union

import numpy as np

from .boosting import create_boosting
from .config import Config, normalize_params
from .io.dataset import Dataset as _InnerDataset
from .models.model_io import (model_to_string, objective_string_to_params,
                              objective_to_string, parse_model_string)
from .models.tree import Tree
from .utils import log
from .utils.device import resolve_device


def _margin_reached(out: np.ndarray, margin: float) -> np.ndarray:
    """Per-row early-termination test (reference
    prediction_early_stop.cpp — binary: 2*|raw|, multiclass: top-2 gap)."""
    if out.shape[1] == 1:
        return 2.0 * np.abs(out[:, 0]) >= margin
    part = np.partition(out, -2, axis=1)
    return (part[:, -1] - part[:, -2]) >= margin


def _host_leaves(trees: List[Tree], X: np.ndarray, k: int, start: int,
                 end: int) -> np.ndarray:
    """i32 [n, trees]: the leaf of every row in iterations [start, end),
    walked on the host (``pred_leaf``)."""
    leaves = [trees[it * k + c].predict_leaf_index(X)
              for it in range(start, end) for c in range(k)]
    return np.stack(leaves, axis=1) if leaves else \
        np.zeros((X.shape[0], 0), np.int32)


def _host_raw(trees: List[Tree], X: np.ndarray, k: int, start: int,
              end: int, early=None) -> np.ndarray:
    """float64 [n, k] raw scores of iterations [start, end), walked on the
    host; ``early`` = (on, freq, margin) stops a row every ``freq``
    iterations once ``_margin_reached``."""
    out = np.zeros((X.shape[0], k))
    active = np.ones(X.shape[0], bool) if early is not None else None
    for it in range(start, end):
        for c in range(k):
            if early is not None:
                out[active, c] += trees[it * k + c].predict(X[active])
            else:
                out[:, c] += trees[it * k + c].predict(X)
        if early is not None and (it + 1) % early[1] == 0:
            active &= ~_margin_reached(out, early[2])
            if not active.any():
                break
    return out


def _objective_string_transform(out: np.ndarray, obj_str: str) -> np.ndarray:
    """Raw scores [n, k] -> output space, from a model-text objective string
    like ``"binary sigmoid:1"`` (reference ConvertOutput dispatch for
    text-loaded models, objective_function.h; the JAX package's)."""
    obj_tokens = obj_str.split(" ")
    obj = obj_tokens[0]
    if obj == "binary":
        sig = 1.0
        for tok in obj_tokens[1:]:
            if tok.startswith("sigmoid:"):
                sig = float(tok.split(":")[1])
        return 1.0 / (1.0 + np.exp(-sig * out))
    if obj == "multiclass":
        ex = np.exp(out - out.max(axis=1, keepdims=True))
        return ex / ex.sum(axis=1, keepdims=True)
    if obj in ("multiclassova", "cross_entropy"):
        return 1.0 / (1.0 + np.exp(-out))
    if obj in ("poisson", "gamma", "tweedie"):
        return np.exp(out)
    if obj == "cross_entropy_lambda":
        return np.log1p(np.exp(out))
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
                 free_raw_data: bool = True, position=None):
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
        self.position = position
        self._inner: Optional[_InnerDataset] = None
        # continued training: a predictor whose raw predictions become this
        # dataset's init score (reference basic.py:2059
        # _set_init_score_by_predictor)
        self._predictor: Optional["Booster"] = None

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
        predictor = self._predictor
        if predictor is None and self.reference is not None:
            predictor = self.reference._predictor
        if predictor is not None and self.init_score is None:
            # all of the predictor's trees: they are merged whole into the
            # new booster, so the residuals are against the full model
            raw = predictor.predict(self.data, raw_score=True,
                                    num_iteration=-1)
            # column-major flatten for k outputs (reference basic.py:2089)
            self.init_score = np.asarray(raw, np.float64).reshape(
                -1, order="F")
        self._inner = _InnerDataset.from_data(
            self.data, label=self.label, config=cfg, weight=self.weight,
            group=self.group, init_score=self.init_score, feature_names=fn,
            categorical_feature=cat, reference=ref_inner)
        if self.position is not None:
            self._inner.metadata.set_position(self.position)
        if self.free_raw_data:
            self.data = None
        return self

    def create_valid(self, data, label=None, **kwargs) -> "Dataset":
        return Dataset(data, label=label, reference=self, **kwargs)

    @classmethod
    def from_inner(cls, inner: _InnerDataset,
                   params: Optional[Dict[str, Any]] = None) -> "Dataset":
        """Wrap an already-constructed inner dataset (subsets)."""
        d = cls(data=None, params=params)
        d._inner = inner
        d.label = inner.metadata.label
        return d

    def subset(self, used_indices, params: Optional[Dict[str, Any]] = None
               ) -> "Dataset":
        """Row subset sharing the bin mappers (reference Dataset.subset ->
        LGBM_DatasetGetSubset)."""
        self.construct()
        return Dataset.from_inner(self._inner.subset(used_indices),
                                  params or dict(self.params))

    def _apply_predictor(self, predictor: Optional["Booster"]) -> None:
        """Set the continuation predictor (reference basic.py:2576
        ``_set_predictor``).  A constructed dataset gets its init score at
        once, which needs the raw data."""
        self._predictor = predictor
        if predictor is None or self._inner is None:
            return
        if self.data is None:
            log.fatal("Cannot use init_model with a constructed Dataset "
                      "whose raw data was freed; create the Dataset with "
                      "free_raw_data=False")
        raw = predictor.predict(self.data, raw_score=True, num_iteration=-1)
        self._inner.metadata.set_init_score(
            np.asarray(raw, np.float64).reshape(-1, order="F"))

    def get_ref_chain(self, ref_limit: int = 100) -> set:
        """This dataset and its chain of references (reference
        Dataset.get_ref_chain)."""
        head, chain = self, set()
        while len(chain) < ref_limit and isinstance(head, Dataset) \
                and head not in chain:
            chain.add(head)
            head = head.reference
        return chain

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

    def get_weight(self) -> Optional[np.ndarray]:
        return self.inner.metadata.weight

    def get_group(self) -> Optional[np.ndarray]:
        """Each query's size (None without queries)."""
        qb = self.inner.metadata.query_boundaries
        return None if qb is None else np.diff(qb)

    def get_init_score(self) -> Optional[np.ndarray]:
        return self.inner.metadata.init_score

    def get_position(self) -> Optional[np.ndarray]:
        """reference Dataset.get_position (position-debiased ranking)."""
        return self.get_field("position")

    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._inner is not None:
            self._inner.metadata.set_label(label)
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._inner is not None:
            self._inner.metadata.set_weight(weight)
        return self

    def set_group(self, group) -> "Dataset":
        self.group = group
        if self._inner is not None:
            self._inner.metadata.set_group(group)
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._inner is not None:
            self._inner.metadata.set_init_score(init_score)
        return self

    def set_position(self, position) -> "Dataset":
        pos = np.asarray(position, np.int32)
        self.position = pos
        if self._inner is not None:
            self._inner.metadata.set_position(pos)
        return self

    def get_field(self, field_name: str) -> Optional[np.ndarray]:
        """reference Dataset.get_field: label / weight / init_score as float
        arrays, ``group`` as the cumulative query boundaries (the
        reference's storage form), ``position`` as int."""
        self.construct()
        md = self._inner.metadata
        if field_name == "label":
            return None if md.label is None else np.asarray(md.label)
        if field_name == "weight":
            return None if md.weight is None else np.asarray(md.weight)
        if field_name == "init_score":
            return None if md.init_score is None else \
                np.asarray(md.init_score)
        if field_name == "group":
            qb = md.query_boundaries
            return None if qb is None else np.asarray(qb, np.int32)
        if field_name == "position":
            return None if md.position is None else \
                np.asarray(md.position, np.int32)
        log.fatal(f"Unknown field name: {field_name}")

    def set_field(self, field_name: str, data) -> "Dataset":
        """reference Dataset.set_field."""
        if field_name == "label":
            return self.set_label(data)
        if field_name == "weight":
            return self.set_weight(data)
        if field_name == "init_score":
            return self.set_init_score(data)
        if field_name == "group":
            return self.set_group(np.asarray(data))
        if field_name == "position":
            return self.set_position(data)
        log.fatal(f"Unknown field name: {field_name}")

    def get_data(self):
        """The raw data this Dataset was built from (reference
        Dataset.get_data); fatal once it was freed or for a subset."""
        if self.data is None:
            log.fatal("Cannot get data: the raw data was freed or this "
                      "Dataset was created from a subset")
        return self.data

    def get_params(self) -> Dict[str, Any]:
        """reference Dataset.get_params."""
        return dict(self.params)


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
        # continued training: the init model's trees ahead of the new ones
        # (reference basic.py:3675 LGBM_BoosterMerge -> gbdt.h:70
        # MergeFrom)
        if train_set._predictor is not None:
            self._gbdt.merge_from(train_set._predictor._get_trees())

    # ------------------------------------------------------------ training
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        data.construct()
        if not hasattr(self, "_valid_lookup"):
            self._valid_lookup = {}
        self._valid_lookup[data] = len(self._gbdt.valid_sets)
        self._gbdt.add_valid(data.inner, name)
        return self

    def update(self, train_set: Optional[Dataset] = None,
               fobj=None) -> bool:
        """One boosting round (reference Booster.update ->
        LGBM_BoosterUpdateOneIter; with ``fobj`` ->
        LGBM_BoosterUpdateOneIterCustom).  ``fobj(preds, train_set)``
        returns (grad, hess) for the current raw scores (float64, [n], or
        [n, k] for k outputs); they reach the device once, as float32.
        ``train_set`` must be the booster's own (training data is not
        replaced: ``reset_training_data`` is not ported)."""
        if train_set is not None and train_set is not self.train_set:
            log.fatal("Booster.update with another train_set "
                      "(reset_training_data) is not supported by "
                      "lightgbm_tpu_torch yet")
        if fobj is None:
            return self._gbdt.train_one_iter()
        if self._gbdt.objective is not None:
            log.fatal("Cannot use fobj with a built-in objective; set "
                      "objective=none")
        grad, hess = fobj(self._current_train_preds(), self.train_set)
        return self._gbdt.train_one_iter(np.asarray(grad), np.asarray(hess))

    def _current_train_preds(self) -> np.ndarray:
        return self._gbdt._host_scores(self._gbdt.scores)

    def rollback_one_iter(self) -> "Booster":
        """Drop the last iteration's trees and their scores (never the
        init model's)."""
        self._gbdt.rollback_one_iter()
        return self

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """LGBM_BoosterResetParameter (c_api.h:853): swap learning-control
        parameters on the live booster (``GBDT.reset_config``)."""
        self.params = {**self.params, **normalize_params(params)}
        if self._gbdt is not None:
            self._gbdt.reset_config(Config(self.params))
        return self

    def telemetry(self) -> Dict[str, Any]:
        """Counters and gauges accumulated while training (obs/metrics.py);
        ``phases`` and ``memory`` stay empty until the JAX package's phase
        timers and memory sampling are ported.  A loaded booster reports
        empty dicts."""
        if self._gbdt is not None:
            return self._gbdt.telemetry()
        return {"counters": {}, "gauges": {}, "phases": {}, "memory": {}}

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

    def _check_valid_alignment(self, data: Dataset) -> None:
        """The reference refuses validation data with other bin mappers
        (Dataset::CheckAlign): its bins would mean other values."""
        if self.train_set is not None and \
                self.train_set in data.get_ref_chain():
            return
        data.construct()
        tm = self._gbdt.train_set.mappers
        vm = data.inner.mappers

        def same(a, b):
            return (a.bin_type == b.bin_type and a.num_bin == b.num_bin
                    and np.array_equal(np.asarray(a.bin_upper_bound),
                                       np.asarray(b.bin_upper_bound))
                    and list(getattr(a, "bin_2_categorical", []) or []) ==
                    list(getattr(b, "bin_2_categorical", []) or []))

        if len(tm) != len(vm) or any(not same(a, b)
                                     for a, b in zip(tm, vm)):
            log.fatal("cannot evaluate data with different bin mappers; "
                      "build it with create_valid / reference=")

    def eval(self, data: Dataset, name: str, feval=None) -> List[tuple]:
        """Evaluate the current model on ``data`` (reference Booster.eval):
        the training set and registered valid sets use their score caches;
        another aligned Dataset is registered as a valid set (and stays
        so), its scores built from the trees.  ``feval`` (one callable or a
        list) gets the raw scores (float64) and ``data``."""
        if self._gbdt is None:
            log.fatal("Booster.eval of a loaded model is not supported by "
                      "lightgbm_tpu_torch yet")
        g = self._gbdt
        if data is self.train_set:
            out = [(name,) + r[1:] for r in self.eval_train()]
            scores = g.scores
        else:
            if data not in getattr(self, "_valid_lookup", {}):
                self._check_valid_alignment(data)
                self.add_valid(data, name)
                g.invalidate_score_cache(
                    only_valid_index=self._valid_lookup[data])
            vi = self._valid_lookup[data]
            out = [(name,) + r[1:] for r in g._eval_metric_list(
                g.valid_names[vi], g.valid_metrics[vi], g.valid_scores[vi])]
            scores = g.valid_scores[vi]
        if feval is not None:
            sc = g._host_scores(scores)
            for f in feval if isinstance(feval, (list, tuple)) else [feval]:
                out.append((name,) + tuple(f(sc, data)))
        return out

    # ---------------------------------------------------------- prediction
    def predict(self, data: Any, start_iteration: int = 0,
                num_iteration: Optional[int] = None, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                pred_early_stop: bool = False, pred_early_stop_freq: int = 10,
                pred_early_stop_margin: float = 10.0,
                **kwargs) -> np.ndarray:
        """Scores, leaf indices (``pred_leaf``: i32 [n, trees]) or SHAP
        contributions (``pred_contrib``: [n, F + 1], class-major for k
        outputs) of the model's iterations [start_iteration,
        start_iteration + num_iteration) (all, or up to ``best_iteration``,
        when ``num_iteration`` is None).  ``pred_early_stop`` stops a row
        every ``pred_early_stop_freq`` iterations once its margin reaches
        ``pred_early_stop_margin`` (host walk)."""
        X = np.asarray(data, np.float64)
        if num_iteration is None:
            num_iteration = self.best_iteration if self.best_iteration > 0 \
                else -1
        if pred_contrib:
            return self._predict_contrib(X, start_iteration, num_iteration)
        early = (pred_early_stop, pred_early_stop_freq,
                 pred_early_stop_margin) if pred_early_stop else None
        if self._gbdt is not None:
            return self._gbdt.predict(X, raw_score=raw_score,
                                      start_iteration=start_iteration,
                                      num_iteration=num_iteration,
                                      pred_leaf=pred_leaf, early=early)
        return self._predict_loaded(X, start_iteration, num_iteration,
                                    raw_score, pred_leaf, early)

    def _predict_loaded(self, X, start_iteration, num_iteration, raw_score,
                        pred_leaf=False, early=None) -> np.ndarray:
        """A loaded model's scores or leaves: the host walk (a loaded
        model carries no bin mappers to bin with)."""
        trees = self._loaded["trees"]
        k = self._loaded["num_tree_per_iteration"]
        total_iters = len(trees) // k if k else 0
        end = total_iters if num_iteration is None or num_iteration <= 0 \
            else min(total_iters, start_iteration + num_iteration)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if pred_leaf:
            return _host_leaves(trees, X, k, start_iteration, end)
        out = _host_raw(trees, X, k, start_iteration, end, early)
        if not raw_score:
            out = _objective_string_transform(out, self._loaded["objective"])
        return out[:, 0] if k == 1 else out

    def _predict_contrib(self, X, start_iteration,
                         num_iteration) -> np.ndarray:
        """SHAP contributions (reference PredictContrib,
        gbdt_prediction.cpp:44; models/shap.py TreeSHAP).  The device part
        runs on the booster's device; a loaded model's device comes from
        ``params["device_type"]`` (the card unless ``cpu``), resolved only
        when the device part runs."""
        from .models.shap import DEVICE_CONTRIB_MIN_WORK, predict_contrib
        trees = self._get_trees()
        k = self.num_model_per_iteration()
        nf = (self._gbdt.train_set.num_total_features if self._gbdt
              else self._loaded["max_feature_idx"] + 1)
        end = -1 if num_iteration is None or num_iteration <= 0 else \
            start_iteration + num_iteration
        n = X.reshape(-1, X.shape[-1]).shape[0]
        device = None
        if n * max((t.num_leaves for t in trees),
                   default=1) > DEVICE_CONTRIB_MIN_WORK:
            device = self._gbdt.device if self._gbdt is not None else \
                resolve_device(self.params.get("device_type"))
        return predict_contrib(trees, X, nf, k, start_iteration, end,
                               device=device)

    def _get_trees(self) -> List[Tree]:
        return self._gbdt.models if self._gbdt is not None \
            else self._loaded["trees"]

    # --------------------------------------------------------------- refit
    @staticmethod
    def _refit_trees(trees: List[Tree], k: int, objective, device, leaf_of,
                     n: int, decay_rate: float, l1: float, l2: float) -> None:
        """New leaf values of ``trees`` in place, iteration by iteration
        (reference GBDT::RefitTree gbdt.cpp:258, FitByExistingTree
        serial_tree_learner.cpp:249-276; the JAX package's formulation):
        the objective's float32 gradients at the refitted model's scores,
        each leaf's sums in float64 in row order, L1 thresholding, the
        tree's shrinkage, then ``decay * old + (1 - decay) * new``.
        ``leaf_of(it, c)``: the rows' leaves in tree ``it * k + c``."""
        import torch
        scores = np.zeros((n, k))
        for it in range(len(trees) // k):
            sc = torch.as_tensor(scores[:, 0] if k == 1 else scores,
                                 dtype=torch.float32, device=device)
            g, h = objective.get_gradients(sc)
            g = g.cpu().numpy().astype(np.float64).reshape(n, k, order="F")
            h = h.cpu().numpy().astype(np.float64).reshape(n, k, order="F")
            for c in range(k):
                t = trees[it * k + c]
                leaf = leaf_of(it, c)
                sg = np.bincount(leaf, weights=g[:, c],
                                 minlength=t.num_leaves)
                sh = np.bincount(leaf, weights=h[:, c],
                                 minlength=t.num_leaves)
                sg_reg = np.sign(sg) * np.maximum(np.abs(sg) - l1, 0.0)
                new_out = -sg_reg / (sh + l2 + 1e-15) * t.shrinkage
                t.leaf_value = decay_rate * t.leaf_value + \
                    (1.0 - decay_rate) * new_out
                scores[:, c] += t.leaf_value[leaf]

    def refit(self, data: Any, label, decay_rate: Optional[float] = None,
              weight=None, group=None, **kwargs) -> "Booster":
        """Refit the leaf values of the existing trees on new data
        (reference GBDT::RefitTree gbdt.cpp:258, LGBM_BoosterRefit
        c_api.h:776): a new (loaded) Booster, the same structures, each
        leaf ``decay * old + (1 - decay) * new`` under the built-in
        objective (a loaded model's from its header).  The rows' leaves
        come from the host walk."""
        from .io.dataset import Metadata
        from .objectives import create_objective
        params = dict(self.params)
        if self._gbdt is None and self._loaded is not None:
            params = {**objective_string_to_params(self._loaded["objective"]),
                      **params}
        cfg = Config(params)
        if decay_rate is None:
            decay_rate = float(cfg.refit_decay_rate)
        X = np.asarray(data, np.float64)
        n = X.shape[0]
        md = Metadata(n)
        md.set_label(np.asarray(label, np.float64))
        if weight is not None:
            md.set_weight(weight)
        if group is not None:
            md.set_group(group)
        objective = create_objective(cfg)
        if objective is None:
            log.fatal("refit requires a built-in objective")
        # the booster's device, or for a loaded model the card unless
        # params say cpu
        device = self._gbdt.device if self._gbdt is not None else \
            resolve_device(self.params.get("device_type"))
        objective.init(md, n, device)
        new_booster = Booster(model_str=self.model_to_string(num_iteration=-1))
        new_booster.params = dict(self.params)
        trees = new_booster._loaded["trees"]
        k = max(1, new_booster._loaded["num_tree_per_iteration"])
        self._refit_trees(
            trees, k, objective, device,
            lambda it, c: trees[it * k + c].predict_leaf_index(X), n,
            decay_rate, float(cfg.lambda_l1), float(cfg.lambda_l2))
        return new_booster

    def refit_from_leaf_preds(self, leaf_preds: np.ndarray,
                              decay_rate: Optional[float] = None
                              ) -> "Booster":
        """Refit the leaf values in place from an [n, num_trees] leaf-index
        matrix of the training set (reference LGBM_BoosterRefit); the score
        caches are rebuilt from the refitted trees."""
        if self._gbdt is None:
            log.fatal("refit_from_leaf_preds needs a booster with training "
                      "state (use refit(data, label) on loaded models)")
        g = self._gbdt
        cfg = g.config
        if decay_rate is None:
            decay_rate = float(cfg.refit_decay_rate)
        trees = g.models
        k = max(1, g.num_tree_per_iteration)
        leaf_preds = np.asarray(leaf_preds)
        if leaf_preds.shape[1] != len(trees):
            log.fatal(f"leaf matrix has {leaf_preds.shape[1]} columns for "
                      f"{len(trees)} trees")
        if g.objective is None:
            log.fatal("refit requires a built-in objective")
        self._refit_trees(
            trees, k, g.objective, g.device,
            lambda it, c: leaf_preds[:, it * k + c], leaf_preds.shape[0],
            decay_rate, float(cfg.lambda_l1), float(cfg.lambda_l2))
        g.invalidate_score_cache()
        return self

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
        obj_str = objective_to_string(
            g.objective.NAME if g.objective is not None else "none",
            g.config)
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
