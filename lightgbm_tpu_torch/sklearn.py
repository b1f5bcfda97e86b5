"""scikit-learn estimator API.

Counterpart of ``lightgbm_tpu/sklearn.py`` (reference
python-package/lightgbm/sklearn.py — ``LGBMModel`` :486, ``LGBMRegressor``
:1285, ``LGBMClassifier`` :1344, ``LGBMRanker`` :1547): the same
constructor surface and fit / predict semantics, on ``engine.train`` (the
fused round loop where it may run: the estimators' callbacks are
``early_stopping`` and ``record_evaluation``).  scikit-learn itself is not
needed: the estimators duck-type its ``get_params`` / ``set_params``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .callback import early_stopping as early_stopping_cb
from .engine import train as _train
from .utils import log


class LGBMModel:
    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[str] = None, class_weight=None,
                 min_split_gain: float = 0.0, min_child_weight: float = 1e-3,
                 min_child_samples: int = 20, subsample: float = 1.0,
                 subsample_freq: int = 0, colsample_bytree: float = 1.0,
                 reg_alpha: float = 0.0, reg_lambda: float = 0.0,
                 random_state=None, n_jobs: int = -1,
                 importance_type: str = "split", **kwargs: Any):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.importance_type = importance_type
        self._other_params = dict(kwargs)
        self._Booster: Optional[Booster] = None
        self._n_classes = 1

    _default_objective = "regression"

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = {
            "boosting_type": self.boosting_type, "num_leaves": self.num_leaves,
            "max_depth": self.max_depth, "learning_rate": self.learning_rate,
            "n_estimators": self.n_estimators,
            "subsample_for_bin": self.subsample_for_bin,
            "objective": self.objective, "class_weight": self.class_weight,
            "min_split_gain": self.min_split_gain,
            "min_child_weight": self.min_child_weight,
            "min_child_samples": self.min_child_samples,
            "subsample": self.subsample, "subsample_freq": self.subsample_freq,
            "colsample_bytree": self.colsample_bytree,
            "reg_alpha": self.reg_alpha, "reg_lambda": self.reg_lambda,
            "random_state": self.random_state, "n_jobs": self.n_jobs,
            "importance_type": self.importance_type,
        }
        params.update(self._other_params)
        return params

    def set_params(self, **params: Any) -> "LGBMModel":
        for k, v in params.items():
            if hasattr(self, k):
                setattr(self, k, v)
            else:
                self._other_params[k] = v
        return self

    def _train_params(self) -> Dict[str, Any]:
        p = self.get_params()
        p.pop("n_estimators", None)
        p.pop("class_weight", None)
        p.pop("importance_type", None)
        p.pop("n_jobs", None)
        obj = p.pop("objective", None) or self._default_objective
        p["objective"] = obj
        p["boosting"] = p.pop("boosting_type", "gbdt")
        p["num_leaves"] = self.num_leaves
        p["bagging_fraction"] = p.pop("subsample", 1.0)
        p["bagging_freq"] = p.pop("subsample_freq", 0)
        p["feature_fraction"] = p.pop("colsample_bytree", 1.0)
        p["lambda_l1"] = p.pop("reg_alpha", 0.0)
        p["lambda_l2"] = p.pop("reg_lambda", 0.0)
        p["min_gain_to_split"] = p.pop("min_split_gain", 0.0)
        p["min_sum_hessian_in_leaf"] = p.pop("min_child_weight", 1e-3)
        p["min_data_in_leaf"] = p.pop("min_child_samples", 20)
        p["bin_construct_sample_cnt"] = p.pop("subsample_for_bin", 200000)
        if p.pop("random_state", None) is not None:
            p["seed"] = self.random_state
        return {k: v for k, v in p.items() if v is not None}

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_group=None, eval_metric=None, early_stopping_rounds=None,
            feature_name="auto", categorical_feature="auto",
            callbacks=None) -> "LGBMModel":
        params = self._train_params()
        if eval_metric:
            params["metric"] = eval_metric
        if self.class_weight is not None and sample_weight is None:
            sample_weight = self._class_weights_to_sample_weight(y)
        train_ds = Dataset(X, label=y, weight=sample_weight,
                           init_score=init_score, group=group,
                           feature_name=feature_name,
                           categorical_feature=categorical_feature,
                           params={k: v for k, v in params.items()})
        valid_sets: List[Dataset] = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                w = eval_sample_weight[i] if eval_sample_weight else None
                g = eval_group[i] if eval_group else None
                valid_sets.append(train_ds.create_valid(vx, label=vy, weight=w,
                                                        group=g))
        callbacks = list(callbacks or [])
        if early_stopping_rounds:
            callbacks.append(early_stopping_cb(early_stopping_rounds))
        self._evals_result: Dict[str, Dict[str, List[float]]] = {}
        if valid_sets:
            from .callback import record_evaluation
            callbacks.append(record_evaluation(self._evals_result))
        self._Booster = _train(params, train_ds,
                               num_boost_round=self.n_estimators,
                               valid_sets=valid_sets, valid_names=eval_names,
                               callbacks=callbacks)
        self._n_features = X.shape[1] if hasattr(X, "shape") else \
            len(X[0])
        return self

    def _class_weights_to_sample_weight(self, y) -> np.ndarray:
        y = np.asarray(y)
        if self.class_weight == "balanced":
            classes, counts = np.unique(y, return_counts=True)
            w = {c: len(y) / (len(classes) * cnt)
                 for c, cnt in zip(classes, counts)}
        else:
            w = dict(self.class_weight)
        return np.asarray([w.get(v, 1.0) for v in y], np.float64)

    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs) -> np.ndarray:
        if self._Booster is None:
            raise RuntimeError("Estimator not fitted")
        return self._Booster.predict(X, raw_score=raw_score,
                                     start_iteration=start_iteration,
                                     num_iteration=num_iteration,
                                     pred_leaf=pred_leaf,
                                     pred_contrib=pred_contrib)

    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise RuntimeError("Estimator not fitted")
        return self._Booster

    @property
    def best_iteration_(self) -> int:
        return self.booster_.best_iteration

    @property
    def feature_importances_(self) -> np.ndarray:
        return self.booster_.feature_importance(self.importance_type)

    @property
    def n_features_(self) -> int:
        return self._n_features

    @property
    def n_features_in_(self) -> int:
        """sklearn-convention alias (reference LGBMModel.n_features_in_)."""
        return self._n_features

    @property
    def best_score_(self):
        """reference LGBMModel.best_score_."""
        return dict(self.booster_.best_score)

    @property
    def evals_result_(self):
        """Per-iteration eval history recorded during fit (reference
        LGBMModel.evals_result_; empty when fit ran without eval_set)."""
        if getattr(self, "_evals_result", None) is None:
            raise RuntimeError("Estimator not fitted")
        return self._evals_result

    @property
    def feature_name_(self) -> List[str]:
        return self.booster_.feature_name()

    @property
    def feature_names_in_(self) -> np.ndarray:
        """sklearn-convention array form (reference
        LGBMModel.feature_names_in_)."""
        return np.asarray(self.booster_.feature_name())

    @property
    def n_estimators_(self) -> int:
        """Actual fitted tree rounds (reference LGBMModel.n_estimators_:
        best_iteration when early stopping fired, else all rounds)."""
        return int(self.booster_.best_iteration
                   if self.booster_.best_iteration > 0
                   else self.booster_.current_iteration())
    n_iter_ = n_estimators_

    @property
    def objective_(self) -> str:
        """Resolved objective of the fitted model (reference
        LGBMModel.objective_)."""
        from .config import resolve_objective_alias
        return resolve_objective_alias(
            self.objective or self._default_objective)


class LGBMRegressor(LGBMModel):
    _default_objective = "regression"


class LGBMClassifier(LGBMModel):
    _default_objective = "binary"

    def fit(self, X, y, **kwargs):
        y = np.asarray(y)
        self._classes = np.unique(y)
        self._n_classes = len(self._classes)
        if self._n_classes > 2:
            self.objective = self.objective or "multiclass"
            self._other_params["num_class"] = self._n_classes
        y_enc = np.searchsorted(self._classes, y)
        eval_set = kwargs.get("eval_set")
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            kwargs["eval_set"] = [
                (vx, np.searchsorted(self._classes, np.asarray(vy)))
                for vx, vy in eval_set]
        return super().fit(X, y_enc, **kwargs)

    def predict(self, X, raw_score: bool = False, **kwargs):
        res = super().predict(X, raw_score=raw_score, **kwargs)
        if raw_score or kwargs.get("pred_leaf") or kwargs.get("pred_contrib"):
            return res
        if self._n_classes > 2:
            return self._classes[np.argmax(res, axis=1)]
        return self._classes[(res > 0.5).astype(int)]

    def predict_proba(self, X, **kwargs) -> np.ndarray:
        res = super().predict(X, **kwargs)
        if self._n_classes > 2:
            return res
        return np.stack([1.0 - res, res], axis=1)

    @property
    def classes_(self):
        return self._classes

    @property
    def n_classes_(self) -> int:
        return self._n_classes


class LGBMRanker(LGBMModel):
    _default_objective = "lambdarank"

    def fit(self, X, y, group=None, **kwargs):
        if group is None:
            log.fatal("Should set group for ranking task")
        return super().fit(X, y, group=group, **kwargs)
