"""The port's sklearn estimators: the ten checks of tests/test_sklearn.py
on ``lightgbm_tpu_torch`` (on the CPU: ``device_type="cpu"``), and each
estimator's booster text equal to the JAX estimator's on the same data
(the batched int8 learner; binary and multiclass without leaf renewal,
where their gradients' ``exp`` may differ by an ulp)."""

import numpy as np
import pytest

import lightgbm_tpu as lgb_jax

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch import LGBMClassifier, LGBMRanker, LGBMRegressor
from lightgbm_tpu_torch.utils.log import LightGBMError

from test_torch_fused import one_torch_thread  # noqa: F401

CPU = dict(device_type="cpu")
FAST = dict(n_estimators=15, num_leaves=15, learning_rate=0.2,
            min_child_samples=5, max_bin=63, verbosity=0, **CPU)
INT8 = dict(n_estimators=4, num_leaves=15, max_bin=63, tpu_split_batch=4,
            use_quantized_grad=True, tpu_hist_dtype="int8",
            quant_train_renew_leaf=False, stochastic_rounding=False,
            hist_kernel="onehot", min_child_samples=5, verbosity=-1)


def test_classifier(synthetic_binary):
    X, y = synthetic_binary
    clf = LGBMClassifier(**FAST)
    clf.fit(X, y)
    acc = (clf.predict(X) == y).mean()
    assert acc > 0.85
    proba = clf.predict_proba(X)
    assert proba.shape == (len(y), 2)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=1e-6)
    assert clf.n_classes_ == 2
    assert len(clf.feature_importances_) == X.shape[1]


def test_classifier_multiclass():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(1200, 4))
    y = np.argmax(X[:, :3], axis=1)
    clf = LGBMClassifier(**FAST)
    clf.fit(X, y)
    assert clf.n_classes_ == 3
    assert (clf.predict(X) == y).mean() > 0.8
    assert clf.predict_proba(X).shape == (1200, 3)


def test_regressor(synthetic_regression):
    X, y = synthetic_regression
    reg = LGBMRegressor(**FAST)
    reg.fit(X, y)
    p = reg.predict(X)
    assert np.mean((p - y) ** 2) < 0.5 * np.var(y)


def test_ranker(synthetic_ranking):
    X, y, group = synthetic_ranking
    rk = LGBMRanker(**FAST)
    rk.fit(X, y, group=group)
    p = rk.predict(X)
    assert np.isfinite(p).all()
    with pytest.raises(LightGBMError):
        LGBMRanker(**FAST).fit(X, y)


def test_eval_set_early_stopping(synthetic_binary):
    X, y = synthetic_binary
    clf = LGBMClassifier(**{**FAST, "n_estimators": 100})
    clf.fit(X[:1500], y[:1500], eval_set=[(X[1500:], y[1500:])],
            eval_metric=["binary_logloss"], early_stopping_rounds=5)
    assert clf.best_iteration_ < 100


def test_get_set_params():
    clf = LGBMClassifier(num_leaves=7)
    assert clf.get_params()["num_leaves"] == 7
    clf.set_params(num_leaves=9, some_extra=1)
    assert clf.num_leaves == 9
    assert clf.get_params()["some_extra"] == 1


def test_fitted_attribute_surface(synthetic_binary):
    X, y = synthetic_binary
    clf = lgb.LGBMClassifier(n_estimators=20, num_leaves=15,
                             min_child_samples=5, verbose=-1, **CPU)
    clf.fit(X, y, eval_set=[(X[:300], y[:300])],
            eval_metric=["binary_logloss"], early_stopping_rounds=5)
    assert clf.n_features_in_ == X.shape[1]
    assert list(clf.feature_names_in_) == clf.feature_name_
    assert len(clf.feature_name_) == X.shape[1]
    er = clf.evals_result_
    (set_name, metrics), = er.items()
    assert "binary_logloss" in metrics
    assert len(metrics["binary_logloss"]) >= clf.best_iteration_
    assert clf.best_score_
    assert 0 < clf.n_estimators_ <= 20
    assert clf.n_iter_ == clf.n_estimators_
    assert clf.objective_ == "binary"


def test_booster_parity_accessors(synthetic_binary, tmp_path):
    X, y = synthetic_binary
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
         "verbose": -1, "metric": "binary_logloss", **CPU}
    ds = lgb.Dataset(X, label=y, params=p)
    dv = ds.create_valid(X[:400], label=y[:400])
    bst = lgb.train(p, ds, num_boost_round=6, valid_sets=[dv],
                    keep_training_booster=True)
    r1 = bst.eval(dv, "again")
    assert r1 and r1[0][0] == "again" and np.isfinite(r1[0][2])
    dfresh = ds.create_valid(X[400:800], label=y[400:800])
    r2 = bst.eval(dfresh, "fresh")
    assert r2 and np.isfinite(r2[0][2])
    raw = bst.predict(X, raw_score=True)
    assert raw.max() <= bst.upper_bound() + 1e-9
    assert raw.min() >= bst.lower_bound() - 1e-9
    v = bst.get_leaf_output(0, 0)
    bst.set_leaf_output(0, 0, v + 0.25)
    assert abs(bst.get_leaf_output(0, 0) - (v + 0.25)) < 1e-12
    imp = bst.feature_importance()
    f = int(np.argmax(imp))
    hist, edges = bst.get_split_value_histogram(f)
    assert hist.sum() > 0 and len(edges) == len(hist) + 1
    xgb = bst.get_split_value_histogram(f, xgboost_style=True)
    assert xgb.shape[1] == 2
    s = bst.model_to_string()
    other = lgb.Booster(model_str=s)
    other.model_from_string(s)
    np.testing.assert_allclose(other.predict(X[:50]), bst.predict(X[:50]),
                               rtol=1e-5, atol=1e-7)
    bst.set_train_data_name("train0")
    bst.free_dataset()
    assert bst.train_set is None


def test_dataset_parity_accessors(synthetic_binary):
    X, y = synthetic_binary
    p = {"objective": "binary", "max_bin": 31, "verbose": -1}
    w = np.linspace(0.5, 1.5, len(y))
    ds = lgb.Dataset(X, label=y, weight=w, params=p, free_raw_data=False)
    ds.construct()
    np.testing.assert_array_equal(ds.get_field("label"), y)
    np.testing.assert_allclose(ds.get_field("weight"), w)
    assert ds.get_params()["max_bin"] == 31
    assert ds.get_feature_name() == ds.feature_names
    assert np.shape(ds.get_data()) == X.shape
    assert 1 < ds.feature_num_bin(0) <= 31
    dv = ds.create_valid(X[:100], label=y[:100])
    dv.construct()
    chain = dv.get_ref_chain()
    assert ds in chain and dv in chain
    ds.set_field("weight", np.ones(len(y)))
    np.testing.assert_allclose(ds.get_field("weight"), 1.0)
    n = len(y)
    dq = lgb.Dataset(X, label=y, group=[n // 2, n - n // 2], params=p)
    dq.construct()
    qb = dq.get_field("group")
    assert qb[0] == 0 and qb[-1] == n and len(qb) == 3


def test_booster_eval_guard_and_loaded_eval(synthetic_binary):
    X, y = synthetic_binary
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
         "verbose": -1, "metric": "binary_logloss", **CPU}
    bst = lgb.train(p, lgb.Dataset(X, label=y, params=p),
                    num_boost_round=6, keep_training_booster=True)
    rogue = lgb.Dataset(X[:200] * 3.0 + 1.0, label=y[:200],
                        params={"max_bin": 7})
    with pytest.raises(LightGBMError):
        bst.eval(rogue, "rogue")
    loaded = lgb.Booster(model_str=bst.model_to_string())
    dv = lgb.Dataset(X[:400], label=y[:400], params=p, free_raw_data=False)
    res = loaded.eval(dv, "v")
    (nm, metric, val, hb), = res
    assert nm == "v" and metric == "binary_logloss"
    assert 0.0 < val < 0.7, val
    bst.set_train_data_name("train0")
    assert bst.eval_train()[0][0] == "train0"


def _head(bst):
    return bst.model_to_string().split("parameters:")[0]


@pytest.mark.parametrize("estimator", ["classifier", "multiclass",
                                       "regressor", "ranker",
                                       "classifier-eval-set"])
def test_estimator_text_matches_jax(estimator, synthetic_binary,
                                    synthetic_regression, synthetic_ranking):
    fit_kw = {}
    if estimator.startswith("classifier"):
        X, y = synthetic_binary
        y = np.where(y > 0, "yes", "no")
        name = "LGBMClassifier"
        if estimator == "classifier-eval-set":
            fit_kw = dict(eval_set=[(X[1500:], y[1500:])],
                          eval_metric="binary_logloss",
                          early_stopping_rounds=2)
            X, y = X[:1500], y[:1500]
    elif estimator == "multiclass":
        rng = np.random.default_rng(0)
        X = rng.normal(size=(1200, 4))
        y = np.argmax(X[:, :3], axis=1)
        name = "LGBMClassifier"
    elif estimator == "regressor":
        X, y = synthetic_regression
        name = "LGBMRegressor"
    else:
        X, y, group = synthetic_ranking
        fit_kw = dict(group=group)
        name = "LGBMRanker"
    params = dict(INT8, n_estimators=8) if estimator.endswith("eval-set") \
        else INT8
    ej = getattr(lgb_jax, name)(**params).fit(X, y, **fit_kw)
    et = getattr(lgb, name)(**params, **CPU).fit(X, y, **fit_kw)
    assert _head(et.booster_) == _head(ej.booster_)
    assert et.best_iteration_ == ej.best_iteration_
    np.testing.assert_allclose(et.predict(X, raw_score=True),
                               ej.predict(X, raw_score=True), rtol=1e-6,
                               atol=1e-7)
    if name == "LGBMClassifier":
        np.testing.assert_array_equal(et.predict(X), ej.predict(X))
        np.testing.assert_array_equal(et.classes_, ej.classes_)
        np.testing.assert_allclose(et.predict_proba(X), ej.predict_proba(X),
                                   rtol=1e-5, atol=1e-7)
        p1 = et.predict_proba(X)[:, -1]
        if et.n_classes_ == 2:
            np.testing.assert_array_equal(p1, et.booster_.predict(X))
    if fit_kw.get("eval_set"):
        assert et.evals_result_.keys() == ej.evals_result_.keys()
    np.testing.assert_array_equal(et.feature_importances_,
                                  ej.feature_importances_)


def test_estimators_need_a_card_unless_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.default_rng(0).normal(size=(200, 3))
    with pytest.raises(LightGBMError):
        LGBMRegressor(n_estimators=2, verbosity=-1).fit(X, X[:, 0])
    LGBMRegressor(n_estimators=2, verbosity=-1, **CPU).fit(X, X[:, 0])
