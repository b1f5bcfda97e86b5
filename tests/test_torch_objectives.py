"""The port's objectives and metrics against lightgbm_tpu on the CPU.

The same seeded numpy inputs go through both packages.

* gradients and hessians of every ported objective (with and without
  weights): bitwise where every operation is exactly rounded in both
  (``sign``, ``where``, ``+``, ``*``, ``/``); where an ``exp`` enters
  (poisson, gamma, tweedie, the sigmoid, softmax and softplus of the
  cross-entropies and the multiclass objectives), XLA's CPU ``exp`` and
  PyTorch's differ by an ulp on ~10% of inputs, so the difference is held
  to 1e-6 of the largest value (5e-6 for cross_entropy_lambda, whose
  hessian divides a cancellation by p^2); ``boost_from_score`` exactly,
  ``convert_output`` to rtol 1e-6, the l1 / quantile / MAPE leaf renewal
  bitwise;
* every ported metric's host evaluation on raw scores to rtol 1e-12, with
  its objective's float32 conversion to rtol 1e-6; the device evaluations
  (rmse, l1, binary_error, multi_logloss, multi_error) against the JAX
  package's ``eval_device_traced`` to rtol 1e-6; ``create_metrics``
  defaults;
* ``train()`` with every ported objective in both growers: the strict
  float32 learner (same splits, leaf values within rtol 1e-5 + atol 5e-5,
  as tests/test_torch_strict.py holds them) and the batched int8 learner
  forced as tests/test_torch_train.py forces it (model text equal where
  the gradients are bitwise, else the same splits and leaf values within
  rtol 1e-5, as binary is held there); multiclass under bagging, GOSS, RF
  and DART;
* multiclass through the fused loop: text equal to the classic loop's with
  a valid set, device ``multi_logloss`` and early stopping, at most one
  host read a class;
* multiclass model text both ways between the packages;
* the k > 1 repairs of ``GBDT.boosting_gradients`` and
  ``RF.boosting_gradients``.

The ranking objectives and metrics are held in tests/test_torch_rank.py.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lgb_jax
from lightgbm_tpu import metrics as JM
from lightgbm_tpu.boosting.gbdt import GBDT as JGBDT
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.learner import batch_grower as JBG
from lightgbm_tpu.objectives import create_objective as j_objective

import lightgbm_tpu_torch as lgb_torch
from lightgbm_tpu_torch import metrics as TM
from lightgbm_tpu_torch.boosting import gbdt as TG
from lightgbm_tpu_torch.boosting.rf import RF
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.learner import batch_grower as TBG
from lightgbm_tpu_torch.objectives import create_objective as t_objective

from test_torch_fused import (  # noqa: F401
    _train_port, fused_host_reads, one_torch_thread)

#: the batched int8 learner at a small size (tests/test_torch_train.py's
#: slice)
SLICE = dict(num_leaves=15, max_bin=63, tpu_split_batch=4,
             use_quantized_grad=True, tpu_hist_dtype="int8",
             quant_train_renew_leaf=True, stochastic_rounding=False,
             hist_kernel="onehot", verbosity=-1)
STRICT = dict(num_leaves=15, verbosity=-1)
N, NF, ROUNDS = 2000, 6, 3
OBJECTIVES = ("regression_l1", "huber", "fair", "poisson", "quantile", "mape",
              "gamma", "tweedie", "cross_entropy", "cross_entropy_lambda",
              "multiclass", "multiclassova")
#: objectives whose gradient ops are exactly rounded in both packages
EXACT = ("regression_l1", "huber", "fair", "quantile", "mape")
#: max |port - jax| / max |jax| of the gradients and hessians
GRAD_TOL = dict(dict.fromkeys(OBJECTIVES, 1e-6), cross_entropy_lambda=5e-6,
                **dict.fromkeys(EXACT, 0.0))


def _label(objective, z, rng):
    n = len(z)
    if objective.startswith("multiclass"):
        return np.digitize(z + 0.3 * rng.normal(size=n), [-0.5, 0.5]) \
            .astype(np.float64)
    if objective.startswith("cross_entropy"):
        return 1.0 / (1.0 + np.exp(-(2.0 * z + 0.5 * rng.normal(size=n))))
    if objective == "poisson":
        return rng.poisson(np.exp(0.5 * z)).astype(np.float64)
    if objective == "gamma":
        return rng.gamma(2.0, np.exp(0.3 * z) / 2.0)
    if objective == "tweedie":
        return np.where(rng.random(n) < 0.3, 0.0,
                        rng.gamma(2.0, np.exp(0.3 * z) / 2.0))
    return 2.0 * np.tanh(z) + 0.5 * rng.standard_t(3, size=n)


def _data(objective, n=N, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, NF))
    X[rng.random((n, NF)) < 0.05] = np.nan
    z = np.nansum(X[:, :3] * np.array([1.0, -0.7, 0.4]), axis=1)
    return X, _label(objective, z, rng)


def _params(objective, **extra):
    p = dict(objective=objective, **extra)
    if objective.startswith("multiclass"):
        p["num_class"] = 3
    return p


def _both(params):
    """The two packages' objectives of ``params``."""
    return (j_objective(JConfig(params)), t_objective(TConfig(params)))


def _ladder(monkeypatch):
    """The warm-up ladder from 1,024 rows in both packages."""
    monkeypatch.setattr(JBG, "_WARMUP_MIN_ROWS", 1024)
    monkeypatch.setattr(TBG, "_WARMUP_MIN_ROWS", 1024)


# ------------------------------------------------------------- objectives

@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weights"])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_gradients_match_jax(objective, weighted):
    rng = np.random.default_rng(1)
    n = 3000
    _, y = _data(objective, n=n)
    w = rng.random(n) + 0.5 if weighted else None
    md = types.SimpleNamespace(label=y, weight=w)
    jo, to = _both(_params(objective))
    jo.init(md, n)
    to.init(md, n)
    k = to.num_model_per_iteration
    assert k == jo.num_model_per_iteration == (3 if objective.startswith(
        "multiclass") else 1)
    shape = (n, k) if k > 1 else (n,)
    score = rng.normal(size=shape).astype(np.float32)
    gj, hj = jo.jitted_gradients(jnp.asarray(score))
    gt, ht = to.get_gradients(torch.as_tensor(score))
    tol = GRAD_TOL[objective]
    for got, want in ((gt, gj), (ht, hj)):
        got, want = got.numpy(), np.asarray(want)
        assert got.dtype == np.float32 and got.shape == shape
        if tol == 0.0:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= tol * np.abs(want).max()
    for c in range(k):
        assert to.boost_from_score(c) == jo.boost_from_score(c)
    assert to.need_convert_output == jo.need_convert_output
    assert to.is_constant_hessian == jo.is_constant_hessian
    assert to.need_renew_tree_output == jo.need_renew_tree_output
    np.testing.assert_allclose(
        to.convert_output(torch.as_tensor(score)).numpy(),
        np.asarray(jo.convert_output(jnp.asarray(score))), rtol=1e-6)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weights"])
@pytest.mark.parametrize("objective", ["regression_l1", "quantile", "mape"])
def test_renew_tree_output_matches_jax(objective, weighted):
    rng = np.random.default_rng(2)
    n, L = 3000, 9
    _, y = _data(objective, n=n)
    w = rng.random(n) + 0.5 if weighted else None
    md = types.SimpleNamespace(label=y, weight=w)
    params = _params(objective, alpha=0.3)
    jo, to = _both(params)
    jo.init(md, n)
    to.init(md, n)
    score = rng.normal(size=n).astype(np.float32).astype(np.float64)
    lor = rng.integers(0, L - 1, n)       # leaf L - 1 stays empty
    got = to.renew_tree_output(score, None, lor, L)
    want = jo.renew_tree_output(score, None, lor, L)
    np.testing.assert_array_equal(got, want)
    assert got[L - 1] == 0.0


# ---------------------------------------------------------------- metrics

#: every ported metric with an objective that converts its scores
METRICS = {"l2": "regression", "rmse": "regression", "l1": "regression_l1",
           "quantile": "quantile", "huber": "huber", "fair": "fair",
           "poisson": "poisson", "mape": "mape", "gamma": "gamma",
           "gamma_deviance": "gamma", "tweedie": "tweedie",
           "binary_logloss": "binary", "binary_error": "binary",
           "auc": "binary", "average_precision": "binary",
           "multi_logloss": "multiclass", "multi_error": "multiclass",
           "auc_mu": "multiclass", "cross_entropy": "cross_entropy",
           "cross_entropy_lambda": "cross_entropy_lambda",
           "kullback_leibler": "cross_entropy"}
DEVICE = ("l2", "rmse", "l1", "binary_logloss", "binary_error", "auc",
          "multi_logloss", "multi_error")


def _metric_case(name, objective, weighted, seed=3):
    """(label, weight, raw scores, positive 'predictions') of a metric."""
    rng = np.random.default_rng(seed)
    n = 4000
    k = 3 if objective.startswith("multiclass") else 1
    if objective == "binary":
        y = (rng.random(n) < 0.4).astype(np.float64)
    else:
        _, y = _data(objective, n=n, seed=seed)
    w = rng.random(n) + 0.5 if weighted else None
    # rounded: ties for AUC's half-credit groups and the top-k ranks
    raw = np.round(rng.normal(size=(n, k) if k > 1 else n), 2) \
        .astype(np.float32)
    return y, w, raw


def _metric_pair(name, objective, y, w, n, **cfg):
    params = dict(_params(objective), metric=name, **cfg)
    tm = {m.NAME: m for m in TM.create_metrics(TConfig(params))}[name]
    jm = {m.NAME: m for m in JM.create_metrics(JConfig(params))}[name]
    md = types.SimpleNamespace(label=y, weight=w)
    tm.init(md, n)
    jm.init(md, n)
    return tm, jm, params


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weights"])
@pytest.mark.parametrize("name", sorted(METRICS))
def test_host_metrics_match_jax(name, weighted):
    objective = METRICS[name]
    y, w, raw = _metric_case(name, objective, weighted)
    tm, jm, params = _metric_pair(name, objective, y, w, len(y))
    assert tm.display_names() == jm.display_names()
    assert tm.bigger_is_better == jm.bigger_is_better
    # raw scores, no conversion: float64 numpy in both
    score = raw.astype(np.float64)
    if name in ("poisson", "gamma", "gamma_deviance", "tweedie"):
        score = np.abs(score) + 0.1
    if name in ("cross_entropy", "kullback_leibler", "binary_logloss"):
        score = 1.0 / (1.0 + np.exp(-score))
    got, want = tm.eval(score, None), jm.eval(score, None)
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-12, atol=0)
    # through the objective's float32 conversion (an ulp of exp apart)
    to = t_objective(TConfig(params))
    jo = j_objective(JConfig(params))
    got = tm.eval(raw.astype(np.float64), to)
    want = jm.eval(raw.astype(np.float64), jo)
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weights"])
@pytest.mark.parametrize("name,objective",
                         [(m, METRICS[m]) for m in DEVICE]
                         + [("multi_logloss", "multiclassova"),
                            ("multi_logloss", None), ("multi_error", None)])
def test_device_metrics_match_jax(name, objective, weighted):
    y, w, raw = _metric_case(name, objective or "multiclass", weighted)
    cfg = {"multi_error_top_k": 2} if objective is None else {}
    tm, jm, params = _metric_pair(name, objective or "multiclass", y, w,
                                  len(y), **cfg)
    assert tm.has_device_eval()
    assert tm._DEV_MULTI == jm._DEV_MULTI == (name.startswith("multi"))
    to = None if objective is None else t_objective(TConfig(params))
    jo = None if objective is None else j_objective(JConfig(params))
    vt = tm.eval_device_traced(torch.as_tensor(raw), to)
    vj = jm.eval_device_traced(jnp.asarray(raw), jo)
    assert vt.dtype == torch.float32 and tuple(vt.shape) == (1,)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-6)


def test_host_only_metrics_have_no_device_eval():
    for name in sorted(set(METRICS) - set(DEVICE)):
        tm = TM.create_metrics(TConfig(dict(_params(METRICS[name]),
                                            metric=name)))[0]
        assert not tm.has_device_eval(), name


@pytest.mark.parametrize("objective", OBJECTIVES + ("regression", "binary"))
def test_create_metrics_defaults_match_jax(objective):
    params = _params(objective)
    names_t = [m.NAME for m in TM.create_metrics(TConfig(params))]
    names_j = [m.NAME for m in JM.create_metrics(JConfig(params))]
    assert names_t == names_j and len(names_t) == 1
    explicit = dict(params, metric=["rmse", "l1", "binary_error", "auc_mu"])
    assert [m.NAME for m in TM.create_metrics(TConfig(explicit))] == \
        [m.NAME for m in JM.create_metrics(JConfig(explicit))]


# ------------------------------------------------------------------ train

def _loop_spy(monkeypatch):
    calls = []
    real = JGBDT.train_fused

    def spy(gb, *a, **k):
        calls.append(1)
        return real(gb, *a, **k)

    monkeypatch.setattr(JGBDT, "train_fused", spy)
    return calls


def _assert_trees_match(bt, bj, exact):
    """Model text equal (``exact``), else the same trees: split features,
    bins, decision types and leaf counts equal, leaf values within rtol
    1e-5 + atol 5e-5."""
    if exact:
        assert bt.model_to_string().split("parameters:")[0] == \
            bj.model_to_string().split("parameters:")[0]
        return
    for tt, tj in zip(bt._gbdt.models, bj._gbdt.models, strict=True):
        assert tt.num_leaves == tj.num_leaves
        np.testing.assert_array_equal(tt.split_feature, tj.split_feature)
        np.testing.assert_array_equal(tt.threshold_bin, tj.threshold_bin)
        np.testing.assert_array_equal(tt.decision_type, tj.decision_type)
        np.testing.assert_array_equal(tt.leaf_count, tj.leaf_count)
        np.testing.assert_allclose(tt.leaf_value, tj.leaf_value, rtol=1e-5,
                                   atol=5e-5)


#: objectives whose int8 model text equals the JAX package's byte for
#: byte: exact gradients and a constant hessian (leaf renewal then divides
#: integer-valued sums)
TEXT_EQUAL = ("regression_l1", "huber", "quantile", "mape")


@pytest.mark.parametrize("grower", ["strict", "int8"])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_train_matches_jax(objective, grower, monkeypatch):
    X, y = _data(objective)
    params = _params(objective, **(STRICT if grower == "strict" else SLICE))
    jcalls = _loop_spy(monkeypatch)
    bj = lgb_jax.train(params, lgb_jax.Dataset(X, y),
                       num_boost_round=ROUNDS)
    fused = bool(jcalls)
    monkeypatch.undo()
    bt = _train_port(params, X, y, ROUNDS, monkeypatch,
                     classic=not fused)
    g = bt._gbdt
    assert g._use_batched_grower() == (grower == "int8")
    assert g.supports_fused() == bj._gbdt.supports_fused()
    if objective in ("regression_l1", "quantile", "mape"):
        assert not fused
    k = g.num_tree_per_iteration
    assert bt.num_trees() == bj.num_trees() == ROUNDS * k
    assert sum(t.num_leaves > 2 for t in g.models) >= ROUNDS * k - 1
    _assert_trees_match(bt, bj, grower == "int8"
                        and objective in TEXT_EQUAL)
    Xt = np.random.default_rng(9).normal(size=(500, NF))
    pt, pj = bt.predict(Xt), bj.predict(Xt)
    assert pt.shape == pj.shape == ((500, k) if k > 1 else (500,))
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-5)


#: multiclass under the boosting modes: (extra params, loop of both)
MODES = {
    "bagging": (dict(bagging_fraction=0.7, bagging_freq=1), "fused"),
    "goss": (dict(data_sample_strategy="goss", learning_rate=0.5), "fused"),
    "pos-neg": (dict(pos_bagging_fraction=0.6, neg_bagging_fraction=0.8,
                     bagging_freq=1), "fused"),
    "rf": (dict(boosting="rf", bagging_fraction=0.7, bagging_freq=1),
           "classic"),
    "dart": (dict(boosting="dart", drop_rate=0.5, skip_drop=0.0),
             "classic"),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_multiclass_modes_match_jax(mode, monkeypatch):
    extra, loop = MODES[mode]
    X, y = _data("multiclass")
    params = _params("multiclass", **SLICE, **extra)
    jcalls = _loop_spy(monkeypatch)
    bj = lgb_jax.train(params, lgb_jax.Dataset(X, y), num_boost_round=4)
    assert bool(jcalls) == (loop == "fused")
    monkeypatch.undo()
    bt = _train_port(params, X, y, 4, monkeypatch,
                     classic=(loop == "classic"))
    assert type(bt._gbdt).__name__ == type(bj._gbdt).__name__
    _assert_trees_match(bt, bj, False)
    if loop == "fused":
        classic = _train_port(params, X, y, 4, monkeypatch, classic=True)
        assert bt.model_to_string() == classic.model_to_string()


def test_rf_multiclass_gradients_take_every_class():
    """RF hands the objective the whole [n, k] score copy (column 0 only
    before: the softmax then saw one class)."""
    X, y = _data("multiclass")
    params = _params("multiclass", **SLICE, boosting="rf",
                     bagging_fraction=0.7, bagging_freq=1,
                     device_type="cpu")
    b = lgb_torch.Booster(params=params, train_set=lgb_torch.Dataset(X, y))
    g = b._gbdt
    assert isinstance(g, RF)
    gr, hr = g.boosting_gradients()
    want = g.objective.get_gradients(g._grad_scores)
    assert gr.shape == (N, 3)
    torch.testing.assert_close(gr, want[0], rtol=0, atol=0)
    torch.testing.assert_close(hr, want[1], rtol=0, atol=0)


def test_rf_multiclass_evaluations_match_jax():
    """RF's multiclass valid metrics are the JAX package's: on the host,
    with the running average over the trees so far."""
    X, y = _data("multiclass")
    Xv, yv = _data("multiclass", n=600, seed=4)
    params = _params("multiclass", **SLICE, boosting="rf",
                     bagging_fraction=0.7, bagging_freq=1,
                     metric=["multi_logloss", "multi_error"])
    res = {}
    for name, lgb, extra in (("jax", lgb_jax, {}),
                             ("port", lgb_torch, {"device_type": "cpu"})):
        rec = {}
        ds = lgb.Dataset(X, y)
        lgb.train(dict(params, **extra), ds, num_boost_round=4,
                  valid_sets=[ds.create_valid(Xv, yv)], valid_names=["v"],
                  callbacks=[lgb.record_evaluation(rec)])
        res[name] = rec["v"]
    for metric in ("multi_logloss", "multi_error"):
        np.testing.assert_allclose(res["port"][metric], res["jax"][metric],
                                   rtol=1e-6)


def test_gbdt_multiclass_gradients_take_every_class():
    X, y = _data("multiclassova")
    b = lgb_torch.Booster(params=_params("multiclassova", **STRICT,
                                         device_type="cpu"),
                          train_set=lgb_torch.Dataset(X, y))
    g = b._gbdt
    g.scores += torch.randn(g.scores.shape, generator=torch.Generator()
                            .manual_seed(0))
    gr, hr = g.boosting_gradients()
    want = g.objective.get_gradients(g.scores)
    assert gr.shape == hr.shape == (N, 3)
    torch.testing.assert_close(gr, want[0], rtol=0, atol=0)
    torch.testing.assert_close(hr, want[1], rtol=0, atol=0)


# ------------------------------------------------------- the fused loop

@pytest.mark.parametrize("objective,lr", [("multiclass", 0.3),
                                          ("multiclassova", 0.8)])
def test_multiclass_fused_matches_classic(objective, lr, monkeypatch):
    """k trees a round through the fused loop with a valid set, device
    multi_logloss / multi_error and early stopping (multi_error stalls
    first): text, best iteration and recorded evaluations equal the
    classic loop's; the JAX package stops at the same iteration."""
    X, y = _data(objective, n=6000)
    Xv, yv = _data(objective, n=1500, seed=5)
    params = _params(objective, num_leaves=31, tpu_split_batch=16,
                     use_quantized_grad=True, tpu_hist_dtype="int8",
                     quant_train_renew_leaf=True, tpu_rows_per_block=1024,
                     learning_rate=lr, verbosity=-1,
                     metric=["multi_logloss", "multi_error"])
    _ladder(monkeypatch)
    out = {}
    for name, lgb, extra, classic in (
            ("fused", lgb_torch, {"device_type": "cpu"}, False),
            ("classic", lgb_torch, {"device_type": "cpu"}, True),
            ("jax", lgb_jax, {}, False)):
        if classic:
            monkeypatch.setattr(TG.GBDT, "supports_fused",
                                lambda self: False)
        rec = {}
        ds = lgb.Dataset(X, y)
        b = lgb.train(dict(params, **extra), ds, num_boost_round=8,
                      valid_sets=[ds.create_valid(Xv, yv)],
                      valid_names=["v"],
                      callbacks=[lgb.early_stopping(2, verbose=False),
                                 lgb.record_evaluation(rec)])
        out[name] = (b, rec["v"])
        monkeypatch.undo()
        _ladder(monkeypatch)
    (bf, rf), (bc, rc), (bj, rj) = out["fused"], out["classic"], out["jax"]
    assert bf._gbdt._fused_cache and not bc._gbdt._fused_cache
    assert len(rf["multi_error"]) < 8          # stopped early
    assert bf.model_to_string() == bc.model_to_string()
    assert bf.best_iteration == bc.best_iteration == bj.best_iteration
    assert rf == rc
    np.testing.assert_allclose(rf["multi_logloss"], rj["multi_logloss"],
                               rtol=1e-5)
    np.testing.assert_array_equal(rf["multi_error"], rj["multi_error"])


def test_multiclass_fused_reads_one_flag_a_class(monkeypatch):
    params = _params("multiclass", num_leaves=31, tpu_split_batch=16,
                     use_quantized_grad=True, tpu_hist_dtype="int8",
                     quant_train_renew_leaf=True, tpu_rows_per_block=1024,
                     verbosity=-1, device_type="cpu",
                     metric="multi_logloss")
    X, y = _data("multiclass", n=6000)
    Xv, yv = _data("multiclass", n=1500, seed=3)
    _ladder(monkeypatch)
    reads, rounds, extra = fused_host_reads(monkeypatch, params, X, y, Xv,
                                            yv, 3)
    assert rounds == 3
    assert reads["body"] == 0
    assert reads["step"] <= 3 * (rounds + extra)


def test_multiclass_stump_round_ends_training(monkeypatch):
    """A round of k stumps ends training in both loops, the stumps kept."""
    X, y = _data("multiclass", n=3000)
    params = _params("multiclass", **SLICE, min_gain_to_split=1e9)
    fused = _train_port(params, X, y, 5, monkeypatch)
    classic = _train_port(params, X, y, 5, monkeypatch, classic=True)
    assert fused.num_trees() == classic.num_trees() == 3
    assert fused.model_to_string() == classic.model_to_string()


# ------------------------------------------------------------ model text

@pytest.mark.parametrize("objective", ["multiclass", "multiclassova",
                                       "poisson", "cross_entropy_lambda"])
def test_model_text_loads_both_ways(objective):
    """Each package's model text loads in the other and predicts the same
    converted outputs (host float64 walks); the trained booster's own
    predict (float32 conversion) agrees to 1e-6."""
    X, y = _data(objective)
    params = _params(objective, **SLICE)
    bt = lgb_torch.train(dict(params, device_type="cpu"),
                         lgb_torch.Dataset(X, y), num_boost_round=ROUNDS)
    bj = lgb_jax.train(params, lgb_jax.Dataset(X, y),
                       num_boost_round=ROUNDS)
    Xt = np.random.default_rng(9).normal(size=(300, NF))
    for text in (bt.model_to_string(), bj.model_to_string()):
        pt = lgb_torch.Booster(model_str=text).predict(Xt)
        pj = lgb_jax.Booster(model_str=text).predict(Xt)
        np.testing.assert_allclose(pt, pj, rtol=1e-12, atol=0)
    loaded = lgb_torch.Booster(model_str=bt.model_to_string()).predict(Xt)
    np.testing.assert_allclose(bt.predict(Xt), loaded, rtol=1e-6, atol=1e-7)
    if objective.startswith("multiclass"):
        assert loaded.shape == (300, 3)
