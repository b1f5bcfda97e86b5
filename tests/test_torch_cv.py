"""The port's ``cv`` and ``CVBooster`` against lightgbm_tpu on the CPU.

The same seeded numpy inputs go through both packages' ``cv``: regression
(plain shuffled folds), stratified binary, ranking (whole-query folds with
each fold's groups), custom folds with a custom metric and
``eval_train_metric``, multiclass, early stopping (every curve cut at the
best mean round, ``CVBooster.best_iteration``) and ``return_cvbooster``.
The folds are made from ``np.random.default_rng(seed)`` in both, so the
result dicts must match key for key, every value within 1e-6 (relative and
absolute).  The learners are the batched int8 slice (model text equal to
the JAX package's for exact gradients, as tests/test_torch_train.py holds
it) and the strict float32 learner.  Also: each fold's captured rounds are
released when its training ends, a fold booster is kept only with
``return_cvbooster``, and ``log_evaluation`` prints cv's deviations.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb_jax

import lightgbm_tpu_torch as lgb_torch
from lightgbm_tpu_torch import engine as TE
from lightgbm_tpu_torch.utils import log as TLOG

from test_torch_fused import one_torch_thread  # noqa: F401

N, NF = 1500, 6
INT8 = dict(num_leaves=15, max_bin=63, tpu_split_batch=4,
            use_quantized_grad=True, tpu_hist_dtype="int8",
            quant_train_renew_leaf=True, stochastic_rounding=False,
            hist_kernel="onehot", verbosity=-1)
STRICT = dict(num_leaves=15, verbosity=-1)
CPU = dict(device_type="cpu")


def _data(kind, n=N, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, NF))
    z = X[:, :3] @ np.array([1.0, -0.7, 0.4])
    if kind == "binary":
        y = (z + 0.5 * rng.normal(size=n) > 0).astype(np.float64)
    elif kind == "multiclass":
        y = np.digitize(z + 0.3 * rng.normal(size=n),
                        [-0.5, 0.5]).astype(np.float64)
    elif kind == "ranking":
        y = np.clip(np.round(z + 1.5 + 0.5 * rng.normal(size=n)), 0, 4)
    else:
        y = 2.0 * np.tanh(z) + 0.5 * rng.normal(size=n)
    return X, y


def _both_cv(params, kind, ds_kw=None, **kw):
    """(port result, JAX result) of one ``cv`` call."""
    X, y = _data(kind)
    out = []
    for lgb, extra in ((lgb_torch, CPU), (lgb_jax, {})):
        ds = lgb.Dataset(X, y, free_raw_data=False, **(ds_kw or {}))
        call = dict(kw)
        if "callbacks" in call:
            call["callbacks"] = call["callbacks"](lgb)
        out.append(lgb.cv(dict(params, **extra), ds, **call))
    return out


def assert_results_match(rt, rj, tol=1e-6):
    assert sorted(k for k in rt if k != "cvbooster") == \
        sorted(k for k in rj if k != "cvbooster")
    for key in rj:
        if key == "cvbooster":
            continue
        assert len(rt[key]) == len(rj[key]), key
        np.testing.assert_allclose(rt[key], rj[key], rtol=tol, atol=tol,
                                   err_msg=key)


CASES = {
    "regression": (dict(INT8, objective="regression", metric="l2"),
                   "regression", None,
                   dict(num_boost_round=6, nfold=3, seed=3)),
    "binary-stratified": (dict(INT8, objective="binary",
                               metric=["binary_logloss", "auc"]),
                          "binary", None,
                          dict(num_boost_round=5, nfold=4, seed=7)),
    "binary-strict": (dict(STRICT, objective="binary",
                           metric="binary_error"),
                      "binary", None,
                      dict(num_boost_round=4, nfold=3, stratified=False)),
    "multiclass": (dict(INT8, objective="multiclass", num_class=3,
                        metric="multi_logloss"),
                   "multiclass", None,
                   dict(num_boost_round=3, nfold=3, seed=1)),
    "ranking": (dict(INT8, objective="lambdarank", metric="ndcg",
                     eval_at=[3, 5]),
                "ranking", dict(group=np.full(30, N // 30)),
                dict(num_boost_round=4, nfold=3, seed=2)),
    "unshuffled": (dict(INT8, objective="regression", metric="l1"),
                   "regression", None,
                   dict(num_boost_round=3, nfold=5, shuffle=False)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cv_matches_jax(case):
    params, kind, ds_kw, kw = CASES[case]
    rt, rj = _both_cv(params, kind, ds_kw, **kw)
    assert_results_match(rt, rj)
    n_rounds = kw["num_boost_round"]
    assert all(len(v) == n_rounds for v in rt.values())
    assert any(k.startswith("valid ") and k.endswith("-stdv") for k in rt)


def _feval_mae(preds, ds):
    return "custom_mae", float(np.mean(np.abs(preds - ds.get_label()))), \
        False


def test_cv_custom_folds_feval_and_train_metric():
    n = N
    idx = np.arange(n)
    folds = [(idx[: n // 2], idx[n // 2:]), (idx[n // 2:], idx[: n // 2])]
    rt, rj = _both_cv(dict(INT8, objective="regression", metric="l2"),
                      "regression", folds=folds, num_boost_round=5,
                      feval=_feval_mae, eval_train_metric=True)
    assert_results_match(rt, rj)
    for key in ("valid l2-mean", "train l2-mean", "valid custom_mae-mean",
                "train custom_mae-stdv"):
        assert len(rt[key]) == 5
    assert rt["valid l2-mean"][-1] < rt["valid l2-mean"][0]


def test_cv_early_stopping_truncates_to_best():
    """Early stopping in the folds cuts every curve at the best round of
    the mean curve and sets ``CVBooster.best_iteration``; the fold
    boosters come back with ``return_cvbooster``."""
    rt, rj = _both_cv(
        dict(INT8, objective="regression", metric="l2", learning_rate=0.5),
        "regression", num_boost_round=60, nfold=3, seed=2,
        callbacks=lambda lgb: [lgb.early_stopping(3, verbose=False)],
        return_cvbooster=True)
    assert_results_match(rt, rj)
    curve = rt["valid l2-mean"]
    assert len(curve) < 60
    assert rt["cvbooster"].best_iteration == \
        rj["cvbooster"].best_iteration == len(curve)
    assert curve[-1] == min(curve)
    cvb = rt["cvbooster"]
    assert isinstance(cvb, TE.CVBooster) and len(cvb.boosters) == 3
    X, _ = _data("regression", 50, seed=9)
    pt = np.asarray(cvb.predict(X))
    pj = np.asarray(rj["cvbooster"].predict(X))
    assert pt.shape == pj.shape == (3, 50)
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-6)


def test_cv_releases_each_fold(monkeypatch):
    """A fold's captured rounds are dropped when its training ends, and
    its booster is kept only with ``return_cvbooster``."""
    X, y = _data("binary")
    kept = []
    real = TE.train

    def spy(*a, **k):
        b = real(*a, **k)
        kept.append(b)
        return b
    monkeypatch.setattr(TE, "train", spy)
    params = dict(INT8, objective="binary", **CPU)
    res = lgb_torch.cv(params, lgb_torch.Dataset(X, y), 3, nfold=3)
    assert len(kept) == 3
    assert all(b._gbdt._fused_cache == {} for b in kept)
    assert all(b._gbdt.telemetry()["counters"]["fused_rounds"] == 3
               for b in kept)
    assert "cvbooster" not in res
    res = lgb_torch.cv(params, lgb_torch.Dataset(X, y), 3, nfold=3,
                       return_cvbooster=True)
    assert res["cvbooster"].boosters == kept[3:]


def test_cv_log_evaluation_shows_stdv(monkeypatch):
    monkeypatch.setattr(TLOG, "_verbosity", 1)
    lines = []
    lgb_torch.register_logger(lines.append)
    try:
        env = lgb_torch.callback.CallbackEnv(
            None, {}, 0, 0, 1, [("valid", "l2", 0.5, False, 0.25)])
        lgb_torch.log_evaluation(1)(env)
        lgb_torch.log_evaluation(1, show_stdv=False)(env)
    finally:
        lgb_torch.register_logger(None)
    assert lines[0].endswith("valid's l2: 0.5 + 0.25")
    assert lines[1].endswith("valid's l2: 0.5")


def test_cv_checkpoint_dir_dropped_with_warning(tmp_path, monkeypatch):
    monkeypatch.setattr(TLOG, "_verbosity", 1)
    lines = []
    lgb_torch.register_logger(lines.append)
    X, y = _data("regression", 300)
    try:
        res = lgb_torch.cv(dict(STRICT, objective="regression",
                                checkpoint_dir=str(tmp_path), **CPU),
                           lgb_torch.Dataset(X, y), 2, nfold=2)
    finally:
        lgb_torch.register_logger(None)
    assert any("checkpoint_dir is not supported inside cv" in ln
               for ln in lines)
    assert len(res["valid l2-mean"]) == 2


def test_side_stream_made_once_a_device(monkeypatch):
    """Every warm-up and capture of the fused round runs on one side
    stream a device: PyTorch keeps a cuBLAS workspace (32 MiB on Hopper)
    for each stream that ran a matmul, so a stream a capture grew device
    memory by 32 MiB a cv fold with a valid set (chip_smoke.py phase 14
    (d) reads the memory fold by fold on the card)."""
    from lightgbm_tpu_torch.boosting import fused_graph as FG
    made = []

    class FakeStream:
        def __init__(self, dev):
            made.append(dev)
    monkeypatch.setattr(FG.torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(FG, "_SIDE_STREAMS", {})
    a = FG.side_stream(torch.device("cuda", 0))
    b = FG.side_stream(torch.device("cuda", 0))
    c = FG.side_stream(torch.device("cuda", 1))
    assert a is b and a is not c
    assert made == [torch.device("cuda", 0), torch.device("cuda", 1)]
