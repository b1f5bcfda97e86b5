"""The port's training surface against lightgbm_tpu on the CPU: custom
objectives and metrics, ``nan_policy``, continued training, rollback,
refit, ``reset_parameter``, ``Dataset.subset`` and the telemetry counters.

The same seeded numpy inputs go through both packages.

* ``fobj`` + ``feval`` (binary, regression, multiclass k = 3 with a flat
  class-major gradient) in the strict float32 learner and the batched int8
  learner: the same splits, bins and leaf counts, leaf values within rtol
  1e-5 + atol 5e-5 (model text equal for int8 regression, whose gradients
  are exact); every ``feval`` value within 1e-6 (relative and absolute);
  a custom binary logloss trains the built-in objective's trees (no
  boost from average) within the same tolerance;
* ``update(fobj=)`` with a built-in objective is fatal in both;
* the three ``nan_policy`` behaviours with a ``fobj`` that poisons round
  3: trees, ``best_iteration``, recorded evaluations and counters equal
  to the JAX package's; an unknown policy is fatal; a policy keeps the
  classic loop; the finite check reads the host once a round;
* continued training from a Booster and from a file (init scores from the
  host walk in both: trees within the strict tolerance), the reused
  constructed dataset, freed raw data fatal, rollback never below the
  init model, the continued model's raw predictions the init model's plus
  the new trees';
* rollback: the score caches after a rollback equal a booster trained one
  round fewer (rtol 1e-6 + atol 1e-6);
* ``refit`` of one model text in both packages (text equal for
  regression, leaf values within rtol 1e-6 + atol 1e-9 for binary), of a
  loaded booster (objective from the header), ``refit_from_leaf_preds``
  (text equal, int8 regression);
* ``reset_parameter`` as a list and as a function (trees within the strict
  tolerance); after ``Booster.reset_parameter`` a fused ``train_fused``
  captures anew (text equal to the classic loop's), never replaying a
  graph captured under the old learning rate;
* ``Dataset.subset``'s bins and metadata bitwise equal to the JAX
  package's, and the field accessors.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb_jax

import lightgbm_tpu_torch as lgb_torch
from lightgbm_tpu_torch.boosting.gbdt import GBDT as TGBDT
from lightgbm_tpu_torch.robustness import guards as TGUARDS

from test_torch_fused import one_torch_thread  # noqa: F401

N, NF, ROUNDS = 2000, 6, 4
STRICT = dict(num_leaves=15, verbosity=-1)
#: the batched int8 learner at a small size (tests/test_torch_train.py's
#: slice)
INT8 = dict(num_leaves=15, max_bin=63, tpu_split_batch=4,
            use_quantized_grad=True, tpu_hist_dtype="int8",
            quant_train_renew_leaf=True, stochastic_rounding=False,
            hist_kernel="onehot", verbosity=-1)
CPU = dict(device_type="cpu")


def _data(kind, n=N, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, NF))
    X[rng.random((n, NF)) < 0.05] = np.nan
    z = np.nansum(X[:, :3] * np.array([1.0, -0.7, 0.4]), axis=1)
    if kind == "binary":
        y = (z + 0.5 * rng.normal(size=n) > 0).astype(np.float64)
    elif kind == "multiclass":
        y = np.digitize(z + 0.3 * rng.normal(size=n),
                        [-0.5, 0.5]).astype(np.float64)
    else:
        y = 2.0 * np.tanh(z) + 0.5 * rng.standard_t(3, size=n)
    return X, y


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def fobj_binary(preds, ds):
    p = _sigmoid(preds)
    return p - ds.get_label(), p * (1.0 - p)


def fobj_l2(preds, ds):
    return preds - ds.get_label(), np.ones_like(preds)


def fobj_softmax(preds, ds):
    """Softmax cross-entropy over [n, 3] raw scores, returned flat in
    class-major order (the reference's layout of k outputs)."""
    y = ds.get_label().astype(int)
    e = np.exp(preds - preds.max(axis=1, keepdims=True))
    p = e / e.sum(axis=1, keepdims=True)
    onehot = np.eye(p.shape[1])[y]
    g = p - onehot
    h = 2.0 * p * (1.0 - p)
    return g.ravel(order="F"), h.ravel(order="F")


def feval_logloss(preds, ds):
    p = np.clip(_sigmoid(preds), 1e-15, 1 - 1e-15)
    y = ds.get_label()
    return ("custom_logloss",
            float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p))), False)


def feval_mae(preds, ds):
    return "custom_mae", float(np.mean(np.abs(preds - ds.get_label()))), \
        False


def feval_acc(preds, ds):
    return "custom_acc", float(np.mean(np.argmax(preds, axis=1)
                                       == ds.get_label())), True


CUSTOM = {
    "binary": (fobj_binary, feval_logloss, {}),
    "regression": (fobj_l2, feval_mae, {}),
    "multiclass": (fobj_softmax, feval_acc, dict(num_class=3)),
}


def _trees(b):
    return b._gbdt.models if b._gbdt is not None else b._loaded["trees"]


def assert_trees_match(bt, bj, exact=False):
    """Model text equal (``exact``), else the same trees: split features,
    decision types, children and leaf counts equal, leaf values within
    rtol 1e-5 + atol 5e-5."""
    if exact:
        assert bt.model_to_string().split("parameters:")[0] == \
            bj.model_to_string().split("parameters:")[0]
        return
    for tt, tj in zip(_trees(bt), _trees(bj), strict=True):
        assert tt.num_leaves == tj.num_leaves
        np.testing.assert_array_equal(tt.split_feature, tj.split_feature)
        np.testing.assert_array_equal(tt.decision_type, tj.decision_type)
        np.testing.assert_array_equal(tt.left_child, tj.left_child)
        np.testing.assert_array_equal(tt.leaf_count, tj.leaf_count)
        np.testing.assert_allclose(tt.leaf_value, tj.leaf_value, rtol=1e-5,
                                   atol=5e-5)


def _both_train(params, X, y, rounds, valid=None, **kw):
    """(port booster, JAX booster, port record, JAX record) of one
    ``train()`` call with the same arguments in both packages."""
    out = []
    for lgb, extra in ((lgb_torch, CPU), (lgb_jax, {})):
        rec = {}
        ds = lgb.Dataset(X, y, free_raw_data=False)
        vs = [ds.create_valid(*valid)] if valid is not None else []
        b = lgb.train(dict(params, **extra), ds, num_boost_round=rounds,
                      valid_sets=vs, valid_names=["v"] * len(vs),
                      callbacks=[lgb.record_evaluation(rec)], **kw)
        out.append((b, rec))
    (bt, rt), (bj, rj) = out
    return bt, bj, rt, rj


def assert_records_match(rt, rj, tol=1e-6):
    assert list(rt) == list(rj)
    for name in rj:
        assert list(rt[name]) == list(rj[name])
        for metric in rj[name]:
            np.testing.assert_allclose(rt[name][metric], rj[name][metric],
                                       rtol=tol, atol=tol)


# ------------------------------------------------------ custom objectives
@pytest.mark.parametrize("learner", ["strict", "int8"])
@pytest.mark.parametrize("kind", sorted(CUSTOM))
def test_fobj_feval_match_jax(kind, learner):
    X, y = _data(kind)
    fobj, feval, extra = CUSTOM[kind]
    params = dict(STRICT if learner == "strict" else INT8, **extra)
    bt, bj, rt, rj = _both_train(params, X, y, ROUNDS,
                                 valid=_data(kind, 500, seed=1),
                                 fobj=fobj, feval=feval)
    g = bt._gbdt
    assert g.objective is None and bj._gbdt.objective is None
    assert g._use_batched_grower() == (learner == "int8")
    k = 3 if kind == "multiclass" else 1
    assert g.num_tree_per_iteration == k
    assert bt.num_trees() == bj.num_trees() == ROUNDS * k
    assert all(t.num_leaves > 2 for t in g.models)
    assert_trees_match(bt, bj, exact=(kind == "regression"
                                      and learner == "int8"))
    assert_records_match(rt, rj)
    assert [len(v) for v in rt["v"].values()] == [ROUNDS] * len(rt["v"])
    assert any(m.startswith("custom_") for m in rt["v"])
    assert "objective=custom" in bt.model_to_string()
    Xt = _data(kind, 300, seed=2)[0]
    np.testing.assert_allclose(bt.predict(Xt), bj.predict(Xt), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["dart", "rf"])
def test_fobj_boosting_modes_match_jax(mode):
    """Custom gradients through DART (its drops around the grown trees)
    and RF (the running average handed to ``fobj``), classic loop."""
    X, y = _data("regression")
    extra = dict(boosting="dart", drop_rate=0.5, skip_drop=0.0) \
        if mode == "dart" else \
        dict(boosting="rf", bagging_fraction=0.7, bagging_freq=1)
    bt, bj, rt, rj = _both_train(dict(STRICT, **extra), X, y, ROUNDS,
                                 valid=_data("regression", 500, seed=1),
                                 fobj=fobj_l2, feval=feval_mae)
    assert type(bt._gbdt).__name__ == type(bj._gbdt).__name__
    assert bt.num_trees() == bj.num_trees() == ROUNDS
    assert_trees_match(bt, bj)
    assert_records_match(rt, rj)


def test_custom_logloss_equals_builtin_binary():
    """A numpy binary logloss through ``fobj`` trains the trees of the
    built-in objective with ``boost_from_average=false``."""
    X, y = _data("binary")
    params = dict(STRICT, **CPU)
    b_custom = lgb_torch.train(params, lgb_torch.Dataset(X, y), ROUNDS,
                               fobj=fobj_binary)
    b_builtin = lgb_torch.train(dict(params, objective="binary",
                                     boost_from_average=False),
                                lgb_torch.Dataset(X, y), ROUNDS)
    assert_trees_match(b_custom, b_builtin)


def test_update_fobj_with_builtin_objective_fatal():
    X, y = _data("binary", 300)
    for lgb, extra in ((lgb_torch, CPU), (lgb_jax, {})):
        b = lgb.Booster(dict(STRICT, objective="binary", **extra),
                        lgb.Dataset(X, y))
        with pytest.raises(lgb.LightGBMError, match="built-in objective"):
            b.update(fobj=fobj_binary)


def test_update_fobj_rounds_match_jax():
    """``Booster.update(train_set, fobj)`` round by round, the
    predictions handed to ``fobj`` equal in both packages."""
    X, y = _data("binary")
    seen = {}
    for name, lgb, extra in (("torch", lgb_torch, CPU), ("jax", lgb_jax, {})):
        ds = lgb.Dataset(X, y)
        b = lgb.Booster(dict(STRICT, objective="none", **extra), ds)
        preds = []

        def fobj(p, d):
            preds.append(np.array(p))
            return fobj_binary(p, d)
        for _ in range(3):
            b.update(ds, fobj=fobj)
        seen[name] = (b, preds)
    (bt, pt), (bj, pj) = seen["torch"], seen["jax"]
    assert pt[0].dtype == np.float64 and pt[0].shape == (N,)
    for a, b in zip(pt, pj, strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert_trees_match(bt, bj)


def test_update_with_another_train_set_fatal():
    """``update(train_set)`` with another set resets the training data
    first (reference Booster.update, ``reset_training_data``):
    fatal when its bins do not align with the model's, a reset when they
    do."""
    X, y = _data("binary", 300)
    ds = lgb_torch.Dataset(X, y)
    b = lgb_torch.Booster(dict(STRICT, objective="binary", **CPU), ds)
    with pytest.raises(lgb_torch.LightGBMError, match="reset_training_data"):
        b.update(lgb_torch.Dataset(X * 3.0 + 1.0, y, params={"max_bin": 7}))
    sub = ds.subset(np.arange(200))
    b.update(sub)
    assert b.train_set is sub and b._gbdt.scores.shape[0] == 200


# ------------------------------------------------------------- nan_policy
def poisoned(fobj, at=3, value=np.nan):
    """``fobj`` whose gradients at its call ``at`` (the boosting round of
    that index when it is called once a round) are ``value``."""
    calls = []

    def f(preds, ds):
        g, h = fobj(preds, ds)
        if len(calls) == at:
            g = np.full_like(g, value)
        calls.append(1)
        return g, h
    return f


@pytest.mark.parametrize("policy", ["skip_round", "raise",
                                    "halt_and_keep_best"])
def test_nan_policy_matches_jax(policy):
    X, y = _data("binary")
    valid = _data("binary", 500, seed=1)
    params = dict(STRICT, nan_policy=policy, metric="binary_logloss")
    if policy == "raise":
        for lgb, extra in ((lgb_torch, CPU), (lgb_jax, {})):
            ds = lgb.Dataset(X, y)
            with pytest.raises(lgb.LightGBMError, match="round 3"):
                lgb.train(dict(params, **extra), ds, 8,
                          fobj=poisoned(fobj_binary))
        return
    value = np.inf if policy == "halt_and_keep_best" else np.nan
    out = {}
    for name, lgb, extra in (("torch", lgb_torch, CPU), ("jax", lgb_jax, {})):
        rec = {}
        ds = lgb.Dataset(X, y)
        b = lgb.train(dict(params, **extra), ds, 8,
                      valid_sets=[ds.create_valid(*valid)],
                      valid_names=["v0"],
                      fobj=poisoned(fobj_binary, value=value),
                      callbacks=[lgb.record_evaluation(rec)])
        out[name] = (b, rec, b.telemetry()["counters"])
    (bt, rt, ct), (bj, rj, cj) = out["torch"], out["jax"]
    assert bt.num_trees() == bj.num_trees()
    assert bt.best_iteration == bj.best_iteration
    assert_records_match(rt, rj)
    nan_keys = [k for k in cj if k.startswith("nan_")]
    assert {k: ct.get(k) for k in nan_keys} == {k: cj[k] for k in nan_keys}
    assert ct["nan_guard_trips"] == 1
    if policy == "skip_round":
        assert ct["nan_rounds_skipped"] == 1
        assert bt.num_trees() == 7
        assert bt.best_iteration == -1
        assert len(rt["v0"]["binary_logloss"]) == 8
    else:
        assert ct["nan_guard_halts"] == 1
        assert bt.num_trees() == 3
        assert bt.best_iteration == 3
        assert len(rt["v0"]["binary_logloss"]) == 3
    assert_trees_match(bt, bj)


def test_nan_policy_unknown_fatal():
    for lgb in (lgb_torch, lgb_jax):
        with pytest.raises(lgb.LightGBMError, match="nan_policy"):
            lgb.Config({"nan_policy": "explode"})


def test_nan_policy_keeps_classic_loop(monkeypatch):
    """A policy keeps the classic loop (the JAX package's gate); with
    nan_policy=none the same configuration fuses."""
    X, y = _data("binary")
    loops = []
    real = TGBDT.train_fused
    monkeypatch.setattr(TGBDT, "train_fused",
                        lambda gb, *a, **k: loops.append(1)
                        or real(gb, *a, **k))
    for policy, fused in (("none", True), ("skip_round", False),
                          ("raise", False)):
        loops.clear()
        p = dict(INT8, objective="binary", nan_policy=policy, **CPU)
        b = lgb_torch.train(p, lgb_torch.Dataset(X, y), 2)
        assert b._gbdt.supports_fused() == fused
        assert bool(loops) == fused
        pj = dict(INT8, objective="binary", nan_policy=policy)
        bj = lgb_jax.Booster(pj, lgb_jax.Dataset(X, y))
        assert bj._gbdt.supports_fused() == fused


def test_finite_check_reads_the_host_once(monkeypatch):
    """The guard's check is one flag read, never a copy of g, h or the
    scores."""
    X, y = _data("binary", 500)
    b = lgb_torch.Booster(dict(STRICT, objective="none",
                               nan_policy="skip_round", **CPU),
                          lgb_torch.Dataset(X, y))
    g = torch.zeros(500, 1)
    h = torch.ones(500, 1)
    reads = []
    for name in ("item", "__bool__", "__int__", "__float__", "tolist",
                 "numpy", "cpu"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _r=real, _n=name, **k:
                            reads.append(_n) or _r(self, *a, **k))
    assert TGUARDS.enforce_nan_policy(b._gbdt, g, h) is False
    assert reads == ["__bool__"]
    reads.clear()
    assert TGUARDS.enforce_nan_policy(b._gbdt, g / 0.0, h) is True
    assert reads == ["__bool__"]


def test_telemetry_counters_match_jax():
    """The round counters the JAX package's classic loop bumps."""
    X, y = _data("binary")
    ct = lgb_torch.train(dict(INT8, objective="binary", **CPU),
                         lgb_torch.Dataset(X, y), 3,
                         callbacks=[lambda env: None]).telemetry()
    cj = lgb_jax.train(dict(INT8, objective="binary"),
                       lgb_jax.Dataset(X, y), 3,
                       callbacks=[lambda env: None]).telemetry()
    keys = ("iterations", "strict_rounds", "trees_grown",
            "hist_build_rounds", "quantize_rounds")
    assert {k: ct["counters"][k] for k in keys} == \
        {k: cj["counters"][k] for k in keys}
    assert ct["phases"] == {} and ct["memory"] == {}
    fused = lgb_torch.train(dict(INT8, objective="binary", **CPU),
                            lgb_torch.Dataset(X, y), 3).telemetry()
    assert fused["counters"]["fused_rounds"] == 3
    assert fused["counters"]["fused_runner_cache_misses"] == 1


# ----------------------------------------------------- continued training
def _init_pair(kind, rounds=3, **extra):
    """One init model trained by the JAX package, loaded in both."""
    X, y = _data(kind)
    bj0 = lgb_jax.train(dict(STRICT, objective=kind, **extra),
                        lgb_jax.Dataset(X, y), rounds)
    text = bj0.model_to_string()
    return X, y, text


@pytest.mark.parametrize("source", ["booster", "file"])
def test_continuation_matches_jax(source, tmp_path):
    X, y, text = _init_pair("binary")
    f = str(tmp_path / "init.txt")
    with open(f, "w") as fh:
        fh.write(text)
    valid = _data("binary", 500, seed=1)
    init = {"torch": lgb_torch.Booster(model_str=text),
            "jax": lgb_jax.Booster(model_str=text)} \
        if source == "booster" else {"torch": f, "jax": f}
    out = {}
    for name, lgb, extra in (("torch", lgb_torch, CPU), ("jax", lgb_jax, {})):
        rec = {}
        ds = lgb.Dataset(X, y, free_raw_data=False)
        b = lgb.train(dict(STRICT, objective="binary", **extra), ds, 3,
                      valid_sets=[ds.create_valid(*valid)],
                      valid_names=["v"], init_model=init[name],
                      callbacks=[lgb.record_evaluation(rec)])
        out[name] = (b, rec, ds)
    (bt, rt, dst), (bj, rj, dsj) = out["torch"], out["jax"]
    assert bt.num_trees() == bj.num_trees() == 6
    assert bt._gbdt.num_init_iteration == 3
    assert bt.current_iteration() == 6
    np.testing.assert_array_equal(dst.get_init_score(), dsj.get_init_score())
    assert_trees_match(bt, bj)
    assert_records_match(rt, rj)
    # the continued model's raw predictions: the init model's plus the
    # new trees'
    Xt = _data("binary", 300, seed=2)[0]
    init_raw = lgb_torch.Booster(model_str=text).predict(Xt, raw_score=True)
    new_raw = bt.predict(Xt, raw_score=True, start_iteration=3)
    np.testing.assert_allclose(bt.predict(Xt, raw_score=True),
                               init_raw + new_raw, rtol=1e-12, atol=1e-12)
    # self-contained after save and load
    f2 = str(tmp_path / "cont.txt")
    bt.save_model(f2)
    np.testing.assert_allclose(
        lgb_torch.Booster(model_file=f2).predict(Xt), bt.predict(Xt),
        rtol=1e-6)


def test_continuation_reuses_constructed_dataset():
    """The same constructed Dataset trained twice, the second time with
    init_model: the init score is injected although construct() ran."""
    X, y = _data("binary")
    p = dict(STRICT, objective="binary", **CPU)
    d = lgb_torch.Dataset(X, y, free_raw_data=False)
    b1 = lgb_torch.train(p, d, 4)
    b2 = lgb_torch.train(p, d, 4, init_model=b1)
    raw1 = b1.predict(X, raw_score=True)
    np.testing.assert_array_equal(d.get_init_score(), raw1)
    assert b2.num_trees() == 8

    def logloss(raw):
        return float(np.mean(np.log1p(np.exp(-(2 * y - 1) * raw))))
    assert logloss(b2.predict(X, raw_score=True)) < logloss(raw1)


def test_continuation_freed_raw_data_fatal():
    X, y = _data("binary", 500)
    p = dict(STRICT, objective="binary", **CPU)
    d = lgb_torch.Dataset(X, y)
    b1 = lgb_torch.train(p, d, 2)
    with pytest.raises(lgb_torch.LightGBMError, match="free_raw_data"):
        lgb_torch.train(p, d, 2, init_model=b1)


def test_checkpoint_arguments_fatal():
    X, y = _data("binary", 300)
    p = dict(STRICT, objective="binary", **CPU)
    for kw in (dict(resume="auto"), dict(final_checkpoint=True)):
        with pytest.raises(lgb_torch.LightGBMError, match="checkpoint"):
            lgb_torch.train(p, lgb_torch.Dataset(X, y), 2, **kw)


def test_rollback_respects_init_model():
    X, y, text = _init_pair("binary")
    out = {}
    for name, lgb, extra in (("torch", lgb_torch, CPU), ("jax", lgb_jax, {})):
        b = lgb.train(dict(STRICT, objective="binary", **extra),
                      lgb.Dataset(X, y, free_raw_data=False), 2,
                      init_model=lgb.Booster(model_str=text))
        for _ in range(5):   # the init model's rounds are never rolled back
            b.rollback_one_iter()
        out[name] = b
    assert out["torch"].num_trees() == out["jax"].num_trees() == 3
    assert out["torch"].current_iteration() == 3
    init_raw = lgb_torch.Booster(model_str=text).predict(X, raw_score=True)
    np.testing.assert_allclose(out["torch"]._gbdt.scores[:, 0].numpy(),
                               init_raw, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_rollback_scores_equal_fewer_rounds(kind):
    """After a rollback the training and valid score caches equal those of
    a booster trained one round fewer (and the JAX package's)."""
    X, y = _data(kind)
    Xv, yv = _data(kind, 500, seed=1)
    extra = dict(num_class=3) if kind == "multiclass" else {}
    p = dict(STRICT, objective=kind, **extra)
    boosters = {}
    for name, lgb, dev in (("torch", lgb_torch, CPU), ("jax", lgb_jax, {})):
        ds = lgb.Dataset(X, y)
        b = lgb.Booster(dict(p, **dev), ds)
        b.add_valid(ds.create_valid(Xv, yv), "v")
        for _ in range(4):
            b.update()
        b.rollback_one_iter()
        boosters[name] = b
    bt, bj = boosters["torch"], boosters["jax"]
    k = bt.num_model_per_iteration()
    assert bt.num_trees() == bj.num_trees() == 3 * k
    ds3 = lgb_torch.Dataset(X, y)
    b3 = lgb_torch.Booster(dict(p, **CPU), ds3)
    b3.add_valid(ds3.create_valid(Xv, yv), "v")
    for _ in range(3):
        b3.update()
    np.testing.assert_allclose(bt._gbdt.scores.numpy(),
                               b3._gbdt.scores.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bt._gbdt.valid_scores[0].numpy(),
                               b3._gbdt.valid_scores[0].numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(bt._gbdt.scores.numpy(),
                               np.asarray(bj._gbdt.scores), rtol=1e-5,
                               atol=5e-5)
    assert bt.model_to_string() == b3.model_to_string()


# ------------------------------------------------------------------ refit
@pytest.mark.parametrize("kind", ["regression", "binary", "multiclass"])
def test_refit_matches_jax(kind):
    """One model text refitted by both packages on new rows: text equal
    where the gradients are exact (l2), leaf values within rtol 1e-6 +
    atol 1e-9 otherwise (the sigmoid / softmax's exp)."""
    extra = dict(num_class=3) if kind == "multiclass" else {}
    X, y, text = _init_pair(kind, rounds=4, **extra)
    Xn, yn = _data(kind, 1500, seed=5)
    rt = lgb_torch.Booster(model_str=text, params=CPU).refit(
        Xn, yn, decay_rate=0.5)
    rj = lgb_jax.Booster(model_str=text).refit(Xn, yn, decay_rate=0.5)
    assert rt.num_trees() == rj.num_trees()
    if kind == "regression":
        assert rt.model_to_string() == rj.model_to_string()
    for tt, tj in zip(_trees(rt), _trees(rj), strict=True):
        np.testing.assert_array_equal(tt.split_feature, tj.split_feature)
        np.testing.assert_allclose(tt.leaf_value, tj.leaf_value, rtol=1e-6,
                                   atol=1e-9)
    # structures unchanged, leaf values moved
    base = lgb_torch.Booster(model_str=text)
    np.testing.assert_array_equal(base.predict(X[:64], pred_leaf=True),
                                  rt.predict(X[:64], pred_leaf=True))
    assert np.abs(base.predict(X[:64], raw_score=True)
                  - rt.predict(X[:64], raw_score=True)).max() > 1e-8


def test_refit_of_trained_and_loaded_booster(tmp_path):
    """A trained booster refits with its own objective; a loaded one takes
    the objective from the model header (no params)."""
    X, y = _data("binary")
    b = lgb_torch.train(dict(STRICT, objective="binary", **CPU),
                        lgb_torch.Dataset(X, y), 5)
    f = str(tmp_path / "m.txt")
    b.save_model(f)
    loaded = lgb_torch.Booster(model_file=f, params=CPU)
    r1 = b.refit(X, y, decay_rate=0.0)
    r2 = loaded.refit(X, y, decay_rate=0.0)
    assert r1.model_to_string() == r2.model_to_string()
    raw = r2.predict(X, raw_score=True)
    assert float(np.mean(np.log1p(np.exp(-(2 * y - 1) * raw)))) < 0.69


def test_refit_from_leaf_preds_matches_jax():
    """In place from the training set's leaf matrix: int8 regression, both
    packages' models text-equal before and after; the score caches
    rebuilt from the refitted trees."""
    X, y = _data("regression")
    p = dict(INT8, objective="regression")
    bt = lgb_torch.train(dict(p, **CPU), lgb_torch.Dataset(X, y), 3)
    bj = lgb_jax.train(p, lgb_jax.Dataset(X, y), 3)
    assert_trees_match(bt, bj, exact=True)
    bt.refit_from_leaf_preds(bt.predict(X, pred_leaf=True), decay_rate=0.3)
    bj.refit_from_leaf_preds(bj.predict(X, pred_leaf=True), decay_rate=0.3)
    assert_trees_match(bt, bj, exact=True)
    np.testing.assert_allclose(bt._gbdt.scores[:, 0].numpy(),
                               bt.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(lgb_torch.LightGBMError, match="columns"):
        bt.refit_from_leaf_preds(np.zeros((N, 2), np.int32))


# -------------------------------------------------------- reset_parameter
@pytest.mark.parametrize("form", ["list", "function"])
def test_reset_parameter_matches_jax(form):
    X, y = _data("binary")
    lrs = [0.2 * 0.9 ** i for i in range(ROUNDS)]
    value = lrs if form == "list" else (lambda i: 0.2 * 0.9 ** i)
    seen = {}
    out = {}
    for name, lgb, extra in (("torch", lgb_torch, CPU), ("jax", lgb_jax, {})):
        shr = seen.setdefault(name, [])
        b = lgb.train(dict(STRICT, objective="binary", **extra),
                      lgb.Dataset(X, y), ROUNDS,
                      callbacks=[lgb.reset_parameter(learning_rate=value),
                                 lambda env, s=shr: s.append(
                                     env.model._gbdt.shrinkage_rate)])
        out[name] = b
    assert seen["torch"] == seen["jax"] == pytest.approx(lrs)
    assert_trees_match(out["torch"], out["jax"])
    np.testing.assert_allclose([t.shrinkage for t in _trees(out["torch"])],
                               lrs)


def test_reset_parameter_list_length_checked():
    X, y = _data("binary", 300)
    with pytest.raises(ValueError, match="Length of list"):
        lgb_torch.train(dict(STRICT, objective="binary", **CPU),
                        lgb_torch.Dataset(X, y), 3,
                        callbacks=[lgb_torch.reset_parameter(
                            learning_rate=[0.1, 0.2])])


def test_reset_parameter_callback_keeps_classic_loop(monkeypatch):
    X, y = _data("binary")
    loops = []
    real = TGBDT.train_fused
    monkeypatch.setattr(TGBDT, "train_fused",
                        lambda gb, *a, **k: loops.append(1)
                        or real(gb, *a, **k))
    b = lgb_torch.train(dict(INT8, objective="binary", **CPU),
                        lgb_torch.Dataset(X, y), 2,
                        callbacks=[lgb_torch.reset_parameter(
                            learning_rate=[0.1, 0.05])])
    assert b._gbdt.supports_fused() and not loops


def test_booster_reset_parameter_recaptures_fused_round():
    """After ``Booster.reset_parameter`` a fused ``train_fused`` runs a new
    capture under the new learning rate and sampling (the classic loop's
    text), never a graph captured under the old config."""
    X, y = _data("binary")
    p = dict(INT8, objective="binary", learning_rate=0.1, **CPU)
    new = dict(learning_rate=0.3, bagging_fraction=0.7, bagging_freq=1)

    def run(fused):
        b = lgb_torch.Booster(p, lgb_torch.Dataset(X, y))
        g = b._gbdt
        if fused:
            g.train_fused(2)
        else:
            for _ in range(2):
                b.update()
        b.reset_parameter(new)
        assert g.shrinkage_rate == 0.3
        assert g._fused_cache == {}
        if fused:
            g.train_fused(2)
            assert g.telemetry()["counters"][
                "fused_runner_cache_misses"] == 2
        else:
            for _ in range(2):
                b.update()
        return b
    bf, bc = run(True), run(False)
    assert [t.shrinkage for t in bf._gbdt.models] == \
        pytest.approx([0.1, 0.1, 0.3, 0.3])
    assert bf.model_to_string() == bc.model_to_string()
    np.testing.assert_allclose(bf._gbdt.scores[:, 0].numpy(),
                               bf.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-5)


def test_booster_reset_parameter_matches_jax():
    X, y = _data("binary")
    out = {}
    for name, lgb, extra in (("torch", lgb_torch, CPU), ("jax", lgb_jax, {})):
        b = lgb.Booster(dict(STRICT, objective="binary", **extra),
                        lgb.Dataset(X, y))
        b.update()
        b.reset_parameter({"learning_rate": 0.3, "num_leaves": 7,
                           "lambda_l2": 1.0})
        b.update()
        out[name] = b
    assert out["torch"]._gbdt.hp.num_leaves == 7
    assert _trees(out["torch"])[1].num_leaves <= 7
    assert_trees_match(out["torch"], out["jax"])


# ----------------------------------------------------------------- eval
def test_booster_eval_matches_jax():
    """``Booster.eval`` on the training set, a registered valid set and an
    unregistered aligned one, with ``feval``; another binning is fatal."""
    X, y = _data("binary")
    Xv, yv = _data("binary", 500, seed=1)
    Xw, yw = _data("binary", 400, seed=3)
    res = {}
    for name, lgb, extra in (("torch", lgb_torch, CPU), ("jax", lgb_jax, {})):
        ds = lgb.Dataset(X, y)
        vs = ds.create_valid(Xv, yv)
        b = lgb.train(dict(STRICT, objective="binary",
                           metric="binary_logloss", **extra), ds, 3,
                      valid_sets=[vs], valid_names=["v"])
        res[name] = (b.eval(ds, "tr", feval=feval_logloss)
                     + b.eval(vs, "v", feval=[feval_logloss])
                     + b.eval(ds.create_valid(Xw, yw), "w",
                              feval=feval_logloss))
        if lgb is lgb_torch:
            with pytest.raises(lgb.LightGBMError, match="bin mappers"):
                b.eval(lgb.Dataset(Xw * 3.0, yw), "other")
    rt, rj = res["torch"], res["jax"]
    assert [r[:2] + r[3:] for r in rt] == [r[:2] + r[3:] for r in rj]
    np.testing.assert_allclose([r[2] for r in rt], [r[2] for r in rj],
                               rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- subset
def test_subset_matches_jax():
    X, y = _data("regression")
    rng = np.random.default_rng(4)
    w = rng.random(N)
    init = rng.normal(size=N)
    pos = rng.integers(0, 5, N)
    idx = np.sort(rng.choice(N, 700, replace=False))
    params = dict(max_bin=63, linear_tree=True, verbosity=-1)
    subs = []
    for lgb in (lgb_torch, lgb_jax):
        ds = lgb.Dataset(X, y, weight=w, init_score=init, position=pos,
                         params=params)
        subs.append(ds.subset(idx))
    st, sj = subs
    it, ij = st.inner, sj.inner
    np.testing.assert_array_equal(it.bins, ij.bins)
    np.testing.assert_array_equal(it.raw, ij.raw)
    for field in ("label", "weight", "init_score", "position"):
        np.testing.assert_array_equal(st.get_field(field),
                                      sj.get_field(field))
    assert st.num_data() == 700
    np.testing.assert_array_equal(st.get_position(), pos[idx])
    assert it.mappers is st.inner.mappers
    assert st.get_params() == sj.get_params()


def test_subset_multiclass_init_score_and_fields():
    """A k-column init score is sliced class by class; the field accessors
    set and get through the constructed dataset."""
    X, y = _data("multiclass", 300)
    init = np.arange(900, dtype=np.float64)
    idx = np.array([0, 5, 7, 299])
    for lgb in (lgb_torch, lgb_jax):
        ds = lgb.Dataset(X, y, init_score=init, free_raw_data=False)
        sub = ds.subset(idx)
        np.testing.assert_array_equal(
            sub.get_init_score(),
            init.reshape(300, 3, order="F")[idx].ravel(order="F"))
    ds = lgb_torch.Dataset(X, y, free_raw_data=False).construct()
    ds.set_group([100, 200])
    np.testing.assert_array_equal(ds.get_group(), [100, 200])
    np.testing.assert_array_equal(ds.get_field("group"), [0, 100, 300])
    ds.set_field("weight", np.ones(300))
    np.testing.assert_array_equal(ds.get_weight(), np.ones(300))
    assert ds.get_data() is X
    with pytest.raises(lgb_torch.LightGBMError, match="Unknown field"):
        ds.get_field("nope")
    freed = lgb_torch.Dataset(X, y).construct()
    with pytest.raises(lgb_torch.LightGBMError, match="freed"):
        freed.get_data()
