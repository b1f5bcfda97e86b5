"""The port's forced splits (``forcedsplits_filename``) against
lightgbm_tpu on the CPU.

* The BFS schedule equals the JAX package's ``_parse_forced_splits``
  (leaf numbering, value -> bin thresholds, an unused feature ending it).
* ``train()`` with int8 levels gives the JAX package's model text byte for
  byte in both growers (the strict learner at ``tpu_split_batch=1`` and
  the batched grower) and both loops (fused and classic), also with the
  bounded histogram pool (a forced leaf whose slot was evicted gets its
  column from the rows), a forced categorical split, EFB-bundled data and
  an entry that fails mid-schedule (the rest of the schedule is skipped;
  the fused loop's round budget, counted from one leaf, still grows the
  whole tree).  Float32 strict models are compared as trees (splits and
  counts equal, leaves rtol 1e-5 + atol 5e-5, gains rtol 1e-5 and 1e-6 of
  the tree's largest).
* The behaviour the JAX package's tests check (tests/test_constraints.py
  test_forced_splits, tests/test_batch_grower.py forced splits batched,
  tests/test_hist_modes.py forced splits with the pool) holds for the
  port's models.
"""

import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb_jax
from lightgbm_tpu.boosting.gbdt import _parse_forced_splits as jax_parse
from lightgbm_tpu.learner import batch_grower as JBG

import lightgbm_tpu_torch as lgb_torch
from lightgbm_tpu_torch.boosting import gbdt as TG
from lightgbm_tpu_torch.learner import batch_grower as TBG

from test_torch_fused import fused_host_reads, one_torch_thread  # noqa: F401
from test_torch_train import SLICE, _data

#: the strict learner with int8 levels (exact, so the text is the JAX
#: package's byte for byte)
STRICT_INT8 = dict(SLICE, tpu_split_batch=1)
#: the strict learner's float32 default below 100k rows
STRICT = dict(num_leaves=15, verbosity=-1)
ROUNDS = 3

#: a three-level schedule: the root, both its children, a grandchild
DEEP = {"feature": 2, "threshold": 0.0,
        "left": {"feature": 3, "threshold": 0.5,
                 "right": {"feature": 0, "threshold": -0.2}},
        "right": {"feature": 0, "threshold": -0.3}}
#: entry 1 (the root's left child) sends every row left: it fails, and the
#: entries after it (the root's right child) are skipped
FAILING = {"feature": 2, "threshold": 0.0,
           "left": {"feature": 3, "threshold": 1e9},
           "right": {"feature": 0, "threshold": -0.3}}


def _json(tmp_path, spec, name="forced.json"):
    p = tmp_path / name
    p.write_text(json.dumps(spec))
    return str(p)


def _categorical_data(n, seed=0):
    """``_data`` with column 7 replaced by integer category codes."""
    X, y = _data("regression", n=n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    codes = rng.integers(0, 6, size=n)
    X[:, 7] = codes
    return X, y + 0.8 * (codes == 4)


def _bundled_data(n, seed=0):
    """Two dense columns and two exclusive one-hot blocks (EFB bundles
    them)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 6, size=n)
    blocks = []
    for b in range(2):
        blk = np.zeros((n, 6))
        j = idx if b == 0 else rng.integers(0, 6, size=n)
        blk[np.arange(n), j] = rng.normal(1.5, 0.2, size=n)
        blocks.append(blk)
    dense = rng.normal(size=(n, 2))
    X = np.concatenate([dense] + blocks, axis=1)
    y = 2.0 * dense[:, 0] + 0.5 * (idx % 2) + 0.3 * rng.normal(size=n)
    return X, y


def _train_both(params, X, y, rounds=ROUNDS, cat=None, classic=False,
                monkeypatch=None):
    kw = {} if cat is None else dict(categorical_feature=cat)
    bj = lgb_jax.train(params, lgb_jax.Dataset(X, y, **kw),
                       num_boost_round=rounds)
    if classic:
        monkeypatch.setattr(TG.GBDT, "supports_fused", lambda self: False)
    bt = lgb_torch.train(dict(params, device_type="cpu"),
                         lgb_torch.Dataset(X, y, **kw),
                         num_boost_round=rounds)
    return bj, bt


def _text(booster):
    head, params = booster.model_to_string().split("parameters:")
    lines = params.splitlines()
    if "[device_type: cpu]" in lines:
        lines.remove("[device_type: cpu]")
    return head, lines


def _assert_same_text(bj, bt):
    (hj, pj), (ht, pt) = _text(bj), _text(bt)
    assert pt == pj
    assert ht == hj


def _assert_trees_match(bj, bt):
    assert len(bt._gbdt.models) == len(bj._gbdt.models)
    for tt, tj in zip(bt._gbdt.models, bj._gbdt.models):
        assert tt.num_leaves == tj.num_leaves
        for f in ("split_feature", "threshold_bin", "decision_type",
                  "left_child", "right_child", "leaf_count",
                  "internal_count"):
            np.testing.assert_array_equal(getattr(tt, f), getattr(tj, f),
                                          err_msg=f)
        np.testing.assert_allclose(tt.leaf_value, tj.leaf_value, rtol=1e-5,
                                   atol=5e-5)
        np.testing.assert_allclose(
            tt.split_gain, tj.split_gain, rtol=1e-5,
            atol=1e-6 * float(np.max(np.abs(tj.split_gain), initial=0.0)))


# -------------------------------------------------------------- schedule
@pytest.mark.parametrize("spec", ["deep", "failing", "unused"])
def test_schedule_matches_jax(spec, tmp_path):
    X, y = _data("regression", n=3000)
    X[:, 5] = 1.0                       # a trivial column: not used
    tree = dict(DEEP if spec == "deep" else FAILING)
    if spec == "unused":
        tree["right"] = {"feature": 5, "threshold": 0.0,
                         "left": {"feature": 1, "threshold": 0.1}}
    path = _json(tmp_path, tree)
    dj = lgb_jax.Dataset(X, y, params=STRICT)
    dj.construct()
    dt = lgb_torch.Dataset(X, y)
    want = jax_parse(path, dj._inner, 15)
    got = TG.parse_forced_splits(path, dt.inner, 15, torch.device("cpu"))
    S = len(got.leaf)
    for a, b in zip((got.leaf, got.feat, got.thr), want):
        b = np.asarray(b)
        np.testing.assert_array_equal(a, b[:S])
        assert (np.asarray(want[0])[S:] < 0).all()
    np.testing.assert_array_equal(got.table.numpy(),
                                  np.stack([got.leaf, got.feat, got.thr]))
    assert S == {"deep": 4, "failing": 3, "unused": 2}[spec]


def test_empty_schedule_is_none(tmp_path):
    X, y = _data("regression", n=500)
    dt = lgb_torch.Dataset(X, y)
    assert TG.parse_forced_splits(_json(tmp_path, {}), dt.inner, 15,
                                  torch.device("cpu")) is None


# --------------------------------------------------------------- train()
CASES = {
    "batched-fused": dict(SLICE),
    "batched-classic": dict(SLICE, classic=True),
    "strict": dict(STRICT_INT8),
    "pooled": dict(SLICE, histogram_pool_size=0.02),
    "pooled-batch1": dict(SLICE, tpu_split_batch=1,
                          histogram_pool_size=0.02),
    "failing": dict(SLICE, spec="failing"),
    "failing-classic": dict(SLICE, spec="failing", classic=True),
    "failing-strict": dict(STRICT_INT8, spec="failing"),
    "categorical": dict(SLICE, data="categorical"),
    "categorical-strict": dict(STRICT_INT8, data="categorical"),
    "bundled": dict(SLICE, data="bundled"),
    "bundled-strict": dict(STRICT_INT8, data="bundled"),
    "bundled-pooled": dict(SLICE, data="bundled", histogram_pool_size=0.01),
}


def _case(case, tmp_path, n=10_000):
    params = dict(CASES[case])
    classic = params.pop("classic", False)
    spec = DEEP if params.pop("spec", "deep") == "deep" else FAILING
    kind = params.pop("data", None)
    cat = None
    if kind == "categorical":
        X, y = _categorical_data(n)
        cat = [7]
        spec = {"feature": 7, "threshold": 4,
                "left": {"feature": 0, "threshold": 0.1}}
    elif kind == "bundled":
        X, y = _bundled_data(n)
        # a one-hot member of the first bundle at the root
        spec = {"feature": 3, "threshold": 0.5,
                "right": {"feature": 0, "threshold": 0.2},
                "left": {"feature": 9, "threshold": 0.5}}
    else:
        X, y = _data("regression", n=n)
    params.update(objective="regression",
                  forcedsplits_filename=_json(tmp_path, spec))
    return params, X, y, cat, classic


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_matches_jax_int8(case, tmp_path, monkeypatch):
    params, X, y, cat, classic = _case(case, tmp_path)
    calls = []
    real = TG.GBDT.train_fused

    def spy(gb, *a, **k):
        calls.append(1)
        return real(gb, *a, **k)

    monkeypatch.setattr(TG.GBDT, "train_fused", spy)
    bj, bt = _train_both(params, X, y, cat=cat, classic=classic,
                         monkeypatch=monkeypatch)
    g = bt._gbdt
    assert g.forced is not None
    assert (calls == [1]) == (not classic and g._use_batched_grower())
    if case.startswith("pooled") or case == "bundled-pooled":
        assert 0 < g.hp.hist_pool_slots < g.hp.num_leaves
    if case.startswith("bundled"):
        assert g.bundle is not None
    _assert_same_text(bj, bt)
    t0 = g.models[0]
    f0 = int(g.train_set.used_feature_idx[int(g.forced.feat[0])])
    assert t0.split_feature[0] == f0
    if case.startswith("failing"):
        # entry 1 failed: the root's right child is not the prescribed
        # split (its entry was skipped), the tree still grows past it
        assert t0.num_leaves > 3


def test_strict_float32_trees_match_jax(tmp_path):
    params, X, y, _, _ = _case("batched-fused", tmp_path, n=3000)
    params = dict(STRICT, objective="regression",
                  forcedsplits_filename=params["forcedsplits_filename"])
    bj, bt = _train_both(params, X, y)
    assert not bt._gbdt._use_batched_grower()
    _assert_trees_match(bj, bt)
    for t in bt._gbdt.models:
        assert list(t.split_feature[:4]) == [2, 3, 0, 0]


def test_fused_failing_entry_budget_matches_classic(tmp_path, monkeypatch):
    """The fused loop's budget after a forced phase (no ladder) counts from
    one leaf: with a failed entry mid-schedule and the ladder switched on
    for small data, fused and classic still give the same text, the fused
    tree growing through its budget and extra rounds."""
    monkeypatch.setattr(JBG, "_WARMUP_MIN_ROWS", 1024)
    monkeypatch.setattr(TBG, "_WARMUP_MIN_ROWS", 1024)
    X, y = _data("regression", n=10_000)
    params = dict(SLICE, objective="regression", max_bin=255,
                  hist_kernel="auto", num_leaves=31, tpu_split_batch=8,
                  device_type="cpu",
                  forcedsplits_filename=_json(tmp_path, FAILING))
    bf = lgb_torch.train(params, lgb_torch.Dataset(X, y), num_boost_round=4)
    g = bf._gbdt
    assert g.supports_fused()
    monkeypatch.setattr(TG.GBDT, "supports_fused", lambda self: False)
    bc = lgb_torch.train(params, lgb_torch.Dataset(X, y), num_boost_round=4)
    assert bf.model_to_string() == bc.model_to_string()
    monkeypatch.undo()
    monkeypatch.setattr(JBG, "_WARMUP_MIN_ROWS", 1024)
    bj = lgb_jax.train({k: v for k, v in params.items()
                        if k != "device_type"},
                       lgb_jax.Dataset(X, y), num_boost_round=4)
    _assert_same_text(bj, bf)
    # the ladder is skipped after the forced phase
    tree = TBG.BatchedTree(
        g.bins, torch.zeros(X.shape[0]), torch.ones(X.shape[0]), None,
        g.num_bins_arr, g.nan_bin_arr, None, g.hp, batch=8,
        forced=g.forced)
    assert tree.ladder() == [] and g.forced.table.shape[1] == 3


def test_fused_cache_keys_on_the_schedule(tmp_path):
    X, y = _data("regression", n=5000)
    params = dict(SLICE, objective="regression", device_type="cpu",
                  forcedsplits_filename=_json(tmp_path, DEEP))
    b = lgb_torch.train(params, lgb_torch.Dataset(X, y), num_boost_round=2)
    g = b._gbdt
    (key,) = g._fused_cache
    assert key[-1] == g.forced.table.numpy().tobytes()


def test_fused_forced_round_reads_the_host_at_most_once(tmp_path,
                                                        monkeypatch):
    X, y = _data("binary", n=6000)
    Xv, yv = _data("binary", n=1500, seed=3)
    params = dict(SLICE, objective="binary", device_type="cpu",
                  metric="auc",
                  forcedsplits_filename=_json(tmp_path, DEEP))
    reads, rounds, extra = fused_host_reads(monkeypatch, params, X, y, Xv,
                                            yv, 3)
    assert rounds == 3
    assert reads["body"] == 0
    assert reads["step"] <= rounds + extra


# ------------------------------------------------------------- behaviour
FAST = dict(min_data_in_leaf=5, verbosity=-1, device_type="cpu")


def test_forced_splits_top_every_tree(tmp_path):
    """tests/test_constraints.py::test_forced_splits on the port."""
    rng = np.random.default_rng(41)
    X = rng.normal(size=(2000, 4))
    y = X @ rng.normal(size=4) + rng.normal(scale=0.2, size=2000)
    fs = {"feature": 2, "threshold": 0.0,
          "left": {"feature": 3, "threshold": 0.5}}
    bst = lgb_torch.train(dict(FAST, objective="regression", num_leaves=15,
                               forcedsplits_filename=_json(tmp_path, fs)),
                          lgb_torch.Dataset(X, y), num_boost_round=5)
    for t in bst._gbdt.models:
        assert t.split_feature[0] == 2
        assert abs(t.threshold[0] - 0.0) < 0.1
        assert t.split_feature[1] == 3
        assert t.left_child[0] == 1
    assert np.corrcoef(bst.predict(X), y)[0, 1] > 0.8


def test_forced_splits_batched_match_strict(tmp_path):
    """tests/test_batch_grower.py's forced-splits check: the strict and the
    batched learner both apply the whole schedule."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(3000, 6))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)
    path = _json(tmp_path, {"feature": 0, "threshold": 0.0,
                            "left": {"feature": 1, "threshold": 0.5}})
    base = dict(FAST, objective="binary", num_leaves=15,
                forcedsplits_filename=path)
    bs = lgb_torch.train(dict(base, tpu_split_batch=1),
                         lgb_torch.Dataset(X, y), num_boost_round=4)
    bb = lgb_torch.train(dict(base, tpu_split_batch=4),
                         lgb_torch.Dataset(X, y), num_boost_round=4)
    assert bb._gbdt._use_batched_grower()
    assert not bs._gbdt._use_batched_grower()
    for ts, tb in zip(bs._gbdt.models, bb._gbdt.models):
        for t in (ts, tb):
            assert t.split_feature[0] == 0 and t.split_feature[1] == 1
            assert t.left_child[0] == 1
        assert ts.threshold_bin[0] == tb.threshold_bin[0]


def test_forced_splits_compose_with_hist_pool(tmp_path):
    """tests/test_hist_modes.py's pool case: the batched grower with the
    pool engaged applies the forced prefix to every tree."""
    rng = np.random.default_rng(20)
    X = rng.standard_normal((2000, 8))
    y = (X[:, 0] + 0.3 * X[:, 1]
         + rng.standard_normal(2000) * 0.2 > 0).astype(float)
    path = _json(tmp_path, {"feature": 0, "threshold": 0.0,
                            "left": {"feature": 1, "threshold": 0.5}})
    p = dict(FAST, objective="binary", num_leaves=31, tpu_split_batch=4,
             histogram_pool_size=0.5, forcedsplits_filename=path)
    bst = lgb_torch.train(p, lgb_torch.Dataset(X, y), num_boost_round=4)
    g = bst._gbdt
    assert g._use_batched_grower()
    assert 0 < g.hp.hist_pool_slots < g.hp.num_leaves
    for t in g.models:
        assert t.split_feature[0] == 0 and t.split_feature[1] == 1
