"""The port's learning to rank against lightgbm_tpu on the CPU.

The same seeded numpy inputs go through both packages (the skewed
lognormal query lengths of tests/test_rank_buckets.py, integer labels 0-4,
and the ``synthetic_ranking`` fixture of tests/conftest.py):

* the query bucket plan (``_pad_queries``, ``_rank_bucket_ladder``,
  ``_rank_buckets``) equal to the JAX package's, for ``"auto"`` and for an
  explicit list;
* lambdarank gradients and hessians against ``LambdarankNDCG``'s over
  truncation {1, 3, 30} x norm x weights x positions, at the rank
  contract's rtol 3e-6 / atol 6e-7 (XLA's CPU ``exp`` and PyTorch's differ
  by an ulp, and the pair sums run in another order): ``jitted_gradients``
  (the JAX package's training path, one compiled program a bucket
  geometry) for the grid, the 5 calls of the position bias vector and
  rank_xendcg, ``get_gradients`` (op by op, ~20 s of op compiles a new
  shape) for a fixture with a 700-document query;
* rank_xendcg over 3 successive calls from one ``objective_seed``: the
  Gumbel draw's uniforms bit for bit against ``jax.random``, the gradients
  at the same tolerance;
* host ``ndcg`` / ``map`` to 1e-12, device ``ndcg`` to 1e-6;
* ``train()`` of each ranking objective in the strict and the batched
  grower compared with the JAX package's model as trees (split features,
  default directions and counts equal, every training row in the same
  leaf, leaves rtol 1e-5 + atol 5e-5; a threshold may differ inside a bin
  range no row of its node falls in, where the strict float32 learner's
  histogram residuals break an exact tie); lambdarank through the
  fused loop (text and valid history equal to the classic loop's, one
  host read a round) and ``supports_fused`` against the JAX package's;
* the refusals (no group, a short ``label_gain``), the position and group
  metadata, model text both ways and ``predict``'s raw scores;
* chip_smoke.py phase 11's host-side helpers (the MSLR-shaped generator,
  the pair count of the kernel's bound, the skewed kernel fixture).

The CUDA kernel (``csrc/rank.cu``) runs only on the card: chip_smoke.py
phase 11 holds it against the plain version these tests hold against the
JAX package.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgb_jax
from lightgbm_tpu import metrics as JM
from lightgbm_tpu import objectives as JO
from lightgbm_tpu.config import Config as JConfig

import lightgbm_tpu_torch as lgb_torch
from lightgbm_tpu_torch import metrics as TM
from lightgbm_tpu_torch.boosting import fused_graph as FG
from lightgbm_tpu_torch.boosting import gbdt as TG
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.objectives import create_objective as t_objective
from lightgbm_tpu_torch.ops import prng
from lightgbm_tpu_torch.ops import rank as TR

from test_torch_fused import (  # noqa: F401
    _ladder_on_small_data, fused_host_reads, one_torch_thread)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

#: the rank contract (ROADMAP.md): rtol 3e-6 / atol 6e-7
GRAD_TOL = dict(rtol=3e-6, atol=6e-7)
#: the batched int8 learner at a small size (tests/test_torch_train.py's
#: slice) and the strict float32 learner
SLICE = dict(num_leaves=15, max_bin=63, tpu_split_batch=4,
             use_quantized_grad=True, tpu_hist_dtype="int8",
             quant_train_renew_leaf=True, stochastic_rounding=False,
             hist_kernel="onehot", verbosity=-1)
STRICT = dict(num_leaves=15, verbosity=-1)


@pytest.fixture(autouse=True)
def _buckets_on(monkeypatch):
    """The JAX package's bucket ladder, never its pad-to-max hatch."""
    monkeypatch.delenv("LGBMTPU_NO_RANK_BUCKETS", raising=False)


def _skewed(n=900, f=4, seed=0):
    """Skewed (lognormal) query lengths with integer labels 0..4
    (tests/test_rank_buckets.py's fixture)."""
    rng = np.random.RandomState(seed)
    sizes = []
    rem = n
    while rem > 0:
        s = min(int(np.clip(rng.lognormal(2.2, 0.8), 2, 120)), rem)
        sizes.append(s)
        rem -= s
    sizes = np.asarray(sizes, np.int64)
    bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    y = np.concatenate([
        np.minimum(4, (rng.permutation(s) * 5) // max(s, 1))
        for s in sizes]).astype(np.float32)
    X = rng.standard_normal((n, f)).astype(np.float32)
    return X, y, sizes, bounds


def _positions(sizes, seed=11):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.permutation(int(s)) % 10 for s in sizes])


def _meta(y, bounds, weight=None, position=None):
    return types.SimpleNamespace(
        label=y, weight=weight, query_boundaries=np.asarray(bounds),
        position=position, init_score=None)


def _both(params, md, n):
    """The two packages' objectives of ``params``, initialised on ``md``."""
    jo = JO.create_objective(JConfig(params))
    to = t_objective(TConfig(params))
    jo.init(md, n)
    to.init(md, n)
    return jo, to


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or GRAD_TOL))


# ------------------------------------------------------------ bucket plan

@pytest.mark.parametrize("spec", ["auto", [8, 64], [4, 16, 1000]],
                         ids=["auto", "short-list", "long-list"])
def test_bucket_plan_matches_jax(spec):
    _, _, sizes, bounds = _skewed(n=1500, seed=2)
    assert TR._rank_bucket_ladder(sizes, spec) == \
        JO._rank_bucket_ladder(sizes, spec)
    got, pad_t = TR._rank_buckets(bounds, spec)
    want, pad_j = JO._rank_buckets(bounds, spec)
    assert pad_t == pad_j
    assert len(got) == len(want) > 1
    for (ct, qt, it), (cj, qj, ij) in zip(got, want):
        assert ct == cj
        np.testing.assert_array_equal(qt, qj)
        np.testing.assert_array_equal(it, ij)
    for a, b in zip(TR._pad_queries(bounds), JO._pad_queries(bounds)):
        np.testing.assert_array_equal(a, b)
    # the device plan carries the same geometry
    plan = TR.rank_plan(bounds, spec, torch.device("cpu"),
                        np.ones(len(sizes)))
    assert [b.cap for b in plan.buckets] == [c for c, _, _ in want]
    assert plan.qmax == int(sizes.max())
    np.testing.assert_array_equal(plan.bounds.numpy(), bounds)


# ------------------------------------------------------------ lambdarank

@pytest.mark.parametrize("positions", [False, True], ids=["", "pos"])
@pytest.mark.parametrize("weighted", [False, True], ids=["", "w"])
@pytest.mark.parametrize("norm", [True, False], ids=["norm", "nonorm"])
@pytest.mark.parametrize("trunc", [1, 3, 30])
def test_lambdarank_gradients_match_jax(trunc, norm, weighted, positions):
    _, y, sizes, bounds = _skewed(seed=trunc)
    rng = np.random.RandomState(3)
    w = rng.uniform(0.5, 1.5, len(y)).astype(np.float32) if weighted \
        else None
    pos = _positions(sizes) if positions else None
    params = dict(objective="lambdarank", lambdarank_truncation_level=trunc,
                  lambdarank_norm=norm,
                  lambdarank_position_bias_regularization=0.1)
    jo, to = _both(params, _meta(y, bounds, w, pos), len(y))
    assert to.jit_safe == jo.jit_safe == (not positions)
    # rounded: ties inside queries go by index in both
    score = np.round(rng.standard_normal(len(y)), 1).astype(np.float32)
    for _ in range(2):
        gj, hj = jo.jitted_gradients(jnp.asarray(score))
        gt, ht = to.get_gradients(torch.as_tensor(score))
        assert gt.dtype == ht.dtype == torch.float32
        _close(gt.numpy(), gj)
        _close(ht.numpy(), hj)
        assert float(np.abs(np.asarray(gj)).max()) > 0
        score = score - 0.5 * np.asarray(gj)


def test_lambdarank_long_query_and_edges_match_jax():
    """One query of 700 documents (several times the cap of the others), a
    query of one document and one whose labels are all equal (zero
    gradients)."""
    rng = np.random.RandomState(5)
    sizes = np.array([1, 12, 700, 30, 9, 2], np.int64)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    y = rng.randint(0, 5, sizes.sum()).astype(np.float32)
    y[bounds[3]:bounds[4]] = 2.0
    jo, to = _both(dict(objective="lambdarank"), _meta(y, bounds),
                   len(y))
    score = rng.standard_normal(len(y)).astype(np.float32)
    gj, hj = jo.get_gradients(jnp.asarray(score))
    gt, ht = to.get_gradients(torch.as_tensor(score))
    _close(gt.numpy(), gj)
    _close(ht.numpy(), hj)
    for q in (0, 3):
        s, e = bounds[q], bounds[q + 1]
        assert not gt[s:e].any() and not ht[s:e].any()


def test_position_bias_after_five_calls_matches_jax():
    _, y, sizes, bounds = _skewed(seed=10)
    pos = _positions(sizes)
    params = dict(objective="lambdarank", lambdarank_truncation_level=10,
                  lambdarank_position_bias_regularization=0.1,
                  learning_rate=0.3)
    jo, to = _both(params, _meta(y, bounds, None, pos), len(y))
    rng = np.random.RandomState(3)
    score = rng.standard_normal(len(y)).astype(np.float32)
    for _ in range(5):
        gj, _ = jo.jitted_gradients(jnp.asarray(score))
        gt, _ = to.get_gradients(torch.as_tensor(score))
        _close(gt.numpy(), gj)
        score = score - 0.1 * np.asarray(gj)
    bj = np.asarray(jo._pos_biases_dev)
    bt = to._pos_biases.numpy()
    assert bt.shape == bj.shape == (10,)
    np.testing.assert_allclose(bt, bj, rtol=3e-6, atol=2e-6)
    assert np.abs(bt).max() > 0


# ----------------------------------------------------------- rank_xendcg

@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "w"])
def test_xendcg_gradients_match_jax(weighted):
    _, y, sizes, bounds = _skewed(seed=7)
    rng = np.random.RandomState(4)
    w = rng.uniform(0.5, 1.5, len(y)).astype(np.float32) if weighted \
        else None
    params = dict(objective="rank_xendcg", objective_seed=9)
    jo, to = _both(params, _meta(y, bounds, w), len(y))
    assert not to.jit_safe and not jo.jit_safe
    tiny = float(np.finfo(np.float32).tiny)
    key = jax.random.PRNGKey(9)
    score = rng.standard_normal(len(y)).astype(np.float32)
    for _ in range(3):
        # the draw's key and uniforms, bit for bit
        key, sub = jax.random.split(key)
        kt = to._rng
        u_t = prng.gumbel_uniform(prng.split(kt)[1], len(y))
        u_j = jax.random.uniform(sub, (len(y),), minval=tiny, maxval=1.0)
        np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
        np.testing.assert_allclose(
            prng.gumbel(prng.split(kt)[1], len(y)).numpy(),
            np.asarray(jax.random.gumbel(sub, (len(y),))), rtol=1e-6,
            atol=1e-6)
        gj, hj = jo.jitted_gradients(jnp.asarray(score))
        gt, ht = to.get_gradients(torch.as_tensor(score))
        assert tuple(to._rng) == tuple(int(v) for v in np.asarray(
            jo._rng).reshape(-1))
        _close(gt.numpy(), gj)
        _close(ht.numpy(), hj)
        score = score - np.asarray(gj)


# --------------------------------------------------------------- metrics

def _metric_pair(name, y, bounds, **cfg):
    params = dict(objective="lambdarank", metric=name, **cfg)
    tm = TM.create_metrics(TConfig(params))[0]
    jm = JM.create_metrics(JConfig(params))[0]
    md = _meta(y, bounds)
    tm.init(md, len(y))
    jm.init(md, len(y))
    return tm, jm


@pytest.mark.parametrize("eval_at", [[1, 2, 3, 4, 5], [1, 3, 10, 200]],
                         ids=["default", "deep"])
@pytest.mark.parametrize("name", ["ndcg", "map"])
def test_host_rank_metrics_match_jax(name, eval_at):
    _, y, sizes, bounds = _skewed(seed=1)
    y[bounds[2]:bounds[3]] = 0.0          # a query with no relevant doc
    tm, jm = _metric_pair(name, y, bounds, eval_at=eval_at)
    assert tm.display_names() == jm.display_names()
    assert tm.bigger_is_better and jm.bigger_is_better
    score = np.round(np.random.RandomState(2).standard_normal(len(y)), 1)
    got, want = tm.eval(score), jm.eval(score)
    assert [k for k, _ in got] == [k for k, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-12, atol=0)
    assert tm.has_device_eval() == (name == "ndcg")


@pytest.mark.parametrize("spec", ["auto", [16, 64]], ids=["auto", "list"])
def test_device_ndcg_matches_jax(spec):
    _, y, sizes, bounds = _skewed(seed=3)
    y[bounds[0]:bounds[1]] = 0.0          # idcg 0 counts as 1.0
    tm, jm = _metric_pair("ndcg", y, bounds, eval_at=[1, 3, 5, 10],
                          rank_query_buckets=spec)
    score = np.round(np.random.RandomState(8).standard_normal(len(y)), 1) \
        .astype(np.float32)
    vt = tm.eval_device_traced(torch.as_tensor(score))
    vj = jm.eval_device_traced(jnp.asarray(score))
    assert vt.dtype == torch.float32 and tuple(vt.shape) == (4,)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-6)
    host = [v for _, v in tm.eval(score.astype(np.float64))]
    np.testing.assert_allclose(vt.numpy(), host, rtol=1e-6)


@pytest.mark.parametrize("objective", ["lambdarank", "rank_xendcg"])
def test_default_rank_metric_matches_jax(objective):
    params = dict(objective=objective)
    assert [m.NAME for m in TM.create_metrics(TConfig(params))] == \
        [m.NAME for m in JM.create_metrics(JConfig(params))] == ["ndcg"]
    _, y, _, bounds = _skewed(n=200, seed=1)
    m = TM.create_metrics(TConfig(dict(params, metric=["map", "ndcg"],
                                       eval_at=[2, 7])))
    for x in m:
        x.init(_meta(y, bounds), len(y))
    assert [x.display_names() for x in m] == [["map@2", "map@7"],
                                              ["ndcg@2", "ndcg@7"]]


# ----------------------------------------------------------------- train

def _rank_data(seed=0, n=1500):
    X, y, sizes, _ = _skewed(n=n, f=6, seed=seed)
    X = X.astype(np.float64)
    # a relevance signal: the label moves the first two features
    X[:, 0] += 0.6 * y
    X[:, 1] -= 0.3 * y
    return X, y, sizes


def _train_both(params, X, y, sizes, rounds, position=None, valid=None,
                classic=False, monkeypatch=None):
    """JAX and port boosters of ``params`` (the port on the CPU; its
    classic loop forced with ``classic``), with the recorded valid
    evaluations of each."""
    out = []
    for lgb, extra in ((lgb_jax, {}), (lgb_torch, {"device_type": "cpu"})):
        kw = {} if position is None else {"position": position}
        ds = lgb.Dataset(X, y, group=sizes, **kw)
        vs, rec, cbs = [], {}, []
        if valid is not None:
            vs = [ds.create_valid(valid[0], valid[1], group=valid[2])]
            cbs = [lgb.record_evaluation(rec)]
        if lgb is lgb_torch and classic:
            monkeypatch.setattr(TG.GBDT, "supports_fused",
                                lambda self: False)
        b = lgb.train(dict(params, **extra), ds, num_boost_round=rounds,
                      valid_sets=vs, valid_names=["v"] * len(vs),
                      callbacks=cbs)
        if lgb is lgb_torch and classic:
            monkeypatch.undo()
        out.append((b, rec.get("v")))
    return out


def _assert_trees_match(bt, bj, X):
    """The same trees: split features, decision types, children and leaf
    counts equal, every row of ``X`` (the training rows) in the same leaf,
    leaf values within rtol 1e-5 + atol 5e-5.  A threshold bin may differ
    only where no row of its node lies between the two: the strict
    float32 learner's histogram residuals break that exact tie of equal
    partitions its own way (tests/test_torch_categorical.py compares such
    trees as partitions of the rows too)."""
    for tt, tj in zip(bt._gbdt.models, bj._gbdt.models, strict=True):
        assert tt.num_leaves == tj.num_leaves
        np.testing.assert_array_equal(tt.split_feature, tj.split_feature)
        np.testing.assert_array_equal(tt.decision_type, tj.decision_type)
        np.testing.assert_array_equal(tt.left_child, tj.left_child)
        np.testing.assert_array_equal(tt.right_child, tj.right_child)
        np.testing.assert_array_equal(tt.leaf_count, tj.leaf_count)
        np.testing.assert_array_equal(tt.predict_leaf_index(X),
                                      tj.predict_leaf_index(X))
        np.testing.assert_allclose(tt.leaf_value, tj.leaf_value, rtol=1e-5,
                                   atol=5e-5)


@pytest.mark.parametrize("grower", ["strict", "int8"])
@pytest.mark.parametrize("case", ["lambdarank", "rank_xendcg",
                                  "lambdarank-position"])
def test_train_matches_jax(case, grower):
    X, y, sizes = _rank_data()
    params = dict(STRICT if grower == "strict" else SLICE,
                  objective=case.split("-")[0], metric="ndcg",
                  eval_at=[3, 5])
    pos = _positions(sizes) if case.endswith("position") else None
    Xv, yv, sv = _rank_data(seed=4, n=400)
    (bj, ej), (bt, et) = _train_both(params, X, y, sizes, 3, position=pos,
                                     valid=(Xv, yv, sv))
    g = bt._gbdt
    assert g._use_batched_grower() == (grower == "int8")
    assert g.supports_fused() == bj._gbdt.supports_fused() == (
        grower == "int8" and case == "lambdarank")
    assert bt.num_trees() == bj.num_trees() == 3
    assert all(t.num_leaves > 2 for t in g.models)
    _assert_trees_match(bt, bj, X)
    for k in ("ndcg@3", "ndcg@5"):
        np.testing.assert_allclose(et[k], ej[k], rtol=1e-5)
    # raw scores in both: a ranking model converts nothing
    Xt = np.random.default_rng(9).normal(size=(300, X.shape[1]))
    pt, pj = bt.predict(Xt), bj.predict(Xt)
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(pt, bt.predict(Xt, raw_score=True))
    if pos is not None:
        np.testing.assert_allclose(g.objective._pos_biases.numpy(),
                                   np.asarray(bj._gbdt.objective
                                              ._pos_biases_dev),
                                   rtol=1e-5, atol=1e-6)


def test_lambdarank_fused_matches_classic(monkeypatch):
    """Plain lambdarank with an ndcg valid set rides the fused loop (the
    device NDCG in the round), its text and valid history equal to the
    classic loop's; at most one host read a round."""
    X, y, sizes = _rank_data(n=3000)
    Xv, yv, sv = _rank_data(seed=4, n=800)
    params = dict(SLICE, objective="lambdarank", metric="ndcg",
                  eval_at=[1, 5])
    before = FG.counts["rounds"]
    (_, ej), (bf, ef) = _train_both(params, X, y, sizes, 4,
                                    valid=(Xv, yv, sv))
    assert FG.counts["rounds"] - before == 4
    assert bf._gbdt._fused_cache
    _, (bc, ec) = _train_both(params, X, y, sizes, 4, valid=(Xv, yv, sv),
                              classic=True, monkeypatch=monkeypatch)
    assert not bc._gbdt._fused_cache
    assert bf.model_to_string() == bc.model_to_string()
    assert ef == ec
    np.testing.assert_allclose(ef["ndcg@5"], ej["ndcg@5"], rtol=1e-5)
    reads, rounds, extra = fused_host_reads(
        monkeypatch, dict(params, device_type="cpu"), X, y, Xv, yv, 3,
        group=sizes, valid_group=sv)
    assert rounds == 3 and reads["body"] == 0
    assert reads["step"] <= rounds + extra


SUPPORTS = {
    "lambdarank": ({}, True),
    "lambdarank-ndcg-valid": (dict(metric="ndcg", valid=True), True),
    "lambdarank-map-valid": (dict(metric="map", valid=True), False),
    "rank_xendcg": (dict(objective="rank_xendcg"), False),
    "position": (dict(position=True), False),
    "by-query-bagging": (dict(bagging_by_query=True, bagging_fraction=0.5,
                              bagging_freq=1), False),
}


@pytest.mark.parametrize("case", sorted(SUPPORTS))
def test_supports_fused_matches_jax(case):
    extra, want = SUPPORTS[case]
    extra = dict(extra)
    valid = extra.pop("valid", False)
    X, y, sizes = _rank_data()
    pos = _positions(sizes) if extra.pop("position", False) else None
    params = dict(dict(SLICE, objective="lambdarank"), **extra)
    kw = {} if pos is None else {"position": pos}
    got = []
    for lgb, dev in ((lgb_jax, {}), (lgb_torch, {"device_type": "cpu"})):
        ds = lgb.Dataset(X, y, group=sizes, **kw)
        b = lgb.Booster(params=dict(params, **dev), train_set=ds)
        if valid:
            b.add_valid(ds.create_valid(X[:300], y[:300],
                                        group=[100, 200]), "v")
        got.append(b._gbdt.supports_fused())
    assert got == [want, want]


# ------------------------------------------------------------- refusals

def test_refusals_match_jax():
    X, y, sizes = _rank_data(n=400)
    for params, kw in ((dict(objective="lambdarank"), {}),
                       (dict(objective="rank_xendcg"), {}),
                       (dict(objective="lambdarank", label_gain=[0, 1, 3]),
                        {"group": sizes})):
        for lgb, dev in ((lgb_jax, {}),
                         (lgb_torch, {"device_type": "cpu"})):
            with pytest.raises(lgb.LightGBMError):
                lgb.train(dict(STRICT, **params, **dev),
                          lgb.Dataset(X, y, **kw), num_boost_round=1)
    md = _meta(y, None)
    md.query_boundaries = None
    for name in ("ndcg", "map"):
        tm = TM.create_metrics(TConfig(dict(metric=name)))[0]
        with pytest.raises(lgb_torch.LightGBMError):
            tm.init(md, len(y))


def test_position_and_group_metadata():
    """``Dataset(position=...)`` reaches the metadata as int32, and a valid
    set's ``group`` its query boundaries, as in the JAX package."""
    X, y, sizes = _rank_data(n=400)
    pos = _positions(sizes)
    dt = lgb_torch.Dataset(X, y, group=sizes, position=pos).construct()
    dj = lgb_jax.Dataset(X, y, group=sizes, position=pos).construct()
    for a, b in ((dt.inner.metadata.position, dj._inner.metadata.position),
                 (dt.inner.metadata.query_boundaries,
                  dj._inner.metadata.query_boundaries)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    vt = dt.create_valid(X[:100], y[:100], group=[40, 60]).construct()
    np.testing.assert_array_equal(vt.inner.metadata.query_boundaries,
                                  [0, 40, 100])
    assert lgb_torch.Dataset(X, y).construct().inner.metadata.position \
        is None


def test_rank_model_text_both_ways():
    X, y, sizes = _rank_data()
    (bj, _), (bt, _) = _train_both(dict(STRICT, objective="lambdarank"),
                                   X, y, sizes, 3)
    Xt = np.random.default_rng(2).normal(size=(200, X.shape[1]))
    text_t = bt.model_to_string()
    assert "objective=lambdarank" in text_t
    loaded_j = lgb_jax.Booster(model_str=text_t)
    loaded_t = lgb_torch.Booster(model_str=bj.model_to_string())
    np.testing.assert_allclose(loaded_j.predict(Xt), bt.predict(Xt),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loaded_t.predict(Xt), bj.predict(Xt),
                               rtol=1e-5, atol=1e-6)


# --------------------------------------------- chip_smoke.py phase 11

def test_mslr_generator_has_the_shape():
    rng = np.random.default_rng(15)
    sizes = chip_smoke.mslr_sizes(2000, 240_000, rng)
    assert sizes.sum() == 240_000 and len(sizes) == 2000
    assert sizes.min() >= 1 and sizes.max() <= chip_smoke.Q_MSLR_MAX
    X, y, pos, w = chip_smoke.synth_mslr(sizes[:50], rng)
    n = int(sizes[:50].sum())
    assert X.shape == (n, chip_smoke.F_MSLR) and X.dtype == np.float32
    assert set(np.unique(y)) <= {0, 1, 2, 3, 4}
    share = np.bincount(y.astype(int), minlength=5) / n
    np.testing.assert_allclose(share, chip_smoke.MSLR_LABELS, atol=0.01)
    starts = np.concatenate([[0], np.cumsum(sizes[:50])[:-1]])
    assert (pos[starts] == 0).all() and pos.max() == 29
    assert np.count_nonzero(w) == 40


def test_rank_pair_work_counts_the_kernels_pairs():
    rng = np.random.default_rng(1)
    sizes = np.array([1, 2, 7, 40, 3])
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    y = rng.integers(0, 3, sizes.sum()).astype(np.float32)
    score = np.round(rng.normal(size=sizes.sum()), 1)
    pairs, sort_ops = chip_smoke.rank_pair_work(score, y, bounds, 5)
    want = 0
    for q in range(len(sizes)):
        s, e = bounds[q], bounds[q + 1]
        lab = y[s:e][np.argsort(-score[s:e], kind="stable")]
        want += sum(lab[a] != lab[b] for a in range(min(5, e - s))
                    for b in range(a + 1, e - s))
    assert pairs == want
    assert sort_ops == pytest.approx(sum(q * np.log2(q) for q in sizes
                                         if q > 1))


def test_rank_kernel_fixture_has_its_edges():
    """The fixture chip_smoke.py holds the kernel to: a query of one
    document and one of equal labels (zero gradients), one longer than
    the kernel's shared-memory staging."""
    obj, sc = chip_smoke.rank_fixture(torch, np.random.default_rng(16),
                                      True, True, dev="cpu")
    plan = obj._plan
    b = plan.bounds.numpy()
    assert plan.qmax > TR.KERNEL_STAGE_DOCS
    assert b[-3] - b[-4] == 1
    y = obj._label.numpy()
    assert len(np.unique(y[b[-3]:b[-2]])) == 1
    g, h = obj.get_gradients(sc)
    for q in (len(b) - 4, len(b) - 3):
        assert not g[b[q]:b[q + 1]].any() and not h[b[q]:b[q + 1]].any()
    assert g[b[-2]:].abs().max() > 0 and obj._weight is not None


def test_slice_data_shares_a_set_unless_fresh(monkeypatch):
    """chip_smoke.py's HIGGS-shaped sets: one binned Dataset per (rows,
    seed, max_bin) for the trainings that share it; a repeat-run check
    asks for a fresh one, binned anew to the same bins."""
    monkeypatch.setattr(chip_smoke, "SLICE_DATA", {})
    a = chip_smoke.slice_data(lgb_torch, 2000, seed=3)
    assert chip_smoke.slice_data(lgb_torch, 2000, seed=3)[0] is a[0]
    b = chip_smoke.slice_data(lgb_torch, 2000, seed=3, fresh=True)
    assert b[0] is not a[0]
    assert chip_smoke.slice_data(lgb_torch, 2000, seed=3)[0] is a[0]
    np.testing.assert_array_equal(b[2], a[2])
    np.testing.assert_array_equal(np.asarray(b[0].inner.bins),
                                  np.asarray(a[0].inner.bins))
