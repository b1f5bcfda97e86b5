"""The port's fused round loop (``GBDT.train_fused``) on the CPU.

On the CPU the fused round's three bodies (boosting/fused_graph.py) run
eagerly instead of as CUDA graph replays; everything else is the card's
path: the batched tree with no host read (a fixed budget of K-wide rounds,
each gated on the device), the bucket chosen on the device, valid sets
scored by path aggregation, metrics evaluated on the device, the stop flag
inside the round and one transfer per chunk.  Inputs are made from seeded
numpy at a small size (6,000 rows, 8 features, 15-31 leaves, 4-16 splits a
round, the warm-up ladder's row threshold lowered on both sides).

* the fused loop against the classic loop (forced by patching
  ``GBDT.supports_fused``, as the JAX package's tests do): byte-identical
  model text for int8 stochastic levels at max_bin 255 and 63, the pooled
  grower, ``deterministic=true`` (float32), the onehot slice and a feature
  fraction; also with a one-round budget, so every tree takes the extra
  one-round body;
* the fused loop against the JAX package's ``train_fused``: byte-identical
  text on the regression slice, the same splits with leaf values at rtol
  1e-5 on binary;
* device metrics (l2, binary_logloss, auc; with and without weights) against
  the JAX package's ``eval_device_traced`` at rtol 1e-6;
* ``tree_path_masks`` / ``predict_bins_tree_matmul`` against the JAX
  package's and the port's walk, bitwise;
* early stopping (the JAX package's test_fused_valid.py mirrors):
  best_iteration, num_trees, predictions and best_score of the fused loop
  equal the classic loop's and the JAX package's, the stop state persists
  across chunks shorter than the window, and min_delta > 0 (no stop flag in
  the round) stops where the classic loop does;
* ``fused_chunk_for`` / ``fused_chunks`` and ``supports_fused`` against the
  JAX package's;
* the device bucket dispatch against the JAX package's and the full masked
  pass, bitwise, in every bucket (the full pass and n/4 .. n/64), and
  gated off in a round that is not live;
* at most one host read a boosting round inside a fused chunk's round
  bodies (``Tensor.item``, ``__bool__``, ``__int__``, ``__float__``,
  ``tolist`` and ``numpy`` counted).
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
from lightgbm_tpu.learner.grower import TreeArrays as JTreeArrays
from lightgbm_tpu.models import predict as JP
from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu.objectives import create_objective as j_objective

import lightgbm_tpu_torch as lgb_torch
from lightgbm_tpu_torch import metrics as TM
from lightgbm_tpu_torch.boosting import fused_graph as FG
from lightgbm_tpu_torch.boosting import gbdt as TG
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.convert import tree_arrays_from_numpy
from lightgbm_tpu_torch.learner import batch_grower as TBG
from lightgbm_tpu_torch.models import predict as TP
from lightgbm_tpu_torch.objectives import create_objective as t_objective
from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops import round_fuse as TRF

N, NF = 6000, 8
#: the default recipe at a small size (the auto policy's int8 levels and
#: leaf renewal set explicitly; 1024-row blocks make the compaction buckets
#: 2048 and 1024 rows at n = 6000)
DEFAULT = dict(num_leaves=31, tpu_split_batch=16, use_quantized_grad=True,
               tpu_hist_dtype="int8", quant_train_renew_leaf=True,
               tpu_rows_per_block=1024, verbosity=-1)
#: the regression slice of test_torch_train.py (onehot, no stochastic
#: rounding)
SLICE = dict(num_leaves=15, max_bin=63, tpu_split_batch=4,
             use_quantized_grad=True, tpu_hist_dtype="int8",
             quant_train_renew_leaf=True, stochastic_rounding=False,
             hist_kernel="onehot", verbosity=-1)


def _data(objective="binary", n=N, f=NF, seed=0, noise=0.5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[rng.random((n, f)) < 0.05] = np.nan
    z = np.nansum(X[:, :3] * np.array([1.0, -0.7, 0.4]), axis=1)
    y = 2.0 * np.tanh(3.0 * z) + noise * rng.normal(size=n)
    if objective == "binary":
        y = (y > 0).astype(np.float64)
    return X, y


@pytest.fixture(autouse=True)
def _ladder_on_small_data(monkeypatch):
    """The warm-up ladder runs from 1,024 rows in both packages."""
    monkeypatch.setattr(JBG, "_WARMUP_MIN_ROWS", 1024)
    monkeypatch.setattr(TBG, "_WARMUP_MIN_ROWS", 1024)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread for the test.  The port's CPU paths run
    many small ops; when several pytest processes share the cores, each
    process's full-width thread pool oversubscribes them and every op waits
    on its pool (30-50x slower).  Other port test files import this
    fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Loop:
    """Count the loops a ``train()`` takes, or force the classic one."""

    def __init__(self, monkeypatch, classic=False):
        self.fused = 0
        real = TG.GBDT.train_fused

        def spy(gb, *a, **k):
            self.fused += 1
            return real(gb, *a, **k)

        monkeypatch.setattr(TG.GBDT, "train_fused", spy)
        if classic:
            monkeypatch.setattr(TG.GBDT, "supports_fused",
                                lambda self: False)


def _train_port(params, X, y, rounds, monkeypatch, classic=False,
                valid=None, callbacks=None):
    loop = _Loop(monkeypatch, classic)
    ds = lgb_torch.Dataset(X, y)
    vs = [ds.create_valid(*valid)] if valid is not None else []
    bst = lgb_torch.train(dict(params, device_type="cpu"), ds,
                          num_boost_round=rounds, valid_sets=vs,
                          valid_names=["v"] * len(vs), callbacks=callbacks)
    monkeypatch.undo()
    monkeypatch.setattr(JBG, "_WARMUP_MIN_ROWS", 1024)
    monkeypatch.setattr(TBG, "_WARMUP_MIN_ROWS", 1024)
    assert loop.fused == (0 if classic else 1), "the wrong loop ran"
    return bst


CASES = {
    "default-255": dict(DEFAULT, max_bin=255),
    "default-63": dict(DEFAULT, max_bin=63),
    "pooled": dict(DEFAULT, max_bin=255, tpu_split_batch=4,
                   histogram_pool_size=0.25),
    "deterministic": dict(DEFAULT, max_bin=255, deterministic=True),
    "onehot-slice": SLICE,
    "feature-fraction": dict(DEFAULT, max_bin=255, feature_fraction=0.6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_matches_classic(case, monkeypatch):
    params = dict(CASES[case], objective="binary")
    X, y = _data()
    before = dict(FG.counts)
    fused = _train_port(params, X, y, 4, monkeypatch)
    rounds = FG.counts["rounds"] - before["rounds"]
    classic = _train_port(params, X, y, 4, monkeypatch, classic=True)
    assert rounds == 4
    g = fused._gbdt
    if case == "pooled":
        assert TBG.pooled(g.hp)
    if case == "deterministic":
        assert g.hp.hist_dtype == "float32"
    assert all(t.num_leaves > 2 for t in g.models)
    assert fused.model_to_string() == classic.model_to_string()


def test_fused_extra_rounds_match_classic(monkeypatch):
    """A budget of one K-wide round a tree: every tree keeps growing
    through the one-round body, and the round's tail runs again."""
    params = dict(DEFAULT, max_bin=255, objective="binary")
    X, y = _data()
    monkeypatch.setattr(FG, "full_width_rounds", lambda *a: 1)
    before = dict(FG.counts)
    fused = _train_port(params, X, y, 3, monkeypatch)
    extra = FG.counts["extra"] - before["extra"]
    classic = _train_port(params, X, y, 3, monkeypatch, classic=True)
    assert extra >= 3
    assert fused.model_to_string() == classic.model_to_string()


def test_fused_stump_ends_training_as_classic(monkeypatch):
    """A round that grows a stump ends training in both loops, the stump
    kept; the host stops replaying at it."""
    params = dict(DEFAULT, max_bin=255, objective="binary",
                  min_gain_to_split=1e9)
    X, y = _data()
    before = FG.counts["rounds"]
    fused = _train_port(params, X, y, 6, monkeypatch)
    rounds = FG.counts["rounds"] - before
    classic = _train_port(params, X, y, 6, monkeypatch, classic=True)
    assert rounds == fused.num_trees() == classic.num_trees() == 1
    assert fused.model_to_string() == classic.model_to_string()


@pytest.mark.parametrize("objective", ["regression", "binary"])
def test_fused_matches_jax_train_fused(objective, monkeypatch):
    """Both packages' train() take their fused loop on the default recipe
    (max_bin 255: radix kernels, ladder, stochastic rounding)."""
    X, y = _data(objective)
    params = dict(DEFAULT, max_bin=255, objective=objective)
    jcalls = []
    real = JGBDT.train_fused

    def spy(gb, *a, **k):
        jcalls.append(1)
        return real(gb, *a, **k)

    monkeypatch.setattr(JGBDT, "train_fused", spy)
    bj = lgb_jax.train(params, lgb_jax.Dataset(X, y), num_boost_round=4)
    monkeypatch.setattr(JGBDT, "train_fused", real)
    bt = _train_port(params, X, y, 4, monkeypatch)
    assert jcalls == [1]
    s_j, s_t = bj.model_to_string(), bt.model_to_string()
    head_j, _ = s_j.split("parameters:")
    head_t, _ = s_t.split("parameters:")
    Xt = np.random.default_rng(9).normal(size=(1000, NF))
    if objective == "regression":
        assert head_t == head_j
        np.testing.assert_array_equal(bt.predict(Xt), bj.predict(Xt))
        return
    for tt, tj in zip(bt._gbdt.models, bj._gbdt.models, strict=True):
        assert tt.num_leaves == tj.num_leaves
        np.testing.assert_array_equal(tt.split_feature, tj.split_feature)
        np.testing.assert_array_equal(tt.threshold_bin, tj.threshold_bin)
        np.testing.assert_allclose(tt.leaf_value, tj.leaf_value, rtol=1e-5)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weights"])
@pytest.mark.parametrize("name", ["l2", "binary_logloss", "auc"])
def test_device_metrics_match_jax(name, weighted):
    rng = np.random.default_rng(3)
    n = 4000
    label = (rng.random(n) < 0.4).astype(np.float64)
    # scores with ties (AUC's half-credit groups)
    score = np.round(rng.normal(size=n) + label, 2).astype(np.float32)
    weight = rng.random(n) + 0.5 if weighted else None
    md = types.SimpleNamespace(label=label, weight=weight)
    params = {"objective": "binary", "metric": name}
    tm = {m.NAME: m for m in TM.create_metrics(TConfig(params))}[name]
    jm = {m.NAME: m for m in JM.create_metrics(JConfig(params))}[name]
    tm.init(md, n)
    jm.init(md, n)
    obj_t, obj_j = t_objective(TConfig(params)), j_objective(JConfig(params))
    vt = tm.eval_device_traced(torch.as_tensor(score), obj_t)
    vj = jm.eval_device_traced(jnp.asarray(score), obj_j)
    assert vt.dtype == torch.float32 and tuple(vt.shape) == (1,)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-6)
    assert tm.display_names() == jm.display_names()


def _random_tree(rng, L, used, num_f, n_bins):
    """A tree of ``used`` leaves in capacity L, grown by random splits
    (the growers' numbering: node k splits one leaf into it and leaf
    k + 1)."""
    ni = L - 1
    sf = np.full(ni, -1, np.int32)
    sb = np.zeros(ni, np.int32)
    dl = np.zeros(ni, bool)
    lc = np.full(ni, -1, np.int32)
    rc = np.full(ni, -1, np.int32)
    where = {0: (-1, 0)}
    for k in range(used - 1):
        leaf = int(rng.integers(0, k + 1))
        p, side = where[leaf]
        if p >= 0:
            (lc if side == 0 else rc)[p] = k
        sf[k] = rng.integers(0, num_f)
        sb[k] = rng.integers(0, n_bins)
        dl[k] = rng.random() < 0.5
        lc[k], rc[k] = -(leaf + 1), -(k + 2)
        where[leaf], where[k + 1] = (k, 0), (k, 1)
    lv = rng.normal(size=L).astype(np.float32)
    lv[used:] = 0.0
    return dict(
        split_feature=sf, split_bin=sb, default_left=dl,
        split_cat=np.zeros(ni, bool), left_child=lc, right_child=rc,
        split_gain=np.zeros(ni, np.float32),
        cat_bitset=np.zeros((ni, n_bins), bool),
        internal_value=np.zeros(ni, np.float32),
        internal_count=np.zeros(ni, np.float32), leaf_value=lv,
        leaf_count=np.zeros(L, np.float32),
        leaf_weight=np.zeros(L, np.float32),
        leaf_depth=np.zeros(L, np.int32),
        leaf_path=np.zeros((L, num_f), bool),
        num_leaves=np.int32(used))


@pytest.mark.parametrize("L,used", [(2, 1), (2, 2), (15, 1), (15, 8),
                                    (15, 15), (31, 31), (255, 200),
                                    (255, 255)])
def test_path_masks_and_matmul_scoring_match_jax_and_walk(L, used):
    rng = np.random.default_rng(L * 1000 + used)
    num_f, n_bins, n = 6, 32, 3000
    d = _random_tree(rng, L, used, num_f, n_bins)
    tt = tree_arrays_from_numpy(d)
    tj = JTreeArrays(**{k: jnp.asarray(v) for k, v in d.items()})
    mp_t, mn_t, dep_t = TP.tree_path_masks(tt)
    mp_j, mn_j, dep_j = JP.tree_path_masks(tj)
    np.testing.assert_array_equal(mp_t.float().numpy(),
                                  np.asarray(mp_j, np.float32))
    np.testing.assert_array_equal(mn_t.float().numpy(),
                                  np.asarray(mn_j, np.float32))
    np.testing.assert_array_equal(dep_t.numpy(), np.asarray(dep_j))
    bins = rng.integers(0, n_bins, (n, num_f)).astype(np.uint8)
    nan_bin = np.array([3, -1, n_bins - 1, -1, 0, 7], np.int32)
    walk = TP.predict_bins_tree(tt, torch.as_tensor(bins),
                                torch.as_tensor(nan_bin))
    mm = TP.predict_bins_tree_matmul(
        tt, torch.as_tensor(np.ascontiguousarray(bins.T)),
        torch.as_tensor(nan_bin))
    mm_j = JP.predict_bins_tree_matmul(
        tj, jnp.asarray(np.ascontiguousarray(bins.T)), jnp.asarray(nan_bin))
    assert torch.equal(mm, walk)
    np.testing.assert_array_equal(mm.numpy(), np.asarray(mm_j))


def _es_task(n=N, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, NF))
    y = ((X @ rng.normal(size=NF) + 3.0 * rng.normal(size=n)) > 0) \
        .astype(np.float64)
    return X, y


ES_BASE = dict(objective="binary", metric="auc", num_leaves=15,
               min_data_in_leaf=5, tpu_split_batch=4, verbosity=-1)


@pytest.mark.parametrize("min_delta", [0.0, 0.01])
def test_fused_early_stopping_matches_classic_and_jax(min_delta,
                                                      monkeypatch):
    """The test_fused_valid.py mirror: best_iteration, model length,
    predictions and best_score; record_evaluation sees every round."""
    X, y = _es_task()
    Xv, yv = _es_task(1500, seed=2)

    def port(classic):
        rec = {}
        b = _train_port(ES_BASE, X, y, 80, monkeypatch, classic=classic,
                        valid=(Xv, yv),
                        callbacks=[lgb_torch.early_stopping(
                            5, verbose=False, min_delta=min_delta),
                            lgb_torch.record_evaluation(rec),
                            lgb_torch.log_evaluation(10)])
        return b, rec

    b_fused, rec_f = port(False)
    b_classic, rec_c = port(True)
    ds = lgb_jax.Dataset(X, label=y, params=ES_BASE)
    b_jax = lgb_jax.train(ES_BASE, ds, num_boost_round=80,
                          valid_sets=[ds.create_valid(Xv, label=yv)],
                          valid_names=["v"],
                          callbacks=[lgb_jax.early_stopping(
                              5, verbose=False, min_delta=min_delta)])
    assert 0 < b_fused.best_iteration < 80, "the task must stop early"
    assert b_fused.best_iteration == b_classic.best_iteration \
        == b_jax.best_iteration
    assert b_fused.num_trees() == b_classic.num_trees() == b_jax.num_trees()
    np.testing.assert_array_equal(b_fused.predict(X[:500]),
                                  b_classic.predict(X[:500]))
    np.testing.assert_allclose(b_fused.predict(X[:500]),
                               b_jax.predict(X[:500]), atol=1e-6)
    assert b_fused.best_score == b_classic.best_score
    np.testing.assert_allclose(b_fused.best_score["v"]["auc"],
                               b_jax.best_score["v"]["auc"], rtol=1e-6)
    assert rec_f == rec_c and len(rec_f["v"]["auc"]) == b_fused.num_trees()
    # the score caches the fused chunk advanced past the stop are rebuilt
    np.testing.assert_allclose(b_fused._gbdt.valid_scores[0].numpy(),
                               b_classic._gbdt.valid_scores[0].numpy(),
                               atol=1e-5)


def test_fused_stop_state_persists_across_chunks():
    """With chunks of 2 rounds and a stall window of 3, the round's own
    stop flag must carry its best rounds across chunks to trip at the
    detection round: the host then stops replaying right there."""
    X, y = _es_task()
    Xv, yv = _es_task(1500, seed=2)
    p = dict(ES_BASE, device_type="cpu")
    ds = lgb_torch.Dataset(X, y)
    b = lgb_torch.Booster(params=p, train_set=ds)
    b.add_valid(ds.create_valid(Xv, yv), "v")
    gb = b._gbdt
    assert gb.supports_fused()
    hits = []

    def driver(it, evals):
        hits.append((it, evals[0][2]))
        best = max(h[1] for h in hits)
        best_it = min(i for i, v in hits if v == best)
        if it - best_it >= 3:
            raise lgb_torch.EarlyStopException(best_it, evals)

    before = FG.counts["rounds"]
    with pytest.raises(lgb_torch.EarlyStopException):
        gb.train_fused(50, chunk=2, cb_driver=driver,
                       es_params=(3, False, 0.0))
    stop_it = hits[-1][0]
    best_it = stop_it - 3
    assert best_it // 2 < stop_it // 2, "the stall must span chunks"
    assert len(gb.models) == stop_it + 1
    fr = gb._fused_cache[(2, 1, (3, False), False)]
    assert bool(fr.stopped)
    assert FG.counts["rounds"] - before == stop_it + 1


def test_fused_chunks_match_jax():
    for r in range(1, 201):
        assert TG.GBDT.fused_chunk_for(r) == JGBDT.fused_chunk_for(r)
        assert TG.GBDT.fused_chunks(r) == JGBDT.fused_chunks(r)


SUPPORTS = {
    "batched": {},
    "strict": dict(tpu_split_batch=1),
    "pooled-strict": dict(tpu_split_batch=1, histogram_pool_size=0.1),
    "valid-auc": dict(metric="auc", valid=True),
    "valid-logloss-l2": dict(metric=["binary_logloss", "auc"], valid=True),
    "valid-deterministic": dict(metric="auc", deterministic=True,
                                valid=True),
    "valid-host-eval": dict(metric="auc", tpu_device_eval=False,
                            valid=True),
    "feature-fraction": dict(feature_fraction=0.5),
    "regression": dict(objective="regression"),
}


@pytest.mark.parametrize("case", sorted(SUPPORTS))
def test_supports_fused_matches_jax(case):
    extra = dict(SUPPORTS[case])
    valid = extra.pop("valid", False)
    params = dict(dict(objective="binary", num_leaves=15, tpu_split_batch=4,
                       verbosity=-1), **extra)
    X, y = _data(params["objective"], n=2000)
    dj = lgb_jax.Dataset(X, y, params=params)
    dt = lgb_torch.Dataset(X, y)
    bj = lgb_jax.Booster(params=params, train_set=dj)
    bt = lgb_torch.Booster(params=dict(params, device_type="cpu"),
                           train_set=dt)
    if valid:
        bj.add_valid(dj.create_valid(X[:500], label=y[:500]), "v")
        bt.add_valid(dt.create_valid(X[:500], y[:500]), "v")
    assert bt._gbdt.supports_fused() == bj._gbdt.supports_fused()


def _dispatch_inputs(rng, n, K, frac):
    """K leaves whose rows make ``frac`` of n (leaf ids 0..2K-1, half of
    them selected), with the fused partition's key and payload."""
    num_f, n_bins = 6, 64
    bins_t = torch.as_tensor(rng.integers(0, n_bins, (num_f, n),
                                          dtype=np.uint8))
    lor = np.where(rng.random(n) < frac, rng.integers(0, K, n),
                   rng.integers(K, 2 * K, n)).astype(np.int32)
    grad = torch.as_tensor(rng.integers(-8, 9, n).astype(np.float32))
    hess = torch.as_tensor(rng.integers(0, 9, n).astype(np.float32))
    lor = torch.as_tensor(lor)
    leaves = torch.arange(K, dtype=torch.int32)
    counts = torch.stack([(lor == k).sum() for k in range(K)]).float()
    _, key, payload = TRF.partition_payload(
        bins_t, TH.bins_to_words(bins_t.t()), grad, hess, lor,
        torch.ones(n, dtype=torch.int32), leaves, torch.zeros_like(leaves),
        torch.zeros_like(leaves), torch.full_like(leaves, -1), leaves,
        leaves + 2 * K, torch.zeros_like(leaves), leaves)
    return bins_t, grad, hess, lor, leaves, counts, key, payload, n_bins


@pytest.mark.parametrize("hist_dtype", ["int8", "float32"])
@pytest.mark.parametrize("frac,bucket", [(0.6, 0), (0.22, 4), (0.11, 8),
                                         (0.055, 16), (0.012, 64)])
def test_device_bucket_dispatch_matches_jax(frac, bucket, hist_dtype,
                                            monkeypatch):
    """The bucket chosen on the device (both passes launched, one gated
    off) gives the JAX package's ``lax.switch`` dispatch bit for bit, and
    the full masked pass's histogram, in every bucket."""
    n, K = 65_536, 4
    rng = np.random.default_rng(int(frac * 1000))
    (bins_t, grad, hess, lor, leaves, counts, key, payload,
     n_bins) = _dispatch_inputs(rng, n, K, frac)
    kw = dict(n_bins=n_bins, rows_per_block=1024, hist_dtype=hist_dtype,
              hist_kernel="onehot")
    seen = {}
    real = TH.histogram_payload

    def spy(pc, lv, cnt, **k):
        seen.setdefault("S", []).append(int(k["rows"]))
        seen.setdefault("gate", []).append(bool(k["gate"]))
        return real(pc, lv, cnt, **k)

    monkeypatch.setattr(TH, "histogram_payload", spy)
    got = TH.histogram_for_leaves_auto(
        bins_t, grad, hess, lor, leaves, counts=counts, sort_key=key,
        payload=payload, **kw)
    want = JH.histogram_for_leaves_auto(
        jnp.asarray(bins_t.t().numpy()), jnp.asarray(bins_t.numpy()),
        jnp.asarray(grad.numpy()), jnp.asarray(hess.numpy()),
        jnp.asarray(lor.numpy()), jnp.asarray(leaves.numpy()),
        counts=jnp.asarray(counts.numpy()), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    full = TH.histogram_for_leaves_masked(
        bins_t, grad, hess, lor, leaves, None, n_bins=n_bins,
        hist_dtype=hist_dtype, hist_kernel="onehot")
    assert torch.equal(got, full)
    sizes = TH.bucket_sizes(n, 1024)
    want_s = 0 if bucket == 0 else sizes[[4, 8, 16, 64].index(bucket)]
    # one payload pass over the largest bucket, gated on the chosen S
    assert seen == {"S": [want_s], "gate": [bucket != 0]}
    assert int(counts.sum()) <= (want_s or n)


@pytest.mark.parametrize("frac", [0.6, 0.055])
def test_device_bucket_dispatch_not_live(frac):
    """A round that is not live gates both passes off: zeros."""
    n, K = 65_536, 4
    (bins_t, grad, hess, lor, leaves, counts, key, payload,
     n_bins) = _dispatch_inputs(np.random.default_rng(3), n, K, frac)
    got = TH.histogram_for_leaves_auto(
        bins_t, grad, hess, lor, leaves, counts=counts, sort_key=key,
        payload=payload, n_bins=n_bins, rows_per_block=1024,
        hist_dtype="int8", live=torch.tensor(False))
    assert not got.any()


def test_fused_round_reads_the_host_at_most_once(monkeypatch):
    """Host reads inside a fused chunk's round bodies: one flag word a
    boosting round, nothing in the bodies themselves."""
    params = dict(DEFAULT, max_bin=255, objective="binary",
                  device_type="cpu", metric="auc")
    X, y = _data()
    Xv, yv = _data(n=1500, seed=3)
    reads, rounds, extra = fused_host_reads(monkeypatch, params, X, y, Xv,
                                            yv, 5)
    assert rounds == 5 and extra == 0
    assert reads["body"] == 0
    assert reads["step"] <= rounds


def fused_host_reads(monkeypatch, params, X, y, Xv, yv, num_rounds,
                     group=None, valid_group=None):
    """Train ``num_rounds`` fused rounds with a valid set, counting the
    host reads (``Tensor.item``, ``__bool__``, ``__int__``, ``__float__``,
    ``tolist``, ``numpy``) inside the round bodies ("body") and in the
    host's step around them ("step"); returns (reads, rounds, extra
    one-round replays).  ``group`` / ``valid_group``: the query sizes of
    ranking data."""
    ds = lgb_torch.Dataset(X, y, group=group)
    b = lgb_torch.Booster(params=params, train_set=ds)
    b.add_valid(ds.create_valid(Xv, yv, group=valid_group), "v")
    gb = b._gbdt
    assert gb.supports_fused()
    reads = {"body": 0, "step": 0}
    state = {"where": None}

    def counting(name):
        real = getattr(torch.Tensor, name)

        def f(self, *a, **k):
            if state["where"] is not None:
                reads[state["where"]] += 1
            return real(self, *a, **k)
        return f

    for name in ("item", "__bool__", "__int__", "__float__", "tolist",
                 "numpy"):
        monkeypatch.setattr(torch.Tensor, name, counting(name))
    for body in ("grads", "main", "extra", "tail"):
        def wrapped(self, _real=getattr(FG.FusedRound, body)):
            state["where"] = "body"
            try:
                return _real(self)
            finally:
                state["where"] = "step"
        monkeypatch.setattr(FG.FusedRound, body, wrapped)
    real_step = FG.FusedRound._step

    def step(self, name):
        state["where"] = "step"
        try:
            return real_step(self, name)
        finally:
            state["where"] = None

    monkeypatch.setattr(FG.FusedRound, "_step", step)
    before = dict(FG.counts)
    gb.train_fused(num_rounds, cb_driver=lambda it, ev: None)
    return (reads, FG.counts["rounds"] - before["rounds"],
            FG.counts["extra"] - before["extra"])


@pytest.mark.parametrize("frac", [0.0, 0.01, 0.3, 1.0])
def test_compact_rows_equals_the_sorted_keys(frac):
    """The device dispatch's prefix-sum compaction takes the sort's rows."""
    rng = np.random.default_rng(int(frac * 100))
    n = 10_007
    rows = torch.arange(n, dtype=torch.int32)
    sel = torch.as_tensor(rng.random(n) < frac)
    key = torch.where(sel, rows, rows | (1 << 30))
    for S in (1, 2048, n):
        want = torch.sort(key).values[:S] & ((1 << 30) - 1)
        assert torch.equal(TH.compact_rows(key, S), want.long())
