"""The port's cost-effective gradient boosting (CEGB: ``cegb_penalty_split``,
``cegb_penalty_feature_coupled``, ``cegb_penalty_feature_lazy``,
``cegb_tradeoff``) against lightgbm_tpu on the CPU.

* ``find_best_split``'s gain penalty equals the JAX package's on
  integer-valued histograms; the lazy counts (an integer scatter-add here,
  a float32 one-hot product there) are equal.
* ``train()`` of each penalty kind gives the JAX package's int8 model text
  byte for byte through the batched grower and the strict learner (int8
  levels), and its trees under the strict learner's float32 histograms
  (splits and counts equal, leaves rtol 1e-5 + atol 5e-5, gains rtol 1e-5
  and 1e-6 of the tree's largest); the acquisition state carried across
  the trees equals the JAX package's.  CEGB keeps the classic loop.
* The behaviour of the JAX package's tests/test_cegb.py (all five) holds
  for the port's models.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lgb_jax
from lightgbm_tpu.ops.split import SplitHyper as JSplitHyper
from lightgbm_tpu.ops.split import find_best_split as jax_find_best_split

import lightgbm_tpu_torch as lgb_torch
from lightgbm_tpu_torch.learner import grower as TGR
from lightgbm_tpu_torch.learner.batch_grower import grow_tree_batched
from lightgbm_tpu_torch.learner.grower import grow_tree
from lightgbm_tpu_torch.ops.split import SplitHyper, find_best_split

from test_torch_fused import one_torch_thread  # noqa: F401
from test_torch_train import SLICE, _data

STRICT = dict(num_leaves=15, verbosity=-1)
STRICT_INT8 = dict(SLICE, tpu_split_batch=1)
ROUNDS = 4

PENALTIES = {
    "split": dict(cegb_penalty_split=2e-4),
    "coupled": dict(cegb_penalty_feature_coupled=[8.0, 0, 0, 3.0, 0, 0, 0,
                                                  0.5]),
    "lazy": dict(cegb_penalty_feature_lazy=[2e-3, 1e-3, 0, 2e-3, 0, 0, 0,
                                            1e-3]),
    "all": dict(cegb_tradeoff=0.5, cegb_penalty_split=1e-4,
                cegb_penalty_feature_coupled=[8.0, 0, 0, 3.0],
                cegb_penalty_feature_lazy=[2e-3] * 8),
}


def _train_both(base, case, n, rounds=ROUNDS, bag=False):
    X, y = _data("regression", n=n)
    params = dict(base, objective="regression", **PENALTIES[case])
    if bag:
        params.update(bagging_fraction=0.7, bagging_freq=1)
    bj = lgb_jax.train(params, lgb_jax.Dataset(X, y), num_boost_round=rounds)
    bt = lgb_torch.train(dict(params, device_type="cpu"),
                         lgb_torch.Dataset(X, y), num_boost_round=rounds)
    return bj, bt


def _text(booster):
    head, params = booster.model_to_string().split("parameters:")
    lines = params.splitlines()
    if "[device_type: cpu]" in lines:
        lines.remove("[device_type: cpu]")
    return head, lines


def _assert_state(bj, bt):
    cj, ct = bj._gbdt.cegb, bt._gbdt.cegb
    np.testing.assert_array_equal(ct.feature_used.numpy(),
                                  np.asarray(cj.feature_used))
    assert (ct.used_rows is None) == (cj.used_rows is None)
    if ct.used_rows is not None:
        np.testing.assert_array_equal(ct.used_rows.numpy(),
                                      np.asarray(cj.used_rows))


# ---------------------------------------------------------- the penalty
@pytest.mark.parametrize("seed", range(3))
def test_gain_penalty_matches_jax(seed):
    rng = np.random.default_rng(seed)
    M, F, B = 3, 5, 16
    n = rng.integers(0, 40, size=(M, F, B)).astype(np.float32)
    g = rng.integers(-30, 31, size=(M, F, B)).astype(np.float32)
    h = n * 2.0
    hist = np.stack([g, h, n, np.zeros_like(n)], -1)
    # every feature's bins hold the same rows
    tot = hist[:, 0].sum(1)
    hist = np.broadcast_to(hist[:, :1], hist.shape).copy()
    nb = np.full(F, B, np.int32)
    nanb = np.array([-1, B - 1, -1, -1, 3], np.int32)
    pen = rng.uniform(0, 3, size=(M, F)).astype(np.float32)
    hp = SplitHyper(num_leaves=7, n_bins=B, min_data_in_leaf=2)
    jhp = JSplitHyper(num_leaves=7, n_bins=B, min_data_in_leaf=2)
    got = find_best_split(
        torch.as_tensor(hist), torch.as_tensor(tot[:, 0]),
        torch.as_tensor(tot[:, 1]), torch.as_tensor(tot[:, 2]),
        torch.as_tensor(nb), torch.as_tensor(nanb), None, None, hp,
        gain_penalty=torch.as_tensor(pen))
    for m in range(M):
        want = jax_find_best_split(
            jnp.asarray(hist[m]), jnp.float32(tot[m, 0]),
            jnp.float32(tot[m, 1]), jnp.float32(tot[m, 2]),
            jnp.asarray(nb), jnp.asarray(nanb),
            jnp.zeros(F, bool), None, jhp, gain_penalty=jnp.asarray(pen[m]))
        for f in got._fields:
            np.testing.assert_array_equal(getattr(got, f)[m].numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)


def test_lazy_counts_match_the_float_product():
    rng = np.random.default_rng(4)
    n, F, L = 5000, 6, 9
    used = rng.random((n, F)) < 0.4
    lor = rng.integers(0, L, size=n).astype(np.int32)
    mask = rng.random(n) < 0.8
    st = TGR.CegbState(torch.zeros(()), torch.zeros(F), torch.zeros(F),
                       torch.zeros(F, dtype=torch.bool),
                       torch.as_tensor(used))
    got = TGR.cegb_lazy_counts(st, torch.as_tensor(lor),
                               torch.as_tensor(mask), L)
    assert got.dtype == torch.int32
    for leaf in range(L):
        sel = ((lor == leaf) & mask).astype(np.float32)
        want = np.einsum("n,nf->f", sel, (~used).astype(np.float32))
        np.testing.assert_array_equal(got[leaf].numpy(), want)
    np.testing.assert_array_equal(got[L].numpy(), (~used[~mask]).sum(0))


# --------------------------------------------------------------- train()
@pytest.mark.parametrize("case", sorted(PENALTIES))
def test_batched_train_matches_jax(case):
    """int8 levels, the batched grower (the classic loop: CEGB keeps it)."""
    bj, bt = _train_both(SLICE, case, 10_000)
    assert bt._gbdt._use_batched_grower()
    assert not bt._gbdt.supports_fused()
    assert _text(bt) == _text(bj)
    _assert_state(bj, bt)


@pytest.mark.parametrize("case", ["lazy", "all"])
def test_strict_int8_train_matches_jax(case):
    bj, bt = _train_both(STRICT_INT8, case, 6_000, bag=case == "all")
    assert not bt._gbdt._use_batched_grower()
    assert _text(bt) == _text(bj)
    _assert_state(bj, bt)


@pytest.mark.parametrize("case", sorted(PENALTIES))
def test_strict_train_matches_jax(case):
    """float32 histograms, the strict learner."""
    bj, bt = _train_both(STRICT, case, 3_000)
    assert _text(bt)[1] == _text(bj)[1]
    for tt, tj in zip(bt._gbdt.models, bj._gbdt.models):
        assert tt.num_leaves == tj.num_leaves
        for f in ("split_feature", "threshold_bin", "decision_type",
                  "left_child", "right_child", "leaf_count"):
            np.testing.assert_array_equal(getattr(tt, f), getattr(tj, f),
                                          err_msg=f)
        np.testing.assert_allclose(tt.leaf_value, tj.leaf_value, rtol=1e-5,
                                   atol=5e-5)
        np.testing.assert_allclose(
            tt.split_gain, tj.split_gain, rtol=1e-5,
            atol=1e-6 * float(np.max(np.abs(tj.split_gain), initial=0.0)))
    _assert_state(bj, bt)


# ------------------------------------------------------------- behaviour
FAST = {"num_leaves": 15, "min_data_in_leaf": 5, "verbosity": -1,
        "enable_bundle": False, "device_type": "cpu"}


def _cegb_data(seed=0):
    """tests/test_cegb.py's data: features 0 and 1 equally informative
    duplicates."""
    rng = np.random.default_rng(seed)
    n = 2000
    X = rng.normal(size=(n, 6))
    X[:, 1] = X[:, 0] + rng.normal(scale=0.01, size=n)
    y = ((X[:, 0] + 0.5 * X[:, 2]) > 0).astype(np.float64)
    return X, y


def _uses(bst, F=6):
    """Splits per feature over the model (split importance)."""
    imp = np.zeros(F, np.int64)
    for t in bst._gbdt.models:
        for f in t.split_feature[:t.num_leaves - 1]:
            imp[int(f)] += 1
    return imp


def _accuracy(bst, X, y):
    return float(((bst.predict(X) > 0.5) == y).mean())


def test_coupled_penalty_steers_feature_choice():
    X, y = _cegb_data()
    b0 = lgb_torch.train(dict(FAST, objective="binary"),
                         lgb_torch.Dataset(X, y), num_boost_round=8)
    assert _uses(b0)[0] > 0
    b1 = lgb_torch.train(dict(FAST, objective="binary", cegb_tradeoff=1.0,
                              cegb_penalty_feature_coupled=[1e6, 0, 0, 0, 0,
                                                            0]),
                         lgb_torch.Dataset(X, y), num_boost_round=8)
    imp = _uses(b1)
    assert imp[0] == 0 and imp[1] > 0
    assert _accuracy(b1, X, y) > 0.9


def test_split_penalty_prunes():
    X, y = _cegb_data(seed=3)
    b0 = lgb_torch.train(dict(FAST, objective="binary"),
                         lgb_torch.Dataset(X, y), num_boost_round=5)
    b1 = lgb_torch.train(dict(FAST, objective="binary", cegb_tradeoff=1.0,
                              cegb_penalty_split=0.05),
                         lgb_torch.Dataset(X, y), num_boost_round=5)
    assert sum(t.num_leaves for t in b1._gbdt.models) < \
        sum(t.num_leaves for t in b0._gbdt.models)


def test_lazy_penalty_trains():
    X, y = _cegb_data(seed=5)
    b = lgb_torch.train(dict(FAST, objective="binary", cegb_tradeoff=1.0,
                             cegb_penalty_feature_lazy=[0.01] * 6),
                        lgb_torch.Dataset(X, y), num_boost_round=6)
    assert _accuracy(b, X, y) > 0.9
    st = b._gbdt.cegb
    assert st.used_rows is not None and st.used_rows.dtype == torch.bool
    assert bool(st.feature_used.any())


@pytest.mark.parametrize("lazy", [False, True])
def test_batched_batch1_identical_to_strict(lazy):
    """The batched grower at batch 1 (under the pool) and the strict one
    grow the same tree and the same acquisitions, under a bag."""
    X, y = _cegb_data()
    p = dict(FAST, objective="binary", cegb_tradeoff=1.0,
             cegb_penalty_split=1e-4,
             cegb_penalty_feature_coupled=[50.0, 0, 0, 10.0, 0, 0])
    if lazy:
        p["cegb_penalty_feature_lazy"] = [1e-3, 0, 0, 1e-3, 0, 0]
    b = lgb_torch.Booster(params=p, train_set=lgb_torch.Dataset(X, y))
    gb = b._gbdt
    rng = np.random.default_rng(3)
    g = torch.as_tensor(rng.normal(size=X.shape[0]).astype(np.float32))
    h = torch.as_tensor(rng.uniform(0.5, 1.5, size=X.shape[0])
                        .astype(np.float32))
    row_mask = torch.as_tensor(rng.uniform(size=X.shape[0]) < 0.7)

    def fresh():
        c = gb.cegb
        return c._replace(feature_used=torch.zeros_like(c.feature_used),
                          used_rows=None if c.used_rows is None
                          else torch.zeros_like(c.used_rows))

    cs, cb = fresh(), fresh()
    t_s, lor_s = grow_tree(gb.bins, g, h, row_mask, gb.num_bins_arr,
                           gb.nan_bin_arr, None, gb.hp, cegb=cs)
    import dataclasses
    hp1 = dataclasses.replace(gb.hp, hist_pool_slots=7)
    t_b, lor_b = grow_tree_batched(gb.bins, g, h, row_mask, gb.num_bins_arr,
                                   gb.nan_bin_arr, None, hp1, batch=1,
                                   cegb=cb)
    np.testing.assert_array_equal(lor_s.numpy(), lor_b.numpy())
    np.testing.assert_array_equal(t_s.split_feature.numpy(),
                                  t_b.split_feature.numpy())
    np.testing.assert_allclose(t_s.leaf_value.numpy(),
                               t_b.leaf_value.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(cs.feature_used.numpy(),
                                  cb.feature_used.numpy())
    if lazy:
        np.testing.assert_array_equal(cs.used_rows.numpy(),
                                      cb.used_rows.numpy())
        assert bool(cs.used_rows.any())


def test_batched_multi_split_rounds_price_out_features():
    X, y = _cegb_data()
    p = dict(FAST, objective="binary", tpu_split_batch=4, cegb_tradeoff=1.0,
             cegb_penalty_feature_coupled=[1e6, 0, 0, 0, 0, 0])
    bst = lgb_torch.train(p, lgb_torch.Dataset(X, y), num_boost_round=8)
    assert bst._gbdt._use_batched_grower()
    imp = _uses(bst)
    assert imp[0] == 0 and imp[1] > 0
    assert _accuracy(bst, X, y) > 0.9
    used = bst._gbdt.cegb.feature_used.numpy()
    assert used[1] and not used[0]
