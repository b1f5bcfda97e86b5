"""The port's linear trees (``linear_tree``) and ``tpu_debug_checks``
against lightgbm_tpu on the CPU.

* The plain versions of csrc/linear.cu's two entries
  (ops/linear_kernels.py ``normal_equations_plain``,
  ``leaf_scores_plain``) under the port's ``fit_linear_leaves`` /
  ``linear_leaf_scores`` against the JAX functions on the same inputs:
  the normal equations against a float64 sum (rtol 1e-5 of each leaf's
  largest entry), the fitted constants and coefficients (rtol 1e-4, atol
  1e-5: the sums' order differs from XLA's contraction), the scores
  (rtol 1e-5, atol 1e-6), NaN rows and a leaf with too few rows included.
* ``train()`` with linear trees through the strict learner and the batched
  grower (the classic loop: linear trees keep it): the trees' structure
  and leaf features equal the JAX package's, ``leaf_const`` and
  ``leaf_coeff`` within rtol 1e-4 + atol 2e-5, the training and valid
  scores and the predictions within rtol 1e-5 + atol 2e-5 of the largest.
* Prediction: the forest's linear mode (plain version) against the host
  walk and the JAX package's forest, bit for bit against the kernel's
  order on the same inputs; a JAX-trained linear model loads into the port
  and predicts the same.
* ``tpu_debug_checks`` trains the same model, and catches a broken tree.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lgb_jax
from lightgbm_tpu.learner.linear import fit_linear_leaves as jax_fit
from lightgbm_tpu.learner.linear import linear_leaf_scores as jax_scores

import lightgbm_tpu_torch as lgb_torch
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.boosting import gbdt as TG
from lightgbm_tpu_torch.convert import (booster_from_model_string,
                                        tree_from_numpy)
from lightgbm_tpu_torch.learner.linear import (fit_linear_leaves,
                                               leaf_features,
                                               linear_leaf_scores)
from lightgbm_tpu_torch.models import predict as TP
from lightgbm_tpu_torch.ops import forest_kernels as FK
from lightgbm_tpu_torch.ops import linear_kernels as LK

from test_torch_fused import one_torch_thread  # noqa: F401
from test_torch_train import SLICE

STRICT = dict(num_leaves=15, min_data_in_leaf=20, verbosity=-1)
BATCHED = dict(STRICT, tpu_split_batch=4)
ROUNDS = 5


def _pl_data(n=3000, f=5, seed=9, nan=0.03):
    """A piecewise-linear target with NaN holes."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[rng.random((n, f)) < nan] = np.nan
    Z = np.nan_to_num(X)
    y = 1.5 * Z[:, 0] + np.where(Z[:, 1] > 0, 2.0 * Z[:, 2], -Z[:, 2]) \
        + rng.normal(scale=0.2, size=n)
    return X, y


def _fit_inputs(seed, n=4000, F=6, L=7, nan=0.05):
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=(n, F)).astype(np.float32)
    raw[rng.random((n, F)) < nan] = np.nan
    lor = rng.integers(0, L, size=n).astype(np.int32)
    # leaf 6 holds three rows: fewer than its unknowns
    lor[lor == 6] = 5
    lor[:3] = 6
    path = rng.random((L, F)) < 0.5
    path[0] = False                       # no path feature: keeps its value
    path[6] = True
    is_num = np.ones(F, bool)
    is_num[4] = False                     # a categorical path feature
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    mask = rng.random(n) < 0.8
    lv = rng.normal(size=L).astype(np.float32)
    return raw, lor, path, is_num, g, h, mask, lv


# ------------------------------------------------------ the plain twins
@pytest.mark.parametrize("masked", [False, True])
def test_normal_equations_plain_matches_float64(masked):
    raw, lor, path, is_num, g, h, mask, _ = _fit_inputs(0)
    feat = leaf_features(torch.as_tensor(path & is_num[None]), 16)
    m = mask if masked else None
    xthx, xtg, cnt = LK.normal_equations_plain(
        torch.as_tensor(raw), torch.as_tensor(lor), feat, torch.as_tensor(g),
        torch.as_tensor(h), None if m is None else torch.as_tensor(m),
        block=1000)
    F = raw.shape[1]
    rp = np.concatenate([raw, np.zeros((raw.shape[0], 1), np.float32)], 1)
    fi = feat.numpy()
    for leaf in range(path.shape[0]):
        rows = lor == leaf
        x = rp[rows][:, fi[leaf]].astype(np.float64)
        w = (~np.isnan(x).any(1)).astype(np.float64)
        if m is not None:
            w = w * m[rows]
        xx = np.concatenate([np.nan_to_num(x), np.ones((len(x), 1))], 1)
        want = (xx * (h[rows] * w)[:, None]).T @ xx
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(xthx[leaf].numpy(), want, rtol=0,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(xtg[leaf].numpy(),
                                   xx.T @ (g[rows] * w), rtol=0,
                                   atol=1e-5 * scale)
        assert cnt[leaf].item() == w.sum()
        assert (fi[leaf] <= F).all()


@pytest.mark.parametrize("seed", range(3))
def test_fit_linear_leaves_matches_jax(seed):
    raw, lor, path, is_num, g, h, mask, lv = _fit_inputs(seed)
    m = mask if seed != 1 else None
    c_j, k_j = jax_fit(jnp.asarray(raw), jnp.asarray(lor), jnp.asarray(path),
                       jnp.asarray(is_num), jnp.asarray(g), jnp.asarray(h),
                       None if m is None else jnp.asarray(m),
                       jnp.asarray(lv), 0.01)
    c_t, k_t = fit_linear_leaves(
        torch.as_tensor(raw), torch.as_tensor(lor), torch.as_tensor(path),
        torch.as_tensor(is_num), torch.as_tensor(g), torch.as_tensor(h),
        None if m is None else torch.as_tensor(m), torch.as_tensor(lv), 0.01)
    c_j, k_j = np.asarray(c_j), np.asarray(k_j)
    np.testing.assert_array_equal(k_t.numpy() != 0, k_j != 0)
    np.testing.assert_allclose(c_t.numpy(), c_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(k_t.numpy(), k_j, rtol=1e-4, atol=1e-5)
    # no path feature, and too few rows: the constant, no coefficient
    for leaf in (0, 6):
        assert c_t[leaf].item() == lv[leaf]
        assert not k_t[leaf].any()
    # a categorical path feature never takes a coefficient
    assert not k_t[:, 4].any()


@pytest.mark.parametrize("seed", range(3))
def test_linear_leaf_scores_match_jax(seed):
    raw, lor, path, is_num, g, h, mask, lv = _fit_inputs(seed)
    c, k = jax_fit(jnp.asarray(raw), jnp.asarray(lor), jnp.asarray(path),
                   jnp.asarray(is_num), jnp.asarray(g), jnp.asarray(h),
                   None, jnp.asarray(lv), 0.01)
    want = np.asarray(jax_scores(jnp.asarray(raw), jnp.asarray(lor), c, k,
                                 jnp.asarray(lv)))
    got = linear_leaf_scores(torch.as_tensor(raw), torch.as_tensor(lor),
                             torch.as_tensor(np.asarray(c)),
                             torch.as_tensor(np.asarray(k)),
                             torch.as_tensor(lv)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the rows with a NaN in a used feature score the plain leaf value
    kk = np.asarray(k)
    bad = (np.isnan(raw) & (kk[lor] != 0)).any(1)
    assert bad.any()
    np.testing.assert_array_equal(got[bad], lv[lor[bad]])


def test_leaf_scores_plain_sums_in_feature_order():
    """The plain version's bits: products added one feature after another
    (the kernel's order), then the constant."""
    rng = np.random.default_rng(5)
    n, F, L = 600, 5, 4
    raw = rng.normal(size=(n, F)).astype(np.float32) * 1e3
    lor = rng.integers(0, L, size=n).astype(np.int32)
    feat = np.array([[0, 2, 5], [1, 3, 4], [0, 1, 2], [5, 5, 5]])
    coef = rng.normal(size=(L, 3)).astype(np.float32)
    coef[1, 1] = 0.0
    const = rng.normal(size=L).astype(np.float32)
    got = LK.leaf_scores_plain(torch.as_tensor(raw), torch.as_tensor(lor),
                               torch.as_tensor(feat), torch.as_tensor(coef),
                               torch.as_tensor(const),
                               torch.zeros(L)).numpy()
    rp = np.concatenate([raw, np.zeros((n, 1), np.float32)], 1)
    for r in range(n):
        acc = np.float32(0.0)
        for j in range(3):
            c = coef[lor[r], j]
            if c != 0:
                acc = np.float32(acc + np.float32(c * rp[r, feat[lor[r],
                                                                  j]]))
        assert got[r] == np.float32(acc + const[lor[r]])


# --------------------------------------------------------------- train()
def _train_both(base, X, y, Xv=None, yv=None, rounds=ROUNDS, **extra):
    p = dict(base, objective="regression", linear_tree=True,
             linear_lambda=0.01, **extra)
    dj, dt = lgb_jax.Dataset(X, y), lgb_torch.Dataset(X, y)
    vj = vt = []
    if Xv is not None:
        vj = [dj.create_valid(Xv, yv)]
        vt = [dt.create_valid(Xv, yv)]
    bj = lgb_jax.train(p, dj, num_boost_round=rounds, valid_sets=vj)
    bt = lgb_torch.train(dict(p, device_type="cpu"), dt,
                         num_boost_round=rounds, valid_sets=vt)
    return bj, bt


def _assert_linear_trees_match(bj, bt):
    assert len(bt._gbdt.models) == len(bj._gbdt.models)
    for tt, tj in zip(bt._gbdt.models, bj._gbdt.models):
        assert tt.is_linear == tj.is_linear
        assert tt.num_leaves == tj.num_leaves
        for f in ("split_feature", "threshold_bin", "decision_type",
                  "left_child", "right_child", "leaf_count"):
            np.testing.assert_array_equal(getattr(tt, f), getattr(tj, f),
                                          err_msg=f)
        assert tt.leaf_features == tj.leaf_features
        np.testing.assert_allclose(tt.leaf_const, tj.leaf_const, rtol=1e-4,
                                   atol=2e-5)
        for a, b in zip(tt.leaf_coeff, tj.leaf_coeff):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-5)


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=1e-5,
                               atol=2e-5 * max(np.abs(b).max(), 1.0))


@pytest.mark.parametrize("learner", ["strict", "batched"])
def test_train_matches_jax(learner):
    X, y = _pl_data()
    Xv, yv = _pl_data(800, seed=10)
    bj, bt = _train_both(STRICT if learner == "strict" else BATCHED, X, y,
                         Xv, yv)
    g = bt._gbdt
    assert g._use_batched_grower() == (learner == "batched")
    assert g.linear and not g.supports_fused()
    assert any(t.is_linear for t in g.models)
    _assert_linear_trees_match(bj, bt)
    _close(g.scores.numpy(), np.asarray(bj._gbdt.scores))
    _close(g.valid_scores[0].numpy(), np.asarray(bj._gbdt.valid_scores[0]))
    _close(bt.predict(X), bj.predict(X))
    # NaN rows included: they score the plain leaf value
    assert np.isnan(X).any(1).sum() > 100


def test_train_int8_batched_matches_jax():
    """use_quantized_grad with linear trees: the tree from int8 levels, the
    fit from the true gradients."""
    X, y = _pl_data(10_000)
    bj, bt = _train_both(dict(SLICE, min_data_in_leaf=20), X, y)
    _assert_linear_trees_match(bj, bt)
    _close(bt.predict(X), bj.predict(X))


def test_leaf_with_too_few_rows_keeps_its_constant():
    """min_data_in_leaf=2 with 20 features a leaf may hold: leaves whose
    usable rows are fewer than their unknowns get no coefficient, in both
    packages."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(400, 20))
    y = X[:, 0] + np.sin(3 * X[:, 1]) + 0.1 * rng.normal(size=400)
    bj, bt = _train_both(dict(STRICT, num_leaves=31, min_data_in_leaf=2),
                         X, y, rounds=1)
    _assert_linear_trees_match(bj, bt)
    t = bt._gbdt.models[0]
    short = [leaf for leaf in range(t.num_leaves)
             if not t.leaf_features[leaf]]
    assert short
    for leaf in short:
        assert t.leaf_const[leaf] == t.leaf_value[leaf]


def test_linear_beats_constant_and_round_trips():
    """tests/test_engine.py::test_linear_tree on the port."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(2000, 4))
    y = 3 * X[:, 0] + np.where(X[:, 1] > 0, X[:, 2], -2 * X[:, 2]) \
        + 0.1 * rng.normal(size=2000)
    p = dict(num_leaves=7, min_data_in_leaf=5, verbosity=-1,
             objective="regression", device_type="cpu")
    b_lin = lgb_torch.train(dict(p, linear_tree=True),
                            lgb_torch.Dataset(X, y), num_boost_round=12)
    b_c = lgb_torch.train(p, lgb_torch.Dataset(X, y), num_boost_round=12)
    pred = b_lin.predict(X)
    assert np.mean((pred - y) ** 2) < np.mean((b_c.predict(X) - y) ** 2)
    s = b_lin.model_to_string()
    assert "is_linear=1" in s
    b2 = lgb_torch.Booster(model_str=s)
    np.testing.assert_allclose(pred, b2.predict(X), rtol=1e-5, atol=1e-6)
    Xn = X.copy()
    Xn[:5, :] = np.nan
    assert np.isfinite(b2.predict(Xn)).all()


# ------------------------------------------------------------ prediction
@pytest.fixture(scope="module")
def linear_pair():
    X, y = _pl_data(3000, seed=11)
    p = dict(STRICT, objective="regression", linear_tree=True)
    bj = lgb_jax.train(p, lgb_jax.Dataset(X, y), num_boost_round=4)
    bt = lgb_torch.train(dict(p, device_type="cpu"), lgb_torch.Dataset(X, y),
                         num_boost_round=4)
    Xq, _ = _pl_data(1500, seed=12, nan=0.08)
    return bj, bt, Xq


def test_forest_linear_mode_matches_host_and_jax(linear_pair, monkeypatch):
    bj, bt, Xq = linear_pair
    g = bt._gbdt
    host = g.predict_raw(Xq)
    monkeypatch.setattr(TG.GBDT, "DEVICE_PREDICT_MIN_WORK", 0)
    dev = g.predict_raw(Xq)
    np.testing.assert_allclose(dev, host, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(dev, bj._gbdt.predict_raw(Xq), rtol=2e-5,
                               atol=2e-6)
    monkeypatch.setattr(TG.GBDT, "PREDICT_BLOCK_ROWS", 512)
    monkeypatch.setattr(TG.GBDT, "PREDICT_TAIL_QUANTUM", 64)
    np.testing.assert_array_equal(g.predict_raw(Xq), dev)


def test_linear_model_without_coefficients_predicts_plain_values(
        linear_pair, monkeypatch):
    """Linear trees whose leaves all kept their constant (no coefficient
    anywhere) take the device path with no linear tables: the plain leaf
    values, as the host walk gives them."""
    _, bt, Xq = linear_pair
    g = bt._gbdt
    for t in g.models:
        monkeypatch.setattr(t, "leaf_features", [[] for _ in
                                                 range(t.num_leaves)])
        monkeypatch.setattr(t, "leaf_coeff", [[] for _ in
                                              range(t.num_leaves)])
        monkeypatch.setattr(t, "leaf_const", t.leaf_value.copy())
    host = g.predict_raw(Xq)
    monkeypatch.setattr(TG.GBDT, "DEVICE_PREDICT_MIN_WORK", 0)
    np.testing.assert_allclose(g.predict_raw(Xq), host, rtol=2e-5,
                               atol=2e-6)


def test_forest_values_linear_sums_in_kernel_order(linear_pair):
    """forest_values' plain linear mode: the tree's leaf output is the
    feature-ordered sum of csrc/forest.cu, recomputed here per row."""
    _, bt, Xq = linear_pair
    Xq = Xq.copy()
    Xq[:74:37, 0] = np.inf             # the largest float in both orders
    g = bt._gbdt
    fb, lin, cat_feats = TG.forest_bitset_arrays(g.models, 1, g.train_set)
    forest = TP.forest_from_numpy(fb)
    linl = TP.forest_from_numpy(lin)
    bins_t = torch.as_tensor(np.ascontiguousarray(
        g.train_set.bin_external_pred(Xq).T))
    raw_t = torch.as_tensor(np.ascontiguousarray(Xq.T.astype(np.float32)))
    got = FK.forest_values(forest, bins_t, 1, cat_feats, lin=linl,
                           raw_t=raw_t).numpy()[:, 0]
    leaves = TP.predict_forest_leaves(forest, bins_t, cat_feats).numpy()
    pk = FK.pack_linear(linl)
    x = np.nan_to_num(Xq.astype(np.float32))
    for r in range(0, Xq.shape[0], 37):
        acc = np.float32(0.0)
        for t in range(len(g.models)):
            leaf = leaves[t, r]
            v = fb["value"][t, leaf]
            fs = pk.feat[t, leaf].numpy()
            if fs[0] >= 0:
                la = np.float32(0.0)
                bad = False
                for j, f in enumerate(fs):
                    if f < 0:
                        break
                    bad |= bool(np.isnan(Xq[r, f]))
                    la = np.float32(la + np.float32(
                        pk.coef[t, leaf, j].item() * x[r, f]))
                if not bad:
                    v = np.float32(la + np.float32(pk.const[t, leaf].item()))
            acc = np.float32(acc + np.float32(v))
        assert got[r] == acc


def test_jax_linear_model_loads_and_predicts_the_same(linear_pair,
                                                      monkeypatch):
    bj, _, Xq = linear_pair
    text = bj.model_to_string()
    b = booster_from_model_string(text)
    np.testing.assert_allclose(b.predict(Xq), bj.predict(Xq), rtol=1e-6,
                               atol=1e-7)
    # the JAX package's stacked forest and linear leaves, carried over
    jg = bj._gbdt
    jfb, jlin, cat_feats = jg._forest_bitset_arrays(jg.models, 1)
    fb = TP.forest_from_numpy({k: np.asarray(v, np.float32)
                               if str(getattr(v, "dtype", "")) == "bfloat16"
                               else np.asarray(v)
                               for k, v in jfb._asdict().items()
                               if v is not None})
    lin = TP.forest_from_numpy({k: np.asarray(v, np.float32)
                                for k, v in jlin._asdict().items()})
    td = lgb_torch.Dataset(*_pl_data(3000, seed=11)).inner
    bins_t = torch.as_tensor(np.ascontiguousarray(
        td.bin_external_pred(Xq).T))
    got = FK.forest_values(fb, bins_t, 1, cat_feats, lin=lin,
                           raw_t=torch.as_tensor(np.ascontiguousarray(
                               Xq.T.astype(np.float32))))
    np.testing.assert_allclose(got.numpy()[:, 0], jg.predict_raw(Xq),
                               rtol=2e-5, atol=2e-6)


def test_jax_tree_and_linear_fit_carry_over():
    """A tree the JAX package grew, with its fit_linear_leaves result,
    becomes the same host tree in the port (convert.tree_from_numpy)."""
    import jax
    from lightgbm_tpu.models.tree import Tree as JTree
    X, y = _pl_data(2000, seed=13)
    p = dict(STRICT, objective="regression", linear_tree=True)
    b = lgb_jax.Booster(params=p, train_set=lgb_jax.Dataset(X, y))
    jg = b._gbdt
    g, h = jg.boosting_gradients()
    arrays, lor = jg._grow(g[:, 0], h[:, 0], None, None, None)
    const, coeff = jax_fit(jg.raw_dev, lor, arrays.leaf_path,
                           ~jg.is_cat_arr, g[:, 0], h[:, 0], None,
                           arrays.leaf_value, 0.0)
    tj = JTree.from_arrays(arrays, jg.train_set)
    tj.set_linear(np.asarray(const, np.float64),
                  np.asarray(coeff, np.float64),
                  jg.train_set.used_feature_idx,
                  ~np.asarray(jg.is_cat_arr))
    d = {k: np.asarray(v) for k, v in jax.device_get(arrays)._asdict()
         .items()}
    td = lgb_torch.Dataset(X, y, params=dict(linear_tree=True)).inner
    tt = tree_from_numpy(d, td, (np.asarray(const), np.asarray(coeff)))
    assert tt.is_linear and tt.leaf_features == tj.leaf_features
    np.testing.assert_array_equal(tt.leaf_const, tj.leaf_const)
    np.testing.assert_array_equal(tt.predict(X), tj.predict(X))


# ---------------------------------------------------------- debug checks
@pytest.mark.parametrize("learner", ["strict", "batched"])
def test_debug_checks_train_the_same_model(learner):
    X, y = _pl_data(2000)
    base = dict(STRICT if learner == "strict" else BATCHED,
                objective="regression", device_type="cpu",
                bagging_fraction=0.8, bagging_freq=1)
    b0 = lgb_torch.train(base, lgb_torch.Dataset(X, y), num_boost_round=3)
    b1 = lgb_torch.train(dict(base, tpu_debug_checks=True),
                         lgb_torch.Dataset(X, y), num_boost_round=3)
    assert not b1._gbdt.supports_fused()
    assert b1.model_to_string().split("parameters:")[0] == \
        b0.model_to_string().split("parameters:")[0]


def test_debug_checks_catch_a_broken_tree():
    X, y = _pl_data(1000)
    b = lgb_torch.Booster(params=dict(STRICT, objective="regression",
                                      device_type="cpu",
                                      tpu_debug_checks=True),
                          train_set=lgb_torch.Dataset(X, y))
    g = b._gbdt
    gr, hs = g.boosting_gradients()
    arrays, lor = g._grow(gr[:, 0].contiguous(), hs[:, 0].contiguous(), None,
                          None)
    g._debug_check_tree(arrays, lor, None)
    bad = arrays._replace(leaf_count=arrays.leaf_count + 3.0)
    with pytest.raises(LightGBMError, match="leaf_count"):
        g._debug_check_tree(bad, lor, None)
    with pytest.raises(LightGBMError, match="out of range"):
        g._debug_check_tree(arrays, lor + int(arrays.num_leaves), None)
