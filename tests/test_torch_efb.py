"""EFB-bundled training in the port against lightgbm_tpu on the CPU.

Exclusive Feature Bundling is on by default: one-hot or sparse columns are
bundled at construction, every histogram pass runs over the physical
bundle columns, split finding over histograms expanded to per-feature
(virtual) bins.  Inputs are made from seeded numpy (the JAX package's
``tests/test_efb.py`` one-hot fixture; a variant with 10% NaN in its
dense columns; the same matrix handed to the JAX package as a scipy
sparse matrix, which the port takes dense; the probe of 6 normal plus 8
one-hot columns):

* ``device_bundle_arrays`` equal to the JAX package's, element for
  element;
* ``_expand_hist`` / ``_expand_hist_col`` / ``_feature_bin_of_rows``
  against the JAX functions: bitwise on integer-valued histograms, rtol
  1e-6 on real ones (the default bin is total - rest, a float32 sum whose
  order may differ);
* the decision-table partition's plain version bitwise equal to the JAX
  package's XLA partition of bundled rounds, on the plan's multi-member
  bundles with split features that are not the first member of their
  bundle; with an all-numeric (identity) table, bitwise equal to the
  numeric ``partition_payload_plain`` / ``partition_select_plain``;
* the strict learner (3,000 rows, default parameters) and the batched
  grower (int8 levels; fused, classic, pooled, max_bin=63) against the
  JAX package's models: every field equal (leaf values of the strict
  float32 learner and of binary's sigmoid within rtol 1e-5; regression's
  int8 text byte for byte), fused text equal to classic text; where a
  fixture has NaN, a ``decision_type`` may differ only at a node that no
  missing row reaches (its NaN bin has count 0: the port treats it as
  empty, the JAX package decides by the sign of a residual);
* bundled against ``enable_bundle=false``: predictions within 5e-3 (the
  JAX test's own bound), and the unbundled model still the JAX package's;
* valid scoring of bundled trees (path aggregation over logical bins) bit
  for bit the JAX package's ``predict_bins_tree(..., bundle)`` walk;
  early stopping's ``best_iteration`` the JAX package's;
* at most one host read a fused round with a bundle.
"""

import numpy as np
import pytest
import scipy.sparse
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgb_jax
from lightgbm_tpu.learner import batch_grower as JBG
from lightgbm_tpu.learner import grower as JG
from lightgbm_tpu.models import predict as JP

import lightgbm_tpu_torch as lgb_torch
from lightgbm_tpu_torch.boosting import gbdt as TG
from lightgbm_tpu_torch.learner import batch_grower as TBG
from lightgbm_tpu_torch.learner import grower as TGR
from lightgbm_tpu_torch.models import predict as TP
from lightgbm_tpu_torch.ops import round_fuse as TRF

from test_torch_fused import (  # noqa: F401
    _train_port, fused_host_reads, one_torch_thread)


def _onehot_data(n=2000, groups=4, levels=8, seed=0, nan=0.0):
    """The JAX package's fixture (tests/test_efb.py ``_onehot_data``):
    exclusive one-hot blocks plus two dense columns; ``nan``: the share of
    the dense columns' values set missing."""
    rng = np.random.default_rng(seed)
    cols = []
    idxs = []
    for g in range(groups):
        idx = rng.integers(0, levels, size=n)
        idxs.append(idx)
        block = np.zeros((n, levels))
        block[np.arange(n), idx] = rng.normal(1.5, 0.2, size=n)
        cols.append(block)
    dense = rng.normal(size=(n, 2))
    X = np.concatenate(cols + [dense], axis=1)
    y = ((idxs[0] % 2) + 0.5 * (idxs[1] % 3) + dense[:, 0]
         + 0.1 * rng.normal(size=n) > 1.0).astype(np.float64)
    if nan:
        X[:, -2:][rng.random((n, 2)) < nan] = np.nan
    return X, y


def _probe_data(n=3000, seed=0):
    """6 normal columns plus one 8-level variable one-hot encoded."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, 6))
    idx = rng.integers(0, 8, size=n)
    onehot = np.zeros((n, 8))
    onehot[np.arange(n), idx] = 1.0
    y = (dense[:, 0] + 0.5 * (idx % 3) - 0.5 * dense[:, 1]
         + 0.3 * rng.normal(size=n) > 0.5).astype(np.float64)
    return np.concatenate([dense, onehot], axis=1), y


def _case(name, n=2000, seed=0):
    """(port input, label, JAX package input)."""
    if name == "probe":
        X, y = _probe_data(n, seed)
        return X, y, X
    X, y = _onehot_data(n, seed=seed, nan=0.1 if name == "onehot-nan"
                        else 0.0)
    return X, y, (scipy.sparse.csr_matrix(X) if name == "sparse" else X)


CASES = ["onehot", "onehot-nan", "sparse", "probe"]


@pytest.fixture(autouse=True)
def _ladder_on_small_data(monkeypatch):
    """The warm-up ladder runs from 1,024 rows in both packages."""
    monkeypatch.setattr(JBG, "_WARMUP_MIN_ROWS", 1024)
    monkeypatch.setattr(TBG, "_WARMUP_MIN_ROWS", 1024)


def _datasets(name, params=None, n=2000):
    Xt, y, Xj = _case(name, n)
    dj = lgb_jax.Dataset(Xj, label=y, params=params).construct()._inner
    dt = lgb_torch.Dataset(Xt, y, params=params).construct()._inner
    return dt, dj


def _bundles(dt):
    ba = dt.device_bundle_arrays()
    return (TGR.DeviceBundle(*(torch.as_tensor(a) for a in ba)),
            JG.DeviceBundle(*(jnp.asarray(a) for a in ba)))


@pytest.mark.parametrize("name", CASES)
def test_device_bundle_arrays_match_jax(name):
    """Equal element for element.  The JAX package plans sparse input from
    the columns' nonzeros, each feature's default bin its zero bin: the
    port (dense input) then differs only in the default bin of singleton
    columns whose most frequent bin is not the zero bin."""
    dt, dj = _datasets(name)
    assert dt.bundle_plan is not None
    assert any(len(m) > 1 for m in dt.bundle_plan.bundles)
    np.testing.assert_array_equal(dt.bins, dj.bins)
    assert dt.device_n_bins() == dj.device_n_bins()
    assert dt.bundle_plan.bundles == dj.bundle_plan.bundles
    single = np.array([len(m) == 1 for m in dt.bundle_plan.bundles])[
        dt.bundle_plan.feat_col]
    for a, b in zip(dt.device_bundle_arrays(), dj.device_bundle_arrays(),
                    strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        if name == "sparse":
            a, b = a[~single], b[~single]
        np.testing.assert_array_equal(a, b)
    off = lgb_torch.Dataset(_case(name)[0], params=dict(
        enable_bundle=False)).construct()._inner
    assert off.bundle_plan is None and off.device_bundle_arrays() is None


def _non_first_members(plan):
    """Features of multi-member bundles that are not the bundle's first."""
    return [f for m in plan.bundles if len(m) > 1 for f in m[1:]]


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "real"])
def test_expand_hist_matches_jax(integer):
    dt, _ = _datasets("onehot-nan")
    bt, bj = _bundles(dt)
    Fb, B = dt.bins.shape[1], dt.device_n_bins()
    rng = np.random.default_rng(1)
    M = 3
    if integer:
        hist = np.stack([rng.integers(-40, 40, (M, Fb, B)),
                         rng.integers(0, 30, (M, Fb, B)),
                         rng.integers(0, 20, (M, Fb, B)),
                         np.zeros((M, Fb, B))], -1).astype(np.float32)
        tot = rng.integers(100, 1000, (3, M)).astype(np.float32)
    else:
        hist = rng.normal(size=(M, Fb, B, 4)).astype(np.float32)
        hist[..., 3] = 0
        tot = (rng.normal(size=(3, M)) * 50).astype(np.float32)

    default = np.arange(B)[None, :] == dt.bundle_plan.default_bin[:, None]

    def check(got, want, m, feats=slice(None)):
        """Gathered bins bitwise; the default bin, total - rest, bitwise
        on integers and within 1e-6 of |total| + sum |bins| on reals
        (float32 sums in another order)."""
        if integer:
            np.testing.assert_array_equal(got, want)
            return
        d = default[feats]
        np.testing.assert_array_equal(got[~d], want[~d])
        tot_m = np.append(tot[:, m], 0)
        scale = np.abs(tot_m) + np.abs(np.where(d[..., None], 0, got)).sum(-2)
        assert (np.abs(got[d] - want[d]) <= 1e-6 * scale).all()

    got = TGR._expand_hist(torch.as_tensor(hist), bt,
                           *map(torch.as_tensor, tot)).numpy()
    for m in range(M):
        check(got[m], np.asarray(JG._expand_hist(
            jnp.asarray(hist[m]), bj, *(jnp.asarray(t[m]) for t in tot))), m)
    feats = _non_first_members(dt.bundle_plan)[:4] + [dt.bins.shape[1] - 1,
                                                      0]
    for f in feats:
        col = dt.bundle_plan.feat_col[f]
        check(TGR._expand_hist_col(torch.as_tensor(hist[1, col]), bt, f,
                                   *(torch.as_tensor(t[1]) for t in tot))
              .numpy(),
              np.asarray(JG._expand_hist_col(
                  jnp.asarray(hist[1, col]), bj, jnp.int32(f),
                  *(jnp.asarray(t[1]) for t in tot))), 1, f)
    bins_t = np.ascontiguousarray(dt.bins.T)
    for f in range(len(dt.bundle_plan.feat_col)):
        got_b = TGR._feature_bin_of_rows(torch.as_tensor(bins_t), bt, f)
        want_b = JG._feature_bin_of_rows(jnp.asarray(bins_t), bj,
                                         jnp.int32(f))
        np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))


def _slots(rng, plan, nan_bin, num_bins, K=6, leaves=8):
    """K split descriptors over distinct parents: features of multi-member
    bundles that are not the first member, plus dense ones; slot 2
    invalid."""
    pool = _non_first_members(plan) + [len(plan.feat_col) - 1]
    feats = rng.choice(pool, K, replace=False).astype(np.int32)
    thr = np.array([rng.integers(0, max(num_bins[f] - 1, 1))
                    for f in feats], np.int32)
    dl = rng.integers(0, 2, K).astype(np.int32)
    nanb = nan_bin[feats].astype(np.int32)
    parents = rng.permutation(leaves)[:K].astype(np.int32)
    new_leaves = np.arange(leaves, leaves + K, dtype=np.int32)
    valid = np.ones(K, np.int32)
    valid[2] = 0
    smaller = np.where(rng.random(K) < 0.5, parents, new_leaves) \
        .astype(np.int32)
    return feats, thr, dl, nanb, parents, new_leaves, valid, smaller


@pytest.mark.parametrize("name", ["onehot", "onehot-nan"])
def test_table_partition_matches_jax_xla_partition(name):
    """The decision-table partition (plain version) against the JAX
    package's XLA partition of bundled rounds (batch_grower.py:866-884,
    ``_feature_bin_of_rows`` vmapped over the slots)."""
    dt, _ = _datasets(name)
    bt, bj = _bundles(dt)
    n = dt.bins.shape[0]
    rng = np.random.default_rng(2)
    desc = _slots(rng, dt.bundle_plan, dt.nan_bin_array(),
                  dt.num_bins_array())
    feats, thr, dl, nanb, parents, new_leaves, valid, smaller = desc
    lor = rng.integers(0, 8, n).astype(np.int32)
    mask = (rng.random(n) < 0.9).astype(np.int32)
    bins_t = np.ascontiguousarray(dt.bins.T)

    cols_k = jax.vmap(lambda f: JG._feature_bin_of_rows(
        jnp.asarray(bins_t), bj, f))(jnp.asarray(feats))
    go_left_k = jnp.where(cols_k == jnp.asarray(nanb)[:, None],
                          jnp.asarray(dl != 0)[:, None],
                          cols_k <= jnp.asarray(thr)[:, None])
    in_parent = (jnp.asarray(lor)[None, :] == jnp.asarray(parents)[:, None]) \
        & jnp.asarray(valid != 0)[:, None]
    move = in_parent & ~go_left_k
    target = jnp.sum(move * jnp.asarray(new_leaves)[:, None], axis=0)
    want_lor = np.asarray(jnp.where(jnp.any(move, axis=0), target,
                                    jnp.asarray(lor)))
    lor_m = np.where(mask != 0, want_lor, -1)
    row = np.arange(n, dtype=np.int32)
    want_key = np.where(np.isin(lor_m, smaller), row, row | (1 << 30))

    t = torch.as_tensor
    cols, tab = TRF.decision_table(t(feats), t(thr), t(dl), t(nanb),
                                   feat_col=bt.feat_col,
                                   inv_table=bt.inv_table)
    assert (cols.numpy() == dt.bundle_plan.feat_col[feats]).all()
    rest = (t(parents), t(new_leaves), t(valid), t(smaller))
    got_lor, got_key = TRF.partition_select_table(
        t(bins_t), t(lor), t(mask), cols, tab, *rest)
    np.testing.assert_array_equal(got_lor.numpy(), want_lor)
    np.testing.assert_array_equal(got_key.numpy(), want_key)
    words = t(dt.packed_mirror())
    g = t(rng.normal(size=n).astype(np.float32))
    h = t(rng.random(n).astype(np.float32))
    p_lor, p_key, pay = TRF.partition_payload_table(
        t(bins_t), words, g, h, t(lor), t(mask), cols, tab, *rest)
    np.testing.assert_array_equal(p_lor.numpy(), want_lor)
    np.testing.assert_array_equal(p_key.numpy(), want_key)
    W = words.shape[1]
    np.testing.assert_array_equal(pay[:, :W].numpy(), words.numpy())
    np.testing.assert_array_equal(pay[:, W].numpy(), g.view(torch.int32))
    np.testing.assert_array_equal(pay[:, W + 1].numpy(), h.view(torch.int32))
    np.testing.assert_array_equal(pay[:, W + 2].numpy(), lor_m)


def test_table_partition_with_identity_table_is_the_numeric_one():
    """An all-numeric plan (feat_col = identity, inv_table[f, v] = v): the
    decision-table variants equal the numeric partition bitwise, split
    features outside [0, F) (read as column 0) included."""
    rng = np.random.default_rng(4)
    n, F, B, K = 5000, 7, 256, 8
    bins = rng.integers(0, 250, (n, F)).astype(np.uint8)
    bins_t = torch.as_tensor(np.ascontiguousarray(bins.T))
    words = torch.as_tensor(np.ascontiguousarray(np.concatenate(
        [bins, np.zeros((n, (-F) % 4), np.uint8)], 1)).view(np.int32))
    feat_col = torch.arange(F, dtype=torch.int32)
    inv_table = torch.arange(B, dtype=torch.int32)[None, :].repeat(F, 1)
    t = torch.as_tensor
    feats = t(np.array([0, 3, 6, -1, F, 2, 5, 1], np.int32))
    thr = t(rng.integers(0, 255, K).astype(np.int32))
    dl = t(rng.integers(0, 2, K).astype(np.int32))
    nanb = t(np.where(rng.random(K) < 0.5, 249, -1).astype(np.int32))
    parents = t(rng.permutation(16)[:K].astype(np.int32))
    new_leaves = t(np.arange(16, 16 + K, dtype=np.int32))
    valid = t((rng.random(K) < 0.8).astype(np.int32))
    smaller = t(np.where(rng.random(K) < 0.5, parents.numpy(),
                         new_leaves.numpy()).astype(np.int32))
    lor = t(rng.integers(0, 16, n).astype(np.int32))
    mask = t((rng.random(n) < 0.9).astype(np.int32))
    g = t(rng.normal(size=n).astype(np.float32))
    h = t(rng.random(n).astype(np.float32))
    rest = (parents, new_leaves, valid, smaller)
    cols, tab = TRF.decision_table(feats, thr, dl, nanb, feat_col=feat_col,
                                   inv_table=inv_table)
    want = TRF.partition_payload_plain(bins_t, words, g, h, lor, mask, feats,
                                       thr, dl, nanb, *rest)
    got = TRF.partition_payload_table_plain(bins_t, words, g, h, lor, mask,
                                            cols, tab, *rest)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    want = TRF.partition_select_plain(bins_t, lor, mask, feats, thr, dl,
                                      nanb, *rest)
    got = TRF.partition_select_table_plain(bins_t, lor, mask, cols, tab,
                                           *rest)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


def _node_nan_rows(tree, X):
    """For each internal node of ``tree``: the training rows reaching it
    whose split feature is missing."""
    out = np.zeros(tree.num_leaves - 1, np.int64)

    def walk(node, rows):
        v = X[rows, tree.split_feature[node]]
        nan = np.isnan(v)
        out[node] = nan.sum()
        go_left = np.where(nan, bool(tree.decision_type[node] & 2),
                           v <= tree.threshold[node])
        for child, sel in ((tree.left_child[node], go_left),
                           (tree.right_child[node], ~go_left)):
            if child >= 0:
                walk(child, rows[sel])

    if tree.num_leaves > 1:
        walk(0, np.arange(X.shape[0]))
    return out


def _assert_models_match(bt, bj, X, leaf_rtol=None):
    """Every tree field equal (leaf values within ``leaf_rtol`` when
    given, plus atol 5e-5 for the strict float32 learner's histogram
    subtraction); a differing decision_type only at a node no missing row
    reaches."""
    mt, mj = bt._gbdt.models, bj._gbdt.models
    assert len(mt) == len(mj)
    for tt, tj in zip(mt, mj):
        assert tt.num_leaves == tj.num_leaves
        for f in ("split_feature", "threshold_bin", "left_child",
                  "right_child"):
            np.testing.assert_array_equal(getattr(tt, f), getattr(tj, f))
        diff = np.flatnonzero(tt.decision_type != tj.decision_type)
        if diff.size:
            assert (_node_nan_rows(tt, X)[diff] == 0).all(), diff
        if leaf_rtol is None:
            np.testing.assert_array_equal(tt.leaf_value, tj.leaf_value)
        else:
            np.testing.assert_allclose(tt.leaf_value, tj.leaf_value,
                                       rtol=leaf_rtol, atol=5e-5)


@pytest.mark.parametrize("name", CASES)
def test_strict_learner_matches_jax(name):
    """3,000 rows, default parameters (the strict learner, float32)."""
    Xt, y, Xj = _case(name, n=3000)
    params = dict(objective="binary", num_leaves=15, verbosity=-1)
    bj = lgb_jax.train(dict(params), lgb_jax.Dataset(Xj, y),
                       num_boost_round=3)
    bt = lgb_torch.train(dict(params, device_type="cpu"),
                         lgb_torch.Dataset(Xt, y), num_boost_round=3)
    g = bt._gbdt
    assert g.bundle is not None and not g._use_batched_grower()
    assert g.bins.shape[1] < g.num_features
    _assert_models_match(bt, bj, Xt, leaf_rtol=1e-5)


#: the default recipe's int8 levels at a small size (test_torch_fused.py)
INT8 = dict(num_leaves=31, tpu_split_batch=16, use_quantized_grad=True,
            tpu_hist_dtype="int8", quant_train_renew_leaf=True,
            tpu_rows_per_block=1024, verbosity=-1)
BATCHED = {
    "regression-255": dict(INT8, objective="regression", max_bin=255),
    "binary-nan-255": dict(INT8, objective="binary", max_bin=255),
    "regression-63": dict(INT8, objective="regression", max_bin=63),
    "pooled": dict(INT8, objective="regression", max_bin=255,
                   tpu_split_batch=4, histogram_pool_size=0.1),
}


@pytest.mark.parametrize("case", sorted(BATCHED))
def test_batched_grower_matches_jax(case, monkeypatch):
    """Fused against classic (byte for byte) and against the JAX
    package's model (which takes its own fused loop)."""
    params = BATCHED[case]
    Xt, y, Xj = _case("onehot-nan" if "nan" in case else "onehot", n=6000)
    fused = _train_port(params, Xt, y, 3, monkeypatch)
    classic = _train_port(params, Xt, y, 3, monkeypatch, classic=True)
    bj = lgb_jax.train(dict(params), lgb_jax.Dataset(Xj, y),
                       num_boost_round=3)
    g = fused._gbdt
    assert g.bundle is not None and g._use_batched_grower()
    assert TBG.pooled(g.hp) == (case == "pooled")
    if case.endswith("-63"):
        assert g.hp.n_bins == 64 and g.bins_words_t is not None
    assert fused.model_to_string() == classic.model_to_string()
    assert all(t.num_leaves > 2 for t in g.models)
    if params["objective"] == "regression":
        assert fused.model_to_string().split("parameters:")[0] \
            == bj.model_to_string().split("parameters:")[0]
    else:
        _assert_models_match(fused, bj, Xt, leaf_rtol=1e-5)


def test_bundled_matches_unbundled(monkeypatch):
    """Conflict-free bundling does not change what the learner sees; with
    enable_bundle=false the port trains as before (the JAX package's
    unbundled model)."""
    X, y, _ = _case("onehot", n=6000)
    params = dict(INT8, objective="regression", max_bin=255)
    on = _train_port(params, X, y, 5, monkeypatch)
    off = _train_port(dict(params, enable_bundle=False), X, y, 5,
                      monkeypatch)
    assert on._gbdt.bundle is not None and off._gbdt.bundle is None
    assert np.abs(on.predict(X) - off.predict(X)).max() < 5e-3
    bj = lgb_jax.train(dict(params, enable_bundle=False),
                       lgb_jax.Dataset(X, y), num_boost_round=5)
    assert off.model_to_string().split("parameters:")[0] \
        == bj.model_to_string().split("parameters:")[0]


def test_valid_scoring_matches_jax_walk():
    """The path aggregation over the valid set's logical bins equals the
    JAX package's walk through the inverse table, bit for bit."""
    X, y, _ = _case("onehot-nan", n=3000)
    Xv, yv, _ = _case("onehot-nan", n=1500, seed=7)
    params = dict(INT8, objective="binary", max_bin=255, device_type="cpu")
    ds = lgb_torch.Dataset(X, y)
    b = lgb_torch.Booster(params=params, train_set=ds)
    dv = ds.create_valid(Xv, yv)
    b.add_valid(dv, "v")
    for _ in range(3):
        b.update()
    g = b._gbdt
    vbins = dv.inner.bins
    assert g._valid_bins_t[0].shape == (g.num_features, len(Xv))
    _, bj = _bundles(ds.inner)
    nan_j = jnp.asarray(ds.inner.nan_bin_array())
    for tree in g.models:
        arrs = TG._tree_to_arrays_stub(tree, ds.inner, g.device)
        got = g._valid_tree_scores(arrs, 0)
        jarrs = JG.TreeArrays(*(jnp.asarray(a.numpy()) for a in arrs))
        want = JP.predict_bins_tree(jarrs, jnp.asarray(vbins), nan_j, bj,
                                    has_categorical=False)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        walk = TP.predict_bins_tree(arrs, torch.as_tensor(vbins),
                                    g.nan_bin_arr, g.bundle)
        assert torch.equal(got, walk)


ES = dict(objective="binary", metric="auc", num_leaves=15,
          min_data_in_leaf=5, tpu_split_batch=4, learning_rate=0.5,
          verbosity=-1)


def test_early_stopping_matches_classic_and_jax(monkeypatch):
    X, y, _ = _case("onehot-nan", n=4000)
    Xv, yv, _ = _case("onehot-nan", n=1500, seed=7)

    def port(classic):
        return _train_port(ES, X, y, 60, monkeypatch, classic=classic,
                           valid=(Xv, yv),
                           callbacks=[lgb_torch.early_stopping(
                               3, verbose=False)])

    b_fused, b_classic = port(False), port(True)
    ds = lgb_jax.Dataset(X, label=y, params=ES)
    b_jax = lgb_jax.train(ES, ds, num_boost_round=60,
                          valid_sets=[ds.create_valid(Xv, label=yv)],
                          valid_names=["v"],
                          callbacks=[lgb_jax.early_stopping(3,
                                                            verbose=False)])
    assert b_fused._gbdt.bundle is not None
    assert 0 < b_fused.best_iteration < 60, "the task must stop early"
    assert b_fused.best_iteration == b_classic.best_iteration \
        == b_jax.best_iteration
    assert b_fused.model_to_string() == b_classic.model_to_string()


def test_supports_fused_admits_bundles_as_jax():
    X, y, _ = _case("onehot", n=2000)
    params = dict(objective="binary", num_leaves=15, tpu_split_batch=4,
                  metric="auc", verbosity=-1)
    dj = lgb_jax.Dataset(X, y, params=params)
    dt = lgb_torch.Dataset(X, y)
    bj = lgb_jax.Booster(params=params, train_set=dj)
    bt = lgb_torch.Booster(params=dict(params, device_type="cpu"),
                           train_set=dt)
    bj.add_valid(dj.create_valid(X[:500], label=y[:500]), "v")
    bt.add_valid(dt.create_valid(X[:500], y[:500]), "v")
    assert bt._gbdt.bundle is not None and bj._gbdt.bundle is not None
    assert bt._gbdt.supports_fused() == bj._gbdt.supports_fused() is True


def test_fused_round_reads_the_host_at_most_once_with_a_bundle(
        monkeypatch):
    """No read inside the round bodies; one flag word a replay: the
    round's own, and where a tree is still growing after it (these
    one-hot trees split fewer leaves a round than the budget assumes)
    each one-round replay's and the tail's replayed once after them."""
    X, y, _ = _case("onehot-nan", n=6000)
    Xv, yv, _ = _case("onehot-nan", n=1500, seed=7)
    params = dict(INT8, objective="binary", max_bin=255, device_type="cpu",
                  metric="auc")
    reads, rounds, extra = fused_host_reads(monkeypatch, params, X, y, Xv,
                                            yv, 4)
    assert rounds == 4
    assert reads["body"] == 0
    assert reads["step"] <= rounds + 2 * extra
