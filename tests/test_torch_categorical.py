"""Categorical splits in the port against lightgbm_tpu on the CPU.

A column named in ``categorical_feature`` is binned by category frequency;
split finding adds the one-hot candidates (features of at most
``max_cat_to_onehot`` bins) and the sorted-subset candidates (bins ordered
by g / (h + cat_smooth), prefixes of either order), both growers cache each
leaf's left-bin set when its best split is found, and the batched rounds
partition through the decision-table kernel.  Inputs are made from seeded
numpy:

* ``find_best_split`` and ``categorical_left_bitset`` bit for bit the JAX
  package's on integer-valued histograms (exact in any order), with
  categorical features of 2-4 bins (one-hot) and 5-60 bins (subset) beside
  numeric ones, planted score ties and signed zeros, over ``cat_smooth``,
  ``min_data_per_group``, ``max_cat_threshold``, ``cat_l2`` and
  ``max_cat_to_onehot``;
* ``decision_table`` with categorical slots plus the plain table
  partitions against the JAX package's XLA partition of categorical
  rounds (batch_grower.py:866-880), with and without an EFB bundle;
* the strict and the batched growers (pooled too) on integer levels: every
  tree field equal to the JAX growers';
* ``train()`` on the probe fixture (3 normal columns, categorical columns
  of 3, 12 and 40 levels): at 3,000 rows the strict float32 learner (split
  features and category sets equal, leaf values within rtol 1e-5 + atol
  5e-5), at 120,000 rows the batched grower at int8 levels in the fused
  loop (model text equal to the JAX package's and to the classic loop's);
* the int8 batched grower at 6,000 rows (warm-up ladder lowered), pooled,
  and with EFB bundling a categorical column: text equal to the JAX
  package's, fused equal to classic;
* valid-set scoring by path counts bit for bit the walk, the JAX package's
  walk and ``predict``; early stopping's ``best_iteration`` the JAX
  package's; ``predict`` on held-out rows with unseen categories, negative
  codes and NaN the JAX package's; at most one host read a fused round.

The strict float32 learner sums its histograms in another order than the
JAX package's one-hot dot.  Where a leaf's best sorted-subset prefix has
exactly half its candidate bins, the ascending prefix and the descending
one are complements with the same gain in exact arithmetic, and float32
rounding decides between them (in either package): such a node may then
hold the complementary category set with its children swapped
(:func:`_assert_same_partition`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgb_jax
from lightgbm_tpu.learner import batch_grower as JBG
from lightgbm_tpu.learner import grower as JG
from lightgbm_tpu.models import predict as JP
from lightgbm_tpu.ops import split as JS

import lightgbm_tpu_torch as lgb_torch
from lightgbm_tpu_torch.boosting import gbdt as TG
from lightgbm_tpu_torch.learner import batch_grower as TBG
from lightgbm_tpu_torch.learner import grower as TGR
from lightgbm_tpu_torch.models import predict as TP
from lightgbm_tpu_torch.ops import round_fuse as TRF
from lightgbm_tpu_torch.ops import split as TS

from test_torch_fused import (  # noqa: F401
    _train_port, fused_host_reads, one_torch_thread)

CAT_COLS = [3, 4, 5]


def _probe(n, seed=0):
    """The probe fixture: 3 normal columns and integer-coded categorical
    columns of 3, 12 and 40 levels; the label reads columns 0, 1, 4 and
    5."""
    rng = np.random.default_rng(seed)
    X = np.zeros((n, 6))
    X[:, :3] = rng.normal(size=(n, 3))
    for j, levels in zip(CAT_COLS, (3, 12, 40)):
        X[:, j] = rng.integers(0, levels, n)
    effect = np.random.default_rng(100).normal(size=40)
    z = (X[:, 0] + effect[X[:, 5].astype(int)] + 0.5 * (X[:, 4] % 3)
         - 0.5 * X[:, 1] + 0.3 * rng.normal(size=n))
    return X, (z > 0.5).astype(np.float64)


#: the probe's parameters
PROBE = dict(objective="binary", num_leaves=15, min_data_per_group=20,
             cat_smooth=5, verbosity=-1)


def _bundled(n, seed=0):
    """EFB bundles the categorical column 8 with the one-hot columns 2-7:
    it leaves its first category only on rows where no one-hot column is
    set (1/7 of them); columns 0-1 dense, 9 a 3-level categorical."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 7, n)
    onehot = np.zeros((n, 7))
    onehot[np.arange(n), idx] = 1.0
    onehot = onehot[:, :6]
    dense = rng.normal(size=(n, 2))
    sparse_cat = np.where(idx == 6, rng.integers(0, 16, n), 0)
    small_cat = rng.integers(0, 3, n)
    X = np.column_stack([dense, onehot, sparse_cat, small_cat]).astype(float)
    effect = np.random.default_rng(101).normal(size=16)
    z = (dense[:, 0] + 0.6 * (idx % 2) + 2.0 * effect[sparse_cat]
         + 0.4 * small_cat + 0.3 * rng.normal(size=n))
    return X, (z > 0.6).astype(np.float64), [8, 9]


@pytest.fixture(autouse=True)
def _ladder_on_small_data(monkeypatch):
    """The warm-up ladder runs from 1,024 rows in both packages."""
    monkeypatch.setattr(JBG, "_WARMUP_MIN_ROWS", 1024)
    monkeypatch.setattr(TBG, "_WARMUP_MIN_ROWS", 1024)


def _head(bst) -> str:
    return bst.model_to_string().split("parameters:")[0]


# ------------------------------------------------------------ split finding

#: (cat_smooth, min_data_per_group, max_cat_threshold, cat_l2,
#: max_cat_to_onehot, lambda_l2)
SPLIT_CASES = {
    "defaults": (10.0, 100, 32, 10.0, 4, 0.0),
    "smooth1-group1": (1.0, 1, 32, 10.0, 4, 1.0),
    "smooth5-group20": (5.0, 20, 8, 1.5, 4, 0.0),
    "threshold2-catl2-0": (5.0, 5, 2, 0.0, 4, 2.0),
    "onehot8": (3.0, 10, 32, 10.0, 8, 0.5),
    "l1": (2.0, 30, 16, 4.0, 4, 1.0),
}


def _split_inputs(rng, M=5, B=64):
    """Integer-valued histograms of M leaves over 7 features: categorical
    ones of 2-4 and 5-60 bins and numeric ones (one with a NaN bin that
    holds rows); duplicated bins, zero gradients and -0.0 plant score
    ties."""
    nbins = np.array([rng.integers(2, 5), rng.integers(5, 13),
                      rng.integers(20, 61), 40, rng.integers(2, 5), 30,
                      rng.integers(5, 61)], np.int32)
    is_cat = np.array([True, True, True, False, True, False, True])
    nan_bin = np.array([-1, -1, -1, 39, -1, -1, -1], np.int32)
    F = len(nbins)
    hist = np.zeros((M, F, B, 4), np.float32)
    hist[..., 0] = rng.integers(-20, 21, size=(M, F, B)) * 0.125
    hist[..., 1] = rng.integers(0, 30, size=(M, F, B)) * 0.25
    hist[..., 2] = rng.integers(0, 40, size=(M, F, B))
    hist[:, :, ::7, 0] = 0.0
    hist[:, :, 3::11, 0] = -0.0
    dup = hist[:, :, 2::5, :3]
    hist[:, :, 1::5, :3][:, :, :dup.shape[2]] = dup[:, :, :hist[
        :, :, 1::5].shape[2]]
    hist[:, 3, 39, 2] += 1
    for f in range(F):
        hist[:, f, nbins[f]:] = 0
    sums = hist[:, 0].sum(axis=1)
    hist[:, :, 0, :3] += sums[:, None, :3] - hist[..., :3].sum(axis=2)
    return hist, sums, nbins, nan_bin, is_cat


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_find_best_split_and_bitset_match_jax(case):
    """Every SplitResult field and the winners' left-bin sets, bitwise."""
    smooth, mdpg, max_thr, cat_l2, onehot, l2 = SPLIT_CASES[case]
    fields = dict(min_data_in_leaf=3, min_sum_hessian_in_leaf=1.0,
                  lambda_l2=l2, cat_l2=cat_l2, cat_smooth=smooth,
                  min_data_per_group=mdpg, max_cat_threshold=max_thr,
                  max_cat_to_onehot=onehot, n_bins=64, has_categorical=True,
                  lambda_l1=0.25 if case == "l1" else 0.0)
    hp_t, hp_j = TS.SplitHyper(**fields), JS.SplitHyper(**fields)
    rng = np.random.default_rng(sorted(SPLIT_CASES).index(case))
    variants = set()
    for _ in range(6):
        hist, sums, nbins, nan_bin, is_cat = _split_inputs(rng)
        fm = rng.random(len(nbins)) < 0.9
        t = torch.as_tensor
        got = TS.find_best_split(t(hist), t(sums[:, 0]), t(sums[:, 1]),
                                 t(sums[:, 2]), t(nbins), t(nan_bin),
                                 t(is_cat), t(fm), hp_t)
        feat = got.feature.long()
        m = torch.arange(hist.shape[0])
        bits = TS.categorical_left_bitset(
            t(hist)[m, feat], t(nbins)[feat], got.variant, got.threshold,
            hp_t)
        for i in range(hist.shape[0]):
            w = JS.find_best_split(
                jnp.asarray(hist[i]), *(jnp.float32(sums[i, c])
                                        for c in range(3)),
                jnp.asarray(nbins), jnp.asarray(nan_bin),
                jnp.asarray(is_cat), jnp.asarray(fm), hp_j)
            for name in w._fields:
                a = getattr(got, name)[i].item()
                b = np.asarray(getattr(w, name)).item()
                assert a == b and np.signbit(a) == np.signbit(b), \
                    (i, name, a, b)
            want = JS.categorical_left_bitset(
                jnp.asarray(hist[i, int(w.feature)]),
                jnp.asarray(nbins)[int(w.feature)], w.variant, w.threshold,
                hp_j)
            np.testing.assert_array_equal(bits[i].numpy(), np.asarray(want))
            variants.add(int(w.variant))
    assert variants & {TS.VAR_CAT_ONEHOT, TS.VAR_CAT_FWD, TS.VAR_CAT_BWD}


def test_numeric_data_keeps_two_variants():
    """Without categorical features the variant axis stays two wide and
    ``is_cat`` is not read."""
    rng = np.random.default_rng(5)
    hist, sums, nbins, nan_bin, _ = _split_inputs(rng)
    t = torch.as_tensor
    args = (t(hist), t(sums[:, 0]), t(sums[:, 1]), t(sums[:, 2]), t(nbins),
            t(nan_bin))
    hp = TS.SplitHyper(min_data_in_leaf=3, n_bins=64)
    got = TS.find_best_split(*args, None, None, hp)
    ref = TS.find_best_split(*args, torch.zeros(len(nbins), dtype=bool),
                             None, TS.SplitHyper(min_data_in_leaf=3,
                                                 n_bins=64,
                                                 has_categorical=True))
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert int(got.variant.max()) <= TS.VAR_NUM_LEFT


def test_subset_key_makes_signed_zeros_equal():
    score = torch.tensor([0.0, -0.0, 1.0, -0.0, 0.0])
    cand = torch.tensor([True, True, True, True, False])
    for desc in (False, True, torch.tensor(False), torch.tensor(True)):
        key = TS._subset_key(score, cand, desc)
        assert not torch.signbit(key[:2]).any()
        order = torch.argsort(key, stable=True)
        assert order[:3].tolist() in ([0, 1, 3], [2, 0, 1])


# ------------------------------------------------------------ partition

def _table_case(bundled: bool):
    """A categorical dataset, its split descriptors (categorical and
    numeric slots, one invalid) and random bitsets."""
    if bundled:
        X, y, cats = _bundled(3000)
    else:
        X, y = _probe(3000)
        cats = CAT_COLS
    ds = lgb_torch.Dataset(X, y, categorical_feature=cats).construct()._inner
    assert (ds.bundle_plan is not None) == bundled
    rng = np.random.default_rng(11)
    is_cat = ds.categorical_array()
    F = len(is_cat)
    K = 6
    cat_f, num_f = np.flatnonzero(is_cat), np.flatnonzero(~is_cat)
    feats = np.concatenate([cat_f, rng.choice(num_f, K - len(cat_f),
                                              len(num_f) < K - len(cat_f))])
    feats = rng.permutation(feats).astype(np.int32)
    nb = ds.num_bins_array()
    thr = np.array([rng.integers(0, max(nb[f] - 1, 1)) for f in feats],
                   np.int32)
    dl = rng.integers(0, 2, K).astype(np.int32)
    nanb = ds.nan_bin_array()[feats].astype(np.int32)
    B = ds.device_n_bins()
    bitsets = rng.random((K, B)) < 0.4
    bitsets &= is_cat[feats][:, None]
    parents = rng.permutation(8)[:K].astype(np.int32)
    new_leaves = np.arange(8, 8 + K, dtype=np.int32)
    valid = np.ones(K, np.int32)
    valid[1] = 0
    smaller = np.where(rng.random(K) < 0.5, parents, new_leaves) \
        .astype(np.int32)
    return ds, is_cat, (feats, thr, dl, nanb), bitsets, \
        (parents, new_leaves, valid, smaller), F


@pytest.mark.parametrize("bundled", [False, True], ids=["plain", "bundle"])
def test_table_partition_matches_jax_xla_partition(bundled):
    """decision_table's categorical rows plus the plain table partitions
    against the JAX package's XLA partition (batch_grower.py:866-880)."""
    ds, is_cat, num, bitsets, rest, F = _table_case(bundled)
    feats, thr, dl, nanb = num
    parents, new_leaves, valid, smaller = rest
    n = ds.bins.shape[0]
    rng = np.random.default_rng(12)
    lor = rng.integers(0, 8, n).astype(np.int32)
    mask = (rng.random(n) < 0.9).astype(np.int32)
    bins_t = np.ascontiguousarray(ds.bins.T)
    ba = ds.device_bundle_arrays()
    bj = None if ba is None else JG.DeviceBundle(*map(jnp.asarray, ba))
    bt = None if ba is None else TGR.DeviceBundle(*map(torch.as_tensor, ba))

    cols_k = jax.vmap(lambda f: JG._feature_bin_of_rows(
        jnp.asarray(bins_t), bj, f))(jnp.asarray(feats))
    go_left_k = jnp.where(cols_k == jnp.asarray(nanb)[:, None],
                          jnp.asarray(dl != 0)[:, None],
                          cols_k <= jnp.asarray(thr)[:, None])
    go_cat_k = jnp.take_along_axis(jnp.asarray(bitsets),
                                   cols_k.astype(jnp.int32), axis=1)
    go_left_k = jnp.where(jnp.asarray(is_cat)[feats][:, None], go_cat_k,
                          go_left_k)
    in_parent = (jnp.asarray(lor)[None, :]
                 == jnp.asarray(parents)[:, None]) \
        & jnp.asarray(valid != 0)[:, None]
    move = in_parent & ~go_left_k
    target = jnp.sum(move * jnp.asarray(new_leaves)[:, None], axis=0)
    want_lor = np.asarray(jnp.where(jnp.any(move, axis=0), target,
                                    jnp.asarray(lor)))
    lor_m = np.where(mask != 0, want_lor, -1)
    row = np.arange(n, dtype=np.int32)
    want_key = np.where(np.isin(lor_m, smaller), row, row | (1 << 30))

    t = torch.as_tensor
    cols, tab = TRF.decision_table(
        t(feats), t(thr), t(dl), t(nanb),
        feat_col=None if bt is None else bt.feat_col,
        inv_table=None if bt is None else bt.inv_table,
        is_cat=t(is_cat), bitsets=t(bitsets))
    phys = feats if bt is None else ds.bundle_plan.feat_col[feats]
    np.testing.assert_array_equal(cols.numpy(), phys)
    tr = tuple(map(t, rest))
    got_lor, got_key = TRF.partition_select_table(
        t(bins_t), t(lor), t(mask), cols, tab, *tr)
    np.testing.assert_array_equal(got_lor.numpy(), want_lor)
    np.testing.assert_array_equal(got_key.numpy(), want_key)
    words = t(ds.packed_mirror())
    g = t(rng.normal(size=n).astype(np.float32))
    h = t(rng.random(n).astype(np.float32))
    p_lor, p_key, pay = TRF.partition_payload_table(
        t(bins_t), words, g, h, t(lor), t(mask), cols, tab, *tr)
    np.testing.assert_array_equal(p_lor.numpy(), want_lor)
    np.testing.assert_array_equal(p_key.numpy(), want_key)
    np.testing.assert_array_equal(pay[:, -1].numpy(), lor_m)
    if bt is None:
        # all-numeric slots: the identity table is the numeric partition
        numeric = t(~is_cat)
        ncols, ntab = TRF.decision_table(
            t(feats), t(thr), t(dl), t(nanb), is_cat=t(np.zeros(F, bool)),
            bitsets=t(bitsets))
        sel = numeric[t(feats).long()].to(torch.int32)
        rest_n = (tr[0], tr[1], tr[2] * sel, tr[3])
        want = TRF.partition_select_plain(t(bins_t), t(lor), t(mask),
                                          t(feats), t(thr), t(dl), t(nanb),
                                          *rest_n)
        got = TRF.partition_select_table_plain(t(bins_t), t(lor), t(mask),
                                               ncols, ntab, *rest_n)
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b)


# ------------------------------------------------------------ growers

def _grower_case(seed=0, n=6000):
    """Binned probe-like data and integer gradient levels (exact sums)."""
    X, y = _probe(n, seed)
    ds = lgb_torch.Dataset(X, y, categorical_feature=CAT_COLS).construct() \
        ._inner
    rng = np.random.default_rng(seed + 1)
    g = (rng.integers(-6, 7, n) + np.where(y > 0, 2, -2)).astype(np.float32)
    h = rng.integers(1, 4, n).astype(np.float32)
    return ds, g, h


@pytest.mark.parametrize("grower", ["strict", "batched", "pooled"])
def test_growers_match_jax(grower):
    """Every TreeArrays field equal to the JAX grower's on exact
    inputs (float32 integer levels; int8 levels in the batched ones)."""
    ds, g, h = _grower_case()
    bins = ds.bins
    B = ds.device_n_bins()
    nb, nanb, cat = ds.num_bins_array(), ds.nan_bin_array(), \
        ds.categorical_array()
    fields = dict(num_leaves=31, min_data_in_leaf=5, n_bins=B,
                  lambda_l2=1.0, cat_smooth=3.0, min_data_per_group=10,
                  cat_l2=2.0, has_categorical=True, rows_per_block=1024)
    t = torch.as_tensor
    if grower == "strict":
        hp = dict(fields, hist_dtype="float32")
        jarr, jlor = JG.grow_tree(
            jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), None,
            jnp.asarray(nb), jnp.asarray(nanb), jnp.asarray(cat), None,
            JS.SplitHyper(**hp))
        tarr, tlor = TGR.grow_tree(t(bins), t(g), t(h), None, t(nb),
                                   t(nanb), None, TS.SplitHyper(**hp),
                                   is_cat=t(cat))
    else:
        hp = dict(fields, hist_dtype="int8")
        if grower == "pooled":
            hp["hist_pool_slots"] = 3 * 4 + 2
        scale = np.array([1.0, 1.0], np.float32)
        jarr, jlor = JBG.grow_tree_batched(
            jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), None,
            jnp.asarray(nb), jnp.asarray(nanb), jnp.asarray(cat), None,
            JS.SplitHyper(**hp), batch=4, hist_scale=jnp.asarray(scale))
        tarr, tlor = TBG.grow_tree_batched(
            t(bins), t(g), t(h), None, t(nb), t(nanb), None,
            TS.SplitHyper(**hp), batch=4, hist_scale=t(scale),
            is_cat=t(cat))
    assert int(tarr.num_leaves) == int(jarr.num_leaves) == 31
    assert bool(tarr.split_cat.any())
    np.testing.assert_array_equal(tlor.numpy(), np.asarray(jlor))
    for name in tarr._fields:
        np.testing.assert_array_equal(getattr(tarr, name).numpy(),
                                      np.asarray(getattr(jarr, name)),
                                      err_msg=name)


# ------------------------------------------------------------ train()

def _assert_same_partition(bt, bj, X, rtol=1e-5, atol=5e-5):
    """Trees equal as partitions of the training rows: the same split
    features, each port leaf holding exactly one JAX leaf's rows with its
    value within rtol + atol; a categorical node's category set equal to
    the JAX package's or, at a complementary-subset tie, to its
    complement among the categories of the rows reaching the node (its
    children swapped)."""
    lt = bt.predict(X, pred_leaf=True)
    lj = bj.predict(X, pred_leaf=True)
    mt, mj = bt._gbdt.models, bj._gbdt.models
    assert len(mt) == len(mj) == lt.shape[1]
    for k, (tt, tj) in enumerate(zip(mt, mj)):
        assert tt.num_leaves == tj.num_leaves
        assert sorted(tt.split_feature) == sorted(tj.split_feature)
        pairs = set(zip(lt[:, k].tolist(), lj[:, k].tolist()))
        assert len(pairs) == len(set(lt[:, k])) == len(set(lj[:, k]))
        for a, b in pairs:
            np.testing.assert_allclose(tt.leaf_value[a], tj.leaf_value[b],
                                       rtol=rtol, atol=atol)
        cats_t = [set(c) for c in tt.cat_threshold]
        cats_j = [set(c) for c in tj.cat_threshold]
        for ct in cats_t:
            # equal, or a complement of a JAX set among the categories
            # present
            assert ct in cats_j or any(not ct & cj for cj in cats_j), \
                (k, ct)


@pytest.fixture(scope="module")
def probe_strict():
    X, y = _probe(3000)
    bj = lgb_jax.train(dict(PROBE), lgb_jax.Dataset(
        X, y, categorical_feature=CAT_COLS), num_boost_round=4)
    bt = lgb_torch.train(dict(PROBE, device_type="cpu"), lgb_torch.Dataset(
        X, y, categorical_feature=CAT_COLS), num_boost_round=4)
    return X, bt, bj


def test_probe_strict_learner_matches_jax(probe_strict):
    """3,000 rows, a default train(): the strict float32 learner."""
    X, bt, bj = probe_strict
    g = bt._gbdt
    assert g.hp.has_categorical and not g._use_batched_grower()
    assert g.hp.hist_dtype == "float32"
    assert sum(len(t.cat_threshold) for t in g.models) >= 4
    for tt, tj in zip(g.models, bj._gbdt.models):
        np.testing.assert_array_equal(tt.split_feature, tj.split_feature)
        np.testing.assert_array_equal(tt.decision_type & 1,
                                      tj.decision_type & 1)
    _assert_same_partition(bt, bj, X)


def test_probe_batched_grower_matches_jax(monkeypatch):
    """120,000 rows, a default train(): int8 levels, K = 14 in the fused
    loop; text equal to the JAX package's and to the classic loop's."""
    monkeypatch.setattr(JBG, "_WARMUP_MIN_ROWS", 65536)
    monkeypatch.setattr(TBG, "_WARMUP_MIN_ROWS", 65536)
    X, y = _probe(120_000)
    bj = lgb_jax.train(dict(PROBE), lgb_jax.Dataset(
        X, y, categorical_feature=CAT_COLS), num_boost_round=2)
    ds = lgb_torch.Dataset(X, y, categorical_feature=CAT_COLS)
    calls = []
    real = TG.GBDT.train_fused

    def spy(gb, *a, **k):
        calls.append(1)
        return real(gb, *a, **k)

    monkeypatch.setattr(TG.GBDT, "train_fused", spy)
    bt = lgb_torch.train(dict(PROBE, device_type="cpu"), ds,
                         num_boost_round=2)
    assert calls == [1]
    g = bt._gbdt
    assert g._use_batched_grower() and g.hp.hist_dtype == "int8"
    assert int(g.config.tpu_split_batch) == 14
    assert any(t.cat_threshold for t in g.models)
    assert _head(bt) == _head(bj)
    monkeypatch.setattr(TG.GBDT, "supports_fused", lambda self: False)
    classic = lgb_torch.train(dict(PROBE, device_type="cpu"), ds,
                              num_boost_round=2)
    assert classic.model_to_string() == bt.model_to_string()


#: the default recipe's int8 levels at a small size, with categorical
#: settings that split subsets at 6,000 rows
INT8 = dict(num_leaves=31, tpu_split_batch=16, use_quantized_grad=True,
            tpu_hist_dtype="int8", quant_train_renew_leaf=True,
            tpu_rows_per_block=1024, min_data_per_group=20, cat_smooth=5,
            verbosity=-1)
BATCHED = {
    "probe-255": (dict(INT8, objective="regression"), "probe"),
    "probe-binary": (dict(INT8, objective="binary"), "probe"),
    "probe-63": (dict(INT8, objective="regression", max_bin=63), "probe"),
    "pooled": (dict(INT8, objective="regression", tpu_split_batch=4,
                    histogram_pool_size=0.05), "probe"),
    "bundled": (dict(INT8, objective="regression"), "bundled"),
    "onehot-16": (dict(INT8, objective="regression", max_cat_to_onehot=16),
                  "probe"),
}


def _batched_data(name, n=6000, seed=0):
    if name == "bundled":
        return _bundled(n, seed)
    X, y = _probe(n, seed)
    return X, y, CAT_COLS


def _train_cat(params, data, rounds, monkeypatch, classic=False,
               valid=None, callbacks=None):
    """_train_port with the categorical columns named."""
    X, y, cats = data
    real = lgb_torch.Dataset

    def named(*a, **k):
        k.setdefault("categorical_feature", cats)
        return real(*a, **k)

    monkeypatch.setattr(lgb_torch, "Dataset", named)
    return _train_port(params, X, y, rounds, monkeypatch, classic=classic,
                       valid=valid, callbacks=callbacks)


@pytest.mark.parametrize("case", sorted(BATCHED))
def test_batched_grower_text_matches_jax(case, monkeypatch):
    """Fused text equal to classic text and to the JAX package's (binary:
    every field, leaf values within rtol 1e-5: its renewal's sigmoid and
    XLA's f32 division round differently)."""
    params, name = BATCHED[case]
    data = _batched_data(name)
    fused = _train_cat(params, data, 3, monkeypatch)
    classic = _train_cat(params, data, 3, monkeypatch, classic=True)
    X, y, cats = data
    bj = lgb_jax.train(dict(params), lgb_jax.Dataset(
        X, y, categorical_feature=cats), num_boost_round=3)
    g = fused._gbdt
    assert g.hp.has_categorical and g._use_batched_grower()
    assert TBG.pooled(g.hp) == (case == "pooled")
    assert (g.bundle is not None) == (name == "bundled")
    if name == "bundled":
        plan = g.train_set.bundle_plan
        assert any(8 in m and len(m) > 1 for m in plan.bundles)
    assert fused.model_to_string() == classic.model_to_string()
    assert sum(len(t.cat_threshold) for t in g.models) >= 3
    if params["objective"] == "regression":
        assert _head(fused) == _head(bj)
        return
    for tt, tj in zip(g.models, bj._gbdt.models, strict=True):
        for f in ("num_leaves", "split_feature", "threshold_bin",
                  "decision_type", "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(tt, f), getattr(tj, f))
        assert [list(c) for c in tt.cat_threshold] == \
            [list(c) for c in tj.cat_threshold]
        np.testing.assert_allclose(tt.leaf_value, tj.leaf_value, rtol=1e-5)


# ------------------------------------------------------------ scoring

@pytest.mark.parametrize("name", ["probe", "bundled"])
def test_valid_scoring_matches_walk_and_predict(name):
    """Path counts with categorical nodes bit for bit the walk and the JAX
    package's walk; the valid scores ``predict``'s raw scores."""
    X, y, cats = _batched_data(name, n=3000)
    Xv, yv, _ = _batched_data(name, n=1500, seed=7)
    params = dict(INT8, objective="binary", device_type="cpu")
    ds = lgb_torch.Dataset(X, y, categorical_feature=cats)
    b = lgb_torch.Booster(params=params, train_set=ds)
    dv = ds.create_valid(Xv, yv)
    b.add_valid(dv, "v")
    for _ in range(3):
        b.update()
    g = b._gbdt
    assert g.hp.has_categorical
    vbins = dv.inner.bins
    ba = ds.inner.device_bundle_arrays()
    bj = None if ba is None else JG.DeviceBundle(*map(jnp.asarray, ba))
    nan_j = jnp.asarray(ds.inner.nan_bin_array())
    for tree in g.models:
        arrs = TG._tree_to_arrays_stub(tree, ds.inner, g.device)
        assert bool(arrs.split_cat.any())
        got = g._valid_tree_scores(arrs, 0)
        jarrs = JG.TreeArrays(*(jnp.asarray(a.numpy()) for a in arrs))
        want = JP.predict_bins_tree(jarrs, jnp.asarray(vbins), nan_j, bj,
                                    has_categorical=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        walk = TP.predict_bins_tree(arrs, torch.as_tensor(vbins),
                                    g.nan_bin_arr, g.bundle)
        assert torch.equal(got, walk)
    np.testing.assert_allclose(g.valid_scores[0][:, 0].numpy(),
                               b.predict(Xv, raw_score=True), rtol=1e-6,
                               atol=1e-6)


ES = dict(objective="binary", metric="auc", num_leaves=15,
          min_data_in_leaf=5, tpu_split_batch=4, learning_rate=0.5,
          min_data_per_group=20, cat_smooth=5, verbosity=-1)


def test_early_stopping_matches_classic_and_jax(monkeypatch):
    data = _batched_data("probe", n=4000)
    Xv, yv, _ = _batched_data("probe", n=1500, seed=7)

    def port(classic):
        return _train_cat(ES, data, 60, monkeypatch, classic=classic,
                          valid=(Xv, yv),
                          callbacks=[lgb_torch.early_stopping(
                              3, verbose=False)])

    b_fused, b_classic = port(False), port(True)
    X, y, cats = data
    ds = lgb_jax.Dataset(X, label=y, params=ES, categorical_feature=cats)
    b_jax = lgb_jax.train(ES, ds, num_boost_round=60,
                          valid_sets=[ds.create_valid(Xv, label=yv)],
                          valid_names=["v"],
                          callbacks=[lgb_jax.early_stopping(3,
                                                            verbose=False)])
    assert b_fused._gbdt.hp.has_categorical
    assert 0 < b_fused.best_iteration < 60, "the task must stop early"
    assert b_fused.best_iteration == b_classic.best_iteration \
        == b_jax.best_iteration
    assert b_fused.model_to_string() == b_classic.model_to_string()


@pytest.mark.parametrize("path", ["host", "forest"])
def test_predict_unseen_categories_and_nan_match_jax(path, monkeypatch):
    """Held-out rows with unseen categories, negative codes and NaN in the
    categorical columns: the port's predict equals the JAX package's (the
    host float64 walk exactly; the forest predictor's plain version, the
    threshold lowered, within the forest's rtol 2e-5 / atol 2e-6)."""
    params, _ = BATCHED["probe-255"]
    data = _batched_data("probe")
    bt = _train_cat(params, data, 3, monkeypatch)
    X, y, cats = data
    bj = lgb_jax.train(dict(params), lgb_jax.Dataset(
        X, y, categorical_feature=cats), num_boost_round=3)
    assert _head(bt) == _head(bj)
    Xh, _ = _probe(2000, seed=9)
    rng = np.random.default_rng(9)
    for j, unseen in zip(CAT_COLS, (3, 12, 40)):
        r = rng.random(len(Xh))
        Xh[r < 0.1, j] = unseen + rng.integers(0, 5, (r < 0.1).sum())
        Xh[(r >= 0.1) & (r < 0.15), j] = np.nan
        Xh[(r >= 0.15) & (r < 0.18), j] = -1
    if path == "forest":
        monkeypatch.setattr(TG.GBDT, "DEVICE_PREDICT_MIN_WORK", 0)
        got = bt.predict(Xh, raw_score=True)
        want = bj.predict(Xh, raw_score=True)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    else:
        np.testing.assert_array_equal(bt.predict(Xh, raw_score=True),
                                      bj.predict(Xh, raw_score=True))


@pytest.mark.parametrize("name", ["probe-255", "onehot-16"])
def test_host_walk_leaves_match_jax_on_odd_codes(name, monkeypatch):
    """The port's host walk decides its categorical nodes a split at a
    time; the JAX package's walk decides them a row at a time.  Leaf for
    leaf they agree on fractional, negative, huge and NaN codes and unseen
    categories, for the trained trees and the text-loaded ones (NaN goes
    right there); an infinite code raises OverflowError in both."""
    params, _ = BATCHED[name]
    data = _batched_data("probe")
    bt = _train_cat(params, data, 3, monkeypatch)
    X, y, cats = data
    bj = lgb_jax.train(dict(params), lgb_jax.Dataset(
        X, y, categorical_feature=cats), num_boost_round=3)
    assert _head(bt) == _head(bj)
    Xh, _ = _probe(3000, seed=11)
    rng = np.random.default_rng(11)
    for j in CAT_COLS:
        r = rng.random(len(Xh))
        Xh[:, j] += rng.choice([0.0, 0.5, 0.999, -0.5], len(Xh))
        Xh[r < 0.05, j] = np.nan
        odd = (r >= 0.05) & (r < 0.08)
        Xh[odd, j] = rng.choice([-1e19, 1e300, 2.0 ** 40, -1.0], odd.sum())
    trees_t = bt._gbdt.models + lgb_torch.Booster(
        model_str=bt.model_to_string())._loaded["trees"]
    trees_j = bj._gbdt.models + lgb_jax.Booster(
        model_str=bj.model_to_string())._loaded["trees"]
    assert sum(len(t.cat_threshold) for t in trees_t) > 0
    for tt, tj in zip(trees_t, trees_j, strict=True):
        np.testing.assert_array_equal(tt.predict_leaf_index(Xh),
                                      tj.predict_leaf_index(Xh))
    Xh[:, CAT_COLS] = np.inf
    raised = []
    for tt, tj in zip(trees_t, trees_j):
        both = []
        for t in (tt, tj):
            try:
                t.predict_leaf_index(Xh)
                both.append(False)
            except OverflowError:
                both.append(True)
        assert both[0] == both[1]
        raised.append(both[0])
    assert any(raised)


# ------------------------------------------------------------ the loop

def test_refusal_is_gone_and_fused_admits_categorical():
    """A categorical Dataset reaches both growers, and supports_fused
    agrees with the JAX package's."""
    X, y = _probe(2000)
    for params in (dict(PROBE), dict(PROBE, tpu_split_batch=4,
                                     metric="auc")):
        dt = lgb_torch.Dataset(X, y, categorical_feature=CAT_COLS)
        bt = lgb_torch.Booster(params=dict(params, device_type="cpu"),
                               train_set=dt)
        dj = lgb_jax.Dataset(X, y, params=params,
                             categorical_feature=CAT_COLS)
        bj = lgb_jax.Booster(params=params, train_set=dj)
        assert bt._gbdt.hp.has_categorical and bj._gbdt.hp.has_categorical
        assert bt._gbdt.is_cat_arr.tolist() == \
            np.asarray(bj._gbdt.is_cat_arr).tolist()
        assert bt._gbdt.supports_fused() == bj._gbdt.supports_fused()


def test_fused_round_reads_the_host_at_most_once(monkeypatch):
    X, y, cats = _batched_data("probe")
    Xv, yv, _ = _batched_data("probe", n=1500, seed=7)
    real = lgb_torch.Dataset
    monkeypatch.setattr(lgb_torch, "Dataset", lambda *a, **k: real(
        *a, **dict(k, categorical_feature=cats)))
    params = dict(INT8, objective="binary", device_type="cpu", metric="auc")
    reads, rounds, extra = fused_host_reads(monkeypatch, params, X, y, Xv,
                                            yv, 4)
    assert rounds == 4
    assert reads["body"] == 0
    assert reads["step"] <= rounds + 2 * extra
