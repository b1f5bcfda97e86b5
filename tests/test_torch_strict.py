"""The port's strict leaf-wise grower and bounded histogram pool against
lightgbm_tpu on the CPU.

* ``grow_tree`` against the JAX package's ``grow_tree`` on integer-valued
  f32 gradients (every histogram sum exact): every ``TreeArrays`` field and
  ``leaf_of_row`` bitwise equal, under ``tpu_leaf_hist`` masked and
  bucketed, at 64 and 256 bins;
* the pooled ``grow_tree_batched`` against the JAX package's at
  ``hist_pool_slots = 3K + 2`` with int8 levels, bitwise, at batch 4 and 1;
  the batch-1 pooled tree is also the port's strict tree;
* the grower choice (``_use_batched_grower``) and the pool translation
  against the JAX booster's;
* the strict slice end to end: ``train()`` of both packages at n = 10,000
  with the auto policy left alone (strict learner, float32 histograms).
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgb_jax
from lightgbm_tpu.boosting.gbdt import GBDT as JGBDT
from lightgbm_tpu.learner.batch_grower import (
    grow_tree_batched as jax_grow_tree_batched)
from lightgbm_tpu.learner.grower import grow_tree as jax_grow_tree
from lightgbm_tpu.ops.quantize import (
    discretize_gradients_levels as jax_discretize)
from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu.ops.split import SplitHyper as JSplitHyper

import lightgbm_tpu_torch as lgb_torch
from lightgbm_tpu_torch.boosting.gbdt import GBDT as TGBDT
from lightgbm_tpu_torch.learner.batch_grower import grow_tree_batched
from lightgbm_tpu_torch.learner.grower import grow_tree
from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops.split import SplitHyper

from test_torch_fused import one_torch_thread  # noqa: F401


def _inputs(n_bins, seed=0, n=6000, f=7):
    """Bins with a signal on features 0 and 1 (deep trees), NaN bins on
    every third feature, integer-valued f32 gradients and hessians."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, n_bins - 1, size=(n, f)).astype(np.uint8)
    nan_bin = np.where(np.arange(f) % 3 == 0, n_bins - 2, -1).astype(np.int32)
    num_bins = np.full(f, n_bins - 1, np.int32)
    g = np.round(4 * ((bins[:, 0] / n_bins - 0.5)
                      + 0.3 * (bins[:, 1] > n_bins // 2)
                      + 0.2 * rng.normal(size=n))).astype(np.float32)
    h = rng.integers(1, 4, size=n).astype(np.float32)
    return bins, g, h, num_bins, nan_bin


def _assert_trees_equal(tarr, tlor, jarr, jlor, close=()):
    """Every field bitwise equal, except those in ``close`` (rtol 1e-5)."""
    np.testing.assert_array_equal(tlor.numpy(), np.asarray(jlor))
    for name in tarr._fields:
        got, want = getattr(tarr, name).numpy(), np.asarray(getattr(jarr,
                                                                    name))
        assert got.dtype == want.dtype, name
        if name in close:
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def _t(a):
    return None if a is None else torch.as_tensor(np.array(a))


# leaf_hist, bins; the row mask, feature mask and depth limit each ride one
# case (one JAX compilation per case)
@pytest.mark.parametrize("leaf_hist,n_bins,extra", [
    ("masked", 256, "row_mask"),
    ("masked", 64, "max_depth"),
    ("bucketed", 256, "feature_mask"),
    ("bucketed", 64, "max_delta_step"),
])
def test_grow_tree_matches_jax(leaf_hist, n_bins, extra):
    bins, g, h, num_bins, nan_bin = _inputs(n_bins)
    n, f = bins.shape
    rng = np.random.default_rng(1)
    row_mask = rng.random(n) < 0.8 if extra == "row_mask" else None
    fmask = np.arange(f) != 1 if extra == "feature_mask" else None
    fields = dict(num_leaves=31, min_data_in_leaf=5, n_bins=n_bins,
                  lambda_l2=1.0, leaf_hist=leaf_hist,
                  max_depth=5 if extra == "max_depth" else -1,
                  max_delta_step=0.7 if extra == "max_delta_step" else 0.0)
    jarr, jlor = jax_grow_tree(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h),
        None if row_mask is None else jnp.asarray(row_mask),
        jnp.asarray(num_bins), jnp.asarray(nan_bin), jnp.zeros(f, bool),
        None if fmask is None else jnp.asarray(fmask), JSplitHyper(**fields))
    tarr, tlor = grow_tree(_t(bins), _t(g), _t(h), _t(row_mask),
                           _t(num_bins), _t(nan_bin), _t(fmask),
                           SplitHyper(**fields))
    assert int(tarr.num_leaves) > 8
    # under max_delta_step a gain is sum(-(2 g out + (h + l2) out^2)), which
    # XLA's CPU code does not round operation by operation (about 30% of
    # random f32 inputs differ from numpy's); a gain is a difference of such
    # terms, so the recorded split gains may differ by a few 1e-6 of their
    # value.  The splits themselves may not
    _assert_trees_equal(tarr, tlor, jarr, jlor,
                        close=("split_gain",) if extra == "max_delta_step"
                        else ())


@pytest.mark.parametrize("batch,n_bins", [(4, 256), (1, 64)])
def test_pooled_grower_matches_jax(batch, n_bins):
    bins, g, h, num_bins, nan_bin = _inputs(n_bins, seed=2)
    gq, hq, gs, hs = jax_discretize(jnp.asarray(g / 4), jnp.asarray(h),
                                    jax.random.PRNGKey(0), n_levels=4,
                                    stochastic=False, constant_hessian=False)
    scale = jnp.stack([gs, hs])
    fields = dict(num_leaves=31, min_data_in_leaf=5, n_bins=n_bins,
                  hist_dtype="int8", lambda_l2=1.0, rows_per_block=1024)
    pool = dict(fields, hist_pool_slots=3 * batch + 2)
    jarr, jlor = jax_grow_tree_batched(
        jnp.asarray(bins), gq, hq, None, jnp.asarray(num_bins),
        jnp.asarray(nan_bin), jnp.zeros(bins.shape[1], bool), None,
        JSplitHyper(**pool), batch=batch, hist_scale=scale)
    ops = (_t(bins), _t(gq), _t(hq), None, _t(num_bins), _t(nan_bin), None)
    tarr, tlor = grow_tree_batched(*ops, SplitHyper(**pool), batch=batch,
                                   hist_scale=_t(scale))
    assert int(tarr.num_leaves) == 31
    _assert_trees_equal(tarr, tlor, jarr, jlor)
    if batch == 1:
        # a pool at batch 1 is the strict order: the same tree
        sarr, slor = grow_tree(*ops, SplitHyper(**fields),
                               hist_scale=_t(scale))
        _assert_trees_equal(tarr, tlor, sarr, slor)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("pool_mb", [-1.0, 0.4])
def test_grower_choice_matches_jax(batch, pool_mb):
    """The pool translation (0.4 MB = 3 slots of 28 x 256 x 4 f32, raised
    to 3 * batch + 2) and the strict/batched decision of both boosters."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(2000, 28))
    y = X[:, 0] + 0.1 * rng.normal(size=2000)
    params = dict(objective="regression", num_leaves=31, max_bin=255,
                  tpu_split_batch=batch, histogram_pool_size=pool_mb,
                  verbosity=-1)
    bj = lgb_jax.Booster(params=dict(params),
                         train_set=lgb_jax.Dataset(X, y))
    bt = lgb_torch.Booster(params=dict(params, device_type="cpu"),
                           train_set=lgb_torch.Dataset(X, y))
    gj, gt = bj._gbdt, bt._gbdt
    assert gt.hp.hist_pool_slots == gj.hp.hist_pool_slots
    assert (gt.hp.hist_pool_slots > 0) == (pool_mb > 0)
    assert gt._use_batched_grower() == gj._use_batched_grower()
    assert gt._use_batched_grower() == (batch > 1 or pool_mb > 0)


def test_use_batched_grower_matches_jax_decision():
    for batch in (1, 2, 4):
        for slots in (0, 14, 30, 31):
            cfg = types.SimpleNamespace(tpu_split_batch=batch)
            hj = JSplitHyper(num_leaves=31, hist_pool_slots=slots)
            want = JGBDT._use_batched_grower(types.SimpleNamespace(
                _batched_decision=None, hp=hj, config=cfg,
                parallel_mode=None, forced_splits=None))
            got = TGBDT._use_batched_grower(types.SimpleNamespace(
                config=cfg, hp=SplitHyper(num_leaves=31,
                                          hist_pool_slots=slots)))
            assert got == want, (batch, slots)


def _data(objective, n=10_000, f=8, seed=0):
    """The slice data of test_torch_train.py: its best splits have no near
    ties, so both packages' f32 sums pick the same splits."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[rng.random((n, f)) < 0.05] = np.nan
    z = np.nansum(X[:, :3] * np.array([1.0, -0.7, 0.4]), axis=1)
    y = 2.0 * np.tanh(3.0 * z) + 0.5 * rng.normal(size=n)
    if objective == "binary":
        y = (y > 0).astype(np.float64)
    return X, y


ROUNDS = 4


@pytest.fixture(scope="module",
                params=[("regression", "masked"), ("binary", "masked"),
                        ("binary", "bucketed")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def trained_strict(request):
    """Both packages trained with nothing but the objective set (and the
    leaf pass); the port's histogram wrapper calls counted by name."""
    objective, leaf_hist = request.param
    X, y = _data(objective)
    params = dict(objective=objective, tpu_leaf_hist=leaf_hist, verbosity=-1)
    bj = lgb_jax.train(dict(params), lgb_jax.Dataset(X, y),
                       num_boost_round=ROUNDS)
    calls = {"histogram_radix_single": 0, "histogram_rows_t": 0}
    mp = pytest.MonkeyPatch()
    try:
        for name in calls:
            def spy(*a, _real=getattr(TH, name), _name=name, **k):
                calls[_name] += 1
                return _real(*a, **k)
            mp.setattr(TH, name, spy)
        bt = lgb_torch.train(dict(params, device_type="cpu"),
                             lgb_torch.Dataset(X, y), num_boost_round=ROUNDS)
    finally:
        mp.undo()
    return leaf_hist, bj, bt, calls


def test_strict_slice_takes_the_strict_kernels(trained_strict):
    leaf_hist, _, bt, calls = trained_strict
    g = bt._gbdt
    assert int(g.config.tpu_split_batch) == 1
    assert g.hp.hist_dtype == "float32" and not g._use_batched_grower()
    splits = sum(t.num_leaves - 1 for t in g.models)
    assert splits == ROUNDS * 30
    if leaf_hist == "masked":     # the root and every split
        assert calls == {"histogram_radix_single": ROUNDS + splits,
                         "histogram_rows_t": 0}
    else:                         # the root, then the rows kernel per split
        assert calls == {"histogram_radix_single": ROUNDS,
                         "histogram_rows_t": splits}


def test_strict_slice_matches_jax(trained_strict):
    """Identical splits; leaf values within rtol 1e-5 plus atol 5e-5 and
    predictions within 1e-5.  The two packages sum f32 histograms in
    different orders (XLA's blocked one-hot dot, the port's row order), and
    histogram subtraction hands the root's rounding (eps times the root's
    sums) to small leaves, hence the absolute term."""
    _, bj, bt, _ = trained_strict
    assert len(bt._gbdt.models) == len(bj._gbdt.models) == ROUNDS
    for tt, tj in zip(bt._gbdt.models, bj._gbdt.models):
        assert tt.num_leaves == tj.num_leaves
        np.testing.assert_array_equal(tt.split_feature, tj.split_feature)
        np.testing.assert_array_equal(tt.threshold_bin, tj.threshold_bin)
        np.testing.assert_array_equal(tt.decision_type, tj.decision_type)
        np.testing.assert_allclose(tt.leaf_value, tj.leaf_value, rtol=1e-5,
                                   atol=5e-5)
    Xt = np.random.default_rng(9).normal(size=(2000, 8))
    Xt[::11, 2] = np.nan
    np.testing.assert_allclose(bt.predict(Xt), bj.predict(Xt), rtol=0,
                               atol=1e-5)


def test_default_direction_of_a_node_without_missing_rows():
    """Strict float32, 10% NaN, max_depth=4: tree 0's node 13 has no row
    missing in its feature, but its NaN bin holds a subtraction residual
    (count 0).  The port treats such a bin as empty, so the two default
    directions tie exactly and the node goes right, as in the JAX package;
    every node's decision_type equals the JAX package's."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(3000, 6))
    X[rng.random((3000, 6)) < 0.1] = np.nan
    X[:, 5] = np.where(rng.random(3000) < 0.5, 0, X[:, 5])
    y = (np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1])
         + 0.3 * rng.normal(size=3000) > 0).astype(np.float64)
    params = dict(objective="binary", num_leaves=15, max_depth=4,
                  verbosity=-1)
    tj = lgb_jax.train(dict(params), lgb_jax.Dataset(X, y),
                       num_boost_round=1)._gbdt.models[0]
    tt = lgb_torch.train(dict(params, device_type="cpu"),
                         lgb_torch.Dataset(X, y),
                         num_boost_round=1)._gbdt.models[0]
    assert tt.num_leaves == tj.num_leaves == 15
    np.testing.assert_array_equal(tt.split_feature, tj.split_feature)
    np.testing.assert_array_equal(tt.threshold_bin, tj.threshold_bin)
    np.testing.assert_array_equal(tt.decision_type, tj.decision_type)


def test_grow_tree_finds_the_scale_once_per_tree(monkeypatch):
    """The masked strict tree computes the radix-single kernel's float32
    scale once and hands the same tensor to the root pass and to every
    split's single-leaf pass (on the CPU the plain versions ignore it)."""
    bins, g, h, num_bins, nan_bin = _inputs(256, seed=3)
    scales, seen = [], []
    real_scale, real_radix = TH.pass_scale, TH.histogram_radix_single

    def counting_scale(grad, hess):
        scales.append(real_scale(grad, hess))
        return scales[-1]

    def recording_radix(*a, scale=None, **kw):
        seen.append(scale)
        return real_radix(*a, scale=scale, **kw)

    monkeypatch.setattr(TH, "pass_scale", counting_scale)
    monkeypatch.setattr(TH, "histogram_radix_single", recording_radix)
    hp = SplitHyper(num_leaves=31, min_data_in_leaf=5, n_bins=256,
                    lambda_l2=1.0, leaf_hist="masked")
    tarr, _ = grow_tree(_t(bins), _t(g), _t(h), None, _t(num_bins),
                        _t(nan_bin), None, hp)
    splits = int(tarr.num_leaves) - 1
    assert len(scales) == 1
    assert len(seen) == splits + 1                     # root + one per split
    assert all(s is scales[0] for s in seen)
    np.testing.assert_array_equal(
        scales[0].numpy(),
        np.array([np.abs(g).max(), np.abs(h).max()], np.float32).view(
            np.int32))


def _nan_probe():
    """ROADMAP.md Queue 3's probe: 3,000 x 6 normal values, seed 0, 10%
    NaN, half of column 5 zeros, binary, ``max_bin_by_feature``."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(3000, 6))
    X[rng.random((3000, 6)) < 0.1] = np.nan
    X[:, 5] = np.where(rng.random(3000) < 0.5, 0, X[:, 5])
    y = (np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1])
         + 0.3 * rng.normal(size=3000) > 0).astype(np.float64)
    params = dict(objective="binary", num_leaves=15, verbosity=-1,
                  max_bin_by_feature=[15, 31, 63, 7, 255, 3])
    return X, y, params


def _variant_gains(xp, cumsum, leaf_gain, hist, tot, nb, nanb, hp):
    """(best gain, its bin) of each missing-value variant of one feature,
    0 (missing right) and 1 (missing left), in one package's arithmetic
    (``xp`` torch or jax.numpy, with that package's ``leaf_gain``)."""
    g, h, n = hist[:, 0], hist[:, 1], hist[:, 2]
    b = xp.arange(hist.shape[0])
    is_nan = b == nanb
    zero = xp.zeros_like(g)
    gl = cumsum(xp.where(is_nan, zero, g))
    hl = cumsum(xp.where(is_nan, zero, h))
    nl = cumsum(xp.where(is_nan, zero, n))
    gm = xp.where(is_nan, g, zero).sum()
    hm = xp.where(is_nan, h, zero).sum()
    nm = xp.where(is_nan, n, zero).sum()
    out = []
    for dg, dh, dn in ((0.0, 0.0, 0.0), (gm, hm, nm)):
        GL, HL, NL = gl + dg, hl + dh, nl + dn
        gain = (leaf_gain(GL, HL, hp.lambda_l1, hp.lambda_l2)
                + leaf_gain(tot[0] - GL, tot[1] - HL, hp.lambda_l1,
                            hp.lambda_l2)
                - leaf_gain(tot[0], tot[1], hp.lambda_l1, hp.lambda_l2))
        ok = ((b < nb - 1) & ~is_nan & (NL >= hp.min_data_in_leaf)
              & (tot[2] - NL >= hp.min_data_in_leaf)
              & (HL >= hp.min_sum_hessian_in_leaf)
              & (tot[1] - HL >= hp.min_sum_hessian_in_leaf))
        gain = xp.where(ok, gain, xp.full_like(gain, -1e30))
        t = int(np.argmax(np.asarray(gain)))
        out.append((float(np.asarray(gain)[t]), t))
    return out


def test_nan_split_probe_same_histogram_same_winner(capsys):
    """Queue 3's two-way NaN-or-not split (strict float32).  At the probed
    node the two missing-value variants can send the same rows to each
    child, so their float32 gains tie but for rounding.  On one shared
    histogram (the node's rows summed in float64) both packages'
    ``find_best_split`` return the same SplitResult, so where trained trees
    differ it is the histograms' float32 summation order (a contract
    note): the trees are held as partitions of the training rows, up to
    the labels of the two children."""
    from lightgbm_tpu.ops.split import find_best_split as jfbs
    from lightgbm_tpu.ops.split import leaf_gain as jleaf_gain
    from lightgbm_tpu_torch.ops.split import find_best_split as tfbs
    from lightgbm_tpu_torch.ops.split import leaf_gain as tleaf_gain
    X, y, params = _nan_probe()
    bj = lgb_jax.train(dict(params), lgb_jax.Dataset(X, y),
                       num_boost_round=1)
    ds = lgb_torch.Dataset(X, y)
    bt = lgb_torch.train(dict(params, device_type="cpu"), ds,
                         num_boost_round=1)
    tj, tt = bj._gbdt.models[0], bt._gbdt.models[0]
    # the partitions of the training rows agree, up to leaf labels
    lt, lj = tt.predict_leaf_index(X), tj.predict_leaf_index(X)
    pairs = set(zip(lt.tolist(), lj.tolist()))
    assert len(pairs) == len(set(lt.tolist())) == len(set(lj.tolist()))
    for a, b in pairs:
        np.testing.assert_allclose(tt.leaf_value[a], tj.leaf_value[b],
                                   rtol=1e-5, atol=5e-5)
    np.testing.assert_array_equal(tt.split_feature, tj.split_feature)

    # node 13's rows, the round-0 gradients, one shared f32 histogram
    node = 13
    sub, stack = set(), [node]
    while stack:
        v = stack.pop()
        for c in (tt.left_child[v], tt.right_child[v]):
            (stack.append(c) if c >= 0 else sub.add(-c - 1))
    rows = np.isin(lt, sorted(sub))
    p0 = y.mean()
    p = np.full(len(y), p0)
    g = (p - y).astype(np.float32)
    h = (p * (1 - p)).astype(np.float32)
    inner = ds.construct()._inner
    bins = np.asarray(inner.bins)[rows].astype(np.int64)
    F, B = bins.shape[1], inner.device_n_bins()
    shared = np.zeros((F, B, 4))
    for f in range(F):
        for c, v in enumerate((g[rows], h[rows], np.ones(rows.sum()))):
            np.add.at(shared[f, :, c], bins[:, f], v.astype(np.float64))
    shared = shared.astype(np.float32)
    tot = shared[0].sum(0)
    nb = inner.num_bins_array()
    nanb = inner.nan_bin_array()
    hp = bt._gbdt.hp
    want = jfbs(jnp.asarray(shared), *(jnp.float32(tot[c])
                                      for c in range(3)),
                jnp.asarray(nb), jnp.asarray(nanb),
                jnp.zeros(F, bool), None,
                JSplitHyper(**{f: getattr(hp, f)
                               for f in hp.__dataclass_fields__}))
    got = tfbs(torch.as_tensor(shared)[None],
               *(torch.tensor([tot[c]]) for c in range(3)),
               torch.as_tensor(nb), torch.as_tensor(nanb), None, None, hp)
    for name in got._fields:
        assert getattr(got, name)[0].item() == \
            np.asarray(getattr(want, name)).item(), name
    f = int(tj.split_feature[node])
    with capsys.disabled():
        print(f"\nnan probe: tree 0 node {node}, feature {f}, "
              f"{int(rows.sum())} rows; (gain, bin) of variants 0 / 1")
        print("  shared histogram, JAX:  ",
              _variant_gains(jnp, jnp.cumsum, jleaf_gain,
                             jnp.asarray(shared[f]), jnp.asarray(tot),
                             int(nb[f]), int(nanb[f]), hp))
        print("  shared histogram, port: ",
              _variant_gains(torch, lambda x: torch.cumsum(x, 0),
                             tleaf_gain, torch.as_tensor(shared[f]),
                             torch.as_tensor(tot), int(nb[f]),
                             int(nanb[f]), hp))
        # each package's own histogram pass over the node's rows
        all_bins = np.asarray(inner.bins)
        own_j = np.asarray(JH.root_histogram(
            jnp.asarray(all_bins.T), jnp.asarray(g), jnp.asarray(h),
            jnp.asarray(rows), n_bins=B, hist_dtype="float32",
            hist_kernel=hp.hist_kernel))
        own_t = TH.root_histogram(
            torch.as_tensor(all_bins.T.copy()), torch.as_tensor(g),
            torch.as_tensor(h), torch.as_tensor(rows), n_bins=B,
            hist_dtype="float32", hist_kernel=hp.hist_kernel)
        print("  own histogram, JAX:     ",
              _variant_gains(jnp, jnp.cumsum, jleaf_gain,
                             jnp.asarray(own_j[f]), jnp.asarray(tot),
                             int(nb[f]), int(nanb[f]), hp))
        print("  own histogram, port:    ",
              _variant_gains(torch, lambda x: torch.cumsum(x, 0),
                             tleaf_gain, own_t[f], torch.as_tensor(tot),
                             int(nb[f]), int(nanb[f]), hp))
        print("  trees: JAX bin %d type %d, port bin %d type %d"
              % (tj.threshold_bin[node], tj.decision_type[node],
                 tt.threshold_bin[node], tt.decision_type[node]))
