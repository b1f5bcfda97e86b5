"""The port's split constraints against lightgbm_tpu on the CPU: monotone
constraints (basic, intermediate, advanced, the penalty), path smoothing,
extra trees, by-node feature sampling and interaction constraints.

* ``learner/monotone.py``'s boxes and bounds, the tensor-key threefry
  (``ops/prng.py``) and ``sample_features_bynode`` equal the JAX
  functions bit for bit; ``find_best_split`` gives the JAX package's whole
  ``SplitResult`` on integer-valued histograms under every constraint.
* ``train()`` through the batched grower (10,000 rows, int8 levels) and
  the strict one (3,000 rows, float32) against the JAX package.  Extra
  trees, by-node sampling and interaction constraints give the JAX
  package's int8 model text byte for byte.  Under monotone constraints
  and path smoothing the split gains are evaluated at the children's
  outputs, ``-(2 g o + (h + l2) o^2)`` and ``o w + p (1 - w)``, where
  XLA's CPU backend contracts the products and sums into fused
  multiply-adds and PyTorch rounds each operation (as the card does):
  the gains differ in their last bits (rtol 1e-5, and 1e-6 of the tree's
  largest gain, since a gain cancels terms as large as the root's), so
  int8 text is held equal line for line except ``split_gain`` and
  ``tree_sizes``.
  Float32 models are compared as trees (splits and counts equal, leaves
  rtol 1e-5 + atol 5e-5).
* The fused loop gives the classic loop's text, and the behaviour the
  JAX package's tests check (tests/test_constraints.py,
  tests/test_batch_grower.py) holds for the port's models.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgb_jax
from lightgbm_tpu.learner import monotone as JM
from lightgbm_tpu.learner.grower import (
    sample_features_bynode as jax_bynode)
from lightgbm_tpu.ops.split import SplitHyper as JSplitHyper
from lightgbm_tpu.ops.split import find_best_split as jax_find_best_split

import lightgbm_tpu_torch as lgb_torch
from lightgbm_tpu_torch.boosting import gbdt as TG
from lightgbm_tpu_torch.learner import monotone as TM
from lightgbm_tpu_torch.learner.grower import sample_features_bynode
from lightgbm_tpu_torch.ops import prng
from lightgbm_tpu_torch.ops.split import SplitHyper, find_best_split

from test_torch_fused import one_torch_thread  # noqa: F401
from test_torch_train import SLICE, _data

#: the strict learner's configuration (float32 histograms below 100k rows)
STRICT = dict(num_leaves=15, verbosity=-1)
MONO = [1, -1, 1, 0, 0, 0, 0, 0]
ROUNDS = 3


# ------------------------------------------------------------- the boxes
def _boxes(rng, L, F, B, n_live, cat_p=0.2):
    """A valid box set: ``n_live`` leaves grown by random splits (a
    categorical one leaves both children on the parent's box), the unused
    slots empty."""
    lo = np.zeros((L, F), np.int32)
    hi = np.zeros((L, F), np.int32)
    hi[0] = rng.integers(4, B + 1, size=F)
    n = 1
    while n < n_live:
        p, f = rng.integers(0, n), rng.integers(0, F)
        categorical = rng.random() < cat_p
        if not categorical and hi[p, f] - lo[p, f] < 2:
            continue
        lo[n], hi[n] = lo[p], hi[p]
        if not categorical:
            t = rng.integers(lo[p, f], hi[p, f] - 1)
            hi[p, f] = lo[n, f] = t + 1
        n += 1
    return lo, hi


@pytest.mark.parametrize("seed", range(5))
def test_monotone_boxes_match_jax(seed):
    rng = np.random.default_rng(seed)
    L, F, B = 31, 5, 16
    n_live = int(rng.integers(2, L + 1))
    lo, hi = _boxes(rng, L, F, B, n_live, cat_p=0.4 if seed % 2 else 0.1)
    out = rng.normal(size=L).astype(np.float32)
    mono = rng.integers(-1, 2, size=F).astype(np.int32)
    want = JM.box_bounds(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(out),
                         jnp.asarray(mono), jnp.int32(n_live))
    got = TM.box_bounds(torch.as_tensor(lo), torch.as_tensor(hi),
                        torch.as_tensor(out), torch.as_tensor(mono), n_live)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    leaves = np.arange(n_live)
    got = TM.advanced_split_bounds(
        torch.as_tensor(lo), torch.as_tensor(hi), torch.as_tensor(out),
        torch.as_tensor(mono), torch.tensor(n_live), torch.as_tensor(leaves),
        B)
    for m in leaves:
        want = JM.advanced_split_bounds(
            jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(out),
            jnp.asarray(mono), jnp.int32(n_live), jnp.int32(m), B)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a[m].numpy(), np.asarray(b))
    p, nl, f = 0, n_live % L, int(rng.integers(0, F))
    for numerical in (True, False):
        want = JM.split_boxes(jnp.asarray(lo), jnp.asarray(hi), jnp.int32(p),
                              jnp.int32(nl), jnp.int32(f), jnp.int32(1),
                              jnp.bool_(numerical))
        got = TM.split_boxes(torch.as_tensor(lo.copy()),
                             torch.as_tensor(hi.copy()), torch.tensor([p]),
                             torch.tensor([nl]), torch.tensor([f]),
                             torch.tensor([1]), torch.tensor([numerical]))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_identical_boxes_bound_nothing():
    # siblings of a categorical split keep the parent's box: ordered along
    # no feature, they constrain each other not at all
    lower, upper = TM.box_bounds(
        torch.zeros(2, 2, dtype=torch.int32),
        torch.full((2, 2), 10, dtype=torch.int32),
        torch.tensor([0.3, -0.7]), torch.tensor([-1, 0]), 2)
    assert (upper > 1e29).all() and (lower < -1e29).all()


# -------------------------------------------------------- the tensor keys
def _key_batch(seed, N):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 2 ** 32, size=(N, 2), dtype=np.uint64)
    return k.astype(np.int64), jnp.asarray(k.astype(np.uint32))


def test_tensor_keys_match_jax():
    keys, jk = _key_batch(0, 84)
    t = torch.as_tensor(keys)
    data = np.arange(84, dtype=np.int64) * 2 + 1
    want = jax.vmap(jax.random.fold_in)(jk, jnp.asarray(data, jnp.uint32))
    np.testing.assert_array_equal(
        prng.fold_in_keys(t, torch.as_tensor(data)).numpy(),
        np.asarray(want).astype(np.int64))
    np.testing.assert_array_equal(
        prng.split_keys(t, 4).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.split(k, 4))(jk))
        .astype(np.int64))
    np.testing.assert_array_equal(
        prng.uniform_keys(t, 28).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (28,)))(jk)))


@pytest.mark.parametrize("path", ["node", "node-family", "strict-split",
                                  "strict-extra"])
def test_draw_matches_jax(path):
    """The growers' draws: a batched round's by-node and extra-trees keys
    (fold_in by node data, then a family of split(., 3)), and the strict
    learner's split(fold_in(key, i), 4) keys (one key for every row)."""
    keys, jk = _key_batch(1, 84)
    t = torch.as_tensor(keys)
    d = np.arange(84, dtype=np.int64) * 2 + 2
    jd = jnp.asarray(d, jnp.uint32)
    fold = jax.vmap(jax.random.fold_in)
    if path == "node":
        got = prng.draw(t, 28, [torch.as_tensor(d)])
        want = jax.vmap(lambda k: jax.random.uniform(k, (28,)))(fold(jk, jd))
    elif path == "node-family":
        got = prng.draw(t, 28, [torch.as_tensor(d), (2, 0)])
        want = jax.vmap(lambda k: jax.random.uniform(
            jax.random.split(k, 3)[2], (28,)))(fold(jk, jd))
    else:
        one = t[:1].expand(4, 2)
        sub = jax.random.split(jax.random.fold_in(jk[0], 7), 4)
        if path == "strict-split":
            got = prng.draw(one, 28, [(7, 0), (0, 1)])
        else:
            got = prng.draw(one, 28, [(7, 0), (0, 1), (1, 0)])
            sub = jax.vmap(lambda k: jax.random.split(k, 3)[1])(sub)
        want = jax.vmap(lambda k: jax.random.uniform(k, (28,)))(sub)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("frac", [0.3, 0.5, 0.8])
def test_sample_features_bynode_matches_jax(frac):
    keys, jk = _key_batch(2, 12)
    rng = np.random.default_rng(3)
    masks = rng.random((12, 28)) < 0.7
    masks[0] = True
    masks[1] = False
    u = prng.uniform_keys(torch.as_tensor(keys), 28)
    got = sample_features_bynode(torch.as_tensor(masks), u, frac)
    for m in range(12):
        want = jax_bynode(jnp.asarray(masks[m]), jk[m], frac, 28)
        np.testing.assert_array_equal(got[m].numpy(), np.asarray(want))
    # no tree mask: every feature allowed
    got = sample_features_bynode(None, u, frac)
    want = jax_bynode(None, jk[4], frac, 28)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want))


# ------------------------------------------------------------ split finding
_FIELDS = ("gain", "feature", "threshold", "default_left", "is_categorical",
           "variant", "left_sum_g", "left_sum_h", "left_count",
           "right_sum_g", "right_sum_h", "right_count")


def _hists(seed, categorical):
    """Integer-valued histograms of six leaves (grad 1/8, hess 1/4 steps;
    an empty bin has zero sums) with totals that every feature agrees on."""
    rng = np.random.default_rng(seed)
    M, F, B = 6, 5, 32
    hist = np.zeros((M, F, B, 4), np.float32)
    hist[..., 0] = rng.integers(-20, 21, size=(M, F, B)) * 0.125
    hist[..., 1] = rng.integers(0, 30, size=(M, F, B)) * 0.25
    hist[..., 2] = rng.integers(0, 30, size=(M, F, B))
    hist[..., :2] *= hist[..., 2:3] > 0
    num_bins = np.array([32, 20, 31, 8, 32], np.int32)
    nan_bin = np.array([31, -1, 30, -1, -1], np.int32)
    hist[:, 1, 20:] = 0
    hist[:, 3, 8:] = 0
    sums = hist[:, 1].sum(axis=1)
    hist[:, :, 0, :3] += sums[:, None, :3] - hist[..., :3].sum(axis=2)
    is_cat = np.array([False, False, False, categorical, False])
    return rng, hist, sums, num_bins, nan_bin, is_cat


SPLIT_CASES = {
    "basic-bounds": dict(use_monotone=True),
    "advanced-bounds": dict(use_monotone=True, monotone_method="advanced"),
    "penalty-0.5": dict(use_monotone=True, monotone_penalty=0.5),
    "penalty-1": dict(use_monotone=True, monotone_penalty=1.0),
    "penalty-3": dict(use_monotone=True, monotone_penalty=3.0),
    "path-smooth": dict(path_smooth=2.0),
    "extra-trees": dict(extra_trees=True),
    "all": dict(use_monotone=True, monotone_penalty=1.0, path_smooth=1.0,
                extra_trees=True),
}


@pytest.mark.parametrize("categorical", [False, True],
                         ids=["numeric", "categorical"])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_find_best_split_constraints_match_jax(case, categorical):
    rng, hist, sums, nb, nanb, isc = _hists(len(case), categorical)
    M, F, B = hist.shape[:3]
    fields = dict(min_data_in_leaf=3, min_sum_hessian_in_leaf=1.0,
                  lambda_l1=0.5, lambda_l2=2.0, n_bins=B,
                  has_categorical=categorical, max_cat_to_onehot=4,
                  min_data_per_group=5, cat_smooth=2.0,
                  **SPLIT_CASES[case])
    mono = rng.integers(-1, 2, size=F).astype(np.int32)
    mono[isc] = 0
    pout = (rng.normal(size=M) * 0.5).astype(np.float32)
    lmin = (-np.abs(rng.normal(size=M)) * 0.3).astype(np.float32)
    lmax = (np.abs(rng.normal(size=M)) * 0.3).astype(np.float32)
    depth = (np.arange(M) % 5).astype(np.int32)   # the penalty's depths 0-4
    keys, jkeys = _key_batch(len(case), M)
    rand = [prng.draw(torch.as_tensor(keys), F, [(j, 0)]) for j in range(3)]
    adv = None
    if fields.get("monotone_method") == "advanced":
        adv = [(sg * np.abs(rng.normal(size=(M, F, B))) * 0.3)
               .astype(np.float32) for sg in (-1, 1, -1, 1)]
        for a, inf in zip(adv, (-1e30, 1e30, -1e30, 1e30)):
            a[rng.random(a.shape) < 0.3] = inf
    got = find_best_split(
        torch.as_tensor(hist), *(torch.as_tensor(sums[:, c])
                                 for c in range(3)),
        torch.as_tensor(nb), torch.as_tensor(nanb), torch.as_tensor(isc),
        None, SplitHyper(**fields), monotone=torch.as_tensor(mono),
        parent_output=torch.as_tensor(pout), leaf_min=torch.as_tensor(lmin),
        leaf_max=torch.as_tensor(lmax), depth=torch.as_tensor(depth),
        rand=rand,
        adv_bounds=None if adv is None else [torch.as_tensor(a)
                                             for a in adv])
    hp_j = JSplitHyper(**fields)
    for m in range(M):
        want = jax_find_best_split(
            jnp.asarray(hist[m]), *(jnp.float32(sums[m, c])
                                    for c in range(3)),
            jnp.asarray(nb), jnp.asarray(nanb), jnp.asarray(isc), None,
            hp_j, monotone=jnp.asarray(mono),
            parent_output=jnp.float32(pout[m]),
            leaf_min=jnp.float32(lmin[m]), leaf_max=jnp.float32(lmax[m]),
            depth=jnp.int32(depth[m]), rng_key=jkeys[m],
            adv_bounds=None if adv is None else tuple(
                jnp.asarray(a[m]) for a in adv))
        for name in _FIELDS:
            assert getattr(got, name)[m].item() == \
                np.asarray(getattr(want, name)).item(), (m, name)


# ------------------------------------------------------------------ train()
def _categorical_data(n, seed=0):
    """``_data`` with column 7 replaced by integer category codes."""
    X, y = _data("regression", n=n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    codes = rng.integers(0, 12, size=n)
    X[:, 7] = codes
    y = y + 0.6 * (codes % 3)
    return X, y


def _bundled_data(n, seed=0):
    """Two dense columns and three exclusive one-hot blocks (EFB bundles
    them), the target increasing in dense column 0."""
    rng = np.random.default_rng(seed)
    blocks = []
    idx0 = None
    for _ in range(3):
        idx = rng.integers(0, 6, size=n)
        idx0 = idx if idx0 is None else idx0
        b = np.zeros((n, 6))
        b[np.arange(n), idx] = rng.normal(1.5, 0.2, size=n)
        blocks.append(b)
    dense = rng.normal(size=(n, 2))
    X = np.concatenate([dense] + blocks, axis=1)
    y = 2.0 * dense[:, 0] + 0.5 * (idx0 % 2) + 0.3 * rng.normal(size=n)
    return X, y


TRAIN_CASES = {
    "basic": dict(monotone_constraints=MONO),
    "intermediate": dict(monotone_constraints=MONO,
                         monotone_constraints_method="intermediate"),
    "advanced": dict(monotone_constraints=MONO,
                     monotone_constraints_method="advanced"),
    "penalty": dict(monotone_constraints=MONO, monotone_penalty=1.5),
    "path-smooth": dict(path_smooth=5.0),
    "extra-trees": dict(extra_trees=True),
    "bynode": dict(feature_fraction_bynode=0.5),
    "interaction": dict(interaction_constraints="[0,1,2],[3,4,5,6,7]"),
    # the categorical column's direction is forced to 0
    "monotone-categorical": dict(
        monotone_constraints=[1, -1, 0, 0, 0, 0, 0, 1],
        monotone_constraints_method="intermediate",
        categorical_feature=[7]),
    "extra-trees-categorical": dict(extra_trees=True,
                                    categorical_feature=[7]),
    "monotone-bundled": dict(monotone_constraints=[1], data="bundled"),
}
#: the configurations whose gains are evaluated at the children's outputs
OUTPUT_PATH = ("basic", "intermediate", "advanced", "penalty", "path-smooth",
               "monotone-categorical", "monotone-bundled")


def _train_both(case, base, n):
    params = dict(base, objective="regression", **TRAIN_CASES[case])
    kind = params.pop("data", None)
    cat = params.pop("categorical_feature", None)
    if kind == "bundled":
        X, y = _bundled_data(n)
    elif cat is not None:
        X, y = _categorical_data(n)
    else:
        X, y = _data("regression", n=n)
    kw = {} if cat is None else dict(categorical_feature=cat)
    bj = lgb_jax.train(params, lgb_jax.Dataset(X, y, **kw),
                       num_boost_round=ROUNDS)
    bt = lgb_torch.train(dict(params, device_type="cpu"),
                         lgb_torch.Dataset(X, y, **kw),
                         num_boost_round=ROUNDS)
    return bj, bt


def _text_lines(booster):
    head, params = booster.model_to_string().split("parameters:")
    lines = params.splitlines()
    if "[device_type: cpu]" in lines:
        lines.remove("[device_type: cpu]")
    return head.splitlines(), lines


def _assert_trees_match(bj, bt, leaf_tol):
    assert len(bt._gbdt.models) == len(bj._gbdt.models)
    for tt, tj in zip(bt._gbdt.models, bj._gbdt.models):
        assert tt.num_leaves == tj.num_leaves
        for f in ("split_feature", "threshold_bin", "decision_type",
                  "left_child", "right_child", "leaf_count",
                  "internal_count"):
            np.testing.assert_array_equal(getattr(tt, f), getattr(tj, f),
                                          err_msg=f)
        np.testing.assert_allclose(tt.leaf_value, tj.leaf_value,
                                   **leaf_tol)
        # a gain is a sum of terms as large as the root's: its rounding
        # error scales with them, not with the gain
        np.testing.assert_allclose(
            tt.split_gain, tj.split_gain, rtol=1e-5,
            atol=1e-6 * float(np.max(np.abs(tj.split_gain), initial=0.0)))


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_batched_train_matches_jax(case):
    """int8 levels, the batched grower, the fused loop."""
    bj, bt = _train_both(case, SLICE, 10_000)
    (hj, pj), (ht, pt) = _text_lines(bj), _text_lines(bt)
    assert pt == pj
    if case not in OUTPUT_PATH:
        assert ht == hj
        return
    # equal but for split_gain's last digits (and so the trees' sizes)
    skip = ("split_gain=", "tree_sizes=")
    assert [x for x in ht if not x.startswith(skip)] == \
        [x for x in hj if not x.startswith(skip)]
    _assert_trees_match(bj, bt, dict(rtol=0, atol=0))


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_strict_train_matches_jax(case):
    """float32 histograms, the strict learner, the classic loop."""
    bj, bt = _train_both(case, STRICT, 3_000)
    assert _text_lines(bt)[1] == _text_lines(bj)[1]
    _assert_trees_match(bj, bt, dict(rtol=1e-5, atol=5e-5))


FUSED_CASES = {
    "intermediate-extra-bynode": dict(
        SLICE, objective="regression", monotone_constraints=MONO,
        monotone_constraints_method="intermediate", extra_trees=True,
        feature_fraction_bynode=0.5),
    "multiclass-k3": dict(
        SLICE, objective="multiclass", num_class=3,
        monotone_constraints=MONO, extra_trees=True,
        feature_fraction_bynode=0.5,
        interaction_constraints="[0,1,2,3],[3,4,5,6,7]"),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_matches_classic(case, monkeypatch):
    params = dict(FUSED_CASES[case], device_type="cpu")
    X, y = _data("regression", n=10_000)
    if params["objective"] == "multiclass":
        y = np.digitize(y, [-0.7, 0.7]).astype(np.float64)
    fused = []
    real = TG.GBDT.train_fused

    def spy(gb, *a, **k):
        fused.append(1)
        return real(gb, *a, **k)

    monkeypatch.setattr(TG.GBDT, "train_fused", spy)
    bf = lgb_torch.train(params, lgb_torch.Dataset(X, y), num_boost_round=4)
    assert fused == [1]
    monkeypatch.setattr(TG.GBDT, "supports_fused", lambda self: False)
    bc = lgb_torch.train(params, lgb_torch.Dataset(X, y), num_boost_round=4)
    assert fused == [1]
    assert bf.model_to_string() == bc.model_to_string()


# ------------------------------------------------------------ behaviour
FAST = dict(min_data_in_leaf=5, verbosity=-1, device_type="cpu")


def _monotone_data(seed=21, n=3000):
    """tests/test_constraints.py's data: increasing in column 0,
    decreasing in column 1, a step in column 2."""
    rng = np.random.default_rng(seed)
    x_inc, x_dec, x_free = (rng.uniform(-1, 1, n) for _ in range(3))
    y = (5 * x_inc + np.sin(3 * x_inc) - 4 * x_dec + np.cos(2 * x_dec)
         + np.sign(x_free) + rng.normal(scale=0.2, size=n))
    return np.stack([x_inc, x_dec, x_free], axis=1), y


def _is_monotone(bst, feature, direction, n_grid=60):
    rng = np.random.default_rng(0)
    for _ in range(5):
        X = np.tile(rng.uniform(-1, 1, 3), (n_grid, 1))
        X[:, feature] = np.linspace(-1, 1, n_grid)
        diffs = np.diff(bst.predict(X)) * direction
        if (diffs < -1e-9).any():
            return False
    return True


@pytest.mark.parametrize("learner", ["strict", "batched"])
@pytest.mark.parametrize("method", ["basic", "intermediate", "advanced"])
def test_monotone_predictions(method, learner):
    X, y = _monotone_data()
    params = dict(FAST, objective="regression", num_leaves=31,
                  monotone_constraints=[1, -1, 0],
                  monotone_constraints_method=method)
    if learner == "batched":
        params.update(tpu_split_batch=8)
    bst = lgb_torch.train(params, lgb_torch.Dataset(X, y),
                          num_boost_round=30)
    assert _is_monotone(bst, 0, +1) and _is_monotone(bst, 1, -1)
    assert np.corrcoef(bst.predict(X), y)[0, 1] > 0.8
    if method == "basic" and learner == "strict":
        free = lgb_torch.train(dict(FAST, objective="regression",
                                    num_leaves=31),
                               lgb_torch.Dataset(X, y), num_boost_round=30)
        assert not (_is_monotone(free, 0, +1) and _is_monotone(free, 1, -1))


def test_intermediate_fits_no_worse_than_basic():
    X, y = _monotone_data()
    mse = {}
    for method in ("basic", "intermediate"):
        bst = lgb_torch.train(dict(FAST, objective="regression",
                                   num_leaves=31,
                                   monotone_constraints=[1, -1, 0],
                                   monotone_constraints_method=method),
                              lgb_torch.Dataset(X, y), num_boost_round=30)
        mse[method] = float(np.mean((bst.predict(X) - y) ** 2))
    assert mse["intermediate"] <= mse["basic"] * 1.02, mse


def test_monotone_penalty_keeps_the_root_off_monotone_features():
    X, y = _monotone_data()
    bst = lgb_torch.train(dict(FAST, objective="regression", num_leaves=15,
                               monotone_constraints=[1, -1, 0],
                               monotone_penalty=2.0),
                          lgb_torch.Dataset(X, y), num_boost_round=5)
    assert bst._gbdt.models[0].split_feature[0] == 2
    assert _is_monotone(bst, 0, +1)


def _path_features(tree):
    out = []

    def walk(node, acc):
        if node < 0:
            out.append(acc)
            return
        acc = acc | {int(tree.split_feature[node])}
        walk(int(tree.left_child[node]), acc)
        walk(int(tree.right_child[node]), acc)

    if tree.num_leaves > 1:
        walk(0, set())
    return out


@pytest.mark.parametrize("learner", ["strict", "batched"])
def test_interaction_paths_stay_in_one_set(learner):
    rng = np.random.default_rng(31)
    X = rng.normal(size=(2000, 4))
    y = X[:, 0] * X[:, 1] + X[:, 2] * X[:, 3] + rng.normal(scale=0.1,
                                                           size=2000)
    params = dict(FAST, objective="regression", num_leaves=15,
                  interaction_constraints="[0,1],[2,3]")
    if learner == "batched":
        params.update(tpu_split_batch=4)
    bst = lgb_torch.train(params, lgb_torch.Dataset(X, y),
                          num_boost_round=10)
    sets = [{0, 1}, {2, 3}]
    for t in bst._gbdt.models:
        for path in _path_features(t):
            assert any(path <= s for s in sets), path


def test_extra_trees_and_bynode_fit_and_repeat():
    rng = np.random.default_rng(32)
    X = rng.normal(size=(2000, 8))
    y = X @ rng.normal(size=8) + rng.normal(scale=0.2, size=2000)
    params = dict(FAST, objective="regression", extra_trees=True,
                  feature_fraction_bynode=0.5)
    b1 = lgb_torch.train(params, lgb_torch.Dataset(X, y),
                         num_boost_round=20)
    assert np.corrcoef(b1.predict(X), y)[0, 1] > 0.9
    b2 = lgb_torch.train(params, lgb_torch.Dataset(X, y),
                         num_boost_round=20)
    assert b1.model_to_string() == b2.model_to_string()


def test_unknown_monotone_method_raises_in_both():
    X, y = _monotone_data(n=500)
    params = dict(objective="regression", verbosity=-1,
                  monotone_constraints=[1, 0, 0],
                  monotone_constraints_method="exact")
    with pytest.raises(lgb_jax.LightGBMError):
        lgb_jax.train(params, lgb_jax.Dataset(X, y), num_boost_round=1)
    with pytest.raises(lgb_torch.LightGBMError):
        lgb_torch.train(dict(params, device_type="cpu"),
                        lgb_torch.Dataset(X, y), num_boost_round=1)
