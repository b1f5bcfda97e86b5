"""The port's training slice against lightgbm_tpu on the CPU.

Both packages train on the same numpy data with the configuration of the
port's slice at a small size (n = 10,000, F = 8, num_leaves = 15,
max_bin = 63, 4 splits per round, exact int8 gradient levels, leaf
renewal, hist_kernel=onehot, 5 rounds); the sizes make rounds take both
the full masked pass and the compacted payload pass.

* regression: L2 gradients are exact subtractions, so the model text is
  byte-identical up to the ``parameters:`` block, where only the port's
  explicit ``device_type`` differs;
* binary: the sigmoid's exp may differ by an ulp between XLA and PyTorch
  on the CPU, which moves renewed leaf values by ~1e-7 relative; every
  tree's split features and bins are identical, leaf values agree to
  rtol 1e-5 and predictions to 1e-6.

The default configuration (``hist_kernel`` and ``stochastic_rounding``
unset: ``auto`` and true) is compared the same way at max_bin = 255
(radix kernels, warm-up ladder on) and 63 (packed kernel), with the auto
policy's values set explicitly since n is small, and the ladder's row
threshold lowered on both sides.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgb_jax
from lightgbm_tpu.boosting.gbdt import GBDT as JGBDT
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.learner import batch_grower as JBG
from lightgbm_tpu.learner.batch_grower import (
    grow_tree_batched as jax_grow_tree_batched)
from lightgbm_tpu.models.predict import predict_bins_tree as jax_predict_bins
from lightgbm_tpu.models.tree import Tree as JTree
from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu.ops.quantize import (
    discretize_gradients_levels as jax_discretize,
    renew_leaf_values as jax_renew)
from lightgbm_tpu.ops.split import SplitHyper as JSplitHyper
from lightgbm_tpu.ops.split import find_best_split as jax_find_best_split

import lightgbm_tpu_torch as lgb_torch
from lightgbm_tpu_torch.boosting.gbdt import GBDT as TGBDT
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.convert import (booster_from_model_string,
                                        tree_arrays_from_numpy)
from lightgbm_tpu_torch.learner import batch_grower as TBG
from lightgbm_tpu_torch.learner.batch_grower import grow_tree_batched
from lightgbm_tpu_torch.models.predict import predict_bins_tree
from lightgbm_tpu_torch.models.tree import Tree as TTree
from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops.quantize import (discretize_gradients_levels,
                                             leaf_sums_sorted,
                                             renew_leaf_values)
from lightgbm_tpu_torch.ops.split import SplitHyper, find_best_split

from test_torch_fused import one_torch_thread  # noqa: F401

SLICE = dict(num_leaves=15, max_bin=63, tpu_split_batch=4,
             use_quantized_grad=True, tpu_hist_dtype="int8",
             quant_train_renew_leaf=True, stochastic_rounding=False,
             hist_kernel="onehot", verbosity=-1)
ROUNDS = 5
#: the default recipe at a small size: hist_kernel and stochastic_rounding
#: unset, the auto policy's int8 levels and leaf renewal set explicitly;
#: 16 splits per round and 1024-row blocks (the compaction buckets round
#: to them) make rounds take every auto kernel
DEFAULT = dict(num_leaves=31, tpu_split_batch=16, use_quantized_grad=True,
               tpu_hist_dtype="int8", quant_train_renew_leaf=True,
               tpu_rows_per_block=1024, verbosity=-1)
#: the port's histogram wrappers the dispatch layer calls
WRAPPERS = ("histogram_leaves", "histogram_payload", "histogram_radix_single",
            "histogram_radix_joint", "histogram_leaves_radix2",
            "histogram_leaves_packed")


def _data(objective, n=10_000, f=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[rng.random((n, f)) < 0.05] = np.nan
    z = np.nansum(X[:, :3] * np.array([1.0, -0.7, 0.4]), axis=1)
    # a near-step target: the first split halves the rows, so the next
    # round's smaller children overflow the largest bucket (a full pass)
    y = 2.0 * np.tanh(3.0 * z) + 0.5 * rng.normal(size=n)
    if objective == "binary":
        y = (y > 0).astype(np.float64)
    return X, y


@pytest.fixture(scope="module", params=["regression", "binary"])
def trained(request):
    """Both packages trained on one objective; the port's histogram
    dispatch counts which branch each round took."""
    objective = request.param
    X, y = _data(objective)
    params = dict(SLICE, objective=objective)
    bj = lgb_jax.train(params, lgb_jax.Dataset(X, y),
                       num_boost_round=ROUNDS)
    calls = {"full": 0, "compacted": 0}
    full, comp = TH.histogram_leaves, TH.histogram_payload

    def count_full(*a, **k):
        calls["full"] += 1
        return full(*a, **k)

    def count_comp(*a, **k):
        calls["compacted"] += 1
        return comp(*a, **k)

    TH.histogram_leaves, TH.histogram_payload = count_full, count_comp
    try:
        bt = lgb_torch.train(dict(params, device_type="cpu"),
                             lgb_torch.Dataset(X, y), num_boost_round=ROUNDS)
    finally:
        TH.histogram_leaves, TH.histogram_payload = full, comp
    Xt = np.random.default_rng(9).normal(size=(2000, X.shape[1]))
    Xt[::11, 2] = np.nan
    return objective, bj, bt, calls, Xt


def test_slice_runs_both_histogram_branches(trained):
    _, _, _, calls, _ = trained
    # the root pass and full masked rounds, and compacted rounds
    assert calls["full"] > ROUNDS and calls["compacted"] > 0


def test_slice_model_matches_jax(trained):
    objective, bj, bt, _, Xt = trained
    _assert_models_match(objective, bj, bt, Xt)


def _assert_models_match(objective, bj, bt, Xt):
    s_j, s_t = bj.model_to_string(), bt.model_to_string()
    head_j, params_j = s_j.split("parameters:")
    head_t, params_t = s_t.split("parameters:")
    lines_t = params_t.splitlines()
    assert "[device_type: cpu]" in lines_t
    lines_t.remove("[device_type: cpu]")
    assert lines_t == params_j.splitlines()
    if objective == "regression":
        assert head_t == head_j
        np.testing.assert_array_equal(bt.predict(Xt), bj.predict(Xt))
        return
    assert len(bt._gbdt.models) == len(bj._gbdt.models) == ROUNDS
    for tt, tj in zip(bt._gbdt.models, bj._gbdt.models):
        assert tt.num_leaves == tj.num_leaves
        np.testing.assert_array_equal(tt.split_feature, tj.split_feature)
        np.testing.assert_array_equal(tt.threshold_bin, tj.threshold_bin)
        np.testing.assert_array_equal(tt.decision_type, tj.decision_type)
        np.testing.assert_allclose(tt.leaf_value, tj.leaf_value, rtol=1e-5)
    np.testing.assert_allclose(bt.predict(Xt), bj.predict(Xt), atol=1e-6)


@pytest.fixture(scope="module",
                params=[("regression", 255), ("binary", 255),
                        ("regression", 63), ("binary", 63)],
                ids=lambda p: f"{p[0]}-{p[1]}bins")
def trained_default(request):
    """Both packages trained on the default recipe; the port's wrapper
    calls counted by name."""
    objective, max_bin = request.param
    X, y = _data(objective)
    params = dict(DEFAULT, objective=objective, max_bin=max_bin)
    mp = pytest.MonkeyPatch()
    calls = dict.fromkeys(WRAPPERS, 0)
    try:
        mp.setattr(JBG, "_WARMUP_MIN_ROWS", 1024)
        mp.setattr(TBG, "_WARMUP_MIN_ROWS", 1024)
        bj = lgb_jax.train(params, lgb_jax.Dataset(X, y),
                           num_boost_round=ROUNDS)
        for name in WRAPPERS:
            def spy(*a, _real=getattr(TH, name), _name=name, **k):
                calls[_name] += 1
                return _real(*a, **k)
            mp.setattr(TH, name, spy)
        bt = lgb_torch.train(dict(params, device_type="cpu"),
                             lgb_torch.Dataset(X, y), num_boost_round=ROUNDS)
    finally:
        mp.undo()
    Xt = np.random.default_rng(9).normal(size=(2000, X.shape[1]))
    Xt[::11, 2] = np.nan
    return objective, max_bin, bj, bt, calls, Xt


def test_default_slice_runs_the_auto_kernels(trained_default):
    _, max_bin, _, bt, calls, _ = trained_default
    assert bt._gbdt.hp.hist_kernel == "auto"
    assert bt._gbdt.config.stochastic_rounding is True
    if max_bin == 255:
        # root, ladder widths 1 and 4, full K = 16 passes, compacted rounds
        for name in ("histogram_radix_single", "histogram_radix_joint",
                     "histogram_leaves_radix2", "histogram_payload"):
            assert calls[name] > 0, (name, calls)
        assert calls["histogram_radix_single"] == ROUNDS
        assert calls["histogram_leaves_packed"] == 0
    else:
        assert calls["histogram_leaves_packed"] > ROUNDS, calls
        assert calls["histogram_radix_single"] == 0
        assert calls["histogram_radix_joint"] == 0
    assert calls["histogram_leaves"] == 0


def test_default_slice_model_matches_jax(trained_default):
    objective, _, bj, bt, _, Xt = trained_default
    _assert_models_match(objective, bj, bt, Xt)


def test_resolve_auto_params_matches_jax():
    """The port's copy of the auto policy gives the JAX package's values at
    >= 100k rows, whatever the user set explicitly."""
    fields = ("tpu_split_batch", "tpu_hist_dtype", "use_quantized_grad",
              "quant_train_renew_leaf")
    for n in (99_999, 100_000, 1_000_000):
        for extra in ({}, {"num_leaves": 255}, {"num_leaves": 7},
                      {"tpu_split_batch": 8}, {"deterministic": True},
                      {"tpu_hist_dtype": "float32"},
                      {"use_quantized_grad": False},
                      {"quant_train_renew_leaf": False},
                      {"linear_tree": True}):
            cj, ct = JConfig(dict(extra)), TConfig(dict(extra))
            ts = types.SimpleNamespace(num_data=n)
            JGBDT._resolve_auto_params(
                types.SimpleNamespace(train_set=ts, parallel_mode=None), cj)
            TGBDT._resolve_auto_params(types.SimpleNamespace(train_set=ts),
                                       ct)
            for f in fields:
                assert getattr(ct, f) == getattr(cj, f), (n, extra, f)


def test_leaf_sums_sorted_match_scatter():
    """The card's fixed-order leaf sums equal the scatter-add's up to the
    order of the terms."""
    rng = np.random.default_rng(3)
    n, L = 20_000, 31
    lor = torch.as_tensor(rng.integers(0, L - 3, size=n))   # empty leaves
    g = torch.as_tensor(rng.normal(size=n).astype(np.float32))
    h = torch.as_tensor(rng.uniform(0.1, 0.3, size=n).astype(np.float32))
    gs, hs = leaf_sums_sorted(lor, g, h, L)
    want_g = torch.zeros(L).index_add_(0, lor, g)
    want_h = torch.zeros(L).index_add_(0, lor, h)
    np.testing.assert_allclose(gs.numpy(), want_g.numpy(), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(hs.numpy(), want_h.numpy(), rtol=1e-5)
    assert (gs[L - 3:] == 0).all() and (hs[L - 3:] == 0).all()
    again = leaf_sums_sorted(lor, g, h, L)
    assert torch.equal(again[0], gs) and torch.equal(again[1], hs)


def test_jax_model_text_loads_and_predicts(trained):
    objective, bj, _, _, Xt = trained
    loaded = booster_from_model_string(bj.model_to_string())
    np.testing.assert_array_equal(loaded.predict(Xt, raw_score=True),
                                  bj.predict(Xt, raw_score=True))
    want = bj.predict(Xt)
    np.testing.assert_allclose(loaded.predict(Xt), want,
                               atol=1e-6 if objective == "binary" else 0)


def _grower_inputs(seed=0, n=6000, f=7, n_bins=64):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, n_bins - 1, size=(n, f)).astype(np.uint8)
    nan_bin = np.where(np.arange(f) % 3 == 0, n_bins - 2, -1).astype(np.int32)
    num_bins = np.full(f, n_bins - 1, np.int32)
    # a signal on features 0 and 1 so trees grow deep
    g = (bins[:, 0].astype(np.float32) / n_bins - 0.5) \
        + 0.3 * (bins[:, 1] > 30) + 0.2 * rng.normal(size=n)
    h = np.ones(n, np.float32)
    return bins, g.astype(np.float32), h, num_bins, nan_bin


@pytest.mark.parametrize("batch", [4, 8])
def test_grower_matches_jax(batch):
    bins, g, h, num_bins, nan_bin = _grower_inputs()
    gq, hq, gs, hs = jax_discretize(jnp.asarray(g), jnp.asarray(h),
                                    jax.random.PRNGKey(0), n_levels=4,
                                    stochastic=False, constant_hessian=True)
    fields = dict(num_leaves=31, min_data_in_leaf=5, n_bins=64,
                  hist_dtype="int8", hist_kernel="onehot", lambda_l2=1.0,
                  rows_per_block=1024)
    jarr, jlor = jax_grow_tree_batched(
        jnp.asarray(bins), gq, hq, None, jnp.asarray(num_bins),
        jnp.asarray(nan_bin), jnp.zeros(bins.shape[1], bool), None,
        JSplitHyper(**fields), batch=batch,
        hist_scale=jnp.stack([gs, hs]))
    tarr, tlor = grow_tree_batched(
        torch.as_tensor(bins), torch.as_tensor(np.array(gq)),
        torch.as_tensor(np.array(hq)), None, torch.as_tensor(num_bins),
        torch.as_tensor(nan_bin), None, SplitHyper(**fields), batch=batch,
        hist_scale=torch.as_tensor(np.array(jnp.stack([gs, hs]))))
    assert int(tarr.num_leaves) == int(jarr.num_leaves) == 31
    np.testing.assert_array_equal(tlor.numpy(), np.asarray(jlor))
    for name in tarr._fields:
        np.testing.assert_array_equal(getattr(tarr, name).numpy(),
                                      np.asarray(getattr(jarr, name)),
                                      err_msg=name)


def test_tree_arrays_from_numpy_feeds_identical_state():
    bins, g, h, num_bins, nan_bin = _grower_inputs(seed=4)
    hp = JSplitHyper(num_leaves=15, min_data_in_leaf=5, n_bins=64,
                     hist_kernel="onehot")
    jarr, _ = jax_grow_tree_batched(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), None,
        jnp.asarray(num_bins), jnp.asarray(nan_bin),
        jnp.zeros(bins.shape[1], bool), None, hp, batch=4)
    host = {k: np.asarray(v) for k, v in
            jax.device_get(jarr)._asdict().items()}
    tarr = tree_arrays_from_numpy(host)
    np.testing.assert_array_equal(
        predict_bins_tree(tarr, torch.as_tensor(bins),
                          torch.as_tensor(nan_bin)).numpy(),
        np.asarray(jax_predict_bins(jarr, jnp.asarray(bins),
                                    jnp.asarray(nan_bin), None, False)))
    X = np.random.default_rng(4).normal(size=(500, 7))
    X[::13, 0] = np.nan
    jds = lgb_jax.Dataset(X, np.zeros(500)).construct().inner
    tds = lgb_torch.Dataset(X, np.zeros(500)).construct().inner
    assert TTree.from_arrays(tarr, tds).to_text(0) == \
        JTree.from_arrays(jarr, jds).to_text(0)


@pytest.mark.parametrize("cnt_rows", ["compacted", "full"])
def test_histogram_for_leaves_auto_matches_jax(cnt_rows):
    rng = np.random.default_rng(6)
    n, f = 8192, 9
    bins = rng.integers(0, 63, size=(n, f)).astype(np.uint8)
    hi = 40 if cnt_rows == "compacted" else 6    # few rows vs most rows
    lor = rng.integers(0, hi, size=n).astype(np.int32)
    leaves = np.array([1, 3, 5, 3], np.int32)
    g = rng.integers(-2, 3, size=n).astype(np.float32)
    h = rng.integers(0, 5, size=n).astype(np.float32)
    kw = dict(n_bins=64, rows_per_block=2048, hist_dtype="float32",
              hist_kernel="onehot")
    want = JH.histogram_for_leaves_auto(
        jnp.asarray(bins), jnp.asarray(bins.T), jnp.asarray(g),
        jnp.asarray(h), jnp.asarray(lor), jnp.asarray(leaves), **kw)
    got = TH.histogram_for_leaves_auto(
        torch.as_tensor(bins.T.copy()), torch.as_tensor(g),
        torch.as_tensor(h), torch.as_tensor(lor), torch.as_tensor(leaves),
        **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_find_best_split_matches_jax():
    rng = np.random.default_rng(7)
    M, f, B = 6, 5, 32
    hist = np.zeros((M, f, B, 4), np.float32)
    hist[..., 0] = rng.integers(-20, 21, size=(M, f, B)) * 0.125
    hist[..., 1] = rng.integers(0, 30, size=(M, f, B)) * 0.25
    hist[..., 2] = rng.integers(0, 30, size=(M, f, B))
    sums = hist.sum(axis=2)[:, 0, :]                     # [M, 4]
    num_bins = np.array([32, 20, 31, 8, 32], np.int32)
    nan_bin = np.array([31, -1, 30, -1, -1], np.int32)
    hist[:, 1, 20:] = 0                                  # past num_bins
    hist[:, 3, 8:] = 0
    sums = hist[:, 1].sum(axis=1)
    hist[:, :, 0, :3] += (sums[:, None, :3] - hist[..., :3].sum(axis=2))
    fields = dict(min_data_in_leaf=3, min_sum_hessian_in_leaf=1.0,
                  lambda_l1=0.5, lambda_l2=2.0, n_bins=B)
    fm = np.array([True, True, True, False, True])
    got = find_best_split(torch.as_tensor(hist), torch.as_tensor(sums[:, 0]),
                          torch.as_tensor(sums[:, 1]),
                          torch.as_tensor(sums[:, 2]),
                          torch.as_tensor(num_bins),
                          torch.as_tensor(nan_bin),
                          torch.zeros(f, dtype=torch.bool),
                          torch.as_tensor(fm), SplitHyper(**fields))
    hp_j = JSplitHyper(**fields)
    for m in range(M):
        w = jax_find_best_split(
            jnp.asarray(hist[m]), jnp.float32(sums[m, 0]),
            jnp.float32(sums[m, 1]), jnp.float32(sums[m, 2]),
            jnp.asarray(num_bins), jnp.asarray(nan_bin),
            jnp.zeros(f, bool), jnp.asarray(fm), hp_j)
        for name in ("gain", "feature", "threshold", "default_left",
                     "left_sum_g", "left_sum_h", "left_count"):
            assert getattr(got, name)[m].item() == \
                np.asarray(getattr(w, name)).item(), (m, name)


def test_quantize_and_renew_match_jax():
    rng = np.random.default_rng(8)
    n, L = 5000, 7
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.05, 0.25, size=n).astype(np.float32)
    lor = rng.integers(0, L, size=n).astype(np.int32)
    for const in (False, True):
        want = jax_discretize(jnp.asarray(g), jnp.asarray(h),
                              jax.random.PRNGKey(0), n_levels=4,
                              stochastic=False, constant_hessian=const)
        got = discretize_gradients_levels(
            torch.as_tensor(g), torch.as_tensor(h), n_levels=4,
            stochastic=False, constant_hessian=const)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = jax_renew(jnp.asarray(lor), jnp.asarray(g), jnp.asarray(h), None,
                     num_leaves=L, lambda_l1=0.1, lambda_l2=1.0)
    got = renew_leaf_values(torch.as_tensor(lor), torch.as_tensor(g),
                            torch.as_tensor(h), None, num_leaves=L,
                            lambda_l1=0.1, lambda_l2=1.0)
    # the per-leaf sums scatter in the same order (bitwise), but XLA's CPU
    # f32 division is not always correctly rounded where PyTorch's is: the
    # quotients may differ by 1 ulp
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2.5e-7,
                               atol=0)


def test_unported_configurations_raise():
    X, y = _data("regression", n=2000)
    # nan_policy trains (tests/test_torch_custom.py);
    # checkpoints and the distributed learners are still refused
    for extra in ({"checkpoint_dir": "ckpt"}, {"tree_learner": "data"},
                  {"tree_learner": "voting"}):
        params = dict(SLICE, objective="regression", device_type="cpu")
        params.update(extra)
        with pytest.raises(lgb_torch.LightGBMError):
            lgb_torch.train(params, lgb_torch.Dataset(X, y),
                            num_boost_round=1)


def test_dataclass_fields_mirror_jax():
    assert [f.name for f in dataclasses.fields(SplitHyper)] == \
        [f.name for f in dataclasses.fields(JSplitHyper)]
