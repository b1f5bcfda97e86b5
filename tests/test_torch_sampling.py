"""Row sampling and the other boosting modes of the port on the CPU.

The port's ``boosting/sample_strategy.py``, ``rf.py`` and ``dart.py``
against the JAX package's, on inputs made from seeded numpy:

* bagging masks (plain, pos/neg, the empty-mask rescue) and GOSS's (mask,
  grad, hess) bit for bit against the JAX strategies at several
  iterations, classic and captured forms, GOSS with tied scores (a
  constant |grad|, signed zeros), its warm-up and ``other_rate=0``; the
  by-query mask against the JAX package's host draw;
* the masked histogram entry points and leaf renewal with a bag that is
  not all ones, bitwise on integer levels;
* model text against the JAX package's ``train()`` (which takes its fused
  loop where the port does) for bagging, GOSS, pos/neg and by-query
  bagging, RF and DART, in the batched grower (int8 levels) and the strict
  one (float32), also on EFB-bundled and categorical data: regression on
  int8 levels byte for byte; binary (the sigmoid's ulp) and the strict
  float32 learner with every split equal and leaf values within rtol 1e-5
  plus atol 5e-5; the batched configurations' fused text equal to the
  classic loop's;
* at most one host read a fused round under bagging and under GOSS;
* RF's evaluations and early stopping under ``tpu_device_eval`` true and
  false, and DART's scores tracking ``predict`` with a large bias.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lgb_jax
from lightgbm_tpu.boosting import sample_strategy as JS
from lightgbm_tpu.boosting.gbdt import GBDT as JGBDT
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Metadata as JMetadata
from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu.ops.quantize import renew_leaf_values as jax_renew

import lightgbm_tpu_torch as lgb_torch
from lightgbm_tpu_torch.boosting import sample_strategy as TS
from lightgbm_tpu_torch.boosting.dart import DART
from lightgbm_tpu_torch.boosting.rf import RF
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops import round_fuse as TRF
from lightgbm_tpu_torch.ops.quantize import renew_leaf_values

from test_torch_fused import (  # noqa: F401
    _data, _ladder_on_small_data, _train_port, fused_host_reads,
    one_torch_thread)

#: the default recipe at a small size (test_torch_fused.py's)
DEFAULT = dict(num_leaves=31, tpu_split_batch=16, use_quantized_grad=True,
               tpu_hist_dtype="int8", quant_train_renew_leaf=True,
               tpu_rows_per_block=1024, max_bin=255, verbosity=-1)
#: the strict learner (float32 histograms)
STRICT = dict(num_leaves=15, max_bin=63, verbosity=-1)


def _head(bst) -> str:
    return bst.model_to_string().split("parameters:")[0]


def _strategies(params, n, label=None, group=None):
    jm, tm = JMetadata(n), TMetadata(n)
    for m in (jm, tm):
        if label is not None:
            m.set_label(label)
        if group is not None:
            m.set_group(group)
    return (JS.create_sample_strategy(JConfig(params), n), jm,
            TS.create_sample_strategy(TConfig(params), n), tm)


# ------------------------------------------------------------------ masks

BAGGING = {
    "fraction-freq5": dict(bagging_fraction=0.8, bagging_freq=5),
    "fraction-seed": dict(bagging_fraction=0.5, bagging_freq=1,
                          bagging_seed=7),
    "pos-neg": dict(pos_bagging_fraction=0.5, neg_bagging_fraction=0.2,
                    bagging_freq=2),
    "empty-rescue": dict(bagging_fraction=1e-7, bagging_freq=1),
}


@pytest.mark.parametrize("case", sorted(BAGGING))
def test_bagging_masks_match_jax(case):
    """Classic and captured masks equal the JAX package's, bit for bit."""
    n = 5000
    rng = np.random.default_rng(0)
    label = (rng.random(n) < 0.3).astype(np.float32)
    js, jm, ts, tm = _strategies(BAGGING[case], n, label)
    g = rng.normal(size=(n, 1)).astype(np.float32)
    h = np.ones((n, 1), np.float32)
    fn = ts.device_sample_fn(tm, "cpu")
    jfn = js.device_sample_fn(jm)
    for it in (0, 1, 4, 5, 11):
        want = np.asarray(js.sample(it, jnp.asarray(g), jnp.asarray(h),
                                    None, jm)[0])
        got = ts.sample(it, torch.as_tensor(g), torch.as_tensor(h), tm)[0]
        np.testing.assert_array_equal(got.numpy(), want)
        k0, k1, active = ts.round_words(it)
        dev = fn(torch.tensor(k0), torch.tensor(k1), torch.tensor(
            bool(active)), torch.as_tensor(g), torch.as_tensor(h))[0]
        np.testing.assert_array_equal(dev.numpy(), np.asarray(
            jfn(jnp.int32(it), jnp.asarray(g), jnp.asarray(h))[0]))
    if case == "empty-rescue":
        assert got.sum() == 1 and bool(got[0])
    if case == "pos-neg":
        frac = [got.numpy()[label == v].mean() for v in (1.0, 0.0)]
        assert abs(frac[0] - 0.5) < 0.05 and abs(frac[1] - 0.2) < 0.05


def test_by_query_mask_matches_jax():
    """The host draw over query boundaries, resampled every freq
    iterations, equals the JAX package's; it has no captured form."""
    n = 3000
    rng = np.random.default_rng(1)
    group = np.full(60, n // 60)
    params = dict(bagging_fraction=0.5, bagging_freq=2, bagging_by_query=True)
    js, jm, ts, tm = _strategies(params, n, group=group)
    assert ts.device_sample_fn(tm, "cpu") is None
    assert js.device_sample_fn(jm) is None
    g = jnp.zeros((n, 1))
    for it in range(6):
        want = np.asarray(js.sample(it, g, g, None, jm)[0])
        got = ts.sample(it, torch.zeros(n, 1), torch.zeros(n, 1), tm)[0]
        np.testing.assert_array_equal(got.numpy(), want)
        # whole queries in or out
        assert all(len(set(want[s:s + n // 60])) == 1
                   for s in range(0, n, n // 60))


GOSS = {
    "default": dict(data_sample_strategy="goss", learning_rate=0.1,
                    num_iterations=20),
    "other-rate-0": dict(data_sample_strategy="goss", other_rate=0.0,
                         learning_rate=0.5, num_iterations=20),
    "rates": dict(data_sample_strategy="goss", top_rate=0.3,
                  other_rate=0.35, learning_rate=0.5, num_iterations=20),
}


@pytest.mark.parametrize("ties", [False, True], ids=["real", "ties"])
@pytest.mark.parametrize("case", sorted(GOSS))
def test_goss_matches_jax(case, ties):
    """(mask, grad, hess) bit for bit, warm-up included; ``ties``: a
    constant |grad| with +0.0 and -0.0 rows, where only an exact stable
    top-k agrees."""
    n = 5000
    rng = np.random.default_rng(2)
    js, jm, ts, tm = _strategies(GOSS[case], n)
    fn = ts.device_sample_fn(tm, "cpu")
    jfn = js.device_sample_fn(jm)
    warm = ts._warmup_iters()
    assert warm == js._warmup_iters()
    for it in (0, warm - 1, warm, warm + 3):
        g = rng.normal(size=(n, 1)).astype(np.float32)
        h = rng.random((n, 1)).astype(np.float32)
        if ties:
            g = np.sign(g).astype(np.float32)
            g[:10], g[10:20] = 0.0, -0.0
            h[:] = 1.0
        want = js.sample(it, jnp.asarray(g), jnp.asarray(h), None, jm)
        got = ts.sample(it, torch.as_tensor(g), torch.as_tensor(h), tm)
        if it < warm:
            assert want[0] is None and got[0] is None
        else:
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        k0, k1, active = ts.round_words(it)
        assert active == int(it >= warm)
        dev = fn(torch.tensor(k0), torch.tensor(k1),
                 torch.tensor(bool(active)), torch.as_tensor(g),
                 torch.as_tensor(h))
        jdev = jfn(jnp.int32(it), jnp.asarray(g), jnp.asarray(h))
        for a, b in zip(dev, jdev):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_goss_rates_over_one_are_fatal():
    with pytest.raises(lgb_torch.LightGBMError):
        TS.create_sample_strategy(TConfig(dict(
            data_sample_strategy="goss", top_rate=0.6, other_rate=0.5)), 10)


# ------------------------------------------- masked passes, leaf renewal

@pytest.mark.parametrize("frac", [0.6, 0.05])
def test_masked_entry_points_match_jax(frac):
    """Each histogram entry point the growers call with a bag equals the
    JAX package's with the same bag, bitwise on integer levels: the K-leaf
    pass (the device bucket dispatch fed the fused partition's masked key
    and payload; ``frac`` of the rows in the K leaves: the full pass, a
    compacted bucket), the single-leaf masked and bucketed passes and the
    root."""
    n, K, n_bins = 16_384, 4, 64
    rng = np.random.default_rng(3)
    bins_t = torch.as_tensor(rng.integers(0, n_bins, (6, n), dtype=np.uint8))
    grad = torch.as_tensor(rng.integers(-8, 9, n).astype(np.float32))
    hess = torch.as_tensor(rng.integers(0, 9, n).astype(np.float32))
    mask = torch.as_tensor(rng.random(n) < 0.8)
    lor = torch.as_tensor(np.where(rng.random(n) < frac,
                                   rng.integers(0, K, n),
                                   rng.integers(K, 2 * K, n)).astype(np.int32))
    leaves = torch.arange(K, dtype=torch.int32)
    counts = torch.stack([((lor == k) & mask).sum() for k in range(K)]) \
        .float()
    mi = mask.to(torch.int32)
    _, key, payload = TRF.partition_payload(
        bins_t, TH.bins_to_words(bins_t.t()), grad, hess, lor, mi, leaves,
        torch.zeros_like(leaves), torch.zeros_like(leaves),
        torch.full_like(leaves, -1), leaves, leaves + 2 * K,
        torch.zeros_like(leaves), leaves)
    j = {k: jnp.asarray(v.numpy()) for k, v in dict(
        bins_t=bins_t, grad=grad, hess=hess, lor=lor, mask=mask,
        leaves=leaves, counts=counts).items()}
    bins_rows = jnp.asarray(bins_t.t().numpy())
    kw = dict(n_bins=n_bins, hist_dtype="int8", hist_kernel="onehot")
    got = TH.histogram_for_leaves_auto(
        bins_t, grad, hess, lor, leaves, mask, counts=counts, sort_key=key,
        payload=payload, rows_per_block=1024, **kw)
    want = JH.histogram_for_leaves_auto(
        bins_rows, j["bins_t"], j["grad"], j["hess"], j["lor"], j["leaves"],
        j["mask"], counts=j["counts"], rows_per_block=1024, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the bag's rows only: the count channel sums to the bagged counts
    np.testing.assert_array_equal(got[:, 0, :, 2].sum(1).numpy(),
                                  counts.numpy())
    one = dict(n_bins=n_bins, hist_dtype="float32")
    for hk in ("onehot", "auto"):
        np.testing.assert_array_equal(
            TH.histogram_for_leaf_masked(bins_t, grad, hess, lor, 1, mask,
                                         hist_kernel=hk, **one).numpy(),
            np.asarray(JH.histogram_for_leaf_masked(
                j["bins_t"], j["grad"], j["hess"], j["lor"], jnp.int32(1),
                j["mask"], hist_kernel=hk, **one)))
        np.testing.assert_array_equal(
            TH.root_histogram(bins_t, grad, hess, mask, hist_kernel=hk,
                              **one).numpy(),
            np.asarray(JH.root_histogram(j["bins_t"], j["grad"], j["hess"],
                                         j["mask"], hist_kernel=hk, **one)))
    cnt1 = int(((lor == 1) & mask).sum())
    np.testing.assert_array_equal(
        TH.histogram_for_leaf_bucketed(bins_t, grad, hess, lor, 1, cnt1,
                                       mask, **one).numpy(),
        np.asarray(JH.histogram_for_leaf_bucketed(
            bins_rows, j["grad"], j["hess"], j["lor"], jnp.int32(1),
            jnp.int32(cnt1), j["mask"], **one)))


def test_renew_leaf_values_with_a_mask_matches_jax():
    """Out-of-bag rows keep out of the sums (each leaf's sums bitwise; the
    quotients within 1 ulp, XLA's CPU division)."""
    rng = np.random.default_rng(5)
    n, L = 20_000, 15
    lor = rng.integers(0, L, n).astype(np.int32)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.random(n).astype(np.float32)
    m = rng.random(n) < 0.7
    want = jax_renew(jnp.asarray(lor), jnp.asarray(g), jnp.asarray(h),
                     jnp.asarray(m), num_leaves=L, lambda_l1=0.1,
                     lambda_l2=1.0)
    got = renew_leaf_values(torch.as_tensor(lor), torch.as_tensor(g),
                            torch.as_tensor(h), torch.as_tensor(m),
                            num_leaves=L, lambda_l1=0.1, lambda_l2=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2.5e-7,
                               atol=0)
    unmasked = renew_leaf_values(torch.as_tensor(lor), torch.as_tensor(g),
                                 torch.as_tensor(h), None, num_leaves=L,
                                 lambda_l1=0.1, lambda_l2=1.0)
    assert not torch.equal(got, unmasked)


# ------------------------------------------------------------ model text

def _onehot(n, seed=0):
    """Two dense columns plus two 8-level variables one-hot encoded (EFB
    bundles each block)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 8, (n, 2))
    blocks = [np.eye(8)[idx[:, b]] * rng.normal(1.5, 0.2, (n, 1))
              for b in range(2)]
    dense = rng.normal(size=(n, 2))
    X = np.concatenate(blocks + [dense], axis=1)
    y = (idx[:, 0] % 2) + 0.5 * (idx[:, 1] % 3) + dense[:, 0] \
        + 0.1 * rng.normal(size=n)
    return X, y


def _categorical(n, seed=0):
    """Three normal columns and integer-coded categorical columns of 3, 12
    and 40 levels (test_torch_categorical.py's probe, a real label)."""
    rng = np.random.default_rng(seed)
    X = np.zeros((n, 6))
    X[:, :3] = rng.normal(size=(n, 3))
    for j, levels in zip((3, 4, 5), (3, 12, 40)):
        X[:, j] = rng.integers(0, levels, n)
    effect = np.random.default_rng(100).normal(size=40)
    y = (X[:, 0] + effect[X[:, 5].astype(int)] + 0.5 * (X[:, 4] % 3)
         - 0.5 * X[:, 1] + 0.3 * rng.normal(size=n))
    return X, y


BAG = dict(bagging_fraction=0.7, bagging_freq=2)
#: (params, data, loop): "fused" configurations also train through the
#: classic loop, which must give the same text
MODES = {
    "bagging": (dict(DEFAULT, **BAG, objective="regression"), "numeric",
                "fused"),
    "goss": (dict(DEFAULT, data_sample_strategy="goss", learning_rate=0.5,
                  objective="regression"), "numeric", "fused"),
    "pos-neg": (dict(DEFAULT, pos_bagging_fraction=0.6,
                     neg_bagging_fraction=0.3, bagging_freq=1,
                     objective="binary"), "numeric", "fused"),
    "bagging-strict": (dict(STRICT, **BAG, objective="regression"),
                       "numeric", "classic"),
    "bagging-strict-bucketed": (dict(STRICT, **BAG, objective="regression",
                                     tpu_leaf_hist="bucketed"), "numeric",
                                "classic"),
    "goss-strict": (dict(STRICT, boosting="goss", learning_rate=0.5,
                         objective="binary"), "numeric", "classic"),
    "by-query": (dict(DEFAULT, bagging_fraction=0.5, bagging_freq=1,
                      bagging_by_query=True, objective="regression"),
                 "query", "classic"),
    "rf": (dict(DEFAULT, boosting="rf", bagging_fraction=0.8,
                bagging_freq=1, objective="regression"), "numeric",
           "classic"),
    "dart": (dict(DEFAULT, boosting="dart", drop_rate=0.3, skip_drop=0.2,
                  objective="regression"), "numeric", "classic"),
    "dart-strict": (dict(STRICT, boosting="dart", drop_rate=0.3,
                         skip_drop=0.2, objective="regression"), "numeric",
                    "classic"),
    "bagging-efb": (dict(DEFAULT, **BAG, objective="regression"), "onehot",
                    "fused"),
    "goss-categorical": (dict(DEFAULT, data_sample_strategy="goss",
                              learning_rate=0.5, objective="regression",
                              min_data_per_group=20, cat_smooth=5),
                         "categorical", "fused"),
}


def _mode_data(kind, n=4000):
    if kind == "onehot":
        return _onehot(n) + ({},)
    if kind == "categorical":
        X, y = _categorical(n)
        return X, y, dict(categorical_feature=[3, 4, 5])
    X, y = _data("regression", n=n)
    if kind == "query":
        return X, y, dict(group=np.full(40, n // 40))
    return X, y, {}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_modes_match_jax(mode, monkeypatch):
    """Model text equal to the JAX package's (exact on int8 regression,
    else every split equal, leaf values and counts close), through the
    loop the JAX package takes; fused text equal to classic text."""
    params, kind, loop = MODES[mode]
    X, y, ds_kw = _mode_data(kind)
    if params["objective"] == "binary":
        y = (y > np.median(y)).astype(np.float64)
    jcalls = []
    real = JGBDT.train_fused

    def spy(gb, *a, **k):
        jcalls.append(1)
        return real(gb, *a, **k)

    monkeypatch.setattr(JGBDT, "train_fused", spy)
    bj = lgb_jax.train(params, lgb_jax.Dataset(X, y, **ds_kw),
                       num_boost_round=5)
    monkeypatch.setattr(JGBDT, "train_fused", real)
    assert len(jcalls) == (loop == "fused")
    bt = _train_port_ds(params, X, y, ds_kw, monkeypatch,
                        classic=(loop == "classic"))
    g = bt._gbdt
    assert g._use_batched_grower() == ("tpu_split_batch" in params)
    assert type(g).__name__ == type(bj._gbdt).__name__
    if loop == "fused":
        classic = _train_port_ds(params, X, y, ds_kw, monkeypatch,
                                 classic=True)
        assert bt.model_to_string() == classic.model_to_string()
    if kind == "onehot":
        assert g.bundle is not None
    if kind == "categorical":
        assert g.hp.has_categorical
    assert all(t.num_leaves > 2 for t in g.models)
    exact = (params["objective"] == "regression"
             and g.hp.hist_dtype == "int8")
    if exact:
        assert _head(bt) == _head(bj)
        return
    for tt, tj in zip(g.models, bj._gbdt.models, strict=True):
        assert tt.num_leaves == tj.num_leaves
        np.testing.assert_array_equal(tt.split_feature, tj.split_feature)
        np.testing.assert_array_equal(tt.threshold_bin, tj.threshold_bin)
        np.testing.assert_array_equal(tt.leaf_count, tj.leaf_count)
        np.testing.assert_allclose(tt.leaf_value, tj.leaf_value, rtol=1e-5,
                                   atol=5e-5)


def _train_port_ds(params, X, y, ds_kw, monkeypatch, classic=False):
    """test_torch_fused.py's ``_train_port`` (5 rounds) with Dataset
    keywords (group, categorical_feature), as test_torch_categorical.py
    names its columns."""
    real = lgb_torch.Dataset

    def with_kw(*a, **k):
        return real(*a, **dict(ds_kw, **k))

    monkeypatch.setattr(lgb_torch, "Dataset", with_kw)
    return _train_port(params, X, y, 5, monkeypatch, classic=classic)


def test_sampling_loops_match_jax_gate():
    """Bagging and GOSS take the fused loop with a batched grower; by-query
    bagging, RF, DART and the strict learner the classic loop, as the JAX
    package decides."""
    X, y = _data("regression", n=2000)
    for mode, (params, kind, loop) in MODES.items():
        if kind in ("onehot", "categorical"):
            continue
        if params["objective"] == "binary":
            y = (y > 0).astype(np.float64)
        ds_kw = dict(group=np.full(20, 100)) if kind == "query" else {}
        bt = lgb_torch.Booster(params=dict(params, device_type="cpu"),
                               train_set=lgb_torch.Dataset(X, y, **ds_kw))
        bj = lgb_jax.Booster(params=params, train_set=lgb_jax.Dataset(
            X, y, params=params, **ds_kw))
        assert bt._gbdt.supports_fused() == bj._gbdt.supports_fused() \
            == (loop == "fused"), mode


@pytest.mark.parametrize("mode", ["bagging", "goss"])
def test_fused_sampling_reads_the_host_at_most_once(mode, monkeypatch):
    """The draw runs inside the round: nothing in the bodies reads the
    device, and one flag word a round comes back."""
    extra = dict(bagging_fraction=0.8, bagging_freq=2) if mode == "bagging" \
        else dict(data_sample_strategy="goss", learning_rate=0.5)
    params = dict(DEFAULT, objective="binary", device_type="cpu",
                  metric="auc", **extra)
    # 20,000 rows: the budget grows every tree (6,000 bagged rows need
    # one-round extra replays, each its own flag read)
    X, y = _data(n=20_000)
    Xv, yv = _data(n=1500, seed=3)
    reads, rounds, extra_r = fused_host_reads(monkeypatch, params, X, y, Xv,
                                              yv, 5)
    assert rounds == 5 and extra_r == 0
    assert reads["body"] == 0
    assert reads["step"] <= rounds


# ------------------------------------------------------------ RF and DART

@pytest.mark.parametrize("device_eval", [True, False],
                         ids=["device-eval", "host-eval"])
def test_rf_evaluations_match_jax(device_eval):
    """RF's recorded evaluations, best iteration and best score equal the
    JAX package's: device metrics read the raw sum / T scores, host
    metrics ``_host_scores``' running average (as in the JAX package)."""
    X, y = _data("regression", n=4000)
    Xv, yv = _data("regression", n=1500, seed=3)
    params = dict(DEFAULT, boosting="rf", bagging_fraction=0.8,
                  bagging_freq=1, objective="regression", metric="l2",
                  tpu_device_eval=device_eval)
    res = {}
    for name, lgb, extra in (("jax", lgb_jax, {}),
                             ("port", lgb_torch, {"device_type": "cpu"})):
        rec = {}
        ds = lgb.Dataset(X, y)
        vs = ds.create_valid(Xv, yv)
        b = lgb.train(dict(params, **extra), ds, num_boost_round=8,
                      valid_sets=[vs], valid_names=["v"],
                      callbacks=[lgb.early_stopping(2, verbose=False),
                                 lgb.record_evaluation(rec)])
        res[name] = (b, rec["v"]["l2"])
    (bj, ej), (bt, et) = res["jax"], res["port"]
    assert isinstance(bt._gbdt, RF)
    np.testing.assert_allclose(et, ej, rtol=1e-6)
    assert bt.best_iteration == bj.best_iteration
    np.testing.assert_allclose(bt.best_score["v"]["l2"],
                               bj.best_score["v"]["l2"], rtol=1e-6)
    # the host metric sees the average over the trees so far, the device
    # metric the partial sum
    avg = bt._gbdt._host_scores(bt._gbdt.valid_scores[0])
    mse = float(np.mean((avg - yv) ** 2))
    t = bt._gbdt.iter_
    if device_eval:
        assert t == bt._gbdt.config.num_iterations or mse != et[-1]
    else:
        np.testing.assert_allclose(et[t - 1], mse, rtol=1e-6)


def test_dart_scores_track_predict():
    """DART with a large boost-from-average bias: the train scores equal
    predict after drops rescale the first tree (the JAX package's
    test_boosting_modes.py::test_dart_bias_preserved)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(800, 4))
    y = 100.0 + X[:, 0] * 2 + rng.normal(scale=0.2, size=800)
    params = dict(num_leaves=7, min_data_in_leaf=5, verbosity=-1,
                  objective="regression", boosting="dart", drop_rate=0.5,
                  skip_drop=0.0, device_type="cpu")
    bst = lgb_torch.train(params, lgb_torch.Dataset(X, y),
                          num_boost_round=8)
    g = bst._gbdt
    assert isinstance(g, DART)
    assert any(t.shrinkage != pytest.approx(0.1) for t in g.models)
    p = bst.predict(X)
    np.testing.assert_allclose(p, g._host_scores(g.scores), atol=1e-3)
    assert np.mean((p - y) ** 2) < np.var(y)
