"""The port's prediction surface against lightgbm_tpu's on the CPU.

* external binning (``bin_external`` / ``bin_external_pred``) on the same
  mappers: NaN rows, unseen categories, negative codes, a bundle plan;
* the stacked forest operands (``_forest_arrays`` of the regression slice,
  whose model text both packages write byte for byte; the bitset forest of
  JAX-trained categorical and linear models through ``forest_from_numpy``);
* the forest predictors' plain versions against the JAX package's jitted
  functions on the same operands and bins (values: tolerance rtol 2e-5 /
  atol 2e-6, whether they were bitwise is recorded; leaves exact), and the
  kernel's table layout (``pack_forest``) walked row by row in Python;
* ``GBDT.predict_raw`` above a patched ``DEVICE_PREDICT_MIN_WORK`` (row
  blocks, tail padding with ``predict_bucketing`` on and off), and
  ``Booster.predict`` with ``pred_leaf``, ``pred_early_stop`` and
  iteration ranges, trained and loaded;
* ``pred_contrib`` (TreeSHAP): the float64 host path bitwise, the float32
  device path (plain PyTorch on the CPU) against the JAX package's jitted
  float32 program at rtol 1e-5 / atol 1e-6, additivity, the SHAP kernel's
  edge and column tables, and the refusals (no card, a linear model on
  the card).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lgb_jax
from lightgbm_tpu.boosting.gbdt import GBDT as JGBDT
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models import predict as JP
from lightgbm_tpu.models import shap as JS

import lightgbm_tpu_torch as lgb_torch
from lightgbm_tpu_torch.boosting.gbdt import GBDT as TGBDT
from lightgbm_tpu_torch.boosting.gbdt import forest_bitset_arrays
from lightgbm_tpu_torch.io.dataset import Dataset as TDataset
from lightgbm_tpu_torch.models import predict as TP
from lightgbm_tpu_torch.models import shap as TS
from lightgbm_tpu_torch.models.tree import Tree as TTree
from lightgbm_tpu_torch.ops import forest_kernels as FK
from lightgbm_tpu_torch.ops import shap_kernels as SK
from lightgbm_tpu_torch.utils.log import LightGBMError

from test_torch_fused import one_torch_thread  # noqa: F401

#: the port's regression slice (tests/test_torch_train.py): both packages
#: write the same model text
SLICE = dict(objective="regression", num_leaves=15, max_bin=63,
             tpu_split_batch=4, use_quantized_grad=True,
             tpu_hist_dtype="int8", quant_train_renew_leaf=True,
             stochastic_rounding=False, hist_kernel="onehot", verbosity=-1)
#: JAX-only models: small, fast
SMALL = dict(num_leaves=15, min_data_in_leaf=5, verbosity=-1)
RTOL, ATOL = 2e-5, 2e-6
CPU = torch.device("cpu")


def _reg_data(n=10_000, f=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[rng.random((n, f)) < 0.05] = np.nan
    z = np.nansum(X[:, :3] * np.array([1.0, -0.7, 0.4]), axis=1)
    y = 2.0 * np.tanh(3.0 * z) + 0.5 * rng.normal(size=n)
    return X, y


def _cat_data(n=3000, seed=2):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.normal(size=(n, 4)),
                        rng.integers(0, 9, size=(n, 1)).astype(float),
                        rng.integers(0, 5, size=(n, 1)).astype(float)], 1)
    X[rng.random(n) < 0.03, 1] = np.nan
    y = X[:, 0] + (X[:, 4] % 3 == 1) - 0.5 * (X[:, 5] == 2) \
        + 0.3 * rng.normal(size=n)
    return X, y


def _cat_query(X, seed=3):
    """Rows with categories unseen at training time, NaN and negative
    codes in both categorical columns."""
    rng = np.random.default_rng(seed)
    Xq = X[:1500].copy()
    Xq[::7, 4] = 50.0
    Xq[::11, 4] = np.nan
    Xq[::13, 4] = -3.0
    Xq[::5, 5] = np.nan
    Xq[::17, 5] = 7.0
    Xq[rng.random(len(Xq)) < 0.05, 0] = np.nan
    return Xq


def _port_trees(jtrees):
    """The port's Tree objects with the JAX package's trees' fields."""
    out = []
    for jt in jtrees:
        t = TTree(jt.num_leaves)
        for k, v in vars(jt).items():
            if not k.startswith("_"):
                setattr(t, k, v.copy() if hasattr(v, "copy") else v)
        out.append(t)
    return out


def _np(d):
    """A forest / linear-leaves NamedTuple's fields as float32 or int
    numpy arrays (bf16 widened)."""
    out = {}
    for k, v in d._asdict().items():
        if v is None:
            continue
        a = v.float().numpy() if isinstance(v, torch.Tensor) and \
            v.dtype == torch.bfloat16 else np.asarray(v)
        out[k] = a.astype(np.float32) if a.dtype.kind == "V" or \
            str(a.dtype) == "bfloat16" else a
    return out


def _assert_values(got, want, record_property, what):
    """Values within rtol 2e-5 / atol 2e-6; whether they were bitwise is
    recorded as a test property."""
    got, want = np.asarray(got), np.asarray(want)
    record_property(f"{what}_bitwise", bool(np.array_equal(got, want)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- binning

@pytest.mark.parametrize("case", ["numeric_nan", "categorical", "bundled"])
def test_bin_external_matches_jax(case):
    rng = np.random.default_rng(7)
    cat = None
    if case == "numeric_nan":
        X, _ = _reg_data(n=3000, f=6)
        Xq = rng.normal(size=(700, 6)) * 2
        Xq[rng.random(Xq.shape) < 0.1] = np.nan
    elif case == "categorical":
        X, _ = _cat_data()
        Xq = _cat_query(X)
        cat = [4, 5]
    else:
        c = rng.integers(0, 12, size=4000)
        X = np.zeros((4000, 14))
        X[np.arange(4000), c] = rng.uniform(1, 5, size=4000)
        X[:, 12:] = rng.normal(size=(4000, 2))
        Xq = X[::3].copy()
        Xq[::9, 13] = np.nan
    params = {"max_bin": 63, "min_data_in_bin": 3}
    jd = JDataset.from_data(X, config=params, categorical_feature=cat)
    td = TDataset.from_data(X, config=params, categorical_feature=cat)
    assert (td.bundle_plan is not None) == (case == "bundled")
    assert (jd.bundle_plan is not None) == (case == "bundled")
    got, want = td.bin_external(Xq), jd.bin_external(Xq)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    got, want = td.bin_external_pred(Xq), jd.bin_external_pred(Xq)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if case == "categorical":
        # the sentinels: unseen -> num_bin, NaN -> num_bin + 1
        col = td.used_feature_idx.index(4)
        nb = td.mappers[4].num_bin
        v = Xq[:, 4]
        np.testing.assert_array_equal(got[np.isnan(v), col], nb + 1)
        unseen = (v == 50.0) | (v == -3.0)
        assert unseen.sum() > 100
        np.testing.assert_array_equal(got[unseen, col], nb)


# ---------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def slice_pair():
    """The regression slice trained by both packages (same text)."""
    X, y = _reg_data()
    bj = lgb_jax.train(SLICE, lgb_jax.Dataset(X, y), num_boost_round=5)
    bt = lgb_torch.train(dict(SLICE, device_type="cpu"),
                         lgb_torch.Dataset(X, y), num_boost_round=5)
    assert bt.model_to_string().split("parameters:")[0] == \
        bj.model_to_string().split("parameters:")[0]
    Xq = _reg_data(n=2600, seed=9)[0]
    return bj, bt, X, Xq


@pytest.fixture(scope="module")
def cat_model():
    """A JAX-trained categorical model, the port's Dataset on the same
    data and the JAX model's trees as the port's."""
    X, y = _cat_data()
    params = dict(SMALL, objective="regression", max_bin=63,
                  categorical_feature=[4, 5], min_data_per_group=5,
                  cat_smooth=1.0, max_cat_to_onehot=4)
    bj = lgb_jax.train(params, lgb_jax.Dataset(X, y), num_boost_round=6)
    td = TDataset.from_data(X, config={"max_bin": 63},
                            categorical_feature=[4, 5])
    return bj, td, _port_trees(bj._gbdt.models), _cat_query(X)


@pytest.fixture(scope="module")
def linear_model():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(2000, 5))
    X[rng.random(X.shape) < 0.04] = np.nan
    y = 2 * np.nan_to_num(X[:, 0]) + np.where(np.nan_to_num(X[:, 1]) > 0,
                                              np.nan_to_num(X[:, 2]), -1.0)
    params = dict(SMALL, objective="regression", linear_tree=True)
    bj = lgb_jax.train(params, lgb_jax.Dataset(X, y), num_boost_round=4)
    td = TDataset.from_data(X, config={})
    Xq = rng.normal(size=(700, 5))
    Xq[rng.random(Xq.shape) < 0.08] = np.nan
    return bj, td, _port_trees(bj._gbdt.models), Xq


@pytest.fixture(scope="module")
def multiclass_model():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(1500, 6))
    y = (X[:, 0] + X[:, 1] > 0).astype(int) + (X[:, 2] > 0.5).astype(int)
    params = dict(SMALL, objective="multiclass", num_class=3, num_leaves=7)
    bj = lgb_jax.train(params, lgb_jax.Dataset(X, y), num_boost_round=4)
    return bj, rng.normal(size=(600, 6))


# ------------------------------------------------------- forest operands

def test_forest_arrays_match_jax(slice_pair):
    bj, bt, _, _ = slice_pair
    jg, tg = bj._gbdt, bt._gbdt
    want = _np(jg._forest_arrays(jg.models, 1))
    got = _np(tg._forest_arrays(tg.models, 1))
    assert set(want) <= set(got)
    for f, w in want.items():
        assert got[f].shape == w.shape, f
        np.testing.assert_array_equal(got[f], w, err_msg=f)
    # the port's children are the trees'
    for ti, t in enumerate(tg.models):
        nn = t.num_leaves - 1
        np.testing.assert_array_equal(got["left"][ti, :nn], t.left_child)
        assert (got["left"][ti, nn:] == -1).all()


@pytest.mark.parametrize("which", ["categorical", "linear"])
def test_forest_bitset_arrays_match_jax(which, cat_model, linear_model):
    bj, td, trees, _ = cat_model if which == "categorical" else linear_model
    jg = bj._gbdt
    jfb, jlin, jcat = jg._forest_bitset_arrays(jg.models, 1)
    d, lin, cat_feats = forest_bitset_arrays(trees, 1, td)
    assert cat_feats == jcat
    assert bool(cat_feats) == (which == "categorical")
    for f, w in _np(jfb).items():
        np.testing.assert_array_equal(d[f], w, err_msg=f)
    assert (lin is None) == (jlin is None) == (which != "linear")
    if lin is not None:
        for f, w in _np(jlin).items():
            np.testing.assert_array_equal(lin[f], w, err_msg=f)
    # and through forest_from_numpy, the JAX operands as the port's
    fb = TP.forest_from_numpy(_np(jfb))
    assert isinstance(fb, TP.BitsetForest) and fb.left is None
    assert fb.mpos.dtype == torch.bfloat16 and fb.feat.dtype == torch.int32
    if jlin is not None:
        assert isinstance(TP.forest_from_numpy(_np(jlin)), TP.LinearLeaves)


# ------------------------------------------------ forest plain versions

def _jax_bins(td, X, pred):
    b = td.bin_external_pred(X) if pred else td.bin_external(X)
    return np.ascontiguousarray(b.T)


def test_numeric_forest_matches_jax(slice_pair, record_property):
    bj, bt, _, Xq = slice_pair
    jg = bj._gbdt
    fa = jg._forest_arrays(jg.models, 1)
    bins = _jax_bins(bt._gbdt.train_set, Xq, False)
    want = np.asarray(JP.predict_numeric_forest(fa, jnp.asarray(bins), 1))
    tfa = TP.forest_from_numpy(_np(fa))
    got = TP.predict_numeric_forest(tfa, torch.as_tensor(bins), 1)
    _assert_values(got.numpy(), want, record_property, "numeric")
    wl = np.asarray(JP.predict_forest_leaves(
        jg._forest_bitset_arrays(jg.models, 1)[0], jnp.asarray(bins)))
    np.testing.assert_array_equal(
        TP.predict_forest_leaves(tfa, torch.as_tensor(bins)).numpy(), wl)


def test_multiclass_cls_routing_matches_jax(multiclass_model,
                                            record_property):
    bj, Xq = multiclass_model
    jg = bj._gbdt
    fa = jg._forest_arrays(jg.models, 3)
    assert np.array_equal(np.asarray(fa.cls), np.arange(12) % 3)
    bins = np.ascontiguousarray(jg.train_set.bin_external(Xq).T)
    want = np.asarray(JP.predict_numeric_forest(fa, jnp.asarray(bins), 3))
    tfa = TP.forest_from_numpy(_np(fa))
    got = TP.predict_numeric_forest(tfa, torch.as_tensor(bins), 3)
    assert got.shape == (600, 3)
    _assert_values(got.numpy(), want, record_property, "multiclass")
    # the wrapper on CPU tensors is the plain version
    np.testing.assert_array_equal(
        FK.forest_values(tfa, torch.as_tensor(bins), 3).numpy(),
        got.numpy())


def test_bitset_forest_categorical_matches_jax(cat_model, record_property):
    bj, td, trees, Xq = cat_model
    jg = bj._gbdt
    jfb, _, cat_feats = jg._forest_bitset_arrays(jg.models, 1)
    assert cat_feats and any(int(t.decision_type[i]) & 1 for t in trees
                             for i in range(t.num_leaves - 1))
    bins = _jax_bins(td, Xq, True)
    want = np.asarray(JP.predict_bitset_forest(
        jfb, jnp.asarray(bins), 1, cat_feats=cat_feats))
    fb = TP.forest_from_numpy(_np(jfb))
    got = TP.predict_bitset_forest(fb, torch.as_tensor(bins), 1, cat_feats)
    _assert_values(got.numpy(), want, record_property, "categorical")
    # the raw-space host walk agrees (sentinels: unseen right, NaN by
    # cat_nan_left)
    np.testing.assert_allclose(got.numpy()[:, 0],
                               jg.predict_raw(Xq), rtol=RTOL, atol=ATOL)
    wl = np.asarray(JP.predict_forest_leaves(jfb, jnp.asarray(bins),
                                             cat_feats=cat_feats))
    gl = TP.predict_forest_leaves(fb, torch.as_tensor(bins), cat_feats)
    np.testing.assert_array_equal(gl.numpy(), wl)


def test_bitset_forest_linear_matches_jax(linear_model, record_property):
    bj, td, trees, Xq = linear_model
    jg = bj._gbdt
    jfb, jlin, cat_feats = jg._forest_bitset_arrays(jg.models, 1)
    assert jlin is not None and any(t.is_linear for t in trees)
    bins = _jax_bins(td, Xq, True)
    raw = np.nan_to_num(Xq.astype(np.float32))
    isnan = np.ascontiguousarray(np.isnan(Xq).T).astype(np.float32)
    want = np.asarray(JP.predict_bitset_forest(
        jfb, jnp.asarray(bins), 1, cat_feats=cat_feats, lin=jlin,
        raw=jnp.asarray(raw), raw_nan=jnp.asarray(isnan, jnp.bfloat16)))
    got = TP.predict_bitset_forest(
        TP.forest_from_numpy(_np(jfb)), torch.as_tensor(bins), 1, cat_feats,
        lin=TP.forest_from_numpy(_np(jlin)), raw=torch.as_tensor(raw),
        raw_nan=torch.as_tensor(isnan))
    _assert_values(got.numpy(), want, record_property, "linear")
    np.testing.assert_allclose(got.numpy()[:, 0], jg.predict_raw(Xq),
                               rtol=1e-4, atol=1e-5)


def _walk_packed(p, bins_t, F):
    """csrc/forest.cu's walk over a PackedForest, row by row in Python."""
    nodes, meta, catb = p.nodes.numpy(), p.meta.numpy(), p.catb.numpy()
    T, ni = nodes.shape[:2]
    Bc = catb.shape[2]
    out = np.zeros((T, bins_t.shape[1]), np.int32)
    for t in range(T):
        for r in range(bins_t.shape[1]):
            node = 0
            for _ in range(ni):
                f, thr, lc, rc = nodes[t, node]
                nanb, flags = meta[t, node]
                b = int(bins_t[min(max(f, 0), F - 1), r])
                slot = (flags >> 1) - 1
                if slot >= 0:
                    left = 0 <= b < Bc and catb[t, slot, b] != 0
                else:
                    left = bool(flags & 1) if b == nanb else b <= thr
                child = lc if left else rc
                if child < 0:
                    out[t, r] = -child - 1
                    break
                node = child
    return out


def test_packed_forest_walk_equals_plain(cat_model, slice_pair):
    """The kernel's tables (pack_forest), walked as the kernel walks them,
    reach the plain version's leaves: categorical slots, both sentinels,
    NaN bins and padded nodes included."""
    bj, td, trees, Xq = cat_model
    d, _, cat_feats = forest_bitset_arrays(trees, 1, td)
    fb = TP.forest_from_numpy(d)
    bins = torch.as_tensor(_jax_bins(td, Xq[:300], True))
    want = TP.predict_forest_leaves(fb, bins, cat_feats).numpy()
    got = _walk_packed(FK.pack_forest(fb, cat_feats), bins.numpy(),
                       bins.shape[0])
    np.testing.assert_array_equal(got, want)
    _, bt, _, Xn = slice_pair
    tg = bt._gbdt
    fa = tg._forest_arrays(tg.models, 1)
    bins = torch.as_tensor(_jax_bins(tg.train_set, Xn[:300], False))
    np.testing.assert_array_equal(
        _walk_packed(FK.pack_forest(fa), bins.numpy(), bins.shape[0]),
        TP.predict_forest_leaves(fa, bins).numpy())
    with pytest.raises(LightGBMError):
        FK.pack_forest(TP.forest_from_numpy(_np(bj._gbdt._forest_arrays(
            bj._gbdt.models, 1))))


# ----------------------------------------------- GBDT.predict_raw dispatch

def test_predict_raw_device_path_matches_jax(slice_pair, monkeypatch,
                                             record_property):
    bj, bt, _, Xq = slice_pair
    host = bt._gbdt.predict_raw(Xq)
    np.testing.assert_array_equal(host, bj._gbdt.predict_raw(Xq))
    for cls in (JGBDT, TGBDT):
        monkeypatch.setattr(cls, "DEVICE_PREDICT_MIN_WORK", 0)
    dev = bt._gbdt.predict_raw(Xq)
    _assert_values(dev, bj._gbdt.predict_raw(Xq), record_property, "raw")
    np.testing.assert_allclose(dev, host, rtol=RTOL, atol=ATOL)
    assert not np.array_equal(dev, host)      # float32 sums, not float64


@pytest.mark.parametrize("bucketing", ["on", "off"])
def test_predict_raw_blocks_and_padding(slice_pair, monkeypatch, bucketing):
    _, bt, _, Xq = slice_pair
    g = bt._gbdt
    monkeypatch.setattr(TGBDT, "DEVICE_PREDICT_MIN_WORK", 0)
    whole = g.predict_raw(Xq)
    monkeypatch.setattr(TGBDT, "PREDICT_BLOCK_ROWS", 1024)
    monkeypatch.setattr(TGBDT, "PREDICT_TAIL_QUANTUM", 64)
    monkeypatch.setattr(g.config, "predict_bucketing", bucketing)
    for n in (1, 63, 65, 1024, 1500, 2600):
        np.testing.assert_array_equal(g.predict_raw(Xq[:n]), whole[:n])


def test_predict_linear_model_on_card_raises(slice_pair, monkeypatch):
    """A linear model above the threshold on the card takes the card path
    (the forest kernel's linear mode), with no refusal and no fall back to
    the host walk: on a machine without a card it raises where it first
    puts a tensor on the card."""
    _, bt, _, Xq = slice_pair
    g = bt._gbdt
    monkeypatch.setattr(TGBDT, "DEVICE_PREDICT_MIN_WORK", 0)
    monkeypatch.setattr(g.models[0], "is_linear", True)
    monkeypatch.setattr(g, "device", torch.device("cuda"))
    import lightgbm_tpu_torch.basic as TB
    host = []
    monkeypatch.setattr(TB, "_host_raw", lambda *a, **k: host.append(1))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the card path runs")
    with pytest.raises((AssertionError, RuntimeError)) as err:
        g.predict_raw(Xq)
    assert not isinstance(err.value, LightGBMError)
    assert "CUDA" in str(err.value) and not host


# --------------------------------------------------------- Booster.predict

@pytest.mark.parametrize("loaded", [False, True], ids=["trained", "loaded"])
@pytest.mark.parametrize("kw", [
    dict(pred_leaf=True), dict(pred_leaf=True, start_iteration=1,
                               num_iteration=2),
    dict(raw_score=True, pred_early_stop=True, pred_early_stop_freq=1,
         pred_early_stop_margin=0.5),
    dict(start_iteration=2, num_iteration=2), dict(raw_score=True)],
    ids=["leaf", "leaf_range", "early_stop", "range", "raw"])
def test_booster_predict_matches_jax(slice_pair, loaded, kw):
    bj, bt, _, Xq = slice_pair
    if loaded:
        text = bj.model_to_string()
        bj = lgb_jax.Booster(model_str=text)
        bt = lgb_torch.Booster(model_str=text)
    got, want = bt.predict(Xq, **kw), bj.predict(Xq, **kw)
    assert got.shape == want.shape
    if kw.get("pred_leaf"):
        assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_binary_early_stop_matches_jax():
    rng = np.random.default_rng(8)
    X = rng.normal(size=(2000, 6))
    y = (X[:, 0] + 0.3 * rng.normal(size=2000) > 0).astype(float)
    params = dict(objective="binary", num_leaves=7, max_bin=63,
                  tpu_split_batch=2, use_quantized_grad=True,
                  tpu_hist_dtype="int8", stochastic_rounding=False,
                  hist_kernel="onehot", verbosity=-1)
    bj = lgb_jax.train(params, lgb_jax.Dataset(X, y), num_boost_round=12)
    text = bj.model_to_string()
    bt = lgb_torch.Booster(model_str=text)
    kw = dict(pred_early_stop=True, pred_early_stop_freq=2,
              pred_early_stop_margin=1.5, raw_score=True)
    got = bt.predict(X, **kw)
    np.testing.assert_array_equal(got, bj.predict(X, **kw))
    np.testing.assert_array_equal(
        got, lgb_jax.Booster(model_str=text).predict(X, **kw))
    # early stopping changed some rows and left others
    full = bt.predict(X, raw_score=True)
    assert (got != full).any() and (got == full).any()


# ------------------------------------------------------------ pred_contrib

def test_contrib_host_path_bitwise_and_additive(slice_pair):
    bj, _, _, Xq = slice_pair
    text = bj.model_to_string()
    bt = lgb_torch.Booster(model_str=text)
    bjl = lgb_jax.Booster(model_str=text)
    got = bt.predict(Xq[:200], pred_contrib=True)
    want = bjl.predict(Xq[:200], pred_contrib=True)
    assert got.shape == (200, Xq.shape[1] + 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.sum(axis=1),
                               bt.predict(Xq[:200], raw_score=True),
                               atol=1e-9)
    got = bt.predict(Xq[:50], pred_contrib=True, start_iteration=1,
                     num_iteration=2)
    want = bjl.predict(Xq[:50], pred_contrib=True, start_iteration=1,
                       num_iteration=2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", ["regression", "categorical",
                                   "multiclass"])
def test_contrib_device_path_matches_jax(which, slice_pair, cat_model,
                                         multiclass_model):
    if which == "regression":
        bj, _, _, Xq = slice_pair
        Xq = Xq[:300]
    elif which == "categorical":
        bj, _, _, Xq = cat_model
        Xq = Xq[:300]
    else:
        bj, Xq = multiclass_model
        Xq = Xq[:200]
    jtrees = bj._gbdt.models
    k = bj._gbdt.num_tree_per_iteration
    nf = Xq.shape[1]
    want = JS.predict_contrib(jtrees, Xq, nf, k, force_device=True)
    trees = lgb_torch.Booster(model_str=bj.model_to_string())._get_trees()
    got = TS.predict_contrib(trees, Xq, nf, k, force_device=True,
                             device=CPU)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    host = TS.predict_contrib(trees, Xq, nf, k)
    np.testing.assert_allclose(got, host, rtol=1e-4, atol=1e-5)


def test_shap_kernel_tables(slice_pair):
    """csrc/shap.cu's edge table (slot_ptr) and column table (col_ptr /
    col_idx), read as the kernel reads them: the same one-fractions as the
    segment-AND and the same per-feature sums as the einsum."""
    _, bt, _, Xq = slice_pair
    t = bt._gbdt.models[2]
    tp = TS._paths_of(t, Xq.shape[1])
    tb = SK.tree_tables(tp, CPU)
    assert SK.tree_tables(tp, CPU) is tb
    gl_np = TS._go_left_matrix(t, Xq[:64])
    gl = SK.go_left_to_device(gl_np, CPU)
    o = SK.one_fractions_plain(tb, gl).numpy()
    np.testing.assert_array_equal(o, TS._one_fractions(tp, gl_np))
    sp, en, ed = tb.slot_ptr.numpy(), tb.edge_node.numpy(), \
        tb.edge_dir.numpy()
    L, S = tp.feats.shape
    for r in (0, 17, 63):
        for q in range(L * S):
            ok = all(bool(gl_np[r, en[e]]) == bool(ed[e])
                     for e in range(sp[q], sp[q + 1]))
            assert float(ok) == o[r, q // S, q % S]
    ps = SK.phi_slots_plain(torch.as_tensor(o), tb.z, tb.m, tb.values,
                            tb.S).numpy().reshape(64, L * S)
    cp, ci = tb.col_ptr.numpy(), tb.col_idx.numpy()
    sums = np.stack([ps[:, ci[cp[f]:cp[f + 1]]].sum(1)
                     for f in range(tb.F1)], 1)
    np.testing.assert_allclose(sums, SK.tree_shap_plain(tb, gl).numpy(),
                               rtol=1e-6, atol=1e-7)
    assert (sums[:, -1] == 0).all()


def test_contrib_large_slot_count():
    """A chain tree with 40 distinct features on one path: S = 40, above
    the kernel's register buckets; the float32 device path against the
    float64 host path and against additivity."""
    F = 44
    nl = 42
    t = TTree(nl)
    ni = nl - 1
    t.split_feature = np.arange(ni, dtype=np.int32) % 40
    t.threshold = np.linspace(-0.5, 0.5, ni)
    t.decision_type = np.zeros(ni, np.int32)
    t.left_child = np.array([-(i + 1) for i in range(ni)], np.int32)
    t.right_child = np.array(list(range(1, ni)) + [-nl], np.int32)
    t.leaf_value = np.linspace(-1, 1, nl)
    counts = np.maximum(1000 >> np.minimum(np.arange(nl), 12), 3)
    t.leaf_count = counts.astype(np.int64)
    t.internal_count = np.array([counts[i:].sum() for i in range(ni)],
                                np.int64)
    rng = np.random.default_rng(3)
    X = rng.normal(size=(40, F)) * 0.5
    tp = TS._paths_of(t, F)
    assert tp.S > SK.REGISTER_SLOTS
    host = TS.predict_contrib([t], X, F)
    np.testing.assert_allclose(host.sum(1), t.predict(X), atol=1e-9)
    dev = TS.predict_contrib([t], X, F, force_device=True, device=CPU)
    # float32 recurrences over a 40-slot path lose about three digits
    # against float64 (the unwound sums subtract nearly equal terms); the
    # JAX package's float32 program is as far off on this tree
    np.testing.assert_allclose(dev, host, rtol=0, atol=5e-4)


def test_contrib_loaded_needs_a_card(slice_pair, monkeypatch):
    """A loaded booster's pred_contrib above the threshold resolves its
    device from params: with device_type unset and no card it raises;
    with device_type=cpu it runs the plain version."""
    bj, _, _, Xq = slice_pair
    text = bj.model_to_string()
    monkeypatch.setattr(TS, "DEVICE_CONTRIB_MIN_WORK", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(LightGBMError):
        lgb_torch.Booster(model_str=text).predict(Xq[:10], pred_contrib=True)
    got = lgb_torch.Booster(params={"device_type": "cpu"},
                            model_str=text).predict(Xq[:10],
                                                    pred_contrib=True)
    want = JS.predict_contrib(bj._gbdt.models, Xq[:10], Xq.shape[1], 1,
                              force_device=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
