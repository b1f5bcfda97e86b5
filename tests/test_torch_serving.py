"""The port's serving predictor core (``lightgbm_tpu_torch/serving/``)
against ``Booster.predict`` and lightgbm_tpu's serving tier, on the CPU:

* exact mode is bit-identical to ``Booster.predict(raw_score=True)`` over
  mixed request sizes for trained and text-loaded numeric, categorical,
  linear and multiclass models (converted scores bitwise for loaded
  models, within float32 rounding for trained ones, as in the JAX
  package);
* every chunk reaches the forest predictor at a bucket of the ladder;
* fast mode equals the booster's own device predict
  (``GBDT._device_predict_raw``) bitwise; linear models force exact mode;
* ``StandaloneUnsupported`` falls back to the host booster;
* lightgbm_tpu's ``CompiledPredictor`` on the same model text gives the
  same leaves and the same raw scores;
* the C API's fast path through the bucket-1 predictor;
* a loaded model's ``Booster.predict`` above ``DEVICE_PREDICT_MIN_WORK``
  (the forest kernel's leaves, host float64 sums) equals its host walk
  bitwise, with its tables made once and the kernel's packed forest made
  once a live forest.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb_jax
from lightgbm_tpu.serving import CompiledPredictor as JaxPredictor

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch import capi_impl as C
from lightgbm_tpu_torch.boosting.gbdt import GBDT
from lightgbm_tpu_torch.obs.metrics import global_metrics
from lightgbm_tpu_torch.ops import forest_kernels as FK
from lightgbm_tpu_torch.serving import (BucketLadder, CompiledPredictor,
                                        StandaloneUnsupported)
from lightgbm_tpu_torch.utils.log import LightGBMError

from test_torch_fused import one_torch_thread  # noqa: F401

CPU = {"device_type": "cpu"}
SIZES = (1, 3, 8, 37, 64, 130)
LADDER = BucketLadder((1, 8, 64))


def _train(params, X, y, rounds):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return lgb.train(dict(params, verbosity=-1, **CPU),
                         lgb.Dataset(X, label=y), num_boost_round=rounds)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reg_model():
    """Numeric regression forest with NaN-bearing features."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(400, 6))
    X[rng.random(X.shape) < 0.08] = np.nan
    y = np.nansum(X[:, :3], axis=1) + rng.normal(scale=0.1, size=400)
    return _train({"objective": "regression", "num_leaves": 15,
                   "min_data_in_leaf": 5}, X, y, 10), X


@pytest.fixture(scope="module")
def cat_model():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(400, 5))
    X[:, 4] = rng.integers(0, 8, size=400)
    y = X[:, 0] + (X[:, 4] > 3) + rng.normal(scale=0.1, size=400)
    return _train({"objective": "regression", "num_leaves": 15,
                   "categorical_feature": [4], "min_data_in_leaf": 5},
                  X, y, 8), X


@pytest.fixture(scope="module")
def linear_model():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(400, 4))
    y = X @ np.array([1.0, -2.0, 0.5, 0.0]) + rng.normal(scale=0.05,
                                                         size=400)
    return _train({"objective": "regression", "num_leaves": 8,
                   "linear_tree": True}, X, y, 6), X


@pytest.fixture(scope="module")
def multi_model():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(450, 5))
    y = rng.integers(0, 3, size=450).astype(np.float64)
    return _train({"objective": "multiclass", "num_class": 3,
                   "num_leaves": 10}, X, y, 5), X


@pytest.fixture(scope="module")
def binary_model():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(500, 4))
    y = (X[:, 0] - X[:, 1] + 0.3 * rng.normal(size=500) > 0).astype(float)
    return _train({"objective": "binary", "num_leaves": 15,
                   "min_data_in_leaf": 5}, X, y, 8), X


def test_bucket_ladder_table():
    lad = BucketLadder((1, 8, 64, 512))
    table = {1: 1, 2: 8, 8: 8, 9: 64, 64: 64, 65: 512, 512: 512,
             513: 512, 5000: 512}
    for n, b in table.items():
        assert lad.bucket_for(n) == b, (n, b)
    assert lad.chunks(5) == [(0, 5, 8)]
    assert lad.chunks(513) == [(0, 512, 512), (512, 1, 1)]
    assert lad.chunks(1100) == [(0, 512, 512), (512, 512, 512),
                                (1024, 76, 512)]
    assert lad.pad_rows(5) == 3 and lad.pad_rows(64) == 0
    assert BucketLadder((64, 8, 8, 1)).sizes == (1, 8, 64)
    for bad in ((), (0, 8), (-4,)):
        with pytest.raises(LightGBMError):
            BucketLadder(bad)


def _assert_bit_identical(bst, X, **kw):
    pred = CompiledPredictor.from_booster(bst, ladder=LADDER, **kw)
    assert pred._fallback is None and pred.exact
    g = bst._gbdt
    conv_exact = g.objective is None or not g.objective.need_convert_output
    for n in SIZES:
        for raw in (True, False):
            got = np.asarray(pred.predict(X[:n], raw_score=raw))
            want = np.asarray(bst.predict(X[:n], raw_score=raw))
            if raw or conv_exact:
                assert np.array_equal(got, want), (n, raw, kw)
            else:
                # served scores convert in float64 on the host, the
                # trained booster in float32
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("model", ["reg_model", "cat_model", "linear_model",
                                   "multi_model", "binary_model"])
def test_exact_bit_identity_trained(model, request):
    _assert_bit_identical(*request.getfixturevalue(model))


def test_int8_changes_nothing(reg_model, cat_model):
    for bst, X in (reg_model, cat_model):
        a = CompiledPredictor.from_booster(bst, ladder=LADDER)
        b = CompiledPredictor.from_booster(bst, ladder=LADDER, int8=True)
        assert np.array_equal(a.predict(X[:130]), b.predict(X[:130]))


@pytest.mark.parametrize("model", ["reg_model", "cat_model", "linear_model",
                                   "multi_model", "binary_model"])
def test_exact_bit_identity_text_loaded(model, request):
    bst, X = request.getfixturevalue(model)
    text = bst.model_to_string()
    loaded = lgb.Booster(model_str=text)
    pred = CompiledPredictor.from_model_text(text, params=CPU,
                                             ladder=LADDER)
    assert pred._fallback is None and pred.device.type == "cpu"
    for n in SIZES:
        for raw in (True, False):
            got = pred.predict(X[:n], raw_score=raw)
            want = loaded.predict(X[:n], raw_score=raw)
            assert np.array_equal(np.asarray(got), np.asarray(want)), (n,
                                                                       raw)


def test_loaded_model_takes_the_card_unless_told(reg_model, monkeypatch):
    bst, X = reg_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(LightGBMError, match="CUDA"):
        CompiledPredictor.from_model_text(bst.model_to_string())


def test_every_chunk_runs_at_a_bucket(multi_model, monkeypatch):
    bst, X = multi_model
    shapes = []
    real = FK.forest_leaves
    monkeypatch.setattr(FK, "forest_leaves",
                        lambda f, b, *a, **k: shapes.append(tuple(b.shape))
                        or real(f, b, *a, **k))
    pred = CompiledPredictor.from_booster(bst, ladder=LADDER)
    rng = np.random.default_rng(9)
    sizes = rng.integers(1, 200, size=40)
    for n in sizes:
        Xn = X[rng.integers(0, len(X), size=n)]
        out, stats = pred.predict_ex(Xn)
        assert np.array_equal(out, bst.predict(Xn, raw_score=True))
        assert [b for b, _ in stats.chunks] == \
            [b for _, _, b in LADDER.chunks(int(n))]
        assert stats.pad_rows == LADDER.pad_rows(int(n))
    assert shapes and {s[1] for s in shapes} <= set(LADDER.sizes)
    assert {s[0] for s in shapes} == {X.shape[1]}
    assert len(shapes) == sum(len(LADDER.chunks(int(n))) for n in sizes)


def test_fast_mode_equals_device_predict(reg_model, cat_model, linear_model,
                                         monkeypatch):
    monkeypatch.setattr(GBDT, "DEVICE_PREDICT_MIN_WORK", 0)
    monkeypatch.setattr(GBDT, "PREDICT_TAIL_QUANTUM", 64)
    for bst, X in (reg_model, cat_model):
        pred = CompiledPredictor.from_booster(bst, ladder=LADDER,
                                              exact=False)
        assert not pred.exact
        for n in SIZES:
            got = pred.predict(X[:n])
            want = bst._gbdt.predict_raw(X[:n])
            assert np.array_equal(got, want), n
        np.testing.assert_allclose(
            pred.predict(X[:50]), bst.predict(X[:50], raw_score=True),
            rtol=1e-5, atol=1e-5)
    lb, _ = linear_model
    assert CompiledPredictor.from_booster(lb, ladder=LADDER,
                                          exact=False).exact


def test_standalone_fallback(reg_model, monkeypatch):
    bst, X = reg_model
    import lightgbm_tpu_torch.serving.standalone as ss

    def boom(*a, **k):
        raise StandaloneUnsupported("forced by test")
    monkeypatch.setattr(ss, "build_standalone", boom)
    text = bst.model_to_string()
    pred = CompiledPredictor.from_model_text(text)   # no device needed
    assert pred._fallback is not None and pred.warmup() == {}
    base = global_metrics.snapshot()["counters"].get(
        "serve_host_fallback_requests", 0)
    out, stats = pred.predict_ex(X[:9])
    assert stats.fallback
    assert global_metrics.snapshot()["counters"][
        "serve_host_fallback_requests"] == base + 1
    assert np.array_equal(out, lgb.Booster(model_str=text).predict(
        X[:9], raw_score=True))


def test_standalone_refusals():
    from lightgbm_tpu_torch.models.tree import Tree
    from lightgbm_tpu_torch.serving.standalone import build_standalone
    with pytest.raises(StandaloneUnsupported):
        build_standalone([], 4, 1)
    t = Tree(3)
    t.split_feature[:2] = [0, 0]
    t.decision_type[:2] = [0 | (2 << 2), 0 | (1 << 2)]   # NaN vs zero
    t.left_child[:2] = [1, -1]
    t.right_child[:2] = [-2, -3]
    with pytest.raises(StandaloneUnsupported, match="missing types"):
        build_standalone([t], 2, 1)


def test_leaves_and_raw_match_jax_serving(reg_model, cat_model,
                                          linear_model):
    """lightgbm_tpu's CompiledPredictor and the port's, both from the same
    model text: the same leaf of every row in every tree, the same raw
    scores (both finish on the host in float64)."""
    for bst, X in (reg_model, cat_model, linear_model):
        text = bst.model_to_string()
        jp = JaxPredictor.from_model_text(text, ladder=LADDER)
        tp = CompiledPredictor.from_model_text(text, params=CPU,
                                               ladder=LADDER)
        assert jp._fallback is None and tp._fallback is None
        bins = tp._binner(X[:64])
        assert np.array_equal(bins, jp._binner(X[:64]))
        assert np.array_equal(tp._leaves_for_chunk(bins, 64, 64),
                              jp._leaves_for_chunk(bins, 64, 64))
        for n in (1, 37, 130):
            assert np.array_equal(tp.predict(X[:n]), jp.predict(X[:n]))
    jb = lgb_jax.Booster(model_str=reg_model[0].model_to_string())
    assert np.array_equal(
        CompiledPredictor.from_model_text(
            reg_model[0].model_to_string(), params=CPU).predict(
            reg_model[1][:20]),
        jb.predict(reg_model[1][:20], raw_score=True))


def test_contrib_matches_booster(reg_model, multi_model):
    for bst, X in (reg_model, multi_model):
        pred = CompiledPredictor.from_booster(bst, ladder=BucketLadder((8,
                                                                        64)))
        got, stats = pred.predict_contrib_ex(X[:50])
        ref = np.asarray(bst.predict(X[:50], pred_contrib=True))
        assert got.shape == ref.shape and [b for b, _ in stats.chunks] == [64]
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


def test_warmup_and_item8_refusals(reg_model):
    bst, X = reg_model
    pred = CompiledPredictor.from_booster(bst, ladder=LADDER)
    t = pred.warmup()
    assert set(t) == set(LADDER.sizes)
    _, stats = pred.predict_ex(X[:5])
    assert stats.warm_chunks == 1
    with pytest.raises(LightGBMError, match="item 8"):
        pred.predict_ex(X[:5], trace=object())
    with pytest.raises(LightGBMError, match="item 8"):
        pred.predict_contrib_ex(X[:5], trace=object())
    with pytest.raises(LightGBMError, match="item 8"):
        CompiledPredictor.from_booster(bst, aot_store=object())
    with pytest.raises(LightGBMError):
        CompiledPredictor("not a booster")


@pytest.mark.parametrize("model", ["reg_model", "cat_model", "linear_model",
                                   "binary_model"])
def test_capi_fast_path_parity(model, request, monkeypatch):
    bst, X = request.getfixturevalue(model)
    calls = []
    real = FK.forest_leaves
    monkeypatch.setattr(FK, "forest_leaves",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    loaded = lgb.Booster(model_str=bst.model_to_string())
    lh = C._new_handle(loaded)
    C.booster_reset_parameter(lh, '{"device_type": "cpu"}')
    for b in (bst, loaded):
        h = C._new_handle(b) if b is bst else lh
        for raw in (1, 0):
            fp = C._handles[C.fastpredict_init(h, X.shape[1], raw)]
            assert fp._served is not None
            for i in range(6):
                got = fp.predict_row(np.ascontiguousarray(X[i]))
                want = np.asarray(b.predict(X[i:i + 1], raw_score=bool(raw)),
                                  np.float64).reshape(-1)
                assert np.array_equal(got, want), (i, raw)
    assert len(calls) == 2 * 2 * 6


def test_capi_fast_path_hatch_and_refresh(monkeypatch):
    rng = np.random.default_rng(7)
    X = rng.normal(size=(600, 5))
    y = X[:, 0] + np.sin(X[:, 1])
    bst = _train({"objective": "regression", "num_leaves": 10}, X, y, 3)
    fid = C.fastpredict_init(C._new_handle(bst), 5, 1)
    fp = C._handles[fid]
    assert np.array_equal(fp.predict_row(X[0]),
                          bst.predict(X[:1], raw_score=True))
    bst.update()     # a tree grown in place: the served forest follows
    assert np.array_equal(fp.predict_row(X[0]),
                          bst.predict(X[:1], raw_score=True))


@pytest.mark.parametrize("model", ["reg_model", "cat_model", "linear_model",
                                   "multi_model", "binary_model"])
def test_loaded_booster_device_predict_is_the_host_walk(model, request,
                                                        monkeypatch):
    """A loaded model's scores above DEVICE_PREDICT_MIN_WORK: one leaves
    launch a block of rows, bitwise the host walk (raw and converted, whole
    model and an iteration slice); the tables are kept across calls and
    made anew once the trees change."""
    bst, X = request.getfixturevalue(model)
    loaded = lgb.Booster(params=CPU, model_str=bst.model_to_string())
    Xs = X[:150]
    want = {(raw, s0, ni): loaded.predict(Xs, raw_score=raw,
                                          start_iteration=s0,
                                          num_iteration=ni)
            for raw in (True, False) for s0, ni in ((0, None), (1, 2))}
    assert loaded._loaded_forest is None
    calls = []
    real = FK.forest_leaves
    monkeypatch.setattr(FK, "forest_leaves",
                        lambda *a, **k: calls.append(a[1].shape) or
                        real(*a, **k))
    monkeypatch.setattr(GBDT, "DEVICE_PREDICT_MIN_WORK", 0)
    monkeypatch.setattr(GBDT, "PREDICT_BLOCK_ROWS", 64)
    for (raw, s0, ni), w in want.items():
        got = loaded.predict(Xs, raw_score=raw, start_iteration=s0,
                             num_iteration=ni)
        assert np.array_equal(got, w), (raw, s0, ni)
    # blocks of 64 rows
    assert calls[:3] == [(X.shape[1], 64)] * 2 + [(X.shape[1], 22)]
    loaded.predict(Xs, raw_score=True)
    forest = loaded._loaded_forest[2][1]
    # the serving predictor and the fast row share the Booster's tables
    assert CompiledPredictor.from_booster(loaded).fb is forest
    loaded.predict(Xs)
    assert loaded._loaded_forest[2][1] is forest
    loaded.set_leaf_output(0, 0, loaded.get_leaf_output(0, 0))
    assert loaded._loaded_forest is None
    loaded.predict(Xs, raw_score=True)
    forest = loaded._loaded_forest[2][1]
    loaded.merge_models(lgb.Booster(model_str=bst.model_to_string()))
    both = loaded.predict(Xs, raw_score=True)
    assert loaded._loaded_forest[2][1] is not forest
    monkeypatch.setattr(GBDT, "DEVICE_PREDICT_MIN_WORK", 1 << 62)
    assert np.array_equal(loaded.predict(Xs, raw_score=True), both)


def test_loaded_booster_without_tables_walks_on_the_host(reg_model,
                                                         monkeypatch):
    bst, X = reg_model
    import lightgbm_tpu_torch.serving.standalone as ss

    def boom(*a, **k):
        raise StandaloneUnsupported("forced by test")
    monkeypatch.setattr(ss, "build_standalone", boom)
    loaded = lgb.Booster(params=CPU, model_str=bst.model_to_string())
    want = loaded.predict(X[:40])
    monkeypatch.setattr(GBDT, "DEVICE_PREDICT_MIN_WORK", 0)
    assert np.array_equal(loaded.predict(X[:40]), want)
    assert loaded._loaded_forest[2] is None


def test_packed_forest_made_once_a_live_forest(cat_model):
    """The forest kernel's tables (``pack_forest``) are kept while the
    forest lives and made anew for another forest or other categorical
    features; they go with the forest."""
    import gc
    bst, _ = cat_model
    pred = CompiledPredictor.from_booster(bst, ladder=LADDER)
    fb, cat = pred.fb, tuple(pred.cat_feats)
    p = FK._packed_forest(fb, cat)
    assert FK._packed_forest(fb, cat) is p
    assert FK._packed_forest(fb, ()) is not p
    other = fb._replace(value=fb.value + 1.0)
    po = FK._packed_forest(other, cat)
    assert po is not p and FK._packed_forest(other, cat) is po
    assert torch.equal(po.value, p.value + 1.0)
    assert torch.equal(po.nodes, p.nodes)
    n = len(FK._packed)
    del pred, fb, other, p, po
    gc.collect()
    assert len(FK._packed) == n - 1
