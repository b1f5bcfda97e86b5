"""The port's model-inspection methods and model edits against
lightgbm_tpu, on models both packages train from the same seeded data and
on the stock models of ``tests/fixtures/golden``:

* ``feature_importance`` (split and gain), ``dump_model`` (the dicts
  equal), ``model_to_json`` / ``model_to_cpp``, ``trees_to_dataframe``
  (the frames equal), ``get_split_value_histogram`` (both styles),
  ``upper_bound`` / ``lower_bound``;
* ``get_leaf_output`` / ``set_leaf_output`` (``eval_train`` after the edit
  equal to the metric of ``predict``), ``model_from_string``,
  ``merge_models``, ``shuffle_models`` (the same permutation) and
  ``Booster.eval`` of a loaded model;
* ``reset_training_data`` then more rounds: the int8 text equal to the
  JAX package's, the fused loop equal to the classic loop.
"""

from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import lightgbm_tpu as lgb_jax
from lightgbm_tpu.models import model_io as JIO

import lightgbm_tpu_torch as lgb_torch
from lightgbm_tpu_torch.boosting.gbdt import GBDT as TGBDT
from lightgbm_tpu_torch.models import model_io as TIO

from test_torch_fused import one_torch_thread  # noqa: F401

GOLDEN = Path(__file__).resolve().parent / "fixtures" / "golden"
INT8 = dict(num_leaves=15, max_bin=63, tpu_split_batch=4,
            use_quantized_grad=True, tpu_hist_dtype="int8",
            quant_train_renew_leaf=True, stochastic_rounding=False,
            hist_kernel="onehot", min_data_in_leaf=5, verbosity=-1)
CPU = dict(device_type="cpu")


def _data(n=2500, f=6, seed=0, kind="regression"):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[rng.random((n, f)) < 0.05] = np.nan
    z = np.nan_to_num(X[:, 0]) - 0.7 * np.nan_to_num(X[:, 1])
    if kind == "binary":
        return X, (z + 0.5 * rng.normal(size=n) > 0).astype(float)
    if kind == "multiclass":
        return X, np.digitize(z, [-0.5, 0.5]).astype(float)
    return X, z + 0.2 * rng.normal(size=n)


def _head(bst):
    return bst.model_to_string().split("parameters:")[0]


def _pair(kind="regression", rounds=5, categorical=False, **extra):
    """(JAX booster, port booster, X, y) trained on the same data; binary
    and multiclass without leaf renewal (their gradients' ``exp`` may
    differ by an ulp, which renewal would carry into the leaf values; the
    int8 levels are the same, so the text equals the JAX package's)."""
    X, y = _data(kind=kind)
    kw = {}
    if categorical:
        X[:, 2] = np.random.default_rng(1).integers(0, 6, size=len(X))
        kw["categorical_feature"] = [2]
    p = dict(INT8, objective=kind, **extra)
    if kind in ("binary", "multiclass"):
        p["quant_train_renew_leaf"] = False
    if kind == "multiclass":
        p["num_class"] = 3
    bj = lgb_jax.train(p, lgb_jax.Dataset(X, y, params=p, **kw), rounds)
    bt = lgb_torch.train(dict(p, **CPU), lgb_torch.Dataset(
        X, y, params=p, **kw), rounds)
    assert _head(bt) == _head(bj)
    return bj, bt, X, y


def _golden(name):
    text = (GOLDEN / name).read_text()
    return lgb_jax.Booster(model_str=text), lgb_torch.Booster(model_str=text)


MODELS = ["regression", "binary-categorical", "multiclass",
          "golden-binary", "golden-multiclass", "golden-rank"]


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    name = request.param
    if name.startswith("golden"):
        file = {"golden-binary": "model_ref.txt",
                "golden-multiclass": "model_ref_mc.txt",
                "golden-rank": "model_ref_rank.txt"}[name]
        bj, bt = _golden(file)
        return name, bj, bt
    kind = name.split("-")[0]
    bj, bt, _, _ = _pair(kind, categorical="categorical" in name)
    return name, bj, bt


def test_inspection_matches_jax(pair):
    name, bj, bt = pair
    for it in ("split", "gain"):
        a, b = bt.feature_importance(it), bj.feature_importance(it)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert bt.feature_importance("split").sum() == sum(
        t.num_leaves - 1 for t in bt._get_trees())
    assert bt.dump_model() == bj.dump_model()
    trees = bt._get_trees()
    kw = dict(num_class=bt.dump_model()["num_class"],
              num_tree_per_iteration=bt.num_model_per_iteration(),
              max_feature_idx=bt.num_feature() - 1,
              objective_str=bt.dump_model()["objective"],
              feature_names=bt.feature_name())
    assert TIO.model_to_json(trees, **kw) == JIO.model_to_json(
        bj._get_trees(), **kw)
    k = bt.num_model_per_iteration()
    assert TIO.model_to_cpp(trees, num_tree_per_iteration=k) == \
        JIO.model_to_cpp(bj._get_trees(), num_tree_per_iteration=k)
    pd.testing.assert_frame_equal(bt.trees_to_dataframe(),
                                  bj.trees_to_dataframe())
    assert bt.upper_bound() == bj.upper_bound()
    assert bt.lower_bound() == bj.lower_bound()
    f = int(np.argmax(bt.feature_importance("split")))
    for kw in ({}, dict(bins=7), dict(xgboost_style=True)):
        a, b = bt.get_split_value_histogram(f, **kw), \
            bj.get_split_value_histogram(f, **kw)
        if isinstance(a, tuple):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
        else:
            np.testing.assert_array_equal(a, b)
    name_f = bt.feature_name()[f]
    np.testing.assert_array_equal(bt.get_split_value_histogram(name_f)[0],
                                  bj.get_split_value_histogram(name_f)[0])
    for tid, lid in ((0, 0), (len(trees) - 1, trees[-1].num_leaves - 1)):
        assert bt.get_leaf_output(tid, lid) == bj.get_leaf_output(tid, lid)


def test_trees_to_dataframe_structure():
    _, bt, X, _ = _pair("regression", rounds=3)
    df = bt.trees_to_dataframe()
    assert set(df.tree_index.unique()) == {0, 1, 2}
    t0 = df[df.tree_index == 0]
    splits, leaves = t0[t0.split_feature.notna()], t0[t0.split_feature.isna()]
    assert len(leaves) == len(splits) + 1
    assert leaves["count"].sum() == len(X)
    for _, r in splits.iterrows():
        for child in (r.left_child, r.right_child):
            assert (t0[t0.node_index == child].parent_index
                    == r.node_index).all()


def _metric_of(bst, X, y):
    raw = bst.predict(X, raw_score=True)
    return float(np.mean((raw - y) ** 2))


@pytest.mark.parametrize("edit", ["set_leaf_output", "merge_models",
                                  "shuffle_models"])
def test_model_edits_match_jax(edit):
    bj, bt, X, y = _pair("regression", rounds=6, metric="l2")
    oj, ot, _, _ = _pair("regression", rounds=3, metric="l2",
                         learning_rate=0.3)
    for b, o in ((bj, oj), (bt, ot)):
        if edit == "set_leaf_output":
            b.set_leaf_output(2, 1, b.get_leaf_output(2, 1) + 0.25)
        elif edit == "merge_models":
            b.merge_models(o)
        else:
            b.shuffle_models(1, 5)
    assert _head(bt) == _head(bj)
    if edit == "merge_models":
        assert bt.num_trees() == 9 and bt.current_iteration() == 9
        # the merged trees are copies
        for o in (ot, oj):
            o.set_leaf_output(0, 0, 123.0)
        assert bt.get_leaf_output(6, 0) != 123.0
    (_, name, val, _), = bt.eval_train()
    assert name == "l2"
    if edit != "merge_models":
        # a merged model's folded boost-from-average bias stays out of the
        # score cache, in both packages
        np.testing.assert_allclose(val, _metric_of(bt, X, y), rtol=1e-5)
    (_, _, vj, _), = bj.eval_train()
    np.testing.assert_allclose(val, vj, rtol=1e-6)
    # a loaded model's edits
    lt = lgb_torch.Booster(model_str=ot.model_to_string())
    lj = lgb_jax.Booster(model_str=oj.model_to_string())
    for b in (lt, lj):
        b.merge_models(b)
        b.shuffle_models()
        b.set_leaf_output(1, 0, -1.5)
    assert lt.model_to_string() == lj.model_to_string()


def test_edits_rebuild_valid_scores_and_linear_leaves():
    X, y = _data()
    p = dict(INT8, objective="regression", metric="l2", **CPU)
    ds = lgb_torch.Dataset(X[:2000], y[:2000], params=p)
    dv = ds.create_valid(X[2000:], label=y[2000:])
    b = lgb_torch.train(p, ds, 4, valid_sets=[dv], valid_names=["v"])
    b.set_leaf_output(0, 0, 3.0)
    want = b.predict(X[2000:], raw_score=True)
    np.testing.assert_allclose(
        b._gbdt.valid_scores[0][:, 0].numpy(), want, rtol=1e-5, atol=1e-5)
    # linear leaves: the rebuild adds const + coeff . raw
    pl = dict(num_leaves=7, linear_tree=True, verbosity=-1, **CPU)
    bl = lgb_torch.train(pl, lgb_torch.Dataset(X, y, params=pl), 3)
    before = bl._gbdt.scores.clone()
    bl._gbdt.invalidate_score_cache()
    np.testing.assert_allclose(bl._gbdt.scores.numpy(), before.numpy(),
                               rtol=1e-5, atol=1e-5)
    bl.set_leaf_output(1, 0, 0.5)
    np.testing.assert_allclose(bl._gbdt.scores[:, 0].numpy(),
                               bl.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("linear", [False, True])
def test_merged_text_model_rebuild_and_device_predict(linear, monkeypatch):
    """A model read from text has real thresholds only.  Merged into a
    trained booster (after a leaf edit), its trees are binned by the
    training set's mappers: the rebuilt scores on the training rows and on
    a valid set (a linear model's through the linear scores kernel's plain
    version) and the device predict path equal the host walk's raw
    scores; 5% NaN makes rows of a linear leaf's features take the plain
    leaf value.  (The JAX package walks such trees as bin 0.)"""
    X, y = _data(n=3000)
    p = dict(num_leaves=7, linear_tree=linear, metric="l2", verbosity=-1,
             **CPU)
    ds = lgb_torch.Dataset(X[:2000], y[:2000], params=p)
    dv = ds.create_valid(X[2000:], label=y[2000:])
    b = lgb_torch.train(p, ds, 3, valid_sets=[dv], valid_names=["v"])
    g = b._gbdt
    assert all(t.is_linear == linear for t in g.models)
    assert (g._valid_raw[0] is not None) == linear
    b.set_leaf_output(2, 1, b.get_leaf_output(2, 1) - 0.25)
    b.merge_models(lgb_torch.Booster(model_str=b.model_to_string()))
    assert b.num_trees() == 6
    host = b.predict(X, raw_score=True)
    for rows, sc in ((slice(0, 2000), g.scores),
                     (slice(2000, None), g.valid_scores[0])):
        np.testing.assert_allclose(sc[:, 0].numpy(), host[rows],
                                   rtol=1e-5, atol=1e-5)
    monkeypatch.setattr(TGBDT, "DEVICE_PREDICT_MIN_WORK", 0)
    np.testing.assert_allclose(b.predict(X, raw_score=True), host,
                               rtol=2e-5, atol=2e-6)


def test_model_from_string_and_accessors():
    _, bt, X, y = _pair("binary", rounds=4, metric="binary_logloss")
    s = bt.model_to_string()
    other = lgb_torch.Booster(model_str=s)
    other.model_from_string(s)
    assert other._gbdt is None and other.train_set is None
    np.testing.assert_allclose(other.predict(X[:50]), bt.predict(X[:50]),
                               rtol=1e-5, atol=1e-7)
    bt.set_train_data_name("train0")
    assert bt.eval_train()[0][0] == "train0"
    bt.free_dataset()
    assert bt.train_set is None
    raw = bt.predict(X, raw_score=True)
    assert raw.max() <= bt.upper_bound() + 1e-9
    assert raw.min() >= bt.lower_bound() - 1e-9
    for call in (lambda: bt.set_network("127.0.0.1:12400"),
                 bt.free_network, bt.prometheus_text):
        with pytest.raises(lgb_torch.LightGBMError, match="item [68]"):
            call()


@pytest.mark.parametrize("kind", ["binary", "multiclass", "golden-rank"])
def test_loaded_booster_eval_matches_jax(kind):
    if kind == "golden-rank":
        bj, bt = _golden("model_ref_rank.txt")
        rng = np.random.default_rng(2)
        X = rng.normal(size=(600, bt.num_feature()))
        y = rng.integers(0, 4, size=600).astype(float)
        kw = dict(group=np.full(30, 20))
        params = dict(metric="ndcg", eval_at=[3, 5])
    else:
        bj, bt, X, y = _pair(kind, rounds=4)
        bj = lgb_jax.Booster(model_str=bj.model_to_string())
        bt = lgb_torch.Booster(model_str=bt.model_to_string())
        kw = dict(init_score=np.full(len(y) * (3 if kind == "multiclass"
                                               else 1), 0.1))
        params = {}
    bt.params.update(params)
    bj.params.update(params)

    def feval(preds, data):
        return "mean_pred", float(np.mean(preds)), False

    vt = bt.eval(lgb_torch.Dataset(X, y, free_raw_data=False, **kw), "v",
                 feval=feval)
    vj = bj.eval(lgb_jax.Dataset(X, y, free_raw_data=False, **kw), "v",
                 feval=feval)
    assert [r[:2] for r in vt] == [r[:2] for r in vj] and len(vt) >= 2
    np.testing.assert_allclose([r[2] for r in vt], [r[2] for r in vj],
                               rtol=1e-6)
    assert [r[3] for r in vt] == [r[3] for r in vj]


@pytest.mark.parametrize("loop", ["fused", "classic"])
def test_reset_training_data_matches_jax(loop, monkeypatch):
    """5 rounds on 2,500 rows, ``reset_training_data`` to a 1,500-row
    subset of the same binning, 3 more rounds: the int8 text equals the
    JAX package's; the fused loop's equals the classic loop's."""
    X, y = _data()
    p = dict(INT8, objective="regression", metric="l2")
    idx = np.arange(0, len(y), 5)
    idx = np.sort(np.concatenate([idx, np.arange(1, len(y), 2)]))[:1500]
    if loop == "classic":
        monkeypatch.setattr(TGBDT, "supports_fused", lambda self: False)
    out = {}
    for name, lgb in (("jax", lgb_jax), ("torch", lgb_torch)):
        pp = dict(p, **CPU) if name == "torch" else p
        ds = lgb.Dataset(X, y, params=pp, free_raw_data=False)
        b = lgb.train(pp, ds, 5, keep_training_booster=True)
        sub = ds.subset(idx)
        b.reset_training_data(sub)
        assert b.train_set is sub and b._gbdt.train_set.num_data == 1500
        for _ in range(3):
            b.update()
        out[name] = b
    bt, bj = out["torch"], out["jax"]
    assert bt.num_trees() == 8
    assert _head(bt) == _head(bj)
    np.testing.assert_allclose(bt._gbdt.scores.numpy(),
                               np.asarray(bj._gbdt.scores), rtol=1e-6,
                               atol=1e-6)
    # more rounds through train() on the reset booster's data: the fused
    # loop (where it runs) captures afresh over the new rows
    g = bt._gbdt
    assert g._fused_cache == {}
    if loop == "fused":
        assert g.supports_fused()
        g.train_fused(2)
        assert len(g._fused_cache) == 1
        fr = next(iter(g._fused_cache.values()))
        assert fr.g.scores is g.scores
    else:
        bt.update()
        bt.update()


def test_reset_training_data_fused_equals_classic(monkeypatch):
    X, y = _data()
    p = dict(INT8, objective="regression", **CPU)
    texts = []
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(TGBDT, "supports_fused", lambda self: False)
        ds = lgb_torch.Dataset(X, y, params=p, free_raw_data=False)
        b = lgb_torch.train(p, ds, 4)
        b.update(train_set=ds.subset(np.arange(0, len(y), 2)))
        g = b._gbdt
        if fused:
            g.train_fused(3)
        else:
            for _ in range(3):
                g.train_one_iter()
        texts.append(_head(b))
    assert texts[0] == texts[1]


def test_reset_training_data_refusals():
    X, y = _data()
    p = dict(INT8, objective="regression", **CPU)
    b = lgb_torch.train(p, lgb_torch.Dataset(X, y, params=p), 2)
    other = lgb_torch.Dataset(X * 3.0 + 1.0, y, params=dict(max_bin=7))
    with pytest.raises(lgb_torch.LightGBMError, match="bin mappers"):
        b.reset_training_data(other)
    loaded = lgb_torch.Booster(model_str=b.model_to_string())
    with pytest.raises(lgb_torch.LightGBMError):
        loaded.reset_training_data(lgb_torch.Dataset(X, y, params=p))
