"""The port's input surfaces against lightgbm_tpu on the same seeded inputs.

* ``load_text_file``: CSV, TSV and LibSVM, with and without a header, the
  label / weight / group columns by index and by ``name:``, the accepted
  and ignored ``ignore_column``, the companion files: the same float64
  values bit for bit (NaN where a field is empty);
* sparse (scipy CSR / CSC) construction without a dense matrix: mappers,
  ``used_feature_idx``, the EFB plan and the bins element for element, with
  a small ``bin_construct_sample_cnt``, ``max_bin_by_feature`` and forced
  bins; sparse valid sets against sparse, dense and categorical
  references; a 60,000 x 2,048 one-hot case that fails if construction
  calls ``toarray`` / ``todense``;
* pandas (categorical auto, valid alignment, the model text's
  ``pandas_categorical`` round trip), Arrow (the direct numeric path and
  the dictionary path), a datatable stand-in, ``Sequence`` and a list of
  them;
* binary datasets written by each package and loaded by the other (EFB
  bundles, weights, groups, init score, positions, raw columns) and a
  newer ``format_version`` refused; ``add_features_from``;
  ``serialize_reference`` bytes across the packages;
* CSR prediction in row blocks (the block size patched small) equal to
  dense prediction;
* int8 model text (the batched int8 learner, regression: exact
  gradients) from a file, from CSR and from pandas equal to the JAX
  package's.
"""

import json
import sys
import types

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp

import lightgbm_tpu as lgb_jax
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io import parser as JP

import lightgbm_tpu_torch as lgb_torch
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io import dataset as TD
from lightgbm_tpu_torch.io import parser as TP

from test_torch_fused import one_torch_thread  # noqa: F401

#: the batched int8 learner at a small size (tests/test_torch_train.py's
#: slice): its regression text equals the JAX package's byte for byte
INT8 = dict(num_leaves=15, max_bin=63, tpu_split_batch=4,
            use_quantized_grad=True, tpu_hist_dtype="int8",
            quant_train_renew_leaf=True, stochastic_rounding=False,
            hist_kernel="onehot", min_data_in_leaf=5, verbosity=-1)
CPU = dict(device_type="cpu")


def _head(bst):
    """Model text up to the parameters block (where only the port's
    explicit ``device_type`` differs)."""
    return bst.model_to_string().split("parameters:")[0]


def _both_train(params, jdata, tdata, label, rounds=4, **kw):
    bj = lgb_jax.train(params, lgb_jax.Dataset(jdata, label, params=params,
                                               **kw), rounds)
    bt = lgb_torch.train(dict(params, **CPU),
                         lgb_torch.Dataset(tdata, label, params=params,
                                           **kw), rounds)
    return bj, bt


def _same_mappers(td, jd):
    assert len(td.mappers) == len(jd.mappers)
    for tm, jm in zip(td.mappers, jd.mappers):
        assert tm.to_dict() == jm.to_dict()


def _same_inner(td, jd):
    _same_mappers(td, jd)
    assert td.used_feature_idx == jd.used_feature_idx
    np.testing.assert_array_equal(td.bins, jd.bins)
    assert td.bins.dtype == jd.bins.dtype == np.uint8
    assert td.feature_names == jd.feature_names
    tp, jp = td.bundle_plan, jd.bundle_plan
    assert (tp is None) == (jp is None)
    if tp is not None:
        assert tp.bundles == jp.bundles
        for field in ("feat_col", "src_idx", "valid", "default_bin",
                      "inv_table"):
            np.testing.assert_array_equal(getattr(tp, field),
                                          getattr(jp, field))
    for f in ("label", "weight", "init_score", "query_boundaries",
              "position"):
        a, b = getattr(td.metadata, f), getattr(jd.metadata, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ text files
def _table(n=300, seed=0):
    """label, weight, query id, then 5 features; NaN holes in feature 2."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5)) * 10.0 ** rng.integers(-3, 4, size=5)
    X[rng.random(n) < 0.1, 2] = np.nan
    y = (X[:, 0] > 0).astype(float)
    w = rng.uniform(0.5, 2.0, size=n)
    q = np.repeat(np.arange(n // 10), 10).astype(float)
    return np.column_stack([y, w, q, X])


def _write_delimited(path, M, sep, header):
    lines = []
    if header:
        lines.append(sep.join(["y", "w", "qid"] + [f"f{i}" for i in
                                                   range(M.shape[1] - 3)]))
    for row in M:
        lines.append(sep.join("" if np.isnan(v) else repr(float(v))
                              for v in row))
    path.write_text("\n".join(lines) + "\n")


TEXT_CASES = {
    "csv": dict(fmt="csv"),
    "csv-header": dict(fmt="csv", header=True),
    "tsv": dict(fmt="tsv"),
    "csv-columns-by-index": dict(fmt="csv", weight_column="1",
                                 group_column="2"),
    "csv-columns-by-name": dict(fmt="csv", header=True, label_column="name:y",
                                weight_column="name:w",
                                group_column="name:qid"),
    "tsv-label-last-by-name": dict(fmt="tsv", header=True,
                                   label_column="name:f4"),
    "csv-ignore-column": dict(fmt="csv", ignore_column="3"),
    "csv-companions": dict(fmt="csv", companions=True),
    "libsvm": dict(fmt="libsvm"),
    "libsvm-companions": dict(fmt="libsvm", companions=True),
}


def _write_case(tmp_path, name):
    spec = dict(TEXT_CASES[name])
    fmt = spec.pop("fmt")
    companions = spec.pop("companions", False)
    M = _table()
    path = tmp_path / f"data.{fmt}"
    if fmt == "libsvm":
        rows = []
        for r in M:
            pairs = " ".join(f"{j + 1}:{float(v)!r}"
                             for j, v in enumerate(r[3:])
                             if v != 0 and not np.isnan(v))
            rows.append(f"{r[0]:g} {pairs}")
        path.write_text("\n".join(rows) + "\n")
    else:
        _write_delimited(path, M, "\t" if fmt == "tsv" else ",",
                         spec.get("header", False))
    if companions:
        np.savetxt(str(path) + ".weight", M[:, 1])
        np.savetxt(str(path) + ".query", np.full(len(M) // 10, 10),
                   fmt="%d")
        np.savetxt(str(path) + ".init", np.linspace(-1, 1, len(M)))
        np.savetxt(str(path) + ".position", np.arange(len(M)) % 10,
                   fmt="%d")
    return path, spec


@pytest.mark.parametrize("name", list(TEXT_CASES))
def test_load_text_file_matches_jax(tmp_path, name):
    path, spec = _write_case(tmp_path, name)
    aj, lj, mj = JP.load_text_file(str(path), JConfig(spec))
    at, lt, mt = TP.load_text_file(str(path), TConfig(spec))
    assert at.dtype == aj.dtype == np.float64
    np.testing.assert_array_equal(at, aj)          # NaN-aware, exact
    assert np.isnan(at).any() == (name.startswith("csv") or name == "tsv"
                                  or "label-last" in name)
    np.testing.assert_array_equal(lt, lj)
    assert sorted(mt) == sorted(mj)
    for k in mj:
        np.testing.assert_array_equal(mt[k], mj[k])
        assert mt[k].dtype == mj[k].dtype
    # the Dataset built from the path: the same bins, label and metadata
    params = dict(spec, verbosity=-1)
    dj = lgb_jax.Dataset(str(path), params=params).construct()._inner
    dt = lgb_torch.Dataset(str(path), params=params).construct()._inner
    _same_inner(dt, dj)


def test_parser_stripes_and_helpers_match_jax(tmp_path):
    path, _ = _write_case(tmp_path, "csv")
    tj = list(JP.iter_stripe_texts(str(path), 1000))
    tt = list(TP.iter_stripe_texts(str(path), 1000))
    assert tt == tj and len(tt) > 3
    assert all(t.endswith("\n") for _, t in tt)
    off = tt[2][0]
    assert list(TP.iter_stripe_texts(str(path), 1000, start_offset=off)) \
        == tj[2:]
    qid = np.array([3, 3, 1, 1, 1, 7, 3])
    np.testing.assert_array_equal(TP.qid_to_group_sizes(qid),
                                  JP.qid_to_group_sizes(qid))
    assert TP.parse_delimited_stripe("  \n", ",") is None
    np.testing.assert_array_equal(TP.parse_delimited_stripe("1,,3\n", ","),
                                  JP.parse_delimited_stripe("1,,3\n", ","))
    with pytest.raises(lgb_torch.LightGBMError):
        TP.load_text_file(str(path), TConfig(dict(header=True,
                                                  label_column="name:zz")))


def test_csv_of_a_matrix_parses_exactly(tmp_path):
    """A matrix written with '%.17g' parses to the same float64 values, so
    a model trained from the file equals the in-memory model."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(2000, 6)) * np.array([1e-7, 1, 1e3, 1e-300, 7, 1])
    y = X[:, 1] + 0.1 * rng.normal(size=2000)
    path = tmp_path / "m.csv"
    np.savetxt(path, np.column_stack([y, X]), fmt="%.17g", delimiter=",")
    arr, lab, _ = TP.load_text_file(str(path), TConfig({}))
    np.testing.assert_array_equal(arr, X)
    np.testing.assert_array_equal(lab, y)
    p = dict(INT8, objective="regression", **CPU)
    b_file = lgb_torch.train(p, lgb_torch.Dataset(str(path), params=p), 3)
    b_mem = lgb_torch.train(p, lgb_torch.Dataset(X, y, params=p), 3)
    assert b_file.model_to_string() == b_mem.model_to_string()


# --------------------------------------------------------------- sparse
def _sparse(n=3000, f=40, density=0.08, seed=1):
    rng = np.random.default_rng(seed)
    M = sp.random(n, f, density=density, random_state=seed, format="csr",
                  data_rvs=lambda k: rng.normal(size=k))
    y = np.asarray(M[:, 0].todense()).ravel() + 0.5 * np.asarray(
        M[:, 3].todense()).ravel() + 0.1 * rng.normal(size=n)
    return M, y


def _onehot_sparse(n=4000, n_vars=6, card=12, seed=2):
    rng = np.random.default_rng(seed)
    cats = rng.integers(0, card, size=(n, n_vars))
    rows = np.repeat(np.arange(n), n_vars)
    cols = (np.arange(n_vars)[None, :] * card + cats).ravel()
    vals = rng.integers(1, 4, size=n * n_vars).astype(np.float64)
    X = sp.csr_matrix((vals, (rows, cols)), shape=(n, n_vars * card))
    y = (cats[:, 0] % 3 == 0) + 0.3 * rng.normal(size=n)
    return X, y


def _forced_bins_file(tmp_path):
    f = tmp_path / "forced_bins.json"
    f.write_text(json.dumps([{"feature": 1, "bin_upper_bound": [-0.5, 0.0,
                                                                0.25]},
                             {"feature": 5, "bin_upper_bound": [0.1]}]))
    return str(f)


SPARSE_CASES = ["csr", "csc", "onehot-csr", "onehot-csc", "sample-cnt",
                "max-bin-by-feature", "forced-bins", "no-bundle"]


@pytest.mark.parametrize("case", SPARSE_CASES)
def test_from_sparse_matches_jax(case, tmp_path):
    X, y = _onehot_sparse() if case.startswith("onehot") else _sparse()
    if case.endswith("csc"):
        X = X.tocsc()
    params = {"max_bin": 63, "verbosity": -1}
    if case == "sample-cnt":
        params["bin_construct_sample_cnt"] = 50
    elif case == "max-bin-by-feature":
        params["max_bin_by_feature"] = [7, 3, 255] + [15] * 37
    elif case == "forced-bins":
        params["forcedbins_filename"] = _forced_bins_file(tmp_path)
    elif case == "no-bundle":
        params["enable_bundle"] = False
    dj = lgb_jax.Dataset(X, y, params=params).construct()._inner
    dt = lgb_torch.Dataset(X, y, params=params).construct()._inner
    _same_inner(dt, dj)
    assert dt.device_n_bins() == dj.device_n_bins()
    if case.startswith("onehot"):
        assert dt.bundle_plan is not None and \
            dt.bundle_plan.num_bundles < X.shape[1] // 3
    if case == "no-bundle":
        assert dt.bundle_plan is None


@pytest.mark.parametrize("ref", ["sparse", "dense", "categorical"])
def test_sparse_valid_set_matches_jax(ref):
    rng = np.random.default_rng(7)
    n, f = 2500, 12
    dense = rng.normal(size=(n, f))
    dense[rng.random((n, f)) < 0.6] = 0.0
    dense[:, 5:9][rng.random((n, 4)) < 0.5] = 5.0   # default bin != zero bin
    cats = rng.choice([0, 1, 2, 3, 4], size=n, p=[0.1, 0.4, 0.3, 0.1, 0.1])
    dense[:, 3] = cats
    y = dense[:, 0] + (cats == 1)
    kw = dict(categorical_feature=[3]) if ref == "categorical" else {}
    params = {"max_bin": 63, "verbosity": -1}
    tr = sp.csr_matrix(dense[:2000]) if ref == "sparse" else dense[:2000]
    jtr = lgb_jax.Dataset(tr, y[:2000], params=params, **kw)
    ttr = lgb_torch.Dataset(tr, y[:2000], params=params, **kw)
    va = sp.csr_matrix(dense[2000:])
    jv = jtr.create_valid(va, label=y[2000:]).construct()._inner
    tv = ttr.create_valid(va, label=y[2000:]).construct()._inner
    _same_inner(tv, jv)
    # and equal to the port's own dense-built valid set
    td = ttr.create_valid(dense[2000:], label=y[2000:]).construct()._inner
    np.testing.assert_array_equal(tv.bins, td.bins)


def test_wide_sparse_never_densifies(monkeypatch):
    """60,000 x 2,048 one-hot columns (128 variables of 16 categories):
    construction and a valid set must not call toarray / todense (the
    dense float64 matrix would be 1 GB); EFB compresses the columns; the
    result equals the JAX package's."""
    rng = np.random.default_rng(0)
    n, n_vars, card = 60_000, 128, 16
    cats = rng.integers(0, card, size=(n, n_vars))
    rows = np.repeat(np.arange(n), n_vars)
    cols = (np.arange(n_vars)[None, :] * card + cats).ravel()
    vals = rng.integers(1, 8, size=n * n_vars).astype(np.float64)
    X = sp.csr_matrix((vals, (rows, cols)), shape=(n, n_vars * card))
    y = (cats[:, 0] % 2).astype(float)
    params = {"max_bin": 63, "verbosity": -1}
    dj = lgb_jax.Dataset(X, y, params=params).construct()._inner

    def refuse(self, *a, **k):
        raise AssertionError("sparse input was made dense")

    for cls in (sp.csr_matrix, sp.csc_matrix, sp.coo_matrix,
                sp.csr_array, sp.csc_array):
        monkeypatch.setattr(cls, "toarray", refuse)
        monkeypatch.setattr(cls, "todense", refuse)
    ds = lgb_torch.Dataset(X, y, params=params)
    dt = ds.construct()._inner
    assert dt.bins.shape == (n, dt.bundle_plan.num_bundles)
    assert dt.bins.shape[1] < X.shape[1] // 3
    dv = ds.create_valid(X[:5000], label=y[:5000]).construct()._inner
    monkeypatch.undo()
    np.testing.assert_array_equal(dt.bins, dj.bins)
    assert dt.bundle_plan.bundles == dj.bundle_plan.bundles
    np.testing.assert_array_equal(dv.bins, dt.bins[:5000])


def test_sparse_refusals():
    X, y = _sparse()
    with pytest.raises(lgb_torch.LightGBMError):
        lgb_torch.Dataset(X, y, params={"linear_tree": True}).construct()
    with pytest.raises(lgb_torch.LightGBMError):
        lgb_torch.Dataset(X, y, categorical_feature=[0]).construct()


# --------------------------------------------------- pandas, arrow, etc.
@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(0)
    n = 1500
    df = pd.DataFrame({
        "num1": rng.normal(size=n),
        "num2": rng.normal(size=n),
        "color": pd.Categorical(rng.choice(["red", "green", "blue"], size=n)),
        "size": pd.Categorical(rng.choice(["s", "m", "l", "xl"], size=n)),
    })
    y = (df["num1"] + 2.0 * (df["color"] == "red")
         - (df["size"] == "xl")).to_numpy(float)
    return df, y


def test_pandas_categorical_matches_jax(frame):
    df, y = frame
    p = dict(INT8, objective="regression")
    bj, bt = _both_train(p, df, df, y)
    assert bt._gbdt.train_set.categorical_array().any()
    assert bt.pandas_categorical == bj.pandas_categorical == \
        [["blue", "green", "red"], ["l", "m", "s", "xl"]]
    assert bt.feature_name() == ["num1", "num2", "color", "size"]
    assert _head(bt) == _head(bj)
    assert "pandas_categorical:[[" in bt.model_to_string()
    # permuted category order at predict time changes nothing
    df2 = df.copy()
    df2["color"] = df2["color"].cat.reorder_categories(
        ["blue", "red", "green"])
    np.testing.assert_array_equal(bt.predict(df2), bt.predict(df))
    np.testing.assert_allclose(bt.predict(df), bj.predict(df), rtol=1e-6,
                               atol=1e-9)


def test_pandas_valid_alignment_and_text_roundtrip(frame, tmp_path):
    df, y = frame
    p = dict(INT8, objective="regression", metric="l2")
    dfv = df.iloc[:400].copy()
    dfv["color"] = pd.Categorical(dfv["color"].astype(str),
                                  categories=["green", "blue", "red"])
    dfv.loc[dfv.index[:5], "size"] = np.nan
    out = {}
    for name, lgb in (("jax", lgb_jax), ("torch", lgb_torch)):
        ds = lgb.Dataset(df, y, params=p)
        dv = ds.create_valid(dfv, label=y[:400])
        rec = {}
        pp = dict(p, **CPU) if name == "torch" else p
        bst = lgb.train(pp, ds, 4, valid_sets=[dv], valid_names=["v"],
                        callbacks=[lgb.record_evaluation(rec)])
        out[name] = (bst, rec, dv.construct()._inner.bins)
    np.testing.assert_array_equal(out["torch"][2], out["jax"][2])
    np.testing.assert_allclose(out["torch"][1]["v"]["l2"],
                               out["jax"][1]["v"]["l2"], rtol=1e-6)
    bt = out["torch"][0]
    f = tmp_path / "m.txt"
    bt.save_model(str(f))
    loaded = {}
    for loader in (lgb_torch, lgb_jax):
        lb = loaded[loader] = loader.Booster(model_file=str(f))
        assert lb.pandas_categorical == bt.pandas_categorical
        # rows 5 on (no NaN category): a loaded model text carries no
        # categorical node's NaN side, in either package
        np.testing.assert_allclose(lb.predict(dfv)[5:], bt.predict(dfv)[5:],
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(loaded[lgb_torch].predict(dfv),
                                  loaded[lgb_jax].predict(dfv))
    # an unseen category maps to NaN (missing)
    dfu = df.iloc[:3].copy()
    dfu["color"] = pd.Categorical(["purple", "red", "purple"])
    nan_row = df.iloc[:3].copy()
    nan_row["color"] = pd.Categorical([np.nan, "red", np.nan],
                                      categories=["red"])
    np.testing.assert_array_equal(bt.predict(dfu), bt.predict(nan_row))


def test_arrow_both_paths_match_jax(frame):
    import pyarrow as pa
    df, y = frame
    p = dict(INT8, objective="regression")
    num = pa.Table.from_pandas(df[["num1", "num2"]])
    c = pa.chunked_array([pa.array([1.0, None] + list(df["num1"][2:700])),
                          pa.array(df["num1"][700:].to_numpy())])
    num = num.set_column(0, "num1", c)
    dic = pa.Table.from_pandas(df)            # dictionary columns: pandas
    assert any(pa.types.is_dictionary(f.type) for f in dic.schema)
    for table in (num, dic):
        bj, bt = _both_train(p, table, table, y)
        assert _head(bt) == _head(bj)
        np.testing.assert_allclose(bt.predict(table), bj.predict(table),
                                   rtol=1e-6, atol=1e-9)
    # the direct path equals the matrix it holds
    arr, names, _, _ = __import__("lightgbm_tpu_torch.basic", fromlist=["x"]) \
        ._coerce_data(num, "auto")
    assert names == ["num1", "num2"] and np.isnan(arr[1, 0])


def test_datatable_stub_and_sequences_match_numpy():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(900, 4))
    X[::17, 2] = np.nan
    y = np.nan_to_num(X[:, 0]) + 0.1 * rng.normal(size=900)
    p = dict(INT8, objective="regression", **CPU)
    base = lgb_torch.train(p, lgb_torch.Dataset(
        X, y, params=p, feature_name=["a", "b", "c", "d"]), 3)

    dt_mod = types.ModuleType("datatable")

    class Frame:
        def __init__(self, arr, names):
            self._arr = np.ma.masked_invalid(arr)
            self.names = tuple(names)

        def to_numpy(self):
            return self._arr

    Frame.__module__ = "datatable"
    dt_mod.Frame = Frame
    sys.modules.setdefault("datatable", dt_mod)
    try:
        b = lgb_torch.train(p, lgb_torch.Dataset(
            Frame(X, ["a", "b", "c", "d"]), y, params=p), 3)
    finally:
        sys.modules.pop("datatable", None)
    assert b.model_to_string() == base.model_to_string()

    class NpSeq(lgb_torch.Sequence):
        batch_size = 128

        def __init__(self, arr):
            self.arr = arr

        def __getitem__(self, idx):
            return self.arr[idx]

        def __len__(self):
            return len(self.arr)

    fn = ["a", "b", "c", "d"]
    for data in (NpSeq(X), [NpSeq(X[:333]), NpSeq(X[333:])]):
        b = lgb_torch.train(p, lgb_torch.Dataset(data, y, params=p,
                                                 feature_name=fn), 3)
        assert b.model_to_string() == base.model_to_string()


# ------------------------------------------------------- binary datasets
def _rich_dataset(lgb, linear=False):
    rng = np.random.default_rng(0)
    n = 1500
    idx = rng.integers(0, 8, size=n)
    X = np.zeros((n, 10))
    X[np.arange(n), idx] = rng.normal(1.0, 0.1, size=n)   # bundleable
    X[:, 8:] = rng.normal(size=(n, 2))
    y = (idx % 2) + X[:, 8]
    params = {"verbosity": -1, "max_bin": 63}
    if linear:
        params["linear_tree"] = True
    ds = lgb.Dataset(X, y, weight=rng.random(n) + 0.5,
                     group=np.full(n // 15, 15),
                     init_score=np.linspace(-0.5, 0.5, n),
                     position=np.arange(n) % 15, params=params)
    return ds.construct(), X, y


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("linear", [False, True], ids=["bundled", "raw"])
def test_binary_dataset_across_packages(tmp_path, writer, linear):
    dsj, X, y = _rich_dataset(lgb_jax, linear)
    dst, _, _ = _rich_dataset(lgb_torch, linear)
    _same_inner(dst._inner, dsj._inner)
    f = tmp_path / "d.bin"
    (dsj if writer == "jax" else dst).save_binary(str(f))
    lj = lgb_jax.Dataset(str(f)).construct()._inner
    lt = lgb_torch.Dataset(str(f)).construct()._inner
    _same_inner(lt, lj)
    _same_inner(lt, dst._inner)
    assert lt.bundle_plan is not None
    assert (lt.raw is not None) == linear
    if linear:
        np.testing.assert_array_equal(lt.raw, dst._inner.raw)
    # training from the loaded file equals training from the original
    p = dict(INT8, objective="regression", **CPU)
    b0 = lgb_torch.train(p, dst, 3)
    b1 = lgb_torch.train(p, lgb_torch.Dataset(str(f), params=p), 3)
    assert b1.model_to_string() == b0.model_to_string()


def test_binary_dataset_version_and_overrides(tmp_path):
    ds, X, y = _rich_dataset(lgb_torch)
    f = tmp_path / "d.bin"
    ds.save_binary(str(f))
    z = dict(np.load(str(f), allow_pickle=True))
    assert int(z["format_version"]) == TD.BINARY_FORMAT_VERSION == 2
    assert int(z["lgbtpu_dataset"]) == 1
    z["format_version"] = np.int64(TD.BINARY_FORMAT_VERSION + 1)
    newer = tmp_path / "newer.bin"
    with open(newer, "wb") as fh:
        np.savez_compressed(fh, **z)
    for lgb in (lgb_torch, lgb_jax):
        with pytest.raises(lgb.LightGBMError, match="format version"):
            lgb.Dataset(str(newer)).construct()
    # the constructor's label replaces the file's; no init_model from bins
    d2 = lgb_torch.Dataset(str(f), label=np.zeros(len(y))).construct()
    assert not d2.get_label().any()
    b = lgb_torch.train(dict(INT8, objective="regression", **CPU), ds, 2)
    d3 = lgb_torch.Dataset(str(f))
    d3._apply_predictor(b)
    with pytest.raises(lgb_torch.LightGBMError):
        d3.construct()


def test_add_features_and_serialized_reference():
    rng = np.random.default_rng(5)
    A, B = rng.normal(size=(800, 3)), rng.normal(size=(800, 2))
    y = A[:, 0] + B[:, 1]
    p = {"verbosity": -1, "enable_bundle": False}
    out = {}
    for name, lgb in (("jax", lgb_jax), ("torch", lgb_torch)):
        da = lgb.Dataset(A, y, params=p).construct()
        db = lgb.Dataset(B, y, params=p).construct()
        da.add_features_from(db)
        out[name] = da
    _same_inner(out["torch"]._inner, out["jax"]._inner)
    assert out["torch"].num_feature() == 5
    whole = lgb_torch.Dataset(np.column_stack([A, B]), y,
                              params=p).construct()._inner
    np.testing.assert_array_equal(out["torch"]._inner.bins, whole.bins)
    np.testing.assert_array_equal(out["torch"]._inner.packed_mirror(),
                                  whole.packed_mirror())
    bundled = lgb_torch.Dataset(_onehot_sparse()[0], params={}).construct()
    with pytest.raises(ValueError):
        bundled.add_features_from(lgb_torch.Dataset(
            rng.normal(size=(4000, 1)), params={}))
    # the serialized reference: the same bytes, loadable across packages
    ref_j = lgb_jax.Dataset(A, y, params={"max_bin": 31}).construct()
    ref_t = lgb_torch.Dataset(A, y, params={"max_bin": 31}).construct()
    raw = ref_t.serialize_reference()
    assert raw == ref_j.serialize_reference()
    for src in (raw, ref_j.serialize_reference()):
        rt = lgb_torch.Dataset.deserialize_reference(src)
        rj = lgb_jax.Dataset.deserialize_reference(src)
        vt = rt.create_valid(A[:100] * 1.5, label=y[:100]).construct()
        vj = rj.create_valid(A[:100] * 1.5, label=y[:100]).construct()
        np.testing.assert_array_equal(vt._inner.bins, vj._inner.bins)
        np.testing.assert_array_equal(
            vt._inner.bins, ref_t.create_valid(
                A[:100] * 1.5, label=y[:100]).construct()._inner.bins)
    with pytest.raises(ValueError):
        lgb_torch.Dataset.deserialize_reference(b'{"x": 1}')


def test_dataset_accessors():
    rng = np.random.default_rng(6)
    X = rng.normal(size=(500, 4))
    y = X[:, 0]
    ds = lgb_torch.Dataset(X, y, params={"max_bin": 15,
                                         "categorical_feature": "2"})
    ds.set_categorical_feature([2])
    ds.construct()
    assert ds._inner.categorical_array().tolist() == [False, False, True,
                                                      False]
    assert 1 < ds.feature_num_bin(0) <= 15
    ds.set_feature_name(["a", "b", "c", "d"])
    assert ds.get_feature_name() == ["a", "b", "c", "d"]
    assert ds.feature_num_bin("b") == ds.feature_num_bin(1)
    with pytest.raises(ValueError):
        ds.set_feature_names(["x"])
    other = lgb_torch.Dataset(X, y)
    v = lgb_torch.Dataset(X[:50], y[:50]).set_reference(ds)
    assert v.reference is ds and ds in v.get_ref_chain()
    other.construct()
    assert other.set_reference(ds).reference is None
    # categorical_feature through params under an alias
    dj = lgb_jax.Dataset(X, y, params={"cat_feature": "1,3"}).construct()
    dt = lgb_torch.Dataset(X, y, params={"cat_feature": "1,3"}).construct()
    _same_inner(dt._inner, dj._inner)
    assert dt._inner.categorical_array().tolist() == [False, True, False,
                                                      True]


# ------------------------------------------------------------ prediction
def test_csr_predict_in_blocks_equals_dense(monkeypatch):
    X, y = _sparse(n=2500)
    p = dict(INT8, objective="regression", **CPU)
    bst = lgb_torch.train(p, lgb_torch.Dataset(X, y, params=p), 4)
    dense = X.toarray()
    want = bst.predict(dense)
    leaves = bst.predict(dense, pred_leaf=True)
    calls = []
    real = lgb_torch.Booster._to_matrix

    def spy(self, data):
        calls.append(data.shape[0])
        return real(self, data)

    monkeypatch.setattr(lgb_torch.Booster, "_to_matrix", spy)
    monkeypatch.setattr(lgb_torch.Booster, "SPARSE_BLOCK_BYTES",
                        8 * X.shape[1] * 300)
    np.testing.assert_array_equal(bst.predict(X), want)
    assert calls == [300] * 8 + [100]
    calls.clear()
    np.testing.assert_array_equal(bst.predict(X.tocsc(), pred_leaf=True),
                                  leaves)
    assert len(calls) == 9
    # a loaded model takes the same blocks
    loaded = lgb_torch.Booster(model_str=bst.model_to_string())
    np.testing.assert_allclose(loaded.predict(X), want, rtol=1e-6,
                               atol=1e-9)


# --------------------------------------------------------- model text
@pytest.mark.parametrize("source", ["csv-file", "libsvm-file", "csr",
                                    "pandas"])
def test_int8_text_matches_jax(tmp_path, source, frame):
    p = dict(INT8, objective="regression")
    if source == "pandas":
        df, y = frame
        bj, bt = _both_train(p, df, df, y)
    elif source == "csr":
        X, y = _onehot_sparse()
        bj, bt = _both_train(p, X, X, y)
        assert bt._gbdt.train_set.bundle_plan is not None
    else:
        path, _ = _write_case(tmp_path, "csv" if source == "csv-file"
                              else "libsvm")
        bj = lgb_jax.train(p, lgb_jax.Dataset(str(path), params=p), 4)
        bt = lgb_torch.train(dict(p, **CPU),
                             lgb_torch.Dataset(str(path), params=p), 4)
    assert _head(bt) == _head(bj)
