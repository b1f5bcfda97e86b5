"""The port's C API (``lightgbm_tpu_torch/capi_impl.py`` and its shim
``lightgbm_tpu_torch/native/``) against lightgbm_tpu's, on the CPU:

* in-process parity: the same seeded NumPy buffers go by address through
  the functions of ``lightgbm_tpu.capi_impl`` and
  ``lightgbm_tpu_torch.capi_impl``.  Below 100k rows both train with the
  strict float32 learner, so the models are compared as trees (equal
  splits, leaf values within rtol 1e-5 + atol 5e-5, as
  ``test_strict_slice_matches_jax`` does) and every prediction type
  (normal, raw, leaf, contrib; Mat, CSR, CSC, mats, file, Arrow, single
  row, the fast path, sparse output) within the same contract, leaf
  indices exactly.  Dataset fields, the streaming collector with query
  ids, the serialized reference, sampled columns and Arrow are covered
  too;
* C consumers: pure C programs linked against the port's
  ``liblgbtpu_capi.so`` train and predict with ``device_type=cpu``, and
  each one's model text equals the port's Python API's on the same data;
* the ABI: the port's ``capi.h`` declares exactly lightgbm_tpu's
  functions, the built library exports every one of them and every
  symbol the R glue calls, and ``swig/lgbtpulib.i`` generates and (slow)
  links against the port's library.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import sysconfig
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import sparse

from lightgbm_tpu import capi_impl as JC

import lightgbm_tpu_torch as lgb_torch
from lightgbm_tpu_torch import capi_impl as TC
from lightgbm_tpu_torch import native as TN
from lightgbm_tpu_torch.ops import forest_kernels as FK
from lightgbm_tpu_torch.utils.log import LightGBMError

from test_torch_fused import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
N, F, ROUNDS = 1000, 6, 8
BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
        "metric": ["auc", "binary_logloss"], "verbose": -1}
CPU = {"device_type": "cpu"}
RTOL, ATOL = 1e-5, 5e-5


def _pj(params, port):
    return json.dumps(dict(params, **CPU) if port else params)


def _ptr(a):
    return int(a.ctypes.data)


def _data(n=N, f=F, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[rng.random(X.shape) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1])
         + 0.3 * rng.normal(size=n) > 0).astype(np.float64)
    return np.ascontiguousarray(X), y


def _assert_models_close(bt, bj):
    mt, mj = bt._get_trees(), bj._get_trees()
    assert len(mt) == len(mj)
    for tt, tj in zip(mt, mj):
        assert tt.num_leaves == tj.num_leaves
        np.testing.assert_array_equal(tt.split_feature, tj.split_feature)
        np.testing.assert_array_equal(tt.decision_type, tj.decision_type)
        np.testing.assert_allclose(tt.threshold, tj.threshold, rtol=0,
                                   atol=0)
        np.testing.assert_allclose(tt.leaf_value, tj.leaf_value, rtol=RTOL,
                                   atol=ATOL)


@pytest.fixture(scope="module")
def pair():
    """One dataset and booster per package, made from the same buffers
    through each package's capi_impl, ``ROUNDS`` rounds each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        X, y = _data()
        hs = {}
        for port, C in ((False, JC), (True, TC)):
            ds = C.dataset_from_mat(_ptr(X), N, F, _ptr(y), _pj(BASE, port))
            b = C.booster_create(ds, _pj(BASE, port))
            for _ in range(ROUNDS):
                C.booster_update_one_iter(b)
            hs[port] = (ds, b)
    finally:
        torch.set_num_threads(threads)
    return X, y, hs


def _both(pair, fn, *args, out_size=None, dtype=np.float64):
    """Call ``fn`` of both packages with the booster handle first and the
    same argument buffers; with ``out_size``, an output buffer and its
    capacity last.  Returns (port's, JAX package's)."""
    X, y, hs = pair
    res = []
    for port, C in ((True, TC), (False, JC)):
        extra = ()
        out = None
        if out_size is not None:
            out = np.full(out_size, -7.0, dtype)
            extra = (_ptr(out), out_size)
        r = getattr(C, fn)(hs[port][1], *args, *extra)
        res.append((r, out))
    return res


def test_models_match_jax_as_trees(pair):
    X, y, hs = pair
    bt, bj = TC._handles[hs[True][1]], JC._handles[hs[False][1]]
    assert bt._gbdt.device.type == "cpu"
    _assert_models_close(bt, bj)
    for C, port in ((TC, True), (JC, False)):
        assert C.booster_num_trees(hs[port][1]) == ROUNDS
        assert C.booster_current_iteration(hs[port][1]) == ROUNDS


@pytest.mark.parametrize("ptype", [0, 1, 2, 3],
                         ids=["normal", "raw", "leaf", "contrib"])
@pytest.mark.parametrize("layout", ["mat", "csr", "csc", "mats"])
def test_predict_types_match_jax(pair, ptype, layout):
    X, y, hs = pair
    n = 200
    Xs = np.ascontiguousarray(np.nan_to_num(X[:n]))
    Xs[np.abs(Xs) < 0.3] = 0.0
    width = {2: ROUNDS, 3: F + 1}.get(ptype, 1)
    size = n * width
    for C, port in ((TC, True), (JC, False)):
        assert C.booster_calc_num_predict(hs[port][1], n, ptype, 0,
                                          -1) == size
    if layout in ("mat", "mats"):
        # "mats": the shim's row-pointer entry on the port's side (it makes
        # the rows contiguous and calls booster_predict_for_mat2)
        args = (_ptr(Xs), n, F, ptype, 0, -1)
        fn = "booster_predict_for_mat2"
        keep = ()
    elif layout == "csr":
        m = sparse.csr_matrix(Xs)
        keep = (m.indptr.astype(np.int32), m.indices.astype(np.int32),
                m.data.astype(np.float64))
        args = (*map(_ptr, keep), n + 1, m.nnz, F, ptype, 0, -1)
        fn = "booster_predict_for_csr"
    else:
        m = sparse.csc_matrix(Xs)
        keep = (m.indptr.astype(np.int32), m.indices.astype(np.int32),
                m.data.astype(np.float64))
        args = (*map(_ptr, keep), F + 1, m.nnz, n, ptype, 0, -1)
        fn = "booster_predict_for_csc"
    (rt, ot), (rj, oj) = _both(pair, fn, *args, out_size=size)
    if layout == "mats":
        lib = ctypes.CDLL(TN.build_capi())
        rows = (ctypes.c_void_p * n)(*[_ptr(Xs) + 8 * F * i
                                       for i in range(n)])
        ot = np.full(size, -7.0)
        out_len = ctypes.c_int64(size)
        assert lib.LGBMTPU_BoosterPredictForMats(
            ctypes.c_int64(hs[True][1]), rows, ctypes.c_int32(n),
            ctypes.c_int32(F), ptype, 0, -1, ctypes.c_void_p(_ptr(ot)),
            ctypes.byref(out_len)) == 0
        rt = out_len.value
    assert rt == rj == size
    want_t = TC._handles[hs[True][1]].predict(
        Xs, raw_score=ptype == 1, pred_leaf=ptype == 2,
        pred_contrib=ptype == 3)
    assert np.array_equal(ot, np.asarray(want_t, np.float64).reshape(-1))
    if ptype == 2:
        assert np.array_equal(ot, oj)
    else:
        np.testing.assert_allclose(ot, oj, rtol=RTOL, atol=ATOL)


def test_predict_for_file_matches_jax(pair, tmp_path):
    X, y, hs = pair
    path = tmp_path / "rows.tsv"
    np.savetxt(path, np.column_stack([y[:100], X[:100]]), delimiter="\t")
    outs = []
    for C, port in ((TC, True), (JC, False)):
        res = tmp_path / f"pred_{port}.txt"
        assert C.booster_predict_for_file(hs[port][1], str(path), 0, 1, 0,
                                          -1, str(res)) == 100
        outs.append(np.loadtxt(res))
    np.testing.assert_allclose(outs[0], outs[1], rtol=RTOL, atol=ATOL)
    bt = TC._handles[hs[True][1]]
    assert np.array_equal(outs[0], bt.predict(X[:100], raw_score=True))


def test_single_row_and_fast_path_match_jax(pair, monkeypatch):
    X, y, hs = pair
    calls = []
    real = FK.forest_leaves
    monkeypatch.setattr(FK, "forest_leaves",
                        lambda *a, **k: calls.append(a[1].shape)
                        or real(*a, **k))
    bt = TC._handles[hs[True][1]]
    fts = {port: C.fastpredict_init(hs[port][1], F, 0)
           for C, port in ((TC, True), (JC, False))}
    assert TC._handles[fts[True]]._served is not None
    for i in range(12):
        row = np.ascontiguousarray(X[i])
        (_, st), (_, sj) = _both(pair, "booster_predict_for_mat_single_row",
                                 _ptr(row), F, 0, 0, -1, out_size=1)
        ft, fj = np.zeros(1), np.zeros(1)
        assert TC.fastpredict_row(fts[True], _ptr(row), _ptr(ft), 1) == 1
        assert JC.fastpredict_row(fts[False], _ptr(row), _ptr(fj), 1) == 1
        want = np.float64(bt.predict(X[i:i + 1])[0])
        assert st[0] == want and ft[0] == want
        np.testing.assert_allclose([ft[0], st[0]], [fj[0], sj[0]],
                                   rtol=RTOL, atol=ATOL)
        # the CSR single-row entries on the row's nonzeros
        nz = np.flatnonzero(row != 0).astype(np.int32)
        vals = np.ascontiguousarray(row[nz])
        fc = np.zeros(1)
        TC.fastpredict_row_csr(TC.fastpredict_init_csr(hs[True][1], F, 0),
                               _ptr(nz), _ptr(vals), len(nz), _ptr(fc), 1)
        (_, sc), _ = _both(pair, "booster_predict_for_csr_single_row",
                           _ptr(nz), _ptr(vals), len(nz), F, 0, 0, -1,
                           out_size=1)
        assert fc[0] == want and sc[0] == want
    # one leaves-mode forest call a fast row, at bucket 1
    assert calls == [(F, 1)] * 24
    with pytest.raises(ValueError):
        TC.fastpredict_init(hs[True][1], F + 1, 0)


def test_loaded_model_serves_above_the_threshold(pair, monkeypatch):
    """A model loaded through the ABI predicts as ``Booster.predict``
    does: above DEVICE_PREDICT_MIN_WORK on its device (the card unless its
    params say cpu) through the forest kernel's leaves, one launch a
    block, bitwise the host walk."""
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    X, y, hs = pair
    text = TC._handles[hs[True][1]].model_to_string()
    h = TC.booster_from_string(text)
    Xs = np.ascontiguousarray(X[:300])
    want = {t: np.asarray(TC._handles[h].predict(Xs, raw_score=t == 1),
                          np.float64) for t in (0, 1)}
    monkeypatch.setattr(GBDT, "DEVICE_PREDICT_MIN_WORK", 0)
    calls = []
    real = FK.forest_leaves
    monkeypatch.setattr(FK, "forest_leaves",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = np.zeros(300)
    with pytest.raises(LightGBMError, match="CUDA"):
        TC.booster_predict_for_mat2(h, _ptr(Xs), 300, F, 1, 0, -1,
                                    _ptr(out), 300)
    TC.booster_reset_parameter(h, json.dumps(CPU))
    for t in (0, 1):
        assert TC.booster_predict_for_mat2(h, _ptr(Xs), 300, F, t, 0, -1,
                                           _ptr(out), 300) == 300
        assert np.array_equal(out, want[t]), t
    assert len(calls) == 2
    TC.free_handle(h)


def test_sparse_output_contrib_matches_jax(pair):
    X, y, hs = pair
    n = 40
    Xs = np.nan_to_num(X[:n])
    Xs[np.abs(Xs) < 0.4] = 0.0
    m = sparse.csr_matrix(Xs)
    bufs = (m.indptr.astype(np.int32), m.indices.astype(np.int32),
            m.data.astype(np.float64))
    dense = []
    for C, port in ((TC, True), (JC, False)):
        ip, nip, ix, dp, ne = C.booster_predict_sparse_output(
            hs[port][1], *map(_ptr, bufs), n + 1, m.nnz, F, 3, 0, -1, 0)
        got = sparse.csr_matrix((
            np.ctypeslib.as_array(ctypes.cast(dp, ctypes.POINTER(
                ctypes.c_double)), shape=(ne,)).copy(),
            np.ctypeslib.as_array(ctypes.cast(ix, ctypes.POINTER(
                ctypes.c_int32)), shape=(ne,)).copy(),
            np.ctypeslib.as_array(ctypes.cast(ip, ctypes.POINTER(
                ctypes.c_int32)), shape=(nip,)).copy()),
            shape=(n, F + 1)).toarray()
        C.booster_free_predict_sparse(dp)
        assert dp not in C._sparse_out_keepalive
        dense.append(got)
    want = TC._handles[hs[True][1]].predict(Xs, pred_contrib=True)
    assert np.array_equal(dense[0], want)
    np.testing.assert_allclose(dense[0], dense[1], rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError):
        TC.booster_predict_sparse_output(hs[True][1], *map(_ptr, bufs),
                                         n + 1, m.nnz, F, 3, 0, -1, 1)


def test_introspection_matches_jax(pair):
    X, y, hs = pair
    bt, bj = hs[True][1], hs[False][1]
    for fn in ("booster_num_feature", "booster_num_classes",
               "booster_num_model_per_iteration",
               "booster_number_of_total_model", "booster_get_eval_counts",
               "booster_get_linear", "booster_feature_names",
               "booster_eval_names"):
        assert getattr(TC, fn)(bt) == getattr(JC, fn)(bj), fn
    for fn in ("booster_get_lower_bound_value",
               "booster_get_upper_bound_value"):
        np.testing.assert_allclose(getattr(TC, fn)(bt), getattr(JC, fn)(bj),
                                   rtol=RTOL, atol=ATOL * ROUNDS)
    assert TC.booster_get_num_predict(bt, 0) == JC.booster_get_num_predict(
        bj, 0) == N
    (rt, et), (rj, ej) = _both(pair, "booster_get_eval", 0, out_size=4)
    assert rt == rj == 2
    np.testing.assert_allclose(et[:2], ej[:2], rtol=1e-4, atol=1e-5)
    (rt, pt), (rj, pj) = _both(pair, "booster_get_predict", 0, out_size=N)
    assert rt == rj == N
    np.testing.assert_allclose(pt, pj, rtol=RTOL, atol=ATOL)
    (rt, it), (rj, ij) = _both(pair, "booster_feature_importance", 0,
                               out_size=F)
    assert rt == rj == F and np.array_equal(it, ij)
    dt, dj = json.loads(TC.booster_dump_model(bt, -1)), \
        json.loads(JC.booster_dump_model(bj, -1))
    assert dt.keys() == dj.keys() and len(dt["tree_info"]) == ROUNDS
    assert json.loads(TC.booster_get_loaded_param(bt))["device_type"] == \
        "cpu"
    for C, b in ((TC, bt), (JC, bj)):
        C.booster_validate_feature_names(
            b, json.dumps([f"Column_{i}" for i in range(F)]))
        with pytest.raises(ValueError):
            C.booster_validate_feature_names(b, json.dumps(["x"] * F))
    need = TC.booster_save_model_to_string(bt, 0, 0)
    buf = ctypes.create_string_buffer(need)
    assert TC.booster_save_model_to_string(
        bt, ctypes.addressof(buf), need) == need
    assert buf.value.decode() == TC._handles[bt].model_to_string()


def _trained(C, port, X, y, params, rounds):
    ds = C.dataset_from_mat(_ptr(X), X.shape[0], X.shape[1], _ptr(y),
                            _pj(params, port))
    b = C.booster_create(ds, _pj(params, port))
    for _ in range(rounds):
        C.booster_update_one_iter(b)
    return ds, b


def test_edits_refit_merge_match_jax():
    """Leaf edits (the score cache follows), rollback, refit from leaf
    predictions, merge, shuffle, reset_parameter and a custom-gradient
    round, on both packages' boosters."""
    X, y = _data(600, 4, seed=3)
    p = dict(BASE, num_leaves=7, seed=5)
    res = {}
    for C, port in ((TC, True), (JC, False)):
        ds, b = _trained(C, port, X, y, p, 3)
        v = C.booster_get_leaf_value(b, 1, 2)
        C.booster_set_leaf_value(b, 1, 2, v + 0.5)
        assert C.booster_get_leaf_value(b, 1, 2) == v + 0.5
        sc = np.zeros(600)
        C.booster_get_predict(b, 0, _ptr(sc), 600)
        pr = np.zeros(600)
        C.booster_predict_for_mat2(b, _ptr(X), 600, 4, 0, 0, -1, _ptr(pr),
                                   600)
        np.testing.assert_allclose(sc, pr, rtol=1e-5, atol=1e-6)
        C.booster_rollback_one_iter(b)
        assert C.booster_current_iteration(b) == 2
        leaf = np.zeros(600 * 2)
        C.booster_predict_for_mat2(b, _ptr(X), 600, 4, 2, 0, -1,
                                   _ptr(leaf), leaf.size)
        leaf_i = np.ascontiguousarray(leaf, np.int32)
        C.booster_refit(b, _ptr(leaf_i), 600, 2)
        _, b2 = _trained(C, port, X, y, p, 2)
        C.booster_merge(b, b2)
        assert C.booster_number_of_total_model(b) == 4
        C.booster_shuffle_models(b, 0, -1)
        C.booster_reset_parameter(b, json.dumps({"learning_rate": 0.02}))
        C.booster_update_one_iter(b)
        res[port] = C._handles[b]
        grad = (np.random.default_rng(4).normal(size=600) * 0.1).astype(
            np.float32)
        hess = np.full(600, 0.25, np.float32)
        _, b3 = _trained(C, port, X, y, dict(p, objective="none"), 0)
        C.booster_update_one_iter_custom(b3, _ptr(grad), _ptr(hess), 600)
        assert C.booster_number_of_total_model(b3) == 1
    assert res[True].num_trees() == res[False].num_trees() == 5
    lv = [[t.num_leaves for t in res[k]._get_trees()] for k in (True,
                                                                 False)]
    assert lv[0] == lv[1]


def test_dataset_fields_match_jax(tmp_path):
    X, y = _data(300, 4, seed=1)
    w = np.linspace(0.5, 1.5, 300)
    init = np.linspace(-0.2, 0.2, 300)
    group = np.array([100.0, 120.0, 80.0])
    pos = np.tile(np.arange(10.0), 30)
    got = {}
    for C, port in ((TC, True), (JC, False)):
        ds = C.dataset_from_mat(_ptr(X), 300, 4, _ptr(y),
                                _pj({"verbose": -1}, port))
        C.dataset_set_field(ds, "weight", _ptr(w), 300)
        C.dataset_set_field(ds, "init_score", _ptr(init), 300)
        C.dataset_set_field(ds, "group", _ptr(group), 3)
        C.dataset_set_field(ds, "position", _ptr(pos), 300)
        with pytest.raises(ValueError):
            C.dataset_set_field(ds, "nope", _ptr(w), 300)
        vals = {}
        for field in ("label", "weight", "init_score", "group"):
            out = np.zeros(300)
            k = C.dataset_get_field(ds, field, _ptr(out), 300)
            vals[field] = out[:k].copy()
        names = json.dumps([f"feat_{i}" for i in range(4)])
        C.dataset_set_feature_names(ds, names)
        vals["names"] = C.dataset_get_feature_names(ds)
        vals["nbin"] = [C.dataset_get_feature_num_bin(ds, i)
                        for i in range(4)]
        idx = np.arange(0, 300, 3, dtype=np.int32)
        sub = C.dataset_get_subset(ds, _ptr(idx), len(idx), "{}")
        vals["sub"] = C.dataset_num_data(sub)
        C.dataset_dump_text(ds, str(tmp_path / f"dump_{port}.txt"))
        vals["dump"] = (tmp_path / f"dump_{port}.txt").read_text()
        got[port] = vals
        with pytest.raises(ValueError):
            C.dataset_update_param_checking(json.dumps({"max_bin": 255}),
                                            json.dumps({"max_bin": 63}))
    for key in got[True]:
        if isinstance(got[True][key], np.ndarray):
            assert np.array_equal(got[True][key], got[False][key]), key
        else:
            assert got[True][key] == got[False][key], key
    np.testing.assert_array_equal(got[True]["label"], y)


def _stream(C, port, X, y, qid):
    h = C.dataset_init_streaming(X.shape[1], _pj({"verbose": -1}, port))
    C.dataset_set_wait_for_manual_finish(h, 1)
    w = np.ones(len(y))
    half = len(y) // 2
    for lo, hi in ((0, half), (half, len(y))):
        rows = np.ascontiguousarray(X[lo:hi])
        lab, wt = np.ascontiguousarray(y[lo:hi]), np.ascontiguousarray(
            w[lo:hi])
        q = np.ascontiguousarray(qid[lo:hi])
        C.dataset_push_rows_with_metadata(h, _ptr(rows), hi - lo,
                                          X.shape[1], _ptr(lab), _ptr(wt),
                                          _ptr(q), 0)
    C.dataset_mark_finished(h)
    return C._handles[h]


def test_streaming_collector_with_query_ids():
    X, y = _data(400, 3, seed=2)
    qid = np.repeat(np.array([7, 3, 9, 3], np.int32), 100)   # run-length
    ds = {port: _stream(C, port, X, y, qid)
          for C, port in ((TC, True), (JC, False))}
    assert np.array_equal(ds[True].get_group(), [100, 100, 100, 100])
    assert np.array_equal(ds[True].get_group(), ds[False].get_group())
    assert np.array_equal(ds[True].inner.bins, np.asarray(ds[False]
                                                          .inner.bins))
    # CSR pushes densify row by row
    m = sparse.csr_matrix(np.where(np.abs(X) < 0.5, 0.0, np.nan_to_num(X)))
    bufs = (m.indptr.astype(np.int32), m.indices.astype(np.int32),
            m.data.astype(np.float64))
    bins = []
    for C, port in ((TC, True), (JC, False)):
        h = C.dataset_init_streaming(3, _pj({"verbose": -1}, port))
        C.dataset_push_rows_by_csr(h, *map(_ptr, bufs), 401, m.nnz, 3,
                                   _ptr(y))
        with pytest.raises(ValueError):   # label on one push, not another
            C.dataset_push_rows(h, _ptr(X), 2, 3, 0)
        C.dataset_mark_finished(h)
        with pytest.raises(TypeError):
            C.dataset_push_rows(h, _ptr(X), 2, 3, _ptr(y))
        bins.append(np.asarray(C._handles[h].inner.bins))
    assert np.array_equal(bins[0], bins[1])


def test_serialized_reference_and_sampled_columns():
    X, y = _data(500, 3, seed=4)
    Xv = np.ascontiguousarray(_data(200, 3, seed=5)[0])
    yv = np.zeros(200)
    bins = {}
    for C, port in ((TC, True), (JC, False)):
        ds = C.dataset_from_mat(_ptr(X), 500, 3, _ptr(y),
                                _pj({"verbose": -1}, port))
        bh = C.dataset_serialize_reference_to_binary(ds)
        raw = bytes(C.byte_buffer_get_at(bh, i)
                    for i in range(C.byte_buffer_size(bh)))
        C.free_handle(bh)
        rbuf = np.frombuffer(raw, np.uint8).copy()
        h = C.dataset_from_serialized_reference(_ptr(rbuf), len(rbuf), 200,
                                                _pj({"verbose": -1}, port))
        C.dataset_push_rows(h, _ptr(Xv), 200, 3, _ptr(yv))
        C.dataset_mark_finished(h)
        ref_bins = np.asarray(C._handles[h].inner.bins)
        # sampled columns: mappers from every second row, rows pushed after
        rows = np.arange(0, 500, 2)
        cols = [np.ascontiguousarray(X[rows, j]) for j in range(3)]
        idx = [np.arange(len(rows), dtype=np.int32)] * 3
        dptr = np.array([_ptr(c) for c in cols], np.uint64)
        iptr = np.array([_ptr(i) for i in idx], np.uint64)
        per = np.full(3, len(rows), np.int32)
        s = C.dataset_from_sampled_column(_ptr(dptr), _ptr(iptr), 3,
                                          _ptr(per), len(rows), 500, 500,
                                          _pj({"verbose": -1}, port))
        C.dataset_push_rows(s, _ptr(X), 500, 3, _ptr(y))
        C.dataset_mark_finished(s)
        bins[port] = (ref_bins, np.asarray(C._handles[s].inner.bins))
    for a, b in zip(bins[True], bins[False]):
        assert np.array_equal(a, b)


def _export(table_or_array, schema_size=72):
    items = table_or_array.to_batches() if hasattr(
        table_or_array, "to_batches") else table_or_array.chunks
    buf = (ctypes.c_byte * (80 * len(items)))()
    schema = (ctypes.c_byte * schema_size)()
    for i, it in enumerate(items):
        if i == 0:
            it._export_to_c(ctypes.addressof(buf), ctypes.addressof(schema))
        else:
            it._export_to_c(ctypes.addressof(buf) + 80 * i)
    return buf, schema, len(items)


def test_arrow_matches_jax():
    pa = pytest.importorskip("pyarrow")
    X, y = _data(600, 4, seed=6)
    table = pa.Table.from_batches(
        pa.table({f"f{j}": X[:, j] for j in range(4)}).to_batches(
            max_chunksize=250))
    p = dict(BASE, num_leaves=7)
    preds = {}
    for C, port in ((TC, True), (JC, False)):
        buf, schema, k = _export(table)
        ds = C.dataset_from_arrow(k, ctypes.addressof(buf),
                                  ctypes.addressof(schema), _pj(p, port), 0)
        lab = pa.chunked_array([y[:350], y[350:]])
        lbuf, lschema, lk = _export(lab)
        C.dataset_set_field_from_arrow(ds, "label", lk,
                                       ctypes.addressof(lbuf),
                                       ctypes.addressof(lschema))
        b = C.booster_create(ds, _pj(p, port))
        for _ in range(4):
            C.booster_update_one_iter(b)
        buf2, schema2, k2 = _export(table)
        out = np.zeros(600)
        assert C.booster_predict_for_arrow(
            b, k2, ctypes.addressof(buf2), ctypes.addressof(schema2), 1, 0,
            -1, _ptr(out), 600) == 600
        preds[port] = (out, C._handles[b])
    _assert_models_close(preds[True][1], preds[False][1])
    assert np.array_equal(preds[True][0],
                          preds[True][1].predict(X, raw_score=True))
    np.testing.assert_allclose(preds[True][0], preds[False][0], rtol=RTOL,
                               atol=ATOL)


def test_misc_surface_matches_jax():
    assert json.loads(TC.dump_param_aliases()) == json.loads(
        JC.dump_param_aliases())
    for C in (TC, JC):
        C.set_max_threads(7)
        assert C.get_max_threads() == 7
        C.set_max_threads(0)
    pj = json.dumps({"bin_construct_sample_cnt": 100})
    assert TC.get_sample_count(1000, pj) == JC.get_sample_count(1000, pj) \
        == 100
    it, ij = np.zeros(100, np.int32), np.zeros(100, np.int32)
    assert TC.sample_indices(1000, pj, _ptr(it), 100) == 100
    JC.sample_indices(1000, pj, _ptr(ij), 100)
    assert np.array_equal(it, ij)
    TC.network_init("127.0.0.1:12400", 12400, 120, 1)
    TC.network_free()
    with pytest.raises(LightGBMError, match="item 6"):
        TC.network_init("a:1,b:2", 12400, 120, 2)


def test_external_collectives_and_log_callback():
    seen = []
    AG = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_int)

    def allgather(inp, n, starts, lens, nb, out, out_size):
        # a one-rank transport: the local block twice
        ctypes.memmove(out, inp, n)
        ctypes.memmove(out + n, inp, n)

    ag = AG(allgather)
    TC.network_init_with_functions(
        2, 0, 0, ctypes.cast(ag, ctypes.c_void_p).value)
    try:
        got = TC.ext_allgather(np.arange(5, dtype=np.uint8), [5, 5])
        assert list(got) == [0, 1, 2, 3, 4] * 2
        with pytest.raises(RuntimeError):
            TC.ext_reduce_scatter(np.zeros(8, np.uint8), [8])
    finally:
        TC.network_free()
    CB = ctypes.CFUNCTYPE(None, ctypes.c_char_p)
    cb = CB(lambda m: seen.append(m.decode()))
    from lightgbm_tpu_torch.utils import log
    level = log._verbosity
    TC.register_log_callback(ctypes.cast(cb, ctypes.c_void_p).value)
    try:
        log.set_verbosity(1)
        log.warning("through the C callback")
    finally:
        log.set_verbosity(level)
        log.register_logger(None)
    assert any("through the C callback" in m for m in seen)


def test_free_handle_releases():
    X, y = _data(300, 3, seed=7)
    ds, b = _trained(TC, True, X, y, dict(BASE, num_leaves=7), 2)
    import weakref
    ref = weakref.ref(TC._handles[b]._gbdt)
    TC.free_handle(b)
    TC.free_handle(ds)
    assert b not in TC._handles and ds not in TC._handles
    assert ref() is None
    TC.free_handle(b)   # freeing twice is a no-op


# ------------------------------------------------------------ C consumers

_HEADER = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <stdint.h>
#include <math.h>
#include "capi.h"

#define CHECK(call) do { if ((call) != 0) { \
  fprintf(stderr, "FAIL %s: %s\n", #call, LGBMTPU_GetLastError()); \
  return 1; } } while (0)

static double frand(unsigned* s) {
  *s = *s * 1103515245u + 12345u;
  return ((double)(*s >> 8) / (1 << 24)) * 2.0 - 1.0;
}

static void dump(const char* dir, const char* name, const void* p,
                 size_t bytes) {
  char path[4096];
  snprintf(path, sizeof path, "%s/%s", dir, name);
  FILE* f = fopen(path, "wb");
  fwrite(p, 1, bytes, f);
  fclose(f);
}

static int save_text(const char* dir, int64_t bst) {
  int64_t need = 0;
  CHECK(LGBMTPU_BoosterSaveModelToString(bst, NULL, &need));
  char* text = malloc(need);
  CHECK(LGBMTPU_BoosterSaveModelToString(bst, text, &need));
  dump(dir, "model.txt", text, strlen(text));
  free(text);
  return 0;
}
"""

#: the end-to-end consumer (tests/test_capi.py's first program)
C_END_TO_END = _HEADER + r"""
#define PARAMS "{\"objective\":\"binary\",\"num_leaves\":7," \
  "\"min_data_in_leaf\":5,\"verbose\":-1,\"device_type\":\"cpu\"}"
int main(int argc, char** argv) {
  const int64_t n = 600, f = 4;
  double* X = malloc(sizeof(double) * n * f);
  double* y = malloc(sizeof(double) * n);
  unsigned s = 42;
  for (int64_t i = 0; i < n; ++i) {
    double acc = 0.0;
    for (int64_t j = 0; j < f; ++j) { X[i*f+j] = frand(&s); acc += X[i*f+j]; }
    y[i] = acc > 0.0 ? 1.0 : 0.0;
  }
  dump(argv[1], "X.bin", X, sizeof(double) * n * f);
  dump(argv[1], "y.bin", y, sizeof(double) * n);
  int64_t ds, bst;
  CHECK(LGBMTPU_DatasetCreateFromMat(X, n, f, y, PARAMS, &ds));
  CHECK(LGBMTPU_BoosterCreate(ds, PARAMS, &bst));
  int finished = 0;
  for (int it = 0; it < 10 && !finished; ++it)
    CHECK(LGBMTPU_BoosterUpdateOneIter(bst, &finished));
  int n_trees = 0, num_class = 0;
  CHECK(LGBMTPU_BoosterNumTrees(bst, &n_trees));
  CHECK(LGBMTPU_BoosterNumClasses(bst, &num_class));
  if (n_trees != 10 || num_class != 1) return 2;
  double* preds = malloc(sizeof(double) * n);
  int64_t out_len = n;
  CHECK(LGBMTPU_BoosterPredictForMat(bst, X, n, f, 0, preds, &out_len));
  dump(argv[1], "preds.bin", preds, sizeof(double) * n);
  char path[4096];
  snprintf(path, sizeof path, "%s/saved.txt", argv[1]);
  CHECK(LGBMTPU_BoosterSaveModel(bst, path));
  int64_t bst2;
  CHECK(LGBMTPU_BoosterCreateFromModelfile(path, &bst2));
  double* preds2 = malloc(sizeof(double) * n);
  out_len = n;
  CHECK(LGBMTPU_BoosterPredictForMat(bst2, X, n, f, 0, preds2, &out_len));
  int64_t tiny = 3;   /* an undersized buffer fails, never overflows */
  if (LGBMTPU_BoosterPredictForMat(bst2, X, n, f, 0, preds2, &tiny) == 0)
    return 3;
  for (int64_t i = 0; i < n; ++i)
    if (fabs(preds[i] - preds2[i]) > 1e-5) return 4;
  if (save_text(argv[1], bst)) return 1;
  CHECK(LGBMTPU_FreeHandle(bst2));
  CHECK(LGBMTPU_BoosterFree(bst));
  CHECK(LGBMTPU_DatasetFree(ds));
  printf("C API OK\n");
  return 0;
}
"""

#: streaming push, a CSR valid set, eval, rollback and save-to-string
#: (tests/test_capi.py's second program)
C_STREAMING = _HEADER + r"""
#define PARAMS "{\"objective\":\"regression\",\"num_leaves\":7," \
  "\"min_data_in_leaf\":5,\"metric\":[\"l2\"],\"verbose\":-1," \
  "\"device_type\":\"cpu\"}"
int main(int argc, char** argv) {
  const int64_t n = 500, f = 3, chunk = 120;
  double* X = malloc(sizeof(double) * n * f);
  double* y = malloc(sizeof(double) * n);
  int64_t ds;
  CHECK(LGBMTPU_DatasetInitStreaming(f, PARAMS, &ds));
  unsigned s = 7;
  for (int64_t pushed = 0; pushed < n;) {
    int64_t m = (n - pushed) < chunk ? (n - pushed) : chunk;
    for (int64_t i = pushed; i < pushed + m; ++i) {
      double acc = 0;
      for (int64_t j = 0; j < f; ++j) { X[i*f+j] = frand(&s); acc += X[i*f+j]; }
      y[i] = 2.0 * acc + 0.1 * frand(&s);
    }
    CHECK(LGBMTPU_DatasetPushRows(ds, X + pushed * f, m, f, y + pushed));
    pushed += m;
  }
  CHECK(LGBMTPU_DatasetMarkFinished(ds));
  dump(argv[1], "X.bin", X, sizeof(double) * n * f);
  dump(argv[1], "y.bin", y, sizeof(double) * n);
  int64_t nd = 0, nf = 0;
  CHECK(LGBMTPU_DatasetGetNumData(ds, &nd));
  CHECK(LGBMTPU_DatasetGetNumFeature(ds, &nf));
  if (nd != n || nf != f) return 2;
  int32_t* indptr = malloc(sizeof(int32_t) * (n + 1));
  int32_t* indices = malloc(sizeof(int32_t) * n * f);
  double* vals = malloc(sizeof(double) * n * f);
  double* yv = malloc(sizeof(double) * n);
  int64_t nnz = 0;
  indptr[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    double acc = 0;
    for (int64_t j = 0; j < f; ++j) {
      double v = frand(&s);
      acc += v;
      if (j != 1 || v > 0) { indices[nnz] = (int32_t)j; vals[nnz++] = v; }
      else acc -= v;
    }
    yv[i] = 2.0 * acc + 0.1 * frand(&s);
    indptr[i + 1] = (int32_t)nnz;
  }
  dump(argv[1], "indptr.bin", indptr, sizeof(int32_t) * (n + 1));
  dump(argv[1], "indices.bin", indices, sizeof(int32_t) * nnz);
  dump(argv[1], "vals.bin", vals, sizeof(double) * nnz);
  dump(argv[1], "yv.bin", yv, sizeof(double) * n);
  int64_t dsv, bst;
  CHECK(LGBMTPU_DatasetCreateFromCSR(indptr, indices, vals, n, nnz, f, yv,
                                     PARAMS, &dsv));
  CHECK(LGBMTPU_BoosterCreate(ds, PARAMS, &bst));
  CHECK(LGBMTPU_BoosterAddValidData(bst, dsv));
  int fin = 0;
  for (int it = 0; it < 8 && !fin; ++it)
    CHECK(LGBMTPU_BoosterUpdateOneIter(bst, &fin));
  double evals[8];
  int64_t elen = 8;
  CHECK(LGBMTPU_BoosterGetEval(bst, 1, evals, &elen));
  if (elen != 1) return 3;
  dump(argv[1], "eval.bin", evals, sizeof(double));
  int cur = 0, cur2 = 0;
  CHECK(LGBMTPU_BoosterGetCurrentIteration(bst, &cur));
  CHECK(LGBMTPU_BoosterRollbackOneIter(bst));
  CHECK(LGBMTPU_BoosterGetCurrentIteration(bst, &cur2));
  if (cur2 != cur - 1) return 4;
  if (save_text(argv[1], bst)) return 1;
  CHECK(LGBMTPU_FreeHandle(bst));
  CHECK(LGBMTPU_FreeHandle(ds));
  CHECK(LGBMTPU_FreeHandle(dsv));
  printf("C API v2 OK\n");
  return 0;
}
"""

#: fast single-row predict, CSC, model from string, name queries
#: (tests/test_capi.py's third program)
C_FAST = _HEADER + r"""
#define PARAMS "{\"objective\":\"binary\",\"num_leaves\":15,\"verbose\":-1," \
  "\"min_data_in_leaf\":5,\"metric\":[\"auc\",\"binary_logloss\"]," \
  "\"device_type\":\"cpu\"}"
int main(int argc, char** argv) {
  const int64_t n = 500, f = 4;
  double* X = malloc(sizeof(double) * n * f);
  double* y = malloc(sizeof(double) * n);
  unsigned s = 7;
  for (int64_t i = 0; i < n; ++i) {
    double acc = 0.0;
    for (int64_t j = 0; j < f; ++j) { X[i*f+j] = frand(&s); acc += X[i*f+j]; }
    y[i] = acc > 0.0 ? 1.0 : 0.0;
  }
  dump(argv[1], "X.bin", X, sizeof(double) * n * f);
  dump(argv[1], "y.bin", y, sizeof(double) * n);
  int64_t ds = 0, bst = 0;
  CHECK(LGBMTPU_DatasetCreateFromMat(X, n, f, y, PARAMS, &ds));
  CHECK(LGBMTPU_BoosterCreate(ds, PARAMS, &bst));
  int fin = 0;
  for (int it = 0; it < 8; ++it) CHECK(LGBMTPU_BoosterUpdateOneIter(bst, &fin));
  int nf = 0;
  CHECK(LGBMTPU_BoosterGetNumFeature(bst, &nf));
  if (nf != (int)f) return 2;
  int64_t need = 0;
  CHECK(LGBMTPU_BoosterGetFeatureNames(bst, NULL, 0, &need));
  char* names = malloc(need);
  CHECK(LGBMTPU_BoosterGetFeatureNames(bst, names, need, &need));
  if (strstr(names, "Column_0") == NULL) return 3;
  CHECK(LGBMTPU_BoosterGetEvalNames(bst, NULL, 0, &need));
  char* enames = malloc(need);
  CHECK(LGBMTPU_BoosterGetEvalNames(bst, enames, need, &need));
  if (strstr(enames, "auc") == NULL) return 4;
  need = 0;
  CHECK(LGBMTPU_BoosterSaveModelToString(bst, NULL, &need));
  char* model = malloc(need);
  CHECK(LGBMTPU_BoosterSaveModelToString(bst, model, &need));
  int64_t bst2 = 0;
  CHECK(LGBMTPU_BoosterLoadModelFromString(model, &bst2));
  double* batch = malloc(sizeof(double) * n);
  int64_t wrote = n;
  CHECK(LGBMTPU_BoosterPredictForMat(bst, X, n, f, 0, batch, &wrote));
  double* loaded = malloc(sizeof(double) * n);
  wrote = n;
  CHECK(LGBMTPU_BoosterPredictForMat(bst2, X, n, f, 1, loaded, &wrote));
  dump(argv[1], "loaded_raw.bin", loaded, sizeof(double) * n);
  int64_t fastc = 0;
  CHECK(LGBMTPU_BoosterPredictForMatSingleRowFastInit(bst, f, 0, &fastc));
  double rowout[4];
  for (int64_t i = 0; i < n; ++i) {
    CHECK(LGBMTPU_BoosterPredictForMatSingleRowFast(fastc, X + i * f, rowout,
                                                    4, &wrote));
    if (wrote != 1 || rowout[0] != batch[i]) {
      fprintf(stderr, "fast row %lld: %.17g vs %.17g\n", (long long)i,
              rowout[0], batch[i]);
      return 5;
    }
  }
  int64_t nnz = n * f;
  int32_t* colptr = malloc(sizeof(int32_t) * (f + 1));
  int32_t* rowind = malloc(sizeof(int32_t) * nnz);
  double* vals = malloc(sizeof(double) * nnz);
  for (int64_t j = 0; j <= f; ++j) colptr[j] = (int32_t)(j * n);
  for (int64_t j = 0; j < f; ++j)
    for (int64_t i = 0; i < n; ++i) {
      rowind[j * n + i] = (int32_t)i;
      vals[j * n + i] = X[i * f + j];
    }
  int64_t dsc = 0, ndc = 0;
  CHECK(LGBMTPU_DatasetCreateFromCSC(colptr, rowind, vals, f, nnz, n, y,
                                     "{\"verbose\":-1,\"device_type\":\"cpu\"}",
                                     &dsc));
  CHECK(LGBMTPU_DatasetGetNumData(dsc, &ndc));
  if (ndc != n) return 6;
  if (save_text(argv[1], bst)) return 1;
  CHECK(LGBMTPU_FastConfigFree(fastc));
  CHECK(LGBMTPU_FreeHandle(bst2));
  CHECK(LGBMTPU_FreeHandle(bst));
  CHECK(LGBMTPU_FreeHandle(ds));
  CHECK(LGBMTPU_FreeHandle(dsc));
  printf("C API v3 OK\n");
  return 0;
}
"""

CONSUMERS = {"end_to_end": C_END_TO_END, "streaming": C_STREAMING,
             "fast": C_FAST}


@pytest.fixture(scope="module")
def consumers(tmp_path_factory):
    """The three C programs, each compiled once against the port's
    library (``-L lib_dir() -llgbtpu_capi``)."""
    lib = TN.build_capi()
    d = tmp_path_factory.mktemp("consumers")
    libdir = sysconfig.get_config_var("LIBDIR")
    exes = {}
    for name, src in CONSUMERS.items():
        c = d / f"{name}.c"
        c.write_text(src)
        exe = d / name
        subprocess.run(
            ["gcc", "-O1", str(c), f"-I{REPO / 'lightgbm_tpu_torch' / 'native'}",
             f"-L{os.path.dirname(lib)}", "-llgbtpu_capi",
             f"-Wl,-rpath,{os.path.dirname(lib)}", f"-Wl,-rpath,{libdir}",
             "-lm", "-o", str(exe)], check=True, capture_output=True)
        exes[name] = exe
    return exes


def _run(exe, out_dir):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    r = subprocess.run([str(exe), str(out_dir)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.returncode, r.stderr[-3000:], r.stdout)
    return r.stdout


def _params(**kw):
    return dict(dict(objective="binary", num_leaves=7, min_data_in_leaf=5,
                     verbose=-1), **kw, **CPU)


def _python_booster(X, y, params, rounds, valid=None):
    ds = lgb_torch.Dataset(X, label=y, params=params)
    b = lgb_torch.Booster(params=params, train_set=ds)
    if valid is not None:
        b.add_valid(lgb_torch.Dataset(valid[0], label=valid[1],
                                      params=params), "valid_1")
    for _ in range(rounds):
        b.update()
    return b


def test_c_consumer_end_to_end(consumers, tmp_path):
    assert "C API OK" in _run(consumers["end_to_end"], tmp_path)
    X = np.fromfile(tmp_path / "X.bin").reshape(600, 4)
    y = np.fromfile(tmp_path / "y.bin")
    b = _python_booster(X, y, _params(), 10)
    text = b.model_to_string()
    assert (tmp_path / "model.txt").read_text() == text
    assert (tmp_path / "saved.txt").read_text() == text
    assert np.array_equal(np.fromfile(tmp_path / "preds.bin"),
                          np.asarray(b.predict(X), np.float64))


def test_c_consumer_streaming_csr_eval(consumers, tmp_path):
    assert "C API v2 OK" in _run(consumers["streaming"], tmp_path)
    X = np.fromfile(tmp_path / "X.bin").reshape(500, 3)
    y = np.fromfile(tmp_path / "y.bin")
    indptr = np.fromfile(tmp_path / "indptr.bin", np.int32)
    Xv = sparse.csr_matrix((np.fromfile(tmp_path / "vals.bin"),
                            np.fromfile(tmp_path / "indices.bin", np.int32),
                            indptr), shape=(500, 3))
    yv = np.fromfile(tmp_path / "yv.bin")
    # the C program's params, in its order (the model text lists them)
    p = dict(objective="regression", num_leaves=7, min_data_in_leaf=5,
             metric=["l2"], verbose=-1, **CPU)
    b = _python_booster(X, y, p, 8, valid=(Xv, yv))
    ev = b.eval_valid()[0][2]
    assert np.fromfile(tmp_path / "eval.bin")[0] == ev
    b.rollback_one_iter()
    assert (tmp_path / "model.txt").read_text() == b.model_to_string()


def test_c_consumer_fast_predict_csc_queries(consumers, tmp_path):
    assert "C API v3 OK" in _run(consumers["fast"], tmp_path)
    X = np.fromfile(tmp_path / "X.bin").reshape(500, 4)
    y = np.fromfile(tmp_path / "y.bin")
    p = dict(objective="binary", num_leaves=15, verbose=-1,
             min_data_in_leaf=5, metric=["auc", "binary_logloss"], **CPU)
    b = _python_booster(X, y, p, 8)
    text = b.model_to_string()
    assert (tmp_path / "model.txt").read_text() == text
    loaded = lgb_torch.Booster(model_str=text)
    assert np.array_equal(np.fromfile(tmp_path / "loaded_raw.bin"),
                          loaded.predict(X, raw_score=True))


# -------------------------------------------------------------------- ABI

def _declarations(path):
    """name -> normalized parameter list of every LGBMTPU_* declaration."""
    text = re.sub(r"/\*.*?\*/", "", path.read_text(), flags=re.S)
    out = {}
    for m in re.finditer(r"^[^(\n]*\b(LGBMTPU_\w+)\s*\((.*)\)\s*;\s*$",
                         text, flags=re.M):
        out[m.group(1)] = " ".join(m.group(2).split())
    return out


def test_header_declares_the_jax_abi():
    port = _declarations(REPO / "lightgbm_tpu_torch" / "native" / "capi.h")
    ref = _declarations(REPO / "lightgbm_tpu" / "native" / "capi.h")
    assert len(ref) == 100
    assert port == ref


def _exports(lib):
    res = subprocess.run(["nm", "-D", "--defined-only", lib],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    return set(re.findall(r"\sT\s+(LGBMTPU_\w+)", res.stdout))


def test_library_exports_the_header_and_the_r_glue():
    lib = TN.build_capi()
    assert Path(lib) == REPO / "lightgbm_tpu_torch" / "_build" / \
        "liblgbtpu_capi.so"
    assert TN.lib_dir() == os.path.dirname(lib)
    exported = _exports(lib)
    header = set(_declarations(REPO / "lightgbm_tpu_torch" / "native" /
                               "capi.h"))
    assert header <= exported, sorted(header - exported)
    glue = (REPO / "R-package" / "src" / "lgbtpu_R.cpp").read_text()
    called = set(re.findall(r"(LGBMTPU_\w+)\s*\(", glue))
    assert called and called <= exported, sorted(called - exported)


def test_the_port_library_reaches_the_port(tmp_path):
    """A call through the built library lands in lightgbm_tpu_torch's
    capi_impl (a handle made through the ABI is in its registry)."""
    lib = ctypes.CDLL(TN.build_capi())
    lib.LGBMTPU_GetLastError.restype = ctypes.c_char_p
    X, y = _data(200, 3, seed=8)
    h = ctypes.c_int64()
    rc = lib.LGBMTPU_DatasetCreateFromMat(
        ctypes.c_void_p(_ptr(X)), ctypes.c_int64(200), ctypes.c_int64(3),
        ctypes.c_void_p(_ptr(y)),
        json.dumps(dict(CPU, verbose=-1)).encode(), ctypes.byref(h))
    assert rc == 0, lib.LGBMTPU_GetLastError()
    assert isinstance(TC._handles[h.value], lgb_torch.Dataset)
    bad = ctypes.c_int64()
    rc = lib.LGBMTPU_BoosterCreate(ctypes.c_int64(h.value),
                                   b'{"device_type": "tpu"}',
                                   ctypes.byref(bad))
    assert rc == -1 and b"device_type" in lib.LGBMTPU_GetLastError()
    assert lib.LGBMTPU_DatasetFree(ctypes.c_int64(h.value)) == 0
    assert h.value not in TC._handles


@pytest.mark.skipif(shutil.which("swig") is None, reason="swig absent")
def test_swig_java_binding_generates(tmp_path):
    out = tmp_path / "java"
    out.mkdir()
    rc = subprocess.run(
        ["swig", "-c++", "-java", "-package", "io.lgbtpu",
         "-outdir", str(out), "-o", str(tmp_path / "wrap.cxx"),
         str(REPO / "swig" / "lgbtpulib.i")],
        capture_output=True, text=True)
    assert rc.returncode == 0, rc.stderr
    jni = (out / "lgbtpulibJNI.java").read_text()
    ignored = set(re.findall(r"%ignore\s+(LGBMTPU_\w+)",
                             (REPO / "swig" / "lgbtpulib.i").read_text()))
    decls = _declarations(REPO / "lightgbm_tpu_torch" / "native" / "capi.h")
    missing = [fn for fn in decls if fn not in jni and fn not in ignored]
    assert not missing, missing


@pytest.mark.slow
@pytest.mark.skipif(shutil.which("swig") is None, reason="swig absent")
def test_swig_binding_end_to_end_python_target(tmp_path):
    """Generate -> compile -> link ``-L lib_dir() -llgbtpu_capi`` ->
    import -> train on the CPU through the generated binding (Python as
    the stand-in target language)."""
    wrap = tmp_path / "wrap.cxx"
    rc = subprocess.run(
        ["swig", "-c++", "-python", "-outdir", str(tmp_path),
         "-o", str(wrap), str(REPO / "swig" / "lgbtpulib.i")],
        capture_output=True, text=True)
    assert rc.returncode == 0, rc.stderr
    libdir = TN.lib_dir()
    rc = subprocess.run(
        ["g++", "-O1", "-shared", "-fPIC", str(wrap),
         f"-I{sysconfig.get_paths()['include']}", f"-I{REPO}",
         f"-I{REPO / 'swig'}", f"-L{libdir}", "-llgbtpu_capi",
         f"-Wl,-rpath,{libdir}", "-o", str(tmp_path / "_lgbtpulib.so")],
        capture_output=True, text=True)
    assert rc.returncode == 0, rc.stderr
    (tmp_path / "drive.py").write_text(textwrap.dedent("""
        import sys
        sys.path.insert(0, sys.argv[1])
        import numpy as np
        import lgbtpulib as L
        import lightgbm_tpu_torch.capi_impl as TC
        rng = np.random.default_rng(0)
        n, f = 400, 4
        X = rng.normal(size=(n, f))
        y = (X[:, 0] > 0).astype(np.float64)
        buf = L.new_doubleArray(n * f)
        for i, v in enumerate(X.ravel()):
            L.doubleArray_setitem(buf, i, float(v))
        lab = L.new_doubleArray(n)
        for i, v in enumerate(y):
            L.doubleArray_setitem(lab, i, float(v))
        params = ('{"objective": "binary", "num_leaves": 7, '
                  '"min_data_in_leaf": 5, "verbose": -1, '
                  '"device_type": "cpu"}')
        dsp = L.new_int64p()
        assert L.LGBMTPU_DatasetCreateFromMat(buf, n, f, lab, params,
                                              dsp) == 0
        bp = L.new_int64p()
        assert L.LGBMTPU_BoosterCreate(L.int64p_value(dsp), params, bp) == 0
        bst = L.int64p_value(bp)
        fin = L.new_intp()
        for _ in range(4):
            assert L.LGBMTPU_BoosterUpdateOneIter(bst, fin) == 0
        s = L.LGBMTPU_BoosterSaveModelToStringSWIG(bst)
        assert s == TC._handles[bst].model_to_string()
        print("SWIG_E2E_OK")
    """))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(tmp_path / "drive.py"),
                        str(tmp_path)], capture_output=True, text=True,
                       env=env, timeout=420)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "SWIG_E2E_OK" in r.stdout
