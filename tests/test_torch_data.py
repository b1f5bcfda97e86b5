"""The port's host data layer against lightgbm_tpu's on the same input and
parameters: bin bytes, bin upper bounds, NaN bins, the EFB bundle plan, the
packed word mirror and ``bins_to_words``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.ops.histogram import bins_to_words as jax_bins_to_words

from lightgbm_tpu_torch.io import dataset as TD
from lightgbm_tpu_torch.io.dataset import Dataset as TDataset
from lightgbm_tpu_torch.ops.histogram import bins_to_words

from test_torch_fused import one_torch_thread  # noqa: F401


def _dense(n=3000, f=9, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[rng.random((n, f)) < 0.07] = np.nan          # missing values
    X[:, 3] = np.round(X[:, 3] * 2)                 # few distinct values
    X[:, 5] = 1.0                                   # trivial: dropped
    y = (X[:, 0] > 0).astype(float)
    return X, y


def _sparse_onehot(n=4000, seed=1):
    """Mutually exclusive one-hot-ish columns: EFB bundles them."""
    rng = np.random.default_rng(seed)
    cat = rng.integers(0, 12, size=n)
    X = np.zeros((n, 14))
    X[np.arange(n), cat] = rng.uniform(1, 5, size=n)
    X[:, 12:] = rng.normal(size=(n, 2))
    return X, (cat % 2).astype(float)


@pytest.mark.parametrize("case", ["dense_255", "dense_63", "bundled",
                                  "valid_set", "threaded_dense_255",
                                  "threaded_bundled", "threaded_valid_set"])
def test_dataset_matches_jax(case, monkeypatch):
    if case.startswith("threaded_"):
        # a column per thread, as from PARALLEL_BIN_VALUES values on
        monkeypatch.setattr(TD, "PARALLEL_BIN_VALUES", 1)
        case = case[len("threaded_"):]
    X, y = _sparse_onehot() if case == "bundled" else _dense()
    params = {"max_bin": 63 if case == "dense_63" else 255,
              "min_data_in_bin": 3}
    jd = JDataset.from_data(X, label=y, config=params)
    td = TDataset.from_data(X, label=y, config=params)
    if case == "valid_set":
        Xv, yv = _dense(n=1000, seed=5)
        jd, td = jd.create_valid(Xv, label=yv), td.create_valid(Xv,
                                                                label=yv)
    assert td.bins.dtype == np.uint8
    np.testing.assert_array_equal(td.bins, jd.bins)
    assert td.used_feature_idx == jd.used_feature_idx
    for tm, jm in zip(td.mappers, jd.mappers):
        np.testing.assert_array_equal(np.asarray(tm.bin_upper_bound),
                                      np.asarray(jm.bin_upper_bound))
        assert (tm.num_bin, tm.missing_type, tm.default_bin) == \
            (jm.num_bin, jm.missing_type, jm.default_bin)
    np.testing.assert_array_equal(td.nan_bin_array(), jd.nan_bin_array())
    np.testing.assert_array_equal(td.num_bins_array(), jd.num_bins_array())
    assert td.device_n_bins() == jd.device_n_bins()
    np.testing.assert_array_equal(td.packed_mirror(), jd.packed_mirror())
    if case == "bundled":
        assert jd.bundle_plan is not None
        tp, jp = td.bundle_plan, jd.bundle_plan
        assert tp.bundles == jp.bundles and tp.num_bundles == jp.num_bundles
        for field in ("feat_col", "src_idx", "valid", "default_bin",
                      "inv_table"):
            np.testing.assert_array_equal(getattr(tp, field),
                                          getattr(jp, field))
    else:
        assert td.bundle_plan is None and jd.bundle_plan is None


@pytest.mark.parametrize("f", [4, 9, 28])
def test_bins_to_words_matches_jax(f):
    rng = np.random.default_rng(f)
    bins = rng.integers(0, 256, size=(777, f)).astype(np.uint8)
    want = np.asarray(jax_bins_to_words(jnp.asarray(bins)))
    got = bins_to_words(torch.as_tensor(bins)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
