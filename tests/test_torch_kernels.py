"""The plain PyTorch versions of the port's four kernels against the JAX
package's Pallas kernels, run through the Pallas interpreter on the CPU.

int8 levels are compared bitwise, float32 bitwise on integer-valued
inputs, and float32 on real-valued inputs to rtol 1e-6 (the two sum the
same terms in another order).  The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops.hist_pallas import (_histogram_leaves_impl,
                                          histogram_payload_pallas)
from lightgbm_tpu.ops.histogram import bins_to_words as jax_bins_to_words
from lightgbm_tpu.ops.round_fuse import partition_payload_pallas
from lightgbm_tpu.ops.table import _take_pallas

from lightgbm_tpu_torch.ops.hist_kernels import (histogram_leaves,
                                                 histogram_payload)
from lightgbm_tpu_torch.ops.round_fuse import partition_payload
from lightgbm_tpu_torch.ops.table import take_small_table


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("case", ["in_range", "minus_one",
                                  "past_table_in_pad", "past_pad",
                                  "ragged_n"])
def test_take_matches_pallas(case):
    rng = np.random.default_rng(1)
    T = 100                                    # padded to 128 by the kernel
    n = 1000 if case == "ragged_n" else 1024   # 1000: not a block multiple
    lo, hi = {"in_range": (0, T), "minus_one": (-1, T),
              "past_table_in_pad": (0, 128), "past_pad": (-5, 400),
              "ragged_n": (-1, 128)}[case]
    idx = rng.integers(lo, hi, size=n).astype(np.int32)
    if case == "minus_one":
        idx[::7] = -1
    table = rng.normal(size=T).astype(np.float32)
    want = np.asarray(_take_pallas(jnp.asarray(idx), jnp.asarray(table),
                                   rows_per_block=256, interpret=True))
    got = take_small_table(_t(table), _t(idx)).numpy()
    np.testing.assert_array_equal(got, want)


def _hist_inputs(case, n, f, n_bins, seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, n_bins - 1, size=(n, f)).astype(np.uint8)
    lor = rng.integers(-1, 9, size=n).astype(np.int32)
    K = {"k1": 1, "k8": 8}.get(case, 4)
    leaves = np.array([0, 2, 5, 6, 7, 1, 3, 4][:K], np.int32)
    if case == "repeated_slots":
        leaves = np.array([0, 2, 5, 2, 0], np.int32)
    if case in ("f32_real", "f32_nan_excluded"):
        grad = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
        hess = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    else:
        grad = rng.integers(-3, 4, size=n).astype(np.float32)
        hess = rng.integers(0, 5, size=n).astype(np.float32)
    if case == "f32_nan_excluded":
        out = ~np.isin(lor, leaves)
        grad[out] = np.nan
        hess[out] = np.nan
    mode = "int8" if case in ("int8", "k1", "k8", "repeated_slots",
                              "ragged_n") else "float32"
    return bins, grad, hess, lor, leaves, mode


def _assert_hist(got, want, real):
    if real:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["int8", "f32_int_valued", "f32_real",
                                  "f32_nan_excluded", "repeated_slots",
                                  "ragged_n", "k1", "k8"])
def test_histogram_leaves_matches_pallas(case):
    n = 2000 if case == "ragged_n" else 2048   # 2000: not a block multiple
    bins, grad, hess, lor, leaves, mode = _hist_inputs(case, n, 9, 64)
    cdt = jnp.int8 if mode == "int8" else jnp.float32
    want = np.asarray(_histogram_leaves_impl(
        jnp.asarray(bins.T), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(lor), jnp.asarray(leaves), n_bins=64,
        rows_per_block=512, compute_dtype=cdt, interpret=True))
    got = histogram_leaves(_t(np.ascontiguousarray(bins.T)), _t(grad),
                           _t(hess), _t(lor), _t(leaves), n_bins=64,
                           hist_dtype=mode).numpy()
    assert np.isfinite(got).all()
    _assert_hist(got, want, case in ("f32_real", "f32_nan_excluded"))


@pytest.mark.parametrize("case", ["int8", "f32_int_valued", "f32_real",
                                  "repeated_slots", "k1", "k8"])
def test_histogram_payload_matches_pallas(case):
    n, f = 3000, 10                          # f % 4 != 0: a padded word
    bins, grad, hess, lor, leaves, mode = _hist_inputs(case, n, f, 64,
                                                       seed=2)
    words = np.asarray(jax_bins_to_words(jnp.asarray(bins)))
    payload = np.concatenate([words, grad.view(np.int32)[:, None],
                              hess.view(np.int32)[:, None], lor[:, None]],
                             axis=1)
    S, cnt = 2500, np.array([1700], np.int32)  # rows >= cnt are excluded
    pc = np.ascontiguousarray(payload[:S])
    cdt = jnp.int8 if mode == "int8" else jnp.float32
    want = np.asarray(histogram_payload_pallas(
        jnp.asarray(pc), jnp.asarray(leaves), jnp.asarray(cnt), num_f=f,
        n_bins=64, rows_per_block=512, compute_dtype=cdt, interpret=True))
    got = histogram_payload(_t(pc), _t(leaves), _t(cnt), num_f=f, n_bins=64,
                            hist_dtype=mode).numpy()
    _assert_hist(got, want, case == "f32_real")


@pytest.mark.parametrize("case", ["k3", "k1", "k8", "ragged_n"])
def test_partition_payload_matches_pallas(case):
    rng = np.random.default_rng(3)
    n = 3001 if case == "ragged_n" else 3072
    f, K = 7, {"k1": 1, "k8": 8}.get(case, 3)
    bins = rng.integers(0, 32, size=(n, f)).astype(np.uint8)
    lor = rng.integers(0, 9, size=n).astype(np.int32)
    mask = rng.integers(0, 2, size=n).astype(np.int32)
    grad = rng.normal(size=n).astype(np.float32)
    hess = rng.random(n).astype(np.float32)
    feats = rng.integers(0, f, size=K).astype(np.int32)
    thr = rng.integers(0, 32, size=K).astype(np.int32)
    dl = rng.integers(0, 2, size=K).astype(np.int32)
    nanb = np.where(rng.random(K) < 0.5, 31, -1).astype(np.int32)
    parents = rng.permutation(9)[:K].astype(np.int32)
    new_leaves = (9 + np.arange(K)).astype(np.int32)
    validk = (np.arange(K) < max(1, K - 2)).astype(np.int32)
    smaller = np.where(rng.random(K) < 0.5, parents,
                       new_leaves).astype(np.int32)
    words = np.asarray(jax_bins_to_words(jnp.asarray(bins)))
    ops = (bins.T.copy(), words, grad, hess, lor, mask, feats, thr, dl,
           nanb, parents, new_leaves, validk, smaller)
    want = partition_payload_pallas(*(jnp.asarray(a) for a in ops),
                                    rows_per_block=512, interpret=True)
    got = partition_payload(*(_t(a) for a in ops))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
