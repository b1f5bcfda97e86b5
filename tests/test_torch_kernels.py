"""The plain PyTorch versions of the port's kernels against the JAX
package's Pallas kernels, run through the Pallas interpreter on the CPU,
and the port's copy of the histogram dispatch against the JAX package's.

int8 levels are compared bitwise, float32 and bfloat16 bitwise on
integer-valued inputs, and on real-valued inputs to rtol 1e-6 (the two sum
the same terms in another order).  The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import hist_pallas as JP
from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu.ops.hist_pallas import (_histogram_leaves_impl,
                                          histogram_payload_pallas)
from lightgbm_tpu.ops.histogram import bins_to_words as jax_bins_to_words
from lightgbm_tpu.ops.round_fuse import partition_payload_pallas
from lightgbm_tpu.ops.table import _take_pallas

from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops.hist_kernels import (histogram_leaves,
                                                 histogram_leaves_packed,
                                                 histogram_leaves_radix2,
                                                 histogram_payload,
                                                 histogram_radix_joint,
                                                 histogram_radix_single)
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


# ---- the radix and packed kernels of hist_kernel=auto
#
# case -> (n, F, n_bins, leaves, value kind, mode).  Each case varies one
# kernel-facing property: int8 at the main path's 256 bins, f32 bitwise on
# integer values (with F = 6), f32 and bf16 on real values (bf16 with a
# ragged n), repeated slots, F = 30 (half a word of padding); rows with
# leaf -1 (grad NaN) in every case

_AUTO_CASES = {
    "int8_256_bins": (2048, 5, 256, [3, 1], "int", "int8"),
    "f32_int_valued_f6": (2048, 6, 64, [1, 0, 6], "int", "float32"),
    "f32_real": (2048, 9, 64, [0, 2, 5], "real", "float32"),
    "bf16_real_ragged_n": (2000, 9, 64, [0, 2, 5], "real", "bfloat16"),
    "repeated_slots": (2048, 9, 64, [4, 2, 4, 4], "int", "int8"),
    "f30": (2048, 30, 64, [1, 0, 6], "int", "int8"),
}
_CDT = {"int8": jnp.int8, "float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _auto_inputs(case, seed=5, leaves=None):
    n, f, n_bins, lv, kind, mode = _AUTO_CASES[case]
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, n_bins, size=(n, f)).astype(np.uint8)
    lor = rng.integers(-1, 8, size=n).astype(np.int32)
    if kind == "real":
        grad = rng.normal(size=n).astype(np.float32)
        hess = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    else:
        grad = rng.integers(-3, 4, size=n).astype(np.float32)
        hess = rng.integers(0, 5, size=n).astype(np.float32)
    # excluded rows may carry NaN: they must never reach a sum
    grad[lor == -1] = np.nan
    lv = np.array(lv if leaves is None else leaves, np.int32)
    return bins, grad, hess, lor, lv, n_bins, mode, kind == "real"


def _pallas_kw(mode):
    return dict(rows_per_block=1024, compute_dtype=_CDT[mode],
                interpret=True)


@pytest.mark.parametrize("case", sorted(_AUTO_CASES))
def test_radix_single_matches_pallas(case):
    bins, grad, hess, lor, _, n_bins, mode, real = _auto_inputs(case)
    want = np.asarray(JP.histogram_radix_single_pallas(
        jnp.asarray(bins.T), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(lor), n_bins=n_bins, p=4, **_pallas_kw(mode)))
    got = histogram_radix_single(_t(np.ascontiguousarray(bins.T)), _t(grad),
                                 _t(hess), _t(lor), n_bins=n_bins,
                                 hist_dtype=mode).numpy()
    assert got.shape == (bins.shape[1], n_bins, 4) and np.isfinite(got).all()
    _assert_hist(got, want, real)


@pytest.mark.parametrize("case", sorted(_AUTO_CASES))
def test_radix_joint_matches_pallas(case):
    lv = {"int8_256_bins": [5], "repeated_slots": [4, 2, 4, 4]}.get(case)
    bins, grad, hess, lor, leaves, n_bins, mode, real = _auto_inputs(
        case, seed=6, leaves=lv)
    want = np.asarray(JP.histogram_radix_joint_pallas(
        jnp.asarray(bins.T), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(lor), jnp.asarray(leaves), n_bins=n_bins, p=4,
        **_pallas_kw(mode)))
    got = histogram_radix_joint(_t(np.ascontiguousarray(bins.T)), _t(grad),
                                _t(hess), _t(lor), _t(leaves),
                                n_bins=n_bins, hist_dtype=mode).numpy()
    assert np.isfinite(got).all()
    _assert_hist(got, want, real)


@pytest.mark.parametrize("case", sorted(_AUTO_CASES))
def test_radix2_matches_pallas(case):
    lv = {"int8_256_bins": [0, 2, 5, 7, 1, 3], "repeated_slots":
          [4, 2, 4, 4, 6, 2]}.get(case)
    bins, grad, hess, lor, leaves, n_bins, mode, real = _auto_inputs(
        case, seed=7, leaves=lv)
    p = JP.radix2_pick_p(bins.shape[1], leaves.shape[0], n_bins)
    assert p > 0
    want = np.asarray(JP.histogram_leaves_radix2_pallas(
        jnp.asarray(bins.T), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(lor), jnp.asarray(leaves), n_bins=n_bins, p=p,
        **_pallas_kw(mode)))
    got = histogram_leaves_radix2(_t(np.ascontiguousarray(bins.T)), _t(grad),
                                  _t(hess), _t(lor), _t(leaves),
                                  n_bins=n_bins, hist_dtype=mode).numpy()
    assert np.isfinite(got).all()
    _assert_hist(got, want, real)


@pytest.mark.parametrize("case", sorted(_AUTO_CASES))
def test_packed_matches_pallas(case):
    bins, grad, hess, lor, leaves, n_bins, mode, real = _auto_inputs(
        case, seed=8)
    n, f = bins.shape
    words_t = np.ascontiguousarray(np.asarray(
        jax_bins_to_words(jnp.asarray(bins))).T)
    if f % 4:
        # bytes past num_f in the last word must be dropped, whatever they
        # hold
        pad = np.random.default_rng(1).integers(0, n_bins, size=n)
        words_t[-1] |= (pad.astype(np.int32) << 24)
    want = np.asarray(JP.histogram_leaves_packed_pallas(
        jnp.asarray(words_t), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(lor), jnp.asarray(leaves), num_f=f, n_bins=n_bins,
        **_pallas_kw(mode)))
    got = histogram_leaves_packed(_t(words_t), _t(grad), _t(hess), _t(lor),
                                  _t(leaves), num_f=f, n_bins=n_bins,
                                  hist_dtype=mode).numpy()
    assert got.shape == (leaves.shape[0], f, n_bins, 4)
    assert np.isfinite(got).all()
    _assert_hist(got, want, real)


@pytest.mark.parametrize("hk", ["auto", "onehot", "packed", "radix2"])
def test_dispatch_rules_match_jax(hk):
    for n_bins in (16, 64, 128, 256):
        assert TH.wants_packed_mirror(hk, n_bins) == \
            JH.wants_packed_mirror(hk, n_bins)
        assert TH.ladder_profitable(hk, n_bins) == \
            JH.ladder_profitable(hk, n_bins)
        assert TH._radix_ok(n_bins) == JH._radix_ok(n_bins)
        for K in (1, 4, 5, 16, 42, 84):
            for f in (1, 6, 28, 30, 200):
                assert TH.radix2_pick_p(f, K, n_bins) == \
                    JP.radix2_pick_p(f, K, n_bins)
                for have_words in (False, True):
                    assert TH._masked_kernel_for(
                        hk, n_bins, K, f, have_words) == \
                        JH._masked_kernel_for(hk, n_bins, K, f, have_words), \
                        (hk, n_bins, K, f, have_words)
    assert TH._RADIX2_ACC_BYTES == JP._RADIX2_ACC_BYTES


@pytest.mark.parametrize("hk,n_bins,K,want", [
    ("auto", 256, 1, "histogram_radix_joint"),
    ("auto", 256, 4, "histogram_radix_joint"),
    ("auto", 256, 16, "histogram_leaves_radix2"),
    ("auto", 64, 16, "histogram_leaves_packed"),
    ("onehot", 256, 16, "histogram_leaves"),
    ("radix2", 64, 5, "histogram_leaves_radix2"),
    ("packed", 256, 5, "histogram_leaves_packed"),
])
def test_masked_pass_takes_the_dispatched_kernel(monkeypatch, hk, n_bins, K,
                                                 want):
    """The masked pass calls the wrapper the rule names, and any kernel
    gives the flat histogram."""
    rng = np.random.default_rng(9)
    n, f = 3000, 6
    bins = rng.integers(0, n_bins, size=(n, f)).astype(np.uint8)
    lor = rng.integers(-1, 20, size=n).astype(np.int32)
    leaves = np.arange(K, dtype=np.int32)[::-1].copy()
    g = rng.integers(-2, 3, size=n).astype(np.float32)
    h = rng.integers(0, 4, size=n).astype(np.float32)
    bt = _t(np.ascontiguousarray(bins.T))
    words_t = TH.bins_to_words(_t(bins)).t().contiguous()
    called = []
    real = getattr(TH, want)

    def spy(*a, **k):
        called.append(want)
        return real(*a, **k)

    monkeypatch.setattr(TH, want, spy)
    got = TH.histogram_for_leaves_masked(
        bt, _t(g), _t(h), _t(lor), _t(leaves), n_bins=n_bins,
        hist_dtype="int8", hist_kernel=hk, bins_words_t=words_t)
    assert called == [want]
    flat = histogram_leaves(bt, _t(g), _t(h), _t(lor), _t(leaves),
                            n_bins=n_bins, hist_dtype="int8")
    assert torch.equal(got, flat)
    root = TH.root_histogram(bt, _t(g), _t(h), n_bins=n_bins,
                             hist_dtype="int8", hist_kernel=hk,
                             bins_words_t=words_t)
    zero = torch.zeros(n, dtype=torch.int32)
    assert torch.equal(root, histogram_leaves(
        bt, _t(g), _t(h), zero, zero[:1], n_bins=n_bins,
        hist_dtype="int8")[0])
