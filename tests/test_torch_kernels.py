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
                                          histogram_leaves_rows_pallas,
                                          histogram_payload_pallas)
from lightgbm_tpu.ops.histogram import bins_to_words as jax_bins_to_words
from lightgbm_tpu.ops.round_fuse import (partition_payload_pallas,
                                         partition_select_pallas)
from lightgbm_tpu.ops.table import _take_pallas

from lightgbm_tpu_torch.ops import hist_kernels as HK
from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops.hist_kernels import (histogram_leaves,
                                                 histogram_leaves_packed,
                                                 histogram_leaves_rows,
                                                 histogram_leaves_radix2,
                                                 histogram_payload,
                                                 histogram_radix_joint,
                                                 histogram_radix_single,
                                                 histogram_rows_t)
from lightgbm_tpu_torch.ops.round_fuse import (partition_payload,
                                               partition_select)
from lightgbm_tpu_torch.ops.table import take_small_table

from test_torch_fused import one_torch_thread  # noqa: F401


def _t(a):
    return torch.as_tensor(np.array(a))


#: take's (n, T) where a case changes them: one row, three rows (no full
#: quad of the kernel's 16-byte loads), 1M + 3 rows (a ragged tail after
#: the quads), a one-entry table, a table of more than 2048 floats
_TAKE_SHAPES = {"ragged_n": (1000, 100), "n1": (1, 100), "n3": (3, 100),
                "n_1m_plus_3": (1_000_003, 255), "t1": (2048, 1),
                "t_past_2048": (5000, 3000), "minus_one_and_t": (4099, 255)}


@pytest.mark.parametrize("case", ["in_range", "minus_one",
                                  "past_table_in_pad", "past_pad",
                                  "ragged_n", "n1", "n3", "n_1m_plus_3",
                                  "t1", "t_past_2048", "minus_one_and_t"])
def test_take_matches_pallas(case):
    rng = np.random.default_rng(1)
    # n = 1000: not a block multiple; T = 100 is padded to 128 by the kernel
    n, T = _TAKE_SHAPES.get(case, (1024, 100))
    lo, hi = {"in_range": (0, T), "minus_one": (-1, T),
              "past_table_in_pad": (0, 128), "past_pad": (-5, 400),
              "ragged_n": (-1, 128)}.get(case, (-1, T + 1))
    idx = rng.integers(lo, hi, size=n).astype(np.int32)
    if case == "minus_one":
        idx[::7] = -1
    elif case == "minus_one_and_t":         # exactly the two edges
        idx[::3] = -1
        idx[1::3] = T
    table = rng.normal(size=T).astype(np.float32)
    want = np.asarray(_take_pallas(jnp.asarray(idx), jnp.asarray(table),
                                   rows_per_block=8192 if n > 10_000
                                   else 256, interpret=True))
    got = take_small_table(_t(table), _t(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    ok = (idx >= 0) & (idx < T)
    assert not got[~ok].any()
    np.testing.assert_array_equal(got[ok], table[idx[ok]])


def _hist_inputs(case, n, f, n_bins, seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, n_bins - 1, size=(n, f)).astype(np.uint8)
    lor = rng.integers(-1, 9, size=n).astype(np.int32)
    K = {"k1": 1, "k8": 8}.get(case, 4)
    leaves = np.array([0, 2, 5, 6, 7, 1, 3, 4][:K], np.int32)
    if case == "repeated_slots":
        leaves = np.array([0, 2, 5, 2, 0], np.int32)
    elif case == "leaf_ids_past_table":     # the kernel's linear search
        lor = np.where(lor < 0, -1, lor + 2999).astype(np.int32)
        leaves = np.array([3000, 3002, 3005, 3002, 2047], np.int32)
    elif case == "k84":                     # the pooled extended pass
        lor = rng.integers(-1, 100, size=n).astype(np.int32)
        leaves = rng.permutation(100)[:84].astype(np.int32)
        leaves[-3:] = leaves[0]
    elif case == "empty_selection":
        leaves = np.array([20, 21, 22, 20], np.int32)
    if case in ("f32_real", "f32_nan_excluded", "empty_selection"):
        grad = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
        hess = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    else:
        grad = rng.integers(-3, 4, size=n).astype(np.float32)
        hess = rng.integers(0, 5, size=n).astype(np.float32)
    if case in ("f32_nan_excluded", "empty_selection"):
        out = ~np.isin(lor, leaves)
        grad[out] = np.nan
        hess[out] = np.nan
    mode = "int8" if case in ("int8", "k1", "k8", "repeated_slots",
                              "ragged_n", "leaf_ids_past_table",
                              "k84") else "float32"
    return bins, grad, hess, lor, leaves, mode


def _assert_hist(got, want, real):
    if real:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["int8", "f32_int_valued", "f32_real",
                                  "f32_nan_excluded", "repeated_slots",
                                  "ragged_n", "k1", "k8",
                                  "leaf_ids_past_table", "k84",
                                  "empty_selection"])
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
    if case == "empty_selection":
        assert not got.any()
    _assert_hist(got, want, case in ("f32_real", "f32_nan_excluded"))


@pytest.mark.parametrize("case", ["int8", "f32_int_valued", "f32_real",
                                  "f32_nan_excluded", "repeated_slots",
                                  "ragged_n", "k1", "k8",
                                  "leaf_ids_past_table", "k84",
                                  "empty_selection"])
def test_histogram_leaves_rows_matches_pallas(case):
    """The masked pass from row-major bins u8 [S, F] (F = 9: no whole word
    per row) against the Pallas kernel's rows_major layout."""
    n = 2000 if case == "ragged_n" else 2048
    bins, grad, hess, lor, leaves, mode = _hist_inputs(case, n, 9, 64)
    cdt = jnp.int8 if mode == "int8" else jnp.float32
    want = np.asarray(histogram_leaves_rows_pallas(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(lor), jnp.asarray(leaves), n_bins=64,
        rows_per_block=512, compute_dtype=cdt, interpret=True))
    got = histogram_leaves_rows(_t(bins), _t(grad), _t(hess), _t(lor),
                                _t(leaves), n_bins=64,
                                hist_dtype=mode).numpy()
    assert got.shape == (leaves.shape[0], 9, 64, 4)
    assert np.isfinite(got).all()
    if case == "empty_selection":
        assert not got.any()
    _assert_hist(got, want, case in ("f32_real", "f32_nan_excluded"))


#: the payload pass's edges: no row in use, every row in use, rows below
#: cnt whose leaf is none of the K ids, leaf ids past the kernel's
#: 2048-entry slot table, bins past n_bins, NaN and inf in rows past cnt
_PAYLOAD_EDGES = ("cnt_zero", "cnt_full", "foreign_leaves",
                  "leaf_ids_past_table", "bins_past_n_bins",
                  "nan_inf_past_cnt")


def _payload_inputs(case, seed=2):
    """Compacted payload i32 [S, W+3] (S = 2500 of 3000 rows, F = 10: a
    padded word), leaf ids, cnt, hist_dtype and whether values are real."""
    n, f, S = 3000, 10, 2500
    base = {"cnt_zero": "int8", "cnt_full": "f32_int_valued",
            "foreign_leaves": "int8", "bins_past_n_bins": "f32_int_valued",
            "nan_inf_past_cnt": "f32_real"}.get(case, case)
    bins, grad, hess, lor, leaves, mode = _hist_inputs(base, n, f, 64,
                                                       seed=seed)
    rng = np.random.default_rng(seed + 100)
    cnt = {"cnt_zero": 0, "cnt_full": S}.get(case, 1700)
    if case == "foreign_leaves":            # a third of the rows in use
        lor[rng.random(n) < 0.35] = 40
    elif case == "bins_past_n_bins":
        bins[rng.random(bins.shape) < 0.2] = 200
    elif case == "nan_inf_past_cnt":
        grad[cnt::2] = np.nan
        grad[cnt + 1::2] = np.inf
        hess[cnt::3] = -np.inf
    words = np.asarray(jax_bins_to_words(jnp.asarray(bins)))
    payload = np.concatenate([words, grad.view(np.int32)[:, None],
                              hess.view(np.int32)[:, None], lor[:, None]],
                             axis=1)
    return (np.ascontiguousarray(payload[:S]), leaves,
            np.array([cnt], np.int32), f, mode,
            base in ("f32_real", "f32_nan_excluded"))


@pytest.mark.parametrize("case", ["int8", "f32_int_valued", "f32_real",
                                  "repeated_slots", "k1", "k8",
                                  *_PAYLOAD_EDGES])
def test_histogram_payload_matches_pallas(case):
    pc, leaves, cnt, f, mode, real = _payload_inputs(case)
    cdt = jnp.int8 if mode == "int8" else jnp.float32
    want = np.asarray(histogram_payload_pallas(
        jnp.asarray(pc), jnp.asarray(leaves), jnp.asarray(cnt), num_f=f,
        n_bins=64, rows_per_block=512, compute_dtype=cdt, interpret=True))
    got = histogram_payload(_t(pc), _t(leaves), _t(cnt), num_f=f, n_bins=64,
                            hist_dtype=mode).numpy()
    assert np.isfinite(got).all()
    if case == "cnt_zero":
        assert not got.any()
    _assert_hist(got, want, real)


#: the partition edges a leaf -> slot table must keep: two valid slots
#: splitting one parent (their moves sum), ``smaller`` holding -1 and the
#: ids of invalid slots, split features -1, F and 4W - 1 (F = 6, W = 2: a
#: padding byte), leaf ids past a 2048-entry table
_PARTITION_EDGES = ("same_parent", "smaller_minus_one", "feats_out_of_range",
                    "leaf_ids_past_table")


def _partition_inputs(case, rng):
    n = 3001 if case == "ragged_n" else 3072
    f, K = 7, {"k1": 1, "k8": 8, "k1_zero_mask": 1}.get(case, 3)
    if case in _PARTITION_EDGES:
        K = 6
    if case == "feats_out_of_range":
        f = 6                                          # W = 2, 4W - 1 = 7
    bins = rng.integers(0, 32, size=(n, f)).astype(np.uint8)
    lor = rng.integers(0, 9, size=n).astype(np.int32)
    mask = rng.integers(0, 2, size=n).astype(np.int32)
    if case == "k1_zero_mask":
        mask[:] = 0
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
    if case == "same_parent":
        parents[:] = [2, 2, 5, 2, 7, 2]                # slot 5 invalid
        thr[:] = [31, 8, 12, 20, 5, 0]                 # slot 0 never moves
    elif case == "smaller_minus_one":
        smaller[:] = [-1, parents[1], new_leaves[2], -1, parents[4],
                      parents[5]]                      # 4, 5 invalid
    elif case == "feats_out_of_range":
        feats[:] = [-1, f, 4 * 2 - 1, 3, -7, 1000]
        thr[:3] = 0                                    # column 0 goes left
    elif case == "leaf_ids_past_table":
        lor = (lor + 2995).astype(np.int32)            # 2995 .. 3003
        parents = (parents + 2995).astype(np.int32)
        parents[1] = parents[0]                        # and one shared
        new_leaves = (new_leaves + 3991).astype(np.int32)
        smaller = np.where(rng.random(K) < 0.5, parents,
                           new_leaves).astype(np.int32)
        smaller[0] = 2047
    words = np.asarray(jax_bins_to_words(jnp.asarray(bins)))
    return (bins.T.copy(), words, grad, hess, lor, mask), (
        feats, thr, dl, nanb, parents, new_leaves, validk, smaller)


@pytest.mark.parametrize("case", ["k3", "k1", "k8", "ragged_n",
                                  *_PARTITION_EDGES])
def test_partition_payload_matches_pallas(case):
    rows, desc = _partition_inputs(case, np.random.default_rng(3))
    ops = rows + desc
    want = partition_payload_pallas(*(jnp.asarray(a) for a in ops),
                                    rows_per_block=512, interpret=True)
    got = partition_payload(*(_t(a) for a in ops))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", ["k3", "k1_zero_mask", "k8", "ragged_n",
                                  *_PARTITION_EDGES])
def test_partition_select_matches_pallas(case):
    """Bitwise on both outputs; k8 and k3 carry invalid slots (validk 0),
    k1_zero_mask masks every row out of the next pass's keys; the edges of
    ``_PARTITION_EDGES``."""
    (bins_t, _, _, _, lor, mask), desc = _partition_inputs(
        case, np.random.default_rng(4))
    ops = (bins_t, lor, mask) + desc
    want = partition_select_pallas(*(jnp.asarray(a) for a in ops),
                                   rows_per_block=512, interpret=True)
    got = partition_select(*(_t(a) for a in ops))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "k1_zero_mask":
        assert (got[1].numpy() >= (1 << 30)).all()


# ---- the rows histogram (histogram_pallas): case -> (n, F, n_bins, C,
# value kind, mode); ragged n, F = 6 and 30, B = 64 and 256, C = 4 and 8.
# Values are zero on a quarter of the rows (masked rows, as the callers
# pass them) and bins reach past n_bins - 1 (dropped).
_ROWS_CASES = {
    "int8_c4_f6_b64": (2048, 6, 64, 4, "int", "int8"),
    "f32_int_valued_c8_f30_b256_ragged": (2000, 30, 256, 8, "int",
                                          "float32"),
    "f32_real_c4_f30_b64": (2048, 30, 64, 4, "real", "float32"),
    "bf16_int_valued_c4_f6_b256": (2048, 6, 256, 4, "int", "bfloat16"),
    "bf16_real_c8_f6_b64_ragged": (1900, 6, 64, 8, "real", "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(_ROWS_CASES))
def test_histogram_rows_matches_pallas(case):
    n, f, n_bins, C, kind, mode = _ROWS_CASES[case]
    rng = np.random.default_rng(11)
    bins_t = rng.integers(0, min(n_bins + 8, 256), size=(f, n)
                          ).astype(np.uint8)
    if kind == "real":
        vals_t = rng.normal(size=(C, n)).astype(np.float32)
    else:
        vals_t = rng.integers(-4, 5, size=(C, n)).astype(np.float32)
    vals_t[:, rng.random(n) < 0.25] = 0.0
    want = np.asarray(JP.histogram_pallas(
        jnp.asarray(bins_t), jnp.asarray(vals_t), n_bins=n_bins,
        rows_per_block=512, compute_dtype=_CDT[mode], interpret=True))
    got = histogram_rows_t(_t(bins_t), _t(vals_t), n_bins=n_bins,
                           hist_dtype=mode).numpy()
    assert got.shape == (f, n_bins, C)
    _assert_hist(got, want, kind == "real")


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


#: radix_single beyond _AUTO_CASES: case -> (inputs of that case, and the
#: map lor -> lor * mul + off of its leaf ids >= 0): the strict grower's
#: leaf ids other than 0, ids past 2048, every row excluded, and NaN and
#: inf in both grad and hess of the excluded rows
_SINGLE_EXTRA = {
    "leaf_ids_not_0": ("int8_256_bins", 37, 5),
    "leaf_ids_past_table": ("f32_real", 1, 2999),
    "all_excluded": ("f32_int_valued_f6", 0, -1),
    "nan_inf_excluded": ("bf16_real_ragged_n", 1, 0),
}


@pytest.mark.parametrize("case", sorted(_AUTO_CASES) + sorted(_SINGLE_EXTRA))
def test_radix_single_matches_pallas(case):
    base, mul, off = _SINGLE_EXTRA.get(case, (case, 1, 0))
    bins, grad, hess, lor, _, n_bins, mode, real = _auto_inputs(base)
    lor = np.where(lor < 0, -1, lor * mul + off).astype(np.int32)
    out = lor < 0
    if case == "nan_inf_excluded":
        grad[out] = np.where(np.arange(out.sum()) % 2, np.inf, np.nan)
        hess[out] = np.where(np.arange(out.sum()) % 3, np.nan, -np.inf)
    want = np.asarray(JP.histogram_radix_single_pallas(
        jnp.asarray(bins.T), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(lor), n_bins=n_bins, p=4, **_pallas_kw(mode)))
    got = histogram_radix_single(_t(np.ascontiguousarray(bins.T)), _t(grad),
                                 _t(hess), _t(lor), n_bins=n_bins,
                                 hist_dtype=mode).numpy()
    assert got.shape == (bins.shape[1], n_bins, 4) and np.isfinite(got).all()
    assert got[..., 2].sum() == (lor >= 0).sum() * bins.shape[1]
    _assert_hist(got, want, real)


#: radix_joint beyond _AUTO_CASES: case -> (inputs of that case, leaf ids):
#: G = 1, 2 and 3, and the warm-up ladder's dummy layout of one leaf
#: repeated in every slot
_JOINT_EXTRA = {
    "g1": ("f32_real", [6]),
    "g2": ("bf16_real_ragged_n", [2, 0]),
    "g3": ("f30", [1, 6, 3]),
    "dummy_repeat": ("int8_256_bins", [7, 7, 7, 7]),
}


@pytest.mark.parametrize("case", sorted(_AUTO_CASES) + sorted(_JOINT_EXTRA))
def test_radix_joint_matches_pallas(case):
    base, lv = _JOINT_EXTRA.get(case, (case, None))
    lv = {"int8_256_bins": [5], "repeated_slots": [4, 2, 4, 4]}.get(case, lv)
    bins, grad, hess, lor, leaves, n_bins, mode, real = _auto_inputs(
        base, seed=6, leaves=lv)
    want = np.asarray(JP.histogram_radix_joint_pallas(
        jnp.asarray(bins.T), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(lor), jnp.asarray(leaves), n_bins=n_bins, p=4,
        **_pallas_kw(mode)))
    got = histogram_radix_joint(_t(np.ascontiguousarray(bins.T)), _t(grad),
                                _t(hess), _t(lor), _t(leaves),
                                n_bins=n_bins, hist_dtype=mode).numpy()
    assert np.isfinite(got).all()
    _assert_hist(got, want, real)


# radix2 beyond _AUTO_CASES: (inputs of that case, leaf ids, and the map
# lor -> lor * mul + off of its leaf ids >= 0): leaf ids past the kernel's
# 2048-entry slot table (its linear search), the pooled pass's 84 slots
# (repeats among them) and no selected row
_RADIX2_EXTRA = {
    "leaf_ids_past_table": ("int8_256_bins", [3000, 3002, 3005, 3002, 2047],
                            1, 2999),
    "k84": ("f32_int_valued_f6", list(range(80)) + [11, 66, 11, 0], 11, 0),
    "empty_selection": ("f32_real", [20, 21, 22, 20, 23], 1, 0),
}


@pytest.mark.parametrize("case", sorted(_AUTO_CASES) + sorted(_RADIX2_EXTRA))
def test_radix2_matches_pallas(case):
    lv = {"int8_256_bins": [0, 2, 5, 7, 1, 3], "repeated_slots":
          [4, 2, 4, 4, 6, 2]}.get(case)
    base, mul, off = case, 1, 0
    if case in _RADIX2_EXTRA:
        base, lv, mul, off = _RADIX2_EXTRA[case]
    bins, grad, hess, lor, leaves, n_bins, mode, real = _auto_inputs(
        base, seed=7, leaves=lv)
    lor = np.where(lor < 0, -1, lor * mul + off).astype(np.int32)
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
    if case == "empty_selection":
        assert not got.any()
    _assert_hist(got, want, real)


#: packed beyond _AUTO_CASES: the K = 42 pass of every max_bin=63 round at a
#: ragged n (not a multiple of 4), from the inputs of ``f30``
_PACKED_EXTRA = {"k42_ragged_n": ("f30", 2001, 42)}


@pytest.mark.parametrize("case", sorted(_AUTO_CASES) + sorted(_PACKED_EXTRA))
def test_packed_matches_pallas(case):
    base, lv = case, None
    if case in _PACKED_EXTRA:
        base, n_cut, k = _PACKED_EXTRA[case]
        lv = np.random.default_rng(2).permutation(8)[:6].tolist()
        lv = (lv * 7)[:k]                              # repeated slots
    bins, grad, hess, lor, leaves, n_bins, mode, real = _auto_inputs(
        base, seed=8, leaves=lv)
    if case in _PACKED_EXTRA:
        bins, grad, hess, lor = (np.ascontiguousarray(a[:n_cut])
                                 for a in (bins, grad, hess, lor))
        assert bins.shape[0] % 4 and leaves.shape[0] == 42
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


# ---- the kernels' fixed-point arithmetic mirrored in PyTorch: float32 and
# bfloat16 histograms sum round(v * 2^s) in int64, s = fixed_shift(max
# finite |value|, n) per channel.  On integer values the mirror is the
# plain version bit for bit; on real values each term rounds by at most
# 2^-s / 2, so a cell is within n * 2^-s of the float64 sum, plus the one
# rounding of that sum to f32.

def _fixed_values(case, n, rng):
    v = rng.normal(size=n).astype(np.float32)
    if case == "all_zeros":
        v[:] = 0.0
    elif case == "single_nonzero":
        v[:] = 0.0
        v[n // 3] = -2.75
    elif case == "denormal_max":
        v = (rng.normal(size=n) * 1e-39).astype(np.float32)
    elif case == "inf_nan_ignored":
        v[::7] = np.nan
        v[3] = np.inf
        v[5] = -np.inf
    return v


def _within_fixed(got, v64, n, s):
    tol = n * 2.0 ** -s + np.abs(v64) * 2.0 ** -24
    assert np.isfinite(got).all()
    assert (np.abs(got.astype(np.float64) - v64) <= tol).all(), (
        np.abs(got - v64).max(), s)


@pytest.mark.parametrize("mode", ["int8", "float32", "bfloat16"])
def test_rows_fixed_reference_exact_on_integer_values(mode):
    rng = np.random.default_rng(21)
    bins = _t(rng.integers(0, 70, size=(5, 1999)).astype(np.uint8))
    vals = _t(rng.integers(-4, 5, size=(8, 1999)).astype(np.float32))
    got = HK.histogram_rows_t_fixed(bins, vals, n_bins=64, hist_dtype=mode)
    want = HK.histogram_rows_t_plain(bins, vals, n_bins=64, hist_dtype=mode)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("mode", ["int8", "float32", "bfloat16"])
def test_radix_single_fixed_reference_exact_on_integer_values(mode):
    rng = np.random.default_rng(22)
    n = 2003
    bins = _t(rng.integers(0, 256, size=(6, n)).astype(np.uint8))
    g = rng.integers(-3, 4, size=n).astype(np.float32)
    h = rng.integers(0, 5, size=n).astype(np.float32)
    lor = rng.integers(-1, 2, size=n).astype(np.int32)
    g[lor < 0] = np.nan                      # excluded rows never count
    args = (bins, _t(g), _t(h), _t(lor))
    got = HK.histogram_radix_single_fixed(*args, n_bins=200, hist_dtype=mode)
    want = HK.histogram_radix_single_plain(*args, n_bins=200,
                                           hist_dtype=mode)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("mode", ["int8", "float32", "bfloat16"])
def test_leaves_fixed_reference_exact_on_integer_values(mode):
    rng = np.random.default_rng(25)
    n = 2003
    bins = _t(rng.integers(0, 70, size=(5, n)).astype(np.uint8))
    lor = rng.integers(-1, 9, size=n).astype(np.int32)
    leaves = np.array([0, 2, 5, 2, 7, 0, 3000], np.int32)   # repeats, > 2047
    lor[::11] = 3000
    g = rng.integers(-3, 4, size=n).astype(np.float32)
    h = rng.integers(0, 5, size=n).astype(np.float32)
    g[~np.isin(lor, leaves)] = np.nan        # excluded rows never count
    args = (bins, _t(g), _t(h), _t(lor), _t(leaves))
    got = HK.histogram_leaves_fixed(*args, n_bins=64, hist_dtype=mode)
    want = HK.histogram_leaves_plain(*args, n_bins=64, hist_dtype=mode)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("case", ["real", "all_zeros", "single_nonzero",
                                  "denormal_max", "inf_nan_ignored"])
def test_leaves_fixed_reference_close_to_float64_sums(case):
    rng = np.random.default_rng(26)
    n, f, nb = 3001, 4, 32
    bins = rng.integers(0, nb, size=(f, n)).astype(np.uint8)
    v = _fixed_values(case, n, rng)
    w = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    # rows whose value is not finite are excluded; leaf 1 is not selected
    # but its rows set the scale, which is over all n rows
    lor = np.where(np.isfinite(v), rng.integers(0, 4, size=n), -1)
    lor = lor.astype(np.int32)
    leaves = np.array([0, 2, 3, 2], np.int32)
    s = HK.fixed_shift(int(HK.absmax_bits(_t(v))), n)
    got = HK.histogram_leaves_fixed(_t(bins), _t(v), _t(w), _t(lor),
                                    _t(leaves), n_bins=nb,
                                    hist_dtype="float32").numpy()
    for k, leaf in enumerate(leaves):
        rows = lor == leaf
        want = np.zeros((f, nb))
        cnt = np.zeros((f, nb))
        for j in range(f):
            np.add.at(want[j], bins[j][rows], v[rows].astype(np.float64))
            np.add.at(cnt[j], bins[j][rows], 1.0)
        _within_fixed(got[k, ..., 0], want, n, s)
        np.testing.assert_array_equal(got[k, ..., 2], cnt)
    np.testing.assert_array_equal(got[3], got[1])         # the copy
    assert not got[..., 3].any()


@pytest.mark.parametrize("mode", ["int8", "float32", "bfloat16"])
@pytest.mark.parametrize("case", ["int8", "repeated_slots",
                                  *_PAYLOAD_EDGES[:-1]])
def test_payload_fixed_reference_exact_on_integer_values(case, mode):
    pc, leaves, cnt, f, _, real = _payload_inputs(case)
    assert not real
    args = (_t(pc), _t(leaves), _t(cnt))
    got = HK.histogram_payload_fixed(*args, num_f=f, n_bins=64,
                                     hist_dtype=mode)
    want = HK.histogram_payload_plain(*args, num_f=f, n_bins=64,
                                      hist_dtype=mode)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("case", ["f32_real", "nan_inf_past_cnt",
                                  "cnt_full_real", "big_past_cnt"])
def test_payload_fixed_reference_close_to_float64_sums(case):
    pc, leaves, cnt, f, _, _ = _payload_inputs(
        {"cnt_full_real": "f32_real", "big_past_cnt": "f32_real"}.get(
            case, case))
    S, W = pc.shape[0], pc.shape[1] - 3
    if case == "cnt_full_real":
        cnt[0] = S
    g = pc[:, W].view(np.float32).copy()
    h = pc[:, W + 1].view(np.float32).copy()
    if case == "big_past_cnt":      # a row past cnt sets the scale alone
        g[S - 1] = 1e4
        pc = pc.copy()
        pc[:, W] = g.view(np.int32)
    c = int(cnt[0])
    # the scale is over all S rows, rows at or past cnt included
    sg = HK.fixed_shift(int(HK.absmax_bits(_t(g))), S)
    sh = HK.fixed_shift(int(HK.absmax_bits(_t(h))), S)
    got = HK.histogram_payload_fixed(_t(pc), _t(leaves), _t(cnt), num_f=f,
                                     n_bins=64,
                                     hist_dtype="float32").numpy()
    lor = pc[:, W + 2]
    for k, leaf in enumerate(leaves):
        first = int(np.argmax(leaves == leaf))
        rows = np.flatnonzero(lor[:c] == leaf)
        for j in range(f):
            b = (pc[rows, j // 4] >> (8 * (j % 4))) & 255
            keep = b < 64
            for ch, (v, s) in enumerate(((g, sg), (h, sh))):
                want = np.zeros(64)
                np.add.at(want, b[keep], v[rows][keep].astype(np.float64))
                _within_fixed(got[k, j, :, ch], want, S, s)
            cnt_want = np.bincount(b[keep], minlength=64)[:64]
            np.testing.assert_array_equal(got[k, j, :, 2], cnt_want)
        np.testing.assert_array_equal(got[k], got[first])
    assert np.isfinite(got).all() and not got[..., 3].any()


@pytest.mark.parametrize("case", ["real", "all_zeros", "single_nonzero",
                                  "denormal_max", "inf_nan_ignored"])
def test_fixed_reference_close_to_float64_sums(case):
    rng = np.random.default_rng(23)
    n, f, nb = 3001, 4, 32
    bins = rng.integers(0, nb, size=(f, n)).astype(np.uint8)
    v = _fixed_values(case, n, rng)
    w = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    finite = np.isfinite(v)
    s = HK.fixed_shift(int(HK.absmax_bits(_t(v))), n)
    # rows: channel 0 = v on its finite rows (the callers zero the rest)
    vals = np.stack([np.where(finite, v, 0), w]).astype(np.float32)
    got = HK.histogram_rows_t_fixed(_t(bins), _t(vals), n_bins=nb,
                                    hist_dtype="float32").numpy()
    want = np.zeros((f, nb))
    for j in range(f):
        np.add.at(want[j], bins[j], vals[0].astype(np.float64))
    _within_fixed(got[..., 0], want, n, s)
    # radix single: rows whose value is not finite are excluded
    lor = np.where(finite, 0, -1).astype(np.int32)
    got = HK.histogram_radix_single_fixed(
        _t(bins), _t(v), _t(w), _t(lor), n_bins=nb,
        hist_dtype="float32").numpy()
    _within_fixed(got[..., 0], want, n, s)
    cnt = np.zeros((f, nb))
    for j in range(f):
        np.add.at(cnt[j], bins[j][finite], 1.0)
    np.testing.assert_array_equal(got[..., 2], cnt)
    if case == "all_zeros":
        assert s == 0 and not got[..., 0].any()


def _numpy_shift(vmax, n):
    if not vmax > 0:
        return 0
    _, e = np.frexp(np.float64(vmax))
    k = int(np.floor(np.log2(max(n, 1)))) + 1
    return 62 - k - int(e)


@pytest.mark.parametrize("vmax,n", [(3.0, 3000), (0.0, 10), (1.0, 1),
                                    (1.0, 1 << 20), (0.999, (1 << 20) - 1),
                                    (1e-40, 90_000), (3.4e38, 2),
                                    (float("nan"), 5)])
def test_fixed_shift_mirror(vmax, n):
    bits = int(np.array([vmax], np.float32).view(np.int32)[0])
    s = HK.fixed_shift(bits, n)
    assert s == _numpy_shift(np.float32(vmax), n)
    if vmax > 0:
        # n values below 2^e at 2^s sum below 2^62
        assert n * 2.0 ** (s + np.frexp(np.float64(np.float32(vmax)))[1]) \
            <= 2.0 ** 62


@pytest.mark.parametrize("case", ["real", "inf_nan_ignored", "denormal_max",
                                  "all_zeros"])
def test_pass_scale_matches_numpy(case):
    rng = np.random.default_rng(24)
    g = _fixed_values(case, 777, rng)
    h = rng.uniform(0, 3, size=777).astype(np.float32)
    if case == "inf_nan_ignored":
        h[:] = np.nan                       # nothing finite: 0
    got = HK.pass_scale(_t(g), _t(h)).numpy()
    assert got.dtype == np.int32 and got.shape == (2,)
    for v, bits in zip((g, h), got):
        a = np.abs(v[np.isfinite(v)])
        want = a.max() if a.size else np.float32(0)
        assert bits == np.array([want], np.float32).view(np.int32)[0]


@pytest.mark.parametrize("hk,n_bins,dtype,wanted", [
    ("auto", 256, "float32", True), ("auto", 256, "bfloat16", True),
    ("auto", 256, "int8", False), ("auto", 64, "float32", False),
    ("onehot", 256, "float32", False)])
def test_leaf_pass_scale_only_where_radix_single_reads_it(hk, n_bins, dtype,
                                                          wanted):
    g = _t(np.array([1.5, -4.0, np.nan], np.float32))
    h = _t(np.array([0.25, 1.0, 2.0], np.float32))
    got = TH.leaf_pass_scale(g, h, n_bins=n_bins, hist_dtype=dtype,
                             hist_kernel=hk)
    assert (got is not None) == wanted
    if wanted:
        np.testing.assert_array_equal(
            got.numpy(), np.array([4.0, 2.0], np.float32).view(np.int32))
