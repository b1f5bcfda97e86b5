"""The port's threefry2x32 (lightgbm_tpu_torch/ops/prng.py) against
``jax.random``, bit for bit, and the stochastic gradient rounding built on
it against the JAX package's ``discretize_gradients_levels``.

Seeds 0, 7919 * 3 and 2^31 + 5 are also compared through
``jax.random.PRNGKey``; 2^35 only as a key-word pair, since PRNGKey keeps
32 bits of a seed when jax runs without x64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightgbm_tpu.ops.quantize import (
    discretize_gradients_levels as jax_discretize)

from lightgbm_tpu_torch.ops import prng
from lightgbm_tpu_torch.ops.quantize import discretize_gradients_levels

SEEDS = [0, 7919 * 3, 2 ** 31 + 5, 2 ** 35]


def _jkey(k):
    return jnp.asarray(np.array(k, np.uint32))


def _words(a):
    return tuple(int(x) for x in np.asarray(a).reshape(-1))


def test_jax_runs_partitionable_threefry():
    # the layout of counters the port reproduces
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_match_jax(seed):
    k = prng.key(seed)
    assert k == ((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF)
    if seed < 2 ** 32:
        assert _words(jax.random.PRNGKey(seed)) == k
    jk = _jkey(k)
    for data in (0, 1, 5, 2 ** 31 + 9):
        assert prng.fold_in(k, data) == \
            _words(jax.random.fold_in(jk, data)), data
    want = np.asarray(jax.random.split(jk))
    assert [tuple(w) for w in want.tolist()] == prng.split(k)
    want3 = np.asarray(jax.random.split(jk, 3))
    assert [tuple(w) for w in want3.tolist()] == prng.split(k, 3)


@pytest.mark.parametrize("n", [1, 7, 4096, 10_001])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax(seed, n):
    k = prng.fold_in(prng.key(seed), 1)
    want = np.asarray(jax.random.uniform(_jkey(k), (n,)))
    got = prng.uniform(k, n).numpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("const_hess", [False, True])
@pytest.mark.parametrize("seed,it,cls", [(0, 0, 0), (3, 7, 0), (11, 2, 1)])
def test_stochastic_levels_match_jax(seed, it, cls, const_hess):
    """The booster's key (seed * 7919 + iter, folded with the class) and
    the stochastic rounding it drives, bitwise."""
    rng = np.random.default_rng(seed)
    n = 5000
    g = rng.normal(size=n).astype(np.float32)
    h = (np.full(n, 0.25) if const_hess
         else rng.uniform(0.05, 0.25, size=n)).astype(np.float32)
    jk = jax.random.fold_in(jax.random.PRNGKey(seed * 7919 + it), cls)
    want = jax_discretize(jnp.asarray(g), jnp.asarray(h), jk, n_levels=4,
                          stochastic=True, constant_hessian=const_hess)
    k = prng.fold_in(prng.key(seed * 7919 + it), cls)
    assert k == _words(jk)
    got = discretize_gradients_levels(torch.as_tensor(g), torch.as_tensor(h),
                                      k, n_levels=4, stochastic=True,
                                      constant_hessian=const_hess)
    for a, b in zip(got, want):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    # the stochastic levels differ from the deterministic ones somewhere
    det = discretize_gradients_levels(torch.as_tensor(g), torch.as_tensor(h),
                                      n_levels=4, stochastic=False)
    assert not torch.equal(det[0], got[0])


def test_uniform_counts_its_launches():
    before = prng.launches
    prng.uniform(prng.key(1), 10)
    assert prng.launches > before
