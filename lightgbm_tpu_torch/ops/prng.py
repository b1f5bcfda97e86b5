"""threefry2x32, bit for bit as ``jax.random`` draws it in the JAX package.

The JAX package seeds stochastic gradient rounding from ``jax.random``
(``ops/quantize.py``): a raw uint32[2] key, ``fold_in`` per class,
``split`` into a grad and a hess key, and one ``uniform`` float32 draw per
row.  It runs with ``jax_threefry_partitionable=True`` (jax's default since
0.5), where a draw of ``n`` values hashes the counters ``(hi, lo)`` of each
flat index ``i`` (``hi = i >> 32``, ``lo = i & 0xffffffff``) and ``split``
is the fold-like split over the counters ``(0, j)``.  This module
reproduces those bits, so a port run and a JAX run with the same seed
round every gradient the same way.

A key is a pair of Python ints (its two uint32 words): deriving keys costs
no device work and no host sync.  Only :func:`uniform` runs on a device,
as plain tensor operations on int64 words masked to 32 bits (PyTorch's
uint32 lacks shifts and xors).  ``launches`` counts those operations (one
kernel launch each on the card), so a run can report what the generator
costs per round.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import torch

Key = Tuple[int, int]
Word = Union[int, torch.Tensor]

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

#: tensor operations issued by :func:`uniform` (each one kernel launch on
#: the card); read by chip_smoke.py
launches = 0


def threefry2x32(k: Key, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """The Threefry-2x32 block cipher (20 rounds) of the counter words
    ``(x0, x1)`` under key ``k``: jax's ``threefry2x32_p``.  Counters are
    Python ints or int64 tensors holding uint32 words."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & _MASK
    return x0, x1


def key(seed: int) -> Key:
    """Key words of an integer seed, ``(s >> 32, s & 0xffffffff)`` (the
    JAX package renders its per-round keys this way)."""
    s = int(seed)
    return ((s >> 32) & _MASK, s & _MASK)


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in``: the cipher of ``(data >> 32, data &
    0xffffffff)`` under ``k``."""
    d = int(data)
    return threefry2x32(k, (d >> 32) & _MASK, d & _MASK)


def split(k: Key, num: int = 2) -> List[Key]:
    """``jax.random.split`` (fold-like): new key j is the cipher of the
    counters ``(0, j)``."""
    return [threefry2x32(k, 0, j) for j in range(num)]


def uniform(k: Key, n: int, device=None) -> torch.Tensor:
    """``jax.random.uniform(k, (n,))`` in float32 on [0, 1): the 32 bits
    ``out0 ^ out1`` of each index, their top 23 as the mantissa of a float
    in [1, 2), minus 1."""
    global launches
    i = torch.arange(n, dtype=torch.int64, device=device)
    # the high counter word is 0 below 2^32 rows: a Python int then, so
    # the first rounds skip a tensor of zeros
    hi = (i >> 32) if n > _MASK else 0
    y0, y1 = threefry2x32(k, hi, i)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    f = torch.clamp_min(bits.to(torch.int32).view(torch.float32) - 1.0, 0.0)
    # arange, 2 ops of key injection, 20 rounds of 7, 5 injections of 4,
    # then xor, shift, or, cast, subtract, clamp
    launches += 1 + 2 + 20 * 7 + 5 * 4 + 6
    return f


#: the smallest normal float32, the lower end of ``jax.random.gumbel``'s
#: uniform draw
_TINY = 1.1754943508222875e-38


def gumbel_uniform(k: Key, n: int, device=None) -> torch.Tensor:
    """The uniforms under ``jax.random.gumbel(k, (n,))`` (its default
    mode): ``jax.random.uniform(k, (n,), minval=tiny, maxval=1)``, the [0, 1)
    draw of :func:`uniform` scaled by ``1 - tiny`` (1.0 in float32), plus
    ``tiny``, at least ``tiny``."""
    f = uniform(k, n, device)
    return torch.clamp_min(f * (1.0 - _TINY) + _TINY, _TINY)


def gumbel(k: Key, n: int, device=None) -> torch.Tensor:
    """``jax.random.gumbel(k, (n,))`` in float32: ``-log(-log(u))`` of
    :func:`gumbel_uniform` (the uniforms bit for bit; the logs as PyTorch
    rounds them)."""
    return -torch.log(-torch.log(gumbel_uniform(k, n, device)))
