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

Batches of keys live in int64 tensors [N, 2] (one key's two words a row):
:func:`fold_in_keys`, :func:`split_keys` and :func:`uniform_keys` are
``jax.vmap`` of ``fold_in`` / ``split`` / ``uniform`` bit for bit.  The
growers' per-node draws (extra trees' random thresholds, by-node feature
sampling) go through :func:`draw`: a key, a path of up to three derivation
counters, then ``n`` uniforms, for every row at once.  ``fold_in(k, d)``
and the j-th key of ``split(k, m)`` are both the cipher of one counter
pair under ``k`` (``(d >> 32, d & 0xffffffff)`` and ``(0, j)``), so one
path serves both.  On CUDA tensors :func:`draw` is one launch of
``csrc/prng.cu`` (``draw_launches`` counts them); on CPU tensors it is
its plain version, :func:`draw_plain`.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

from . import cuda_lib
from ..utils import log

Key = Tuple[int, int]
Word = Union[int, torch.Tensor]

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

#: tensor operations issued by :func:`uniform` (each one kernel launch on
#: the card); read by chip_smoke.py
launches = 0
#: launches of csrc/prng.cu's kernel (:func:`draw` on CUDA tensors) in this
#: process; read by chip_smoke.py
draw_launches = 0


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
    # arange, 2 ops of key injection, 20 rounds of 7, 5 injections of 4,
    # then xor, shift, or, cast, subtract, clamp
    launches += 1 + 2 + 20 * 7 + 5 * 4 + 6
    return _bits_to_uniform(y0, y1)


def _bits_to_uniform(y0, y1) -> torch.Tensor:
    """float32 in [0, 1) from the cipher words: the top 23 bits of
    ``y0 ^ y1`` as the mantissa of a float in [1, 2), minus 1."""
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    return torch.clamp_min(bits.to(torch.int32).view(torch.float32) - 1.0,
                           0.0)


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


# ------------------------------------------------------------ tensor keys
def fold_in_keys(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.vmap(jax.random.fold_in)``: keys int64 [N, 2], data an int or
    an int64 tensor [N]; int64 [N, 2]."""
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32((keys[:, 0], keys[:, 1]), (d >> 32) & _MASK,
                          d & _MASK)
    return torch.stack(torch.broadcast_tensors(y0, y1), -1)


def split_keys(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.vmap(lambda k: jax.random.split(k, num))``: int64 [N, num,
    2]; key j of a row is the cipher of the counters ``(0, j)``."""
    j = torch.arange(num, dtype=torch.int64, device=keys.device)[None, :]
    y0, y1 = threefry2x32((keys[:, :1], keys[:, 1:]), 0, j)
    return torch.stack([y0, y1], -1)


def uniform_keys(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.vmap(lambda k: jax.random.uniform(k, (n,)))``: float32 [N,
    n] in [0, 1)."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    hi = (i >> 32) if n > _MASK else 0
    y0, y1 = threefry2x32((keys[:, :1], keys[:, 1:]), hi, i)
    return _bits_to_uniform(y0, y1)


#: one derivation step of :func:`draw`: the counters of the rows, an int64
#: tensor [N], or ``(base, step)``, the counter ``base + r * step`` of row r
Step = Union[torch.Tensor, Tuple[int, int]]


def _step_counters(c: Step, N: int, device) -> torch.Tensor:
    if isinstance(c, torch.Tensor):
        return c
    base, step = c
    return base + step * torch.arange(N, dtype=torch.int64, device=device)


def draw_plain(keys: torch.Tensor, n: int,
               path: Sequence[Step] = ()) -> torch.Tensor:
    """:func:`draw`'s plain version: the same bits from tensor
    operations."""
    N = keys.shape[0]
    k = keys
    for c in path:
        k = fold_in_keys(k, _step_counters(c, N, keys.device))
    return uniform_keys(k, n)


#: the C interface's steps: three (pointer, base, step) triples
MAX_STEPS = 3


def draw(keys: torch.Tensor, n: int,
         path: Sequence[Step] = ()) -> torch.Tensor:
    """float32 [N, n]: for each row r of ``keys`` (int64 [N, 2]; rows may
    be a stride-0 view of one key), the key derived by ciphering the
    counters of ``path`` in turn (``fold_in`` by a datum, or taking key j
    of a ``split``: a counter below 2^32 is either), then ``n`` uniforms
    from it, ``jax.random.uniform(k, (n,))``'s bits.  One launch of
    ``csrc/prng.cu`` on CUDA tensors, :func:`draw_plain` on CPU tensors."""
    if not keys.is_cuda:
        return draw_plain(keys, n, path)
    global draw_launches
    N = keys.shape[0]
    arrays = [c for c in path if isinstance(c, torch.Tensor)]
    if (keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64
            or keys.stride(1) != 1 or len(path) > MAX_STEPS
            or any(c.dtype != torch.int64 or c.shape != (N,)
                   or not c.is_contiguous()
                   or c.device != keys.device for c in arrays)):
        log.fatal("prng.draw takes int64 [N, 2] keys (last dim contiguous) "
                  "and at most %d steps, each an int64 [N] contiguous "
                  "tensor on the keys' device or (base, step)" % MAX_STEPS)
    out = torch.empty(N, n, dtype=torch.float32, device=keys.device)
    if N * n == 0:
        return out
    flat = []
    for s in range(MAX_STEPS):
        c = path[s] if s < len(path) else (0, 0)
        if isinstance(c, torch.Tensor):
            flat += [c.data_ptr(), 0, 0]
        else:
            flat += [None, int(c[0]), int(c[1])]
    code = cuda_lib.load("prng").lgbt_threefry_draw(
        keys.data_ptr(), keys.stride(0), len(path), *flat, N, n,
        out.data_ptr(), cuda_lib.stream_handle(keys))
    if code:
        cuda_lib.check(code, "prng.draw")
    draw_launches += 1
    return out
