"""The forest predictor's kernel: every tree of a model over a row block.

:func:`forest_values` (raw scores f32 [n, k]) and :func:`forest_leaves`
(leaf indices i32 [T, n]) take a stacked forest (models/predict.py
:class:`ForestArrays` or :class:`BitsetForest`, with its ``left`` /
``right`` children) and feature-major bins ``bins_t`` [F, n] (u8 from
``bin_external`` or i32 logical bins from ``bin_external_pred``; a column
slice of a wider matrix is taken as it is, through its row stride).  On a
CUDA tensor they launch the kernel of csrc/forest.cu, one launch a call: a
thread walks one row through every tree (a port kernel with no
``pallas_call`` counterpart: it replaces the XLA programs
``predict_numeric_forest``, ``predict_bitset_forest`` and
``predict_forest_leaves`` of ``lightgbm_tpu/models/predict.py``).  On a
CPU tensor they run those functions' plain versions (models/predict.py
``predict_bitset_forest``, which serves numeric forests as well, and
``predict_forest_leaves``).  The kernel's leaves are the plain version's
exactly, and its float32 sums are the plain version's bit for bit (the
same additions in the same order).

Linear leaves (:class:`~lightgbm_tpu_torch.models.predict.LinearLeaves`,
values mode; the JAX package's ``LinearLeaves`` extension,
models/predict.py:229-236, 340-370): :func:`forest_values` takes them with
the rows' raw values ``raw_t`` [Fr, n] (feature-major, NaN kept); the
kernel's linear mode adds each leaf's ``const + coeff . x`` after the walk
(:func:`pack_linear`'s per-leaf feature lists), in the plain version's
order, so the bits stay the same.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional

import torch

from ..models.predict import predict_bitset_forest, predict_forest_leaves
from ..utils import log
from . import cuda_lib

#: launches of the CUDA kernel in this process (chip_smoke.py resets and
#: reads it to show that Booster.predict went through the kernel)
launches = 0


class PackedForest(NamedTuple):
    """A stacked forest in the kernel's layout, on the forest's device."""
    nodes: torch.Tensor   # i32 [T, ni, 4]: feature, threshold, left, right
    meta: torch.Tensor    # i32 [T, ni, 2]: nan bin, flags (bit 0
                          # default-left, bits 1.. categorical slot + 1)
    catb: torch.Tensor    # u8 [T, C, Bc] membership (C = 0: none)
    value: torch.Tensor   # f32 [T, L]
    cls: torch.Tensor     # i32 [T]


def pack_forest(f, cat_feats: tuple = ()) -> PackedForest:
    """The kernel's tables of a stacked forest, built on its device with no
    host read.  A categorical node (a :class:`BitsetForest` slot whose
    ``catn`` is a node, ``cat_feats`` non-empty) gets its slot in the
    flags, its slot's feature as its feature and its membership bytes;
    as in the plain version, a slot whose feature is not in ``cat_feats``
    sends every row right."""
    if f.left is None or f.right is None:
        log.fatal("the forest kernel needs the trees' children (left / "
                  "right); build the forest with boosting/gbdt.py "
                  "forest_arrays or give them to forest_from_numpy")
    i32 = torch.int32
    T, ni = f.feat.shape
    dev = f.feat.device
    feat = f.feat.to(i32)
    flags = f.dl.to(i32)
    if cat_feats and getattr(f, "catn", None) is not None:
        C, Bc = f.catb.shape[1], f.catb.shape[2]
        slot = torch.full((T, ni + 1), -1, dtype=torch.int64, device=dev)
        cols = f.catn.long().clamp(0, ni)          # pad slots -> column ni
        slot.scatter_(1, cols, torch.arange(C, device=dev).expand(T, C))
        slot = slot[:, :ni]
        known = torch.isin(f.catf, torch.as_tensor(cat_feats, dtype=i32,
                                                   device=dev))
        catb = ((f.catb.float() > 0.5) & known[:, :, None]).to(torch.uint8)
        feat = torch.where(slot >= 0,
                           torch.gather(f.catf, 1, slot.clamp(min=0)), feat)
        flags = flags | ((slot.to(i32) + 1) << 1)
    else:
        catb = torch.zeros(T, 0, 0, dtype=torch.uint8, device=dev)
    return PackedForest(
        nodes=torch.stack([feat, f.thr.to(i32), f.left.to(i32),
                           f.right.to(i32)], -1).contiguous(),
        meta=torch.stack([f.nanb.to(i32), flags], -1).contiguous(),
        catb=catb.contiguous(),
        value=f.value.to(torch.float32).contiguous(),
        cls=f.cls.to(i32).contiguous())


class PackedLinear(NamedTuple):
    """A forest's linear leaves in the kernel's layout."""
    feat: torch.Tensor    # i32 [T, L, Kl] raw columns, increasing, -1 pad
    coef: torch.Tensor    # f32 [T, L, Kl]
    const: torch.Tensor   # f32 [T, L]


def pack_linear(lin) -> PackedLinear:
    """The kernel's tables of :class:`LinearLeaves`: each leaf's columns
    (``featmask`` set) in increasing order and their coefficients, Kl the
    most a leaf has (one host read of it)."""
    use = lin.featmask.float() > 0.5                       # [T, L, Fr]
    Fr = use.shape[-1]
    Kl = max(int(use.sum(-1).max()) if use.numel() else 0, 1)
    iota = torch.arange(Fr, device=use.device)
    idx = torch.sort(torch.where(use, iota, Fr), dim=-1).values[..., :Kl]
    has = idx < Fr
    coef = lin.coeff.float().gather(-1, idx.clamp(max=max(Fr - 1, 0)))
    return PackedLinear(
        feat=torch.where(has, idx, -1).to(torch.int32).contiguous(),
        coef=torch.where(has, coef, torch.zeros_like(coef)).contiguous(),
        const=lin.const.to(torch.float32).contiguous())


#: pack_forest's tables of the forests still alive, keyed by the id of the
#: forest's ``feat`` tensor, so that a forest launched many times (the
#: serving predictor's, a loaded model's) is packed once; an entry goes
#: when that tensor does.  No code writes a forest's tensors in place.
_packed: dict = {}


def _packed_forest(f, cat_feats: tuple) -> PackedForest:
    """``pack_forest(f, cat_feats)``, made once for each live forest."""
    fields = tuple(t for t in f if isinstance(t, torch.Tensor))
    cat_feats = tuple(cat_feats)
    key = id(f.feat)
    hit = _packed.get(key)
    if hit is not None and hit[1] == cat_feats and len(hit[0]) == len(
            fields) and all(r() is t for r, t in zip(hit[0], fields)):
        return hit[2]
    p = pack_forest(f, cat_feats)
    if hit is None:
        weakref.finalize(f.feat, _packed.pop, key, None)
    _packed[key] = (tuple(weakref.ref(t) for t in fields), cat_feats, p)
    return p


def _launch(f, bins_t: torch.Tensor, k: int, cat_feats: tuple,
            leaves: bool, lin=None,
            raw_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    global launches
    if bins_t.dim() != 2 or bins_t.dtype not in (torch.uint8, torch.int32):
        log.fatal("the forest kernel takes u8 or i32 bins [F, n]")
    if bins_t.stride(1) != 1 and bins_t.shape[1] > 1:
        bins_t = bins_t.contiguous()
    dev = bins_t.get_device()
    if f.feat.get_device() != dev:
        log.fatal("the forest and the bins must lie on the same CUDA device")
    p = _packed_forest(f, cat_feats)
    F, n = bins_t.shape
    T, ni = f.feat.shape
    L = p.value.shape[1]
    C, Bc = p.catb.shape[1], p.catb.shape[2]
    if leaves:
        out = torch.empty(T, n, dtype=torch.int32, device=bins_t.device)
        ov, ol = 0, out.data_ptr()
    else:
        out = torch.empty(n, k, dtype=torch.float32, device=bins_t.device)
        ov, ol = out.data_ptr(), 0
    lp = None
    if lin is not None:
        lp = pack_linear(lin)
        if (raw_t is None or raw_t.dtype != torch.float32
                or raw_t.dim() != 2 or raw_t.shape[1] != n
                or raw_t.shape[0] != lin.coeff.shape[-1]
                or raw_t.get_device() != dev or lp.feat.shape[1] != L):
            log.fatal("linear leaves need f32 raw_t [Fr, n] on the bins' "
                      "device, Fr the leaves' columns")
        if raw_t.stride(1) != 1 and n > 1:
            raw_t = raw_t.contiguous()
    code = cuda_lib.load("forest").lgbt_forest(
        bins_t.data_ptr(), int(bins_t.dtype == torch.int32), n,
        bins_t.stride(0), F, p.nodes.data_ptr(), p.meta.data_ptr(), T, ni,
        p.catb.data_ptr() if C else 0, C, Bc, p.value.data_ptr(), L,
        p.cls.data_ptr(), k,
        0 if lp is None else raw_t.data_ptr(),
        0 if lp is None else raw_t.stride(0),
        0 if lp is None else lp.feat.data_ptr(),
        0 if lp is None else lp.coef.data_ptr(),
        0 if lp is None else lp.const.data_ptr(),
        0 if lp is None else lp.feat.shape[2],
        ov, ol, cuda_lib.stream_handle(bins_t))
    if code:
        cuda_lib.check(code, "forest kernel")
    launches += 1
    return out


def forest_values(f, bins_t: torch.Tensor, k: int, cat_feats: tuple = (),
                  lin=None, raw_t: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Raw scores f32 [n, k] of the stacked forest ``f`` over ``bins_t``
    [F, n]: each tree's leaf value added into column ``cls`` in model
    order; ``lin`` (:class:`LinearLeaves` over Fr raw columns) and
    ``raw_t`` f32 [Fr, n] (NaN kept): linear leaves."""
    if not bins_t.is_cuda:
        if lin is None:
            return predict_bitset_forest(f, bins_t, k, cat_feats)
        return predict_bitset_forest(
            f, bins_t, k, cat_feats, lin=lin,
            raw=torch.nan_to_num(raw_t, nan=0.0).t(),
            raw_nan=torch.isnan(raw_t).to(torch.float32))
    return _launch(f, bins_t, k, cat_feats, leaves=False, lin=lin,
                   raw_t=raw_t)


def forest_leaves(f, bins_t: torch.Tensor,
                  cat_feats: tuple = ()) -> torch.Tensor:
    """The leaf index (i32 [T, n]) every row reaches in every tree."""
    if not bins_t.is_cuda:
        return predict_forest_leaves(f, bins_t, cat_feats)
    return _launch(f, bins_t, 0, cat_feats, leaves=True)
