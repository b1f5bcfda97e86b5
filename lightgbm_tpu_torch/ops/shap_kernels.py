"""TreeSHAP's slot recurrences on a torch device: csrc/shap.cu and its
plain version.

:func:`tree_shap` computes one tree's SHAP values f32 [n, F + 1] of a chunk
of rows from the tree's device tables (:func:`tree_tables`, built once per
tree from models/shap.py ``_TreePaths``) and the chunk's split decisions
gl [n, ni] (u8, the host's ``_go_left_matrix``).  On a CUDA tensor it
launches the kernel of csrc/shap.cu once: one thread per (row, leaf) runs
the extend and unwound-sum recurrences on its own path state, then a
block's threads sum the row's slot contributions per feature in a fixed
order (a port kernel with no ``pallas_call`` counterpart: it replaces the
XLA program ``_phi_slots`` + ``einsum("nls,lsf->nf")`` of
``lightgbm_tpu/models/shap.py``).  On a CPU tensor it runs
:func:`tree_shap_plain`: the one-fractions by a segment-AND of the edge
decisions, :func:`phi_slots_plain` (the JAX package's ``_phi_slots`` in
float32) and the contraction.  The kernel repeats the plain version's
arithmetic operation for operation; only the order of the final per-feature
sum differs, so the two agree to float32 rounding, and the kernel gives
the same bits on every run.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import log
from . import cuda_lib

#: launches of the CUDA kernel in this process (chip_smoke.py resets and
#: reads it)
launches = 0

_FLAG_COEF, _FLAG_CONTRIB, _FLAG_GL = 1, 2, 4
#: the largest slot count the kernel keeps in registers; above it the path
#: state lives in a global scratch
REGISTER_SLOTS = 32
_SMEM_COEF_MAX = 64 * 1024
_SMEM_CONTRIB_MAX = 96 * 1024
_SMEM_GL_MAX = 16 * 1024


class ShapTables(NamedTuple):
    """One tree's operands on a device (from models/shap.py
    ``_TreePaths``); L, S padded as there."""
    S: int
    F1: int                  # output columns: features + expected value
    z: torch.Tensor          # f32 [L, S] zero-fractions
    m: torch.Tensor          # i32 [L] slots of each leaf's path
    values: torch.Tensor     # f32 [L] leaf values
    featoh: torch.Tensor     # f32 [L, S, F1] slot -> output column
    edge_node: torch.Tensor  # i32 [E] edges sorted by flat slot l S + s
    edge_dir: torch.Tensor   # u8 [E] 1 where the edge goes left
    edge_slot: torch.Tensor  # i64 [E] flat slot of each edge
    slot_ptr: torch.Tensor   # i32 [L S + 1] each flat slot's edge range
    col_ptr: torch.Tensor    # i32 [F1 + 1] each column's range of col_idx
    col_idx: torch.Tensor    # i32 [nnz] flat slots by column, leaf, slot
    ck: torch.Tensor         # f32 [S, S + 1] extend keep coefficients
    cs: torch.Tensor         # f32 [S, S + 1] extend shift coefficients


def _coefficients(S: int):
    """The extend step's coefficients, row j for the path's (j + 1)-th
    slot: keep (d - pos) / (d + 1) clipped at 0 and shift pos / (d + 1),
    d = j + 1, in float64 then float32 (the JAX package's tables)."""
    pos = np.arange(S + 1)
    d = np.arange(1, S + 1)[:, None]
    ck = ((d - pos) / (d + 1.0)).clip(min=0.0).astype(np.float32)
    cs = (pos / (d + 1.0)).astype(np.float32)
    return ck, cs


def tree_tables(tp, device: torch.device) -> ShapTables:
    """The device tables of a ``_TreePaths``, cached on it per device."""
    key = str(device)
    hit = tp.tables.get(key)
    if hit is not None:
        return hit
    L, S = tp.feats.shape
    F1 = tp.featoh.shape[-1]
    es = np.asarray(tp.edge_sort_slot, np.int64)
    slot_ptr = np.searchsorted(es, np.arange(L * S + 1)).astype(np.int32)
    li, si = np.nonzero(tp.feats >= 0)
    q = (li * S + si).astype(np.int64)
    f = tp.feats[li, si].astype(np.int64)
    order = np.lexsort((q, f))
    col_ptr = np.searchsorted(f[order], np.arange(F1 + 1)).astype(np.int32)
    ck, cs = _coefficients(S)

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    tb = ShapTables(
        S=S, F1=F1, z=t(tp.z, torch.float32), m=t(tp.m, torch.int32),
        values=t(tp.values, torch.float32), featoh=t(tp.featoh),
        edge_node=t(tp.edge_node, torch.int32),
        edge_dir=t(tp.edge_dirleft, torch.uint8), edge_slot=t(es),
        slot_ptr=t(slot_ptr), col_ptr=t(col_ptr),
        col_idx=t(q[order], torch.int32), ck=t(ck), cs=t(cs))
    tp.tables[key] = tb
    return tb


def go_left_to_device(gl: np.ndarray, device: torch.device) -> torch.Tensor:
    """A chunk's split decisions bool [n, ni] as u8 on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(gl, dtype=np.uint8),
                           device=device)


def one_fractions_plain(tb: ShapTables, gl: torch.Tensor) -> torch.Tensor:
    """o f32 [n, L, S]: per (row, leaf, slot) the AND of the row's
    decisions toward the leaf along the slot's edges (1 for a slot with
    no edge), the JAX package's ``_one_fractions``."""
    n = gl.shape[0]
    L = tb.m.shape[0]
    o = torch.ones(n, L * tb.S, dtype=torch.float32, device=gl.device)
    if tb.edge_node.numel():
        toward = (gl[:, tb.edge_node.long()] != 0) == \
            (tb.edge_dir != 0)[None, :]
        o.scatter_reduce_(1, tb.edge_slot[None, :].expand(n, -1),
                          toward.float(), reduce="amin", include_self=True)
    return o.view(n, L, tb.S)


def phi_slots_plain(o: torch.Tensor, z: torch.Tensor, m: torch.Tensor,
                    values: torch.Tensor, S: int) -> torch.Tensor:
    """The JAX package's ``_phi_slots`` in float32 PyTorch: the extend
    recurrence p[0..S] over each leaf's m slots, then every slot's
    unwound path sum; phi_slots [n, L, S] = (o - z) w v per slot.  o
    [n, L, S] 0/1, z [L, S], m [L], values [L]."""
    n, L = o.shape[0], o.shape[1]
    dev = o.device
    f32 = torch.float32
    ck_all, cs_all = _coefficients(S)
    p = torch.zeros(n, L, S + 1, dtype=f32, device=dev)
    p[:, :, 0] = 1.0
    for j in range(S):
        ck = torch.as_tensor(ck_all[j], device=dev)
        cs = torch.as_tensor(cs_all[j], device=dev)
        p_shift = torch.nn.functional.pad(p[:, :, :-1], (1, 0))
        zj = z[None, :, j, None]
        oj = o[:, :, j, None]
        p_new = zj * p * ck + oj * p_shift * cs
        p = torch.where((j < m)[None, :, None], p_new, p)
    D = m.long()
    Dp1 = (D + 1).to(f32)
    p_at_D = p.gather(2, D[None, :, None].expand(n, L, 1))[:, :, 0]
    phi = torch.zeros(n, L, S, dtype=f32, device=dev)
    for i in range(S):
        oi = o[:, :, i]
        zi = z[None, :, i]
        is_one = oi > 0.5
        nxt = p_at_D
        tot = torch.zeros(n, L, dtype=f32, device=dev)
        for jj in range(S - 1, -1, -1):
            live = (jj < D)[None, :]
            # a device tensor, not a Python number: PyTorch divides a CUDA
            # tensor by a host scalar as a multiply by its reciprocal
            tmp = nxt * Dp1[None, :] / torch.full((), jj + 1.0, dtype=f32,
                                                  device=dev)
            nxt_new = p[:, :, jj] - tmp * zi * \
                ((D[None, :] - jj).to(f32) / Dp1[None, :])
            contrib0 = p[:, :, jj] / zi * \
                (Dp1[None, :] / torch.clamp((D[None, :] - jj).to(f32),
                                            min=0.5))
            step = torch.where(is_one, tmp, contrib0)
            tot = torch.where(live, tot + step, tot)
            nxt = torch.where(live & is_one, nxt_new, nxt)
        w_i = torch.where((i < m)[None, :], tot, 0.0)
        phi[:, :, i] = (oi - zi) * w_i * values[None, :]
    return phi


def tree_shap_plain(tb: ShapTables, gl: torch.Tensor) -> torch.Tensor:
    """One tree's SHAP values f32 [n, F + 1] of a chunk, plain PyTorch."""
    o = one_fractions_plain(tb, gl)
    ps = phi_slots_plain(o, tb.z, tb.m, tb.values, tb.S)
    return torch.einsum("nls,lsf->nf", ps, tb.featoh)


def tree_shap(tb: ShapTables, gl: torch.Tensor) -> torch.Tensor:
    """One tree's SHAP values f32 [n, F + 1] of a chunk from its split
    decisions gl u8 [n, ni]: the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if not gl.is_cuda:
        return tree_shap_plain(tb, gl)
    global launches
    if gl.dim() != 2 or gl.dtype != torch.uint8 or not gl.is_contiguous():
        log.fatal("the SHAP kernel takes contiguous u8 decisions [n, ni]")
    if tb.z.get_device() != gl.get_device():
        log.fatal("the SHAP tables and the decisions must lie on the same "
                  "CUDA device")
    n, ni = gl.shape
    L, S, F1 = tb.m.shape[0], tb.S, tb.F1
    flags = 0
    if 2 * S * (S + 1) * 4 <= _SMEM_COEF_MAX:
        flags |= _FLAG_COEF
    c_scratch = p_scratch = None
    if L * S * 4 <= _SMEM_CONTRIB_MAX:
        flags |= _FLAG_CONTRIB
    else:
        c_scratch = torch.empty(n, L * S, dtype=torch.float32,
                                device=gl.device)
    if ni <= _SMEM_GL_MAX:
        flags |= _FLAG_GL
    if S > REGISTER_SLOTS:
        p_scratch = torch.empty(n, L, S + 1, dtype=torch.float32,
                                device=gl.device)
    phi = torch.empty(n, F1, dtype=torch.float32, device=gl.device)
    code = cuda_lib.load("shap").lgbt_shap(
        gl.data_ptr(), n, ni, tb.slot_ptr.data_ptr(),
        tb.edge_node.data_ptr(), tb.edge_dir.data_ptr(), tb.z.data_ptr(),
        tb.m.data_ptr(), tb.values.data_ptr(), L, S, tb.ck.data_ptr(),
        tb.cs.data_ptr(), tb.col_ptr.data_ptr(), tb.col_idx.data_ptr(), F1,
        flags, 0 if c_scratch is None else c_scratch.data_ptr(),
        0 if p_scratch is None else p_scratch.data_ptr(), phi.data_ptr(),
        cuda_lib.stream_handle(gl))
    if code:
        cuda_lib.check(code, "SHAP kernel")
    launches += 1
    return phi
