"""Small-table row lookups (the GBDT score update).

Counterpart of ``lightgbm_tpu/ops/table.py``: ``take_small_table`` computes
``table[idx]`` with out-of-range indices (e.g. -1) reading 0.0, the score
update ``scores += shrunk_leaf_value[leaf_of_row]`` (reference
score_updater.hpp:21 AddScore).  On a CUDA tensor it launches the kernel of
``csrc/take.cu`` (which replaces the TPU kernel ``_take_pallas``); on a CPU
tensor it runs :func:`take_small_table_plain`.
"""

from __future__ import annotations

import torch

from ..utils import log
from . import cuda_lib

#: launches of the CUDA kernel in this process (``chip_smoke.py`` resets and
#: reads it to show the main path went through the kernel)
launches = 0


def take_small_table_plain(table: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``table[idx]``, 0.0 outside [0, T)."""
    t = table.shape[0]
    ok = (idx >= 0) & (idx < t)
    return torch.where(ok, table[idx.clamp(0, max(t - 1, 0))],
                       torch.zeros((), dtype=table.dtype,
                                   device=table.device))


def take_small_table(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for f32 ``table`` [T] and i32 ``idx`` [n]; indices
    outside [0, T) give 0.0.

    The score update calls this once a round: the checks compare device
    indices, not ``torch.device`` objects, and an operand that already is
    contiguous is not copied."""
    if table.dim() != 1 or idx.dim() != 1:
        log.fatal("take_small_table needs a 1-D table and 1-D indices")
    if not table.is_cuda:
        return take_small_table_plain(table, idx)
    global launches
    if (table.dtype != torch.float32 or idx.dtype != torch.int32
            or idx.get_device() != table.get_device()):
        log.fatal("take_small_table kernel takes an f32 table and i32 "
                  "indices on the same CUDA device")
    if not table.is_contiguous():
        table = table.contiguous()
    if not idx.is_contiguous():
        idx = idx.contiguous()
    n = idx.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=idx.device)
    code = cuda_lib.load("take").lgbt_take(
        idx.data_ptr(), n, table.data_ptr(), table.shape[0], out.data_ptr(),
        cuda_lib.stream_handle(idx))
    if code:
        cuda_lib.check(code, "take_small_table")
    launches += 1
    return out
