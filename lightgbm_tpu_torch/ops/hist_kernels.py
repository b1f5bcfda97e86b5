"""Masked K-leaf histogram kernels and their plain PyTorch versions.

Counterpart of ``lightgbm_tpu/ops/hist_pallas.py``, one wrapper per TPU
kernel:

* :func:`histogram_leaves` — the masked K-leaf (grad, hess, count)
  histogram from the transposed bin matrix, replacing
  ``_histogram_leaves_impl`` (``histogram_leaves_pallas``), csrc/hist.cu
  (the one-launch cluster kernel of csrc/masked.cuh);
* :func:`histogram_leaves_rows` — the same histogram from row-major bins,
  replacing ``histogram_leaves_rows_pallas``, csrc/hist.cu (the cluster
  kernel of csrc/masked.cuh with the rows as its row source);
* :func:`histogram_payload` — the same histogram straight from the
  compacted i32 payload, replacing ``histogram_payload_pallas``,
  csrc/hist.cu (the cluster kernel of csrc/masked.cuh with the payload
  rows as its row source);
* :func:`histogram_radix_single` — the root pass (rows with leaf < 0
  excluded), replacing ``histogram_radix_single_pallas``, csrc/radix.cu
  (its own cluster kernel up to 131,072 rows, the cluster kernel of
  csrc/masked.cuh above);
* :func:`histogram_radix_joint` — the masked pass of G <= 4 leaves,
  replacing ``histogram_radix_joint_pallas``, csrc/radix.cu (the same
  function and the same cluster kernel as :func:`histogram_leaves`);
* :func:`histogram_leaves_radix2` — the masked pass of K leaves at a bin
  count that is a multiple of 16, replacing
  ``histogram_leaves_radix2_pallas``, csrc/radix.cu (the same function
  and the same cluster kernel as :func:`histogram_leaves`);
* :func:`histogram_leaves_packed` — the masked pass from the transposed
  packed word mirror, replacing ``histogram_leaves_packed_pallas``,
  csrc/packed.cu (the cluster kernel of csrc/masked.cuh with the words as
  its row source);
* :func:`histogram_rows_t` — the plain [F, B, C] histogram of a row set
  with C value channels, replacing ``histogram_pallas``, csrc/rows.cu;
* :func:`pass_scale` — the float32/bfloat16 scale of a pass (max finite
  |grad|, |hess|), which the strict grower computes once per tree and hands
  to every :func:`histogram_radix_single` call of the tree.

Each masked pass returns f32 [K, F, B, 4] ([F, B, 4] for the root pass;
channel 3 zero; a slot repeating an earlier slot's leaf gets a copy).  On
CUDA tensors a wrapper launches its kernel (or raises); on CPU tensors it
runs its plain version.  ``hist_dtype`` picks the arithmetic: ``int8``
(integer gradient levels, exact int32 sums), ``float32``, or ``bfloat16``
(values rounded to bf16).  The plain versions sum float32 and bfloat16 in
f32; the kernels sum them in 64-bit fixed point at a per-call power-of-two
scale (csrc/hist_common.cuh), so a kernel gives the same bits on every
call, the correctly rounded exact sum on integer-valued inputs.
:func:`fixed_shift`, :func:`histogram_rows_t_fixed`,
:func:`histogram_leaves_fixed`, :func:`histogram_payload_fixed` and
:func:`histogram_radix_single_fixed`
mirror that arithmetic in PyTorch (an int64 ``index_add_`` of
``round(v * 2^s)``): the kernels' bits exactly, on any values.  The radix
and packed kernels compute what the TPU kernels compute, not their nibble
or SWAR formulation, so their plain versions are the flat histogram's.
"""

from __future__ import annotations

import collections
import math
from typing import Callable, Dict, Optional

import torch

from ..utils import log
from . import cuda_lib

#: CUDA launches of each kernel in this process (read by chip_smoke.py)
leaves_launches = 0
leaves_rows_launches = 0
payload_launches = 0
radix_single_launches = 0
radix_joint_launches = 0
radix2_launches = 0
packed_launches = 0
rows_launches = 0
#: histogram_rows_t launches by row count S
rows_launches_by_size: collections.Counter = collections.Counter()
#: gated launches whose gate was on (the launches that did work; a launch
#: gated off exits at once), counted on the device: i32 [1] by pass name,
#: made by each pass's first gated launch, never inside a capture (a
#: captured graph adds into them on every replay, so they are zeroed in
#: place, :func:`zero_gate_counts`, never replaced)
gate_on: Dict[str, torch.Tensor] = {}


def _count_gate(what: str, gate: Optional[torch.Tensor]) -> None:
    if gate is None:
        return
    c = gate_on.get(what)
    if c is None:
        if torch.cuda.is_current_stream_capturing():
            log.fatal(f"{what}: the first gated launch is inside a capture")
        c = gate_on[what] = torch.zeros(1, dtype=torch.int32,
                                        device=gate.device)
    c.add_(gate.reshape(1))


def zero_gate_counts() -> None:
    for c in gate_on.values():
        c.zero_()


def gate_counts() -> Dict[str, int]:
    """The :data:`gate_on` counts on the host (a read per pass)."""
    return {k: int(v.item()) for k, v in gate_on.items()}

_MODES = {"int8": 0, "float32": 1, "bfloat16": 2}


def _mode(hist_dtype: str) -> int:
    m = _MODES.get(str(hist_dtype))
    if m is None:
        log.fatal(f"hist_dtype={hist_dtype!r} is not supported by the "
                  f"histogram kernels (expected one of {sorted(_MODES)})")
    return m


def _hist_plain(bin_of: Callable[[int], torch.Tensor], num_f: int,
                grad: torch.Tensor, hess: torch.Tensor, lor: torch.Tensor,
                row_ok: Optional[torch.Tensor], leaves: torch.Tensor,
                n_bins: int, hist_dtype: str,
                fixed: bool = False) -> torch.Tensor:
    """The arithmetic every masked kernel shares, one feature at a time:
    each selected row adds (grad, hess, 1) to the cell (first slot of its
    leaf, feature, bin); excluded rows add nothing (NaN-safe).  float32 and
    bfloat16 sum in f32, or with ``fixed`` as the cluster kernel does: in
    int64 at 2^fixed_shift(max finite |grad| (|hess|) over all rows, n)."""
    mode = _mode(hist_dtype)
    dev = grad.device
    K = leaves.shape[0]
    if K == 0:
        return torch.zeros(0, num_f, n_bins, 4, device=dev)
    eq = lor[None, :] == leaves[:, None]                          # [K, n]
    if row_ok is not None:
        eq = eq & row_ok[None, :]
    sel = eq.any(0)
    slot = eq.to(torch.uint8).argmax(0).long()                    # first
    if mode == 0:
        def lvl(v):
            return v.to(torch.int32).to(torch.int8).to(torch.int64)
        vals = torch.stack([lvl(grad), lvl(hess),
                            torch.ones_like(lor, dtype=torch.int64)], 1)
        vals = torch.where(sel[:, None], vals, torch.zeros_like(vals))
    elif fixed:
        n = grad.shape[0]
        s = [fixed_shift(int(absmax_bits(v)), n) for v in (grad, hess)] + [0]
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        p2 = _pow2(s, dev)
        vals = torch.stack([_fix(torch.where(sel, grad, zero), p2[0], mode),
                            _fix(torch.where(sel, hess, zero), p2[1], mode),
                            sel.to(torch.int64)], 1)
    else:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        vals = torch.stack([torch.where(sel, grad, zero),
                            torch.where(sel, hess, zero),
                            sel.to(torch.float32)], 1)
        if mode == 2:
            vals = vals.to(torch.bfloat16).to(torch.float32)
    cells = K * num_f * n_bins
    acc = torch.zeros(cells + 1, 3, dtype=vals.dtype, device=dev)
    for f in range(num_f):
        b = bin_of(f).long()
        ok = sel & (b < n_bins)
        idx = torch.where(ok, (slot * num_f + f) * n_bins + b,
                          torch.full_like(b, cells))           # trash row
        acc.index_add_(0, idx, vals)
    sums = acc[:cells]
    if mode != 0 and fixed:
        sums = _unfix(sums, _pow2([-x for x in s], dev))
    out = torch.zeros(K, num_f, n_bins, 4, dtype=torch.float32, device=dev)
    out[..., :3] = sums.reshape(K, num_f, n_bins, 3).to(torch.float32)
    first = (leaves[:, None] == leaves[None, :]).to(torch.uint8).argmax(1)
    return out[first]


def histogram_leaves_plain(bins_t: torch.Tensor, grad: torch.Tensor,
                           hess: torch.Tensor, leaf_of_row: torch.Tensor,
                           leaves: torch.Tensor, *, n_bins: int,
                           hist_dtype: str = "float32") -> torch.Tensor:
    """Plain version of :func:`histogram_leaves`."""
    return _hist_plain(lambda f: bins_t[f], bins_t.shape[0], grad, hess,
                       leaf_of_row, None, leaves, n_bins, hist_dtype)


def histogram_leaves_fixed(bins_t: torch.Tensor, grad: torch.Tensor,
                           hess: torch.Tensor, leaf_of_row: torch.Tensor,
                           leaves: torch.Tensor, *, n_bins: int,
                           hist_dtype: str = "float32") -> torch.Tensor:
    """:func:`histogram_leaves` (and :func:`histogram_leaves_radix2`) as
    the kernel computes it, bit for bit: grad and hess of the selected rows
    summed in int64 at 2^fixed_shift(max finite |grad| (|hess|) over all n
    rows, n), counts exactly, repeated slots copied (int8 sums are exact:
    the plain version)."""
    return _hist_plain(lambda f: bins_t[f], bins_t.shape[0], grad, hess,
                       leaf_of_row, None, leaves, n_bins, hist_dtype,
                       fixed=True)


def histogram_leaves(bins_t: torch.Tensor, grad: torch.Tensor,
                     hess: torch.Tensor, leaf_of_row: torch.Tensor,
                     leaves: torch.Tensor, *, n_bins: int,
                     hist_dtype: str = "float32",
                     out: Optional[torch.Tensor] = None,
                     gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked multi-leaf histogram f32 [K, F, n_bins, 4].

    bins_t: u8 [F, n] (transposed, the resident training layout);
    grad/hess: f32 [n]; leaf_of_row: i32 [n] (rows whose leaf is not in
    ``leaves`` are excluded, e.g. -1 for rows out of the bag); leaves: i32
    [K] (dummy slots may repeat a leaf).  ``out``/``gate``: see
    :func:`gated`.
    """
    if not bins_t.is_cuda:
        return gated(lambda: histogram_leaves_plain(
            bins_t, grad, hess, leaf_of_row, leaves, n_bins=n_bins,
            hist_dtype=hist_dtype), out, gate)
    global leaves_launches
    out = _leaf_pass("hist", "lgbt_hist_leaves", "histogram_leaves", bins_t,
                     grad, hess, leaf_of_row, leaves, n_bins, hist_dtype,
                     out=out, gate=gate)
    if out.numel():
        leaves_launches += 1
    return out


def gated(plain: Callable[[], torch.Tensor], out: Optional[torch.Tensor],
          gate: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain side of a masked pass's ``out``/``gate`` operands.
    ``out``: the tensor the pass writes (a new one when None); ``gate``:
    None, or an i32 [1] read by the kernel on the device: 0 and the pass
    writes nothing, ``out`` keeps what it held.  The device bucket
    dispatch (ops/histogram.py) launches the compacted pass and then the
    full pass into one ``out``, the full one gated by the bucket the
    device chose."""
    res = plain()
    if gate is None:
        return res if out is None else out.copy_(res)
    if out is None:
        log.fatal("a gated histogram pass needs the out it writes into")
    return out.copy_(torch.where(gate.reshape(()) != 0, res, out))


def _gate_ptr(gate: Optional[torch.Tensor], out: Optional[torch.Tensor],
              dev: torch.device, what: str) -> Optional[int]:
    """The device address of a kernel's gate (None: ungated)."""
    if gate is None:
        return None
    if (out is None or gate.dtype != torch.int32 or gate.numel() != 1
            or gate.get_device() != dev.index or not gate.is_contiguous()):
        log.fatal(f"{what}: a gate is an i32 [1] on the pass's device and "
                  f"needs the out it writes into")
    return gate.data_ptr()


def _out(out: Optional[torch.Tensor], shape, dev: torch.device,
         what: str) -> torch.Tensor:
    """``out``, checked, or a new f32 tensor of ``shape``."""
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=dev)
    if (tuple(out.shape) != tuple(shape) or out.dtype != torch.float32
            or not out.is_contiguous() or out.get_device() != dev.index):
        log.fatal(f"{what}: out must be a contiguous f32 {tuple(shape)} on "
                  f"the pass's device")
    return out


def histogram_leaves_rows_plain(bins_rows: torch.Tensor, grad: torch.Tensor,
                                hess: torch.Tensor, leaf_of_row: torch.Tensor,
                                leaves: torch.Tensor, *, n_bins: int,
                                hist_dtype: str = "float32") -> torch.Tensor:
    """Plain version of :func:`histogram_leaves_rows`: the flat histogram of
    the transposed bins."""
    return histogram_leaves_plain(bins_rows.t(), grad, hess, leaf_of_row,
                                  leaves, n_bins=n_bins,
                                  hist_dtype=hist_dtype)


def histogram_leaves_rows(bins_rows: torch.Tensor, grad: torch.Tensor,
                          hess: torch.Tensor, leaf_of_row: torch.Tensor,
                          leaves: torch.Tensor, *, n_bins: int,
                          hist_dtype: str = "float32") -> torch.Tensor:
    """Masked multi-leaf histogram f32 [K, F, n_bins, 4] from row-major bins
    u8 [S, F] (the operands of :func:`histogram_leaves` otherwise; float32
    and bfloat16 give the bits of :func:`histogram_leaves_fixed` on the
    transposed bins)."""
    if not bins_rows.is_cuda:
        return histogram_leaves_rows_plain(bins_rows, grad, hess,
                                           leaf_of_row, leaves,
                                           n_bins=n_bins,
                                           hist_dtype=hist_dtype)
    global leaves_rows_launches
    out = _leaf_pass("hist", "lgbt_hist_leaves_rows", "histogram_leaves_rows",
                     bins_rows, grad, hess, leaf_of_row, leaves, n_bins,
                     hist_dtype, rows=True)
    if out.numel():
        leaves_rows_launches += 1
    return out


def _payload_plain(payload: torch.Tensor, leaves: torch.Tensor,
                   cnt: torch.Tensor, num_f: int, n_bins: int,
                   hist_dtype: str, fixed: bool) -> torch.Tensor:
    S, wp3 = payload.shape
    W = wp3 - 3
    pos_ok = torch.arange(S, device=payload.device) < cnt.reshape(())
    g = payload[:, W].contiguous().view(torch.float32)
    h = payload[:, W + 1].contiguous().view(torch.float32)

    def bin_of(f):
        return (payload[:, f // 4] >> (8 * (f % 4))) & 255

    return _hist_plain(bin_of, num_f, g, h, payload[:, W + 2], pos_ok,
                       leaves, n_bins, hist_dtype, fixed=fixed)


def histogram_payload_plain(payload: torch.Tensor, leaves: torch.Tensor,
                            cnt: torch.Tensor, *, num_f: int, n_bins: int,
                            hist_dtype: str = "float32") -> torch.Tensor:
    """Plain version of :func:`histogram_payload`."""
    return _payload_plain(payload, leaves, cnt, num_f, n_bins, hist_dtype,
                          fixed=False)


def histogram_payload_fixed(payload: torch.Tensor, leaves: torch.Tensor,
                            cnt: torch.Tensor, *, num_f: int, n_bins: int,
                            hist_dtype: str = "float32") -> torch.Tensor:
    """:func:`histogram_payload` as the kernel computes it, bit for bit: grad
    and hess of the selected rows below ``cnt`` summed in int64 at
    2^fixed_shift(max finite |grad| (|hess|) over all S payload rows, rows
    at or past ``cnt`` included, S), counts exactly, repeated slots copied
    (int8 sums are exact: the plain version)."""
    return _payload_plain(payload, leaves, cnt, num_f, n_bins, hist_dtype,
                          fixed=True)


def histogram_payload(payload: torch.Tensor, leaves: torch.Tensor,
                      cnt: torch.Tensor, *, num_f: int, n_bins: int,
                      hist_dtype: str = "float32",
                      out: Optional[torch.Tensor] = None,
                      gate: Optional[torch.Tensor] = None,
                      rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked multi-leaf histogram f32 [K, num_f, n_bins, 4] from the
    compaction payload i32 [S, W+3] (per row: W words of 4 little-endian
    bin bytes, grad bits, hess bits, leaf id).  Rows at positions >=
    ``cnt`` (i32 [1], read on the device: no host sync) are excluded.  One
    launch of the cluster kernel of csrc/masked.cuh (no scratch); float32
    and bfloat16 give the bits of :func:`histogram_payload_fixed`.
    ``rows`` (i32 [1] on the device, at most S, with ``cnt`` <= it): the
    pass is the one over the first ``rows`` payload rows, the float32 and
    bfloat16 scale taken over them (so the device bucket dispatch gathers
    the largest bucket once and passes the chosen one); ``out``: the
    tensor written (a new one when None); ``gate`` (i32 [1] on the device,
    or None): 0 and the pass takes no row, so it writes zeros into
    ``out`` (unlike the masked passes' gate, which keeps ``out``: the
    dispatch runs this pass first)."""
    if gate is not None:
        cnt = cnt * gate
        if rows is not None and hist_dtype != "int8":  # int8 has no scale
            rows = rows * gate
    if not payload.is_cuda:
        # rows past cnt add nothing to the plain sums: the first ``rows``
        # rows give what all S give
        return gated(lambda: histogram_payload_plain(
            payload, leaves, cnt, num_f=num_f, n_bins=n_bins,
            hist_dtype=hist_dtype), out, None)
    global payload_launches
    mode = _mode(hist_dtype)
    S, wp3 = payload.shape
    W = wp3 - 3
    K = leaves.shape[0]
    dev = payload.device
    if (payload.dtype != torch.int32 or leaves.dtype != torch.int32
            or cnt.dtype != torch.int32 or cnt.numel() != 1):
        log.fatal("histogram_payload kernel takes an i32 payload, i32 leaf "
                  "ids and an i32 [1] row count")
    if W < 1 or 4 * W < num_f:
        log.fatal(f"histogram_payload: payload width {wp3} cannot hold "
                  f"{num_f} features")
    if leaves.device != dev or cnt.device != dev:
        log.fatal("histogram_payload: all operands must be on one device")
    if not 1 <= n_bins <= 256:
        log.fatal(f"histogram_payload: n_bins={n_bins} outside [1, 256]")
    if rows is not None and (rows.dtype != torch.int32 or rows.numel() != 1
                             or rows.device != dev):
        log.fatal("histogram_payload: rows is an i32 [1] on the device")
    payload, leaves, cnt = _c(payload, leaves, cnt)
    if payload.data_ptr() % 16:      # the kernel copies 16 bytes at a time
        payload = payload.clone()
    out = _out(out, (K, num_f, n_bins, 4), dev, "histogram_payload")
    if out.numel() == 0:
        return out
    code = cuda_lib.load("hist").lgbt_hist_payload(
        payload.data_ptr(), S, W, num_f, leaves.data_ptr(), K,
        cnt.data_ptr(), n_bins, mode, out.data_ptr(),
        None if rows is None else rows.data_ptr(),
        cuda_lib.stream_handle(payload))
    cuda_lib.check(code, "histogram_payload")
    payload_launches += 1
    _count_gate("histogram_payload", gate)
    return out


def _check_pass(what: str, n: int, grad: torch.Tensor, hess: torch.Tensor,
                lor: torch.Tensor, leaves: Optional[torch.Tensor],
                n_bins: int, dev: torch.device) -> None:
    """The checks every row-pass wrapper makes before it launches."""
    if (grad.dtype != torch.float32 or hess.dtype != torch.float32
            or lor.dtype != torch.int32
            or (leaves is not None and leaves.dtype != torch.int32)):
        log.fatal(f"{what} kernel takes f32 grad/hess and i32 leaf ids")
    if grad.shape != (n,) or hess.shape != (n,) or lor.shape != (n,):
        log.fatal(f"{what}: grad/hess/leaf_of_row must be [n]")
    # device indices, not torch.device objects: this runs once per split
    d = dev.index
    if (grad.get_device() != d or hess.get_device() != d
            or lor.get_device() != d
            or (leaves is not None and leaves.get_device() != d)):
        log.fatal(f"{what}: all operands must be on one device")
    if not 1 <= n_bins <= 256:
        log.fatal(f"{what}: n_bins={n_bins} outside [1, 256]")


def _c(*ts):
    return [t if t.is_contiguous() else t.contiguous() for t in ts]


def histogram_radix_single_plain(bins_t: torch.Tensor, grad: torch.Tensor,
                                 hess: torch.Tensor, lor: torch.Tensor, *,
                                 n_bins: int,
                                 hist_dtype: str = "float32"
                                 ) -> torch.Tensor:
    """Plain version of :func:`histogram_radix_single`."""
    sel = torch.where(lor >= 0, 0, -1).to(torch.int32)
    leaves = torch.zeros(1, dtype=torch.int32, device=lor.device)
    return histogram_leaves_plain(bins_t, grad, hess, sel, leaves,
                                  n_bins=n_bins, hist_dtype=hist_dtype)[0]


def pass_scale_plain(grad: torch.Tensor, hess: torch.Tensor
                     ) -> torch.Tensor:
    """Plain version of :func:`pass_scale`."""
    return torch.stack([absmax_bits(grad), absmax_bits(hess)])


def pass_scale(grad: torch.Tensor, hess: torch.Tensor) -> torch.Tensor:
    """i32 [2]: the f32 bit patterns of the largest finite |grad| and
    |hess| (0 when there is none), found on the device with no host read.
    It is the scale of :func:`histogram_radix_single`'s float32 and
    bfloat16 sums over these values; a caller that makes several passes
    over the same grad/hess computes it once and hands it to each."""
    if not grad.is_cuda:
        return pass_scale_plain(grad, hess)
    n = grad.shape[0]
    if (grad.dtype != torch.float32 or hess.dtype != torch.float32
            or grad.shape != (n,) or hess.shape != (n,)
            or hess.device != grad.device):
        log.fatal("pass_scale takes f32 grad/hess [n] on one device")
    grad, hess = _c(grad, hess)
    out = torch.zeros(2, dtype=torch.int32, device=grad.device)
    code = cuda_lib.load("radix").lgbt_pass_scale(
        grad.data_ptr(), hess.data_ptr(), n, out.data_ptr(),
        cuda_lib.stream_handle(grad))
    cuda_lib.check(code, "pass_scale")
    return out


def histogram_radix_single(bins_t: torch.Tensor, grad: torch.Tensor,
                           hess: torch.Tensor, lor: torch.Tensor, *,
                           n_bins: int, hist_dtype: str = "float32",
                           scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Root-pass histogram f32 [F, n_bins, 4] over every row whose
    ``lor`` (i32 [n]) is >= 0.  bins_t: u8 [F, n]; grad/hess: f32 [n];
    ``scale``: :func:`pass_scale` of these grad/hess (float32/bfloat16),
    found here when not given."""
    if not bins_t.is_cuda:
        return histogram_radix_single_plain(bins_t, grad, hess, lor,
                                            n_bins=n_bins,
                                            hist_dtype=hist_dtype)
    global radix_single_launches
    mode = _mode(hist_dtype)
    num_f, n = bins_t.shape
    if bins_t.dtype != torch.uint8:
        log.fatal("histogram_radix_single kernel takes u8 bins")
    if n >= (1 << 31):
        log.fatal("histogram_radix_single counts rows in 32 bits: n < 2^31")
    _check_pass("histogram_radix_single", n, grad, hess, lor, None, n_bins,
                bins_t.device)
    vmax = None
    if scale is not None and mode != 0:
        if (scale.dtype != torch.int32 or scale.shape != (2,)
                or scale.get_device() != bins_t.get_device()
                or not scale.is_contiguous()):
            log.fatal("histogram_radix_single: scale must be pass_scale's "
                      "i32 [2] on the device")
        vmax = scale.data_ptr()
    bins_t, grad, hess, lor = _c(bins_t, grad, hess, lor)
    out = torch.empty(num_f, n_bins, 4, dtype=torch.float32,
                      device=bins_t.device)
    code = cuda_lib.load("radix").lgbt_hist_radix_single(
        bins_t.data_ptr(), n, num_f, grad.data_ptr(), hess.data_ptr(),
        lor.data_ptr(), n_bins, mode, vmax, out.data_ptr(),
        cuda_lib.stream_handle(bins_t))
    cuda_lib.check(code, "histogram_radix_single")
    radix_single_launches += 1
    return out


def _leaf_pass(lib: str, entry: str, what: str, bins, grad, hess, lor,
               leaves, n_bins, hist_dtype, rows: bool = False, out=None,
               gate=None) -> torch.Tensor:
    """Check the operands of a masked pass over bins u8 [F, n] (``rows``:
    u8 [n, F]) and launch ``entry`` of csrc/<lib>.cu into f32
    [K, F, n_bins, 4] (an empty output launches nothing); ``out``/``gate``
    (not with ``rows``): see :func:`gated`."""
    mode = _mode(hist_dtype)
    if bins.dim() != 2:
        log.fatal(f"{what} takes a 2-d bin matrix")
    n, num_f = bins.shape if rows else bins.shape[::-1]
    K = leaves.shape[0]
    if bins.dtype != torch.uint8:
        log.fatal(f"{what} kernel takes u8 bins")
    _check_pass(what, n, grad, hess, lor, leaves, n_bins, bins.device)
    bins, grad, hess, lor, leaves = _c(bins, grad, hess, lor, leaves)
    gp = _gate_ptr(gate, out, bins.device, what)
    out = _out(out, (K, num_f, n_bins, 4), bins.device, what)
    if out.numel() == 0:
        return out
    gargs = () if rows else (gp,)
    code = getattr(cuda_lib.load(lib), entry)(
        bins.data_ptr(), n, num_f, grad.data_ptr(), hess.data_ptr(),
        lor.data_ptr(), leaves.data_ptr(), K, n_bins, mode, out.data_ptr(),
        *gargs, cuda_lib.stream_handle(bins))
    cuda_lib.check(code, what)
    _count_gate(what, gate)
    return out


#: the most leaves histogram_radix_joint takes (the warm-up ladder's widths
#: are 1 and 4; the JAX kernel's contract)
RADIX_JOINT_MAX_LEAVES = 4

histogram_radix_joint_plain = histogram_leaves_plain
histogram_leaves_radix2_plain = histogram_leaves_plain


def histogram_radix_joint(bins_t: torch.Tensor, grad: torch.Tensor,
                          hess: torch.Tensor, leaf_of_row: torch.Tensor,
                          leaves: torch.Tensor, *, n_bins: int,
                          hist_dtype: str = "float32",
                          out: Optional[torch.Tensor] = None,
                          gate: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Masked histogram f32 [G, F, n_bins, 4] of G <= 4 leaves (the
    operands of :func:`histogram_leaves`)."""
    if not bins_t.is_cuda:
        return gated(lambda: histogram_radix_joint_plain(
            bins_t, grad, hess, leaf_of_row, leaves, n_bins=n_bins,
            hist_dtype=hist_dtype), out, gate)
    global radix_joint_launches
    if not 1 <= leaves.shape[0] <= RADIX_JOINT_MAX_LEAVES:
        log.fatal(f"histogram_radix_joint takes 1 to "
                  f"{RADIX_JOINT_MAX_LEAVES} leaves, got {leaves.shape[0]}")
    out = _leaf_pass("radix", "lgbt_hist_radix2", "histogram_radix_joint",
                     bins_t, grad, hess, leaf_of_row, leaves, n_bins,
                     hist_dtype, out=out, gate=gate)
    if out.numel():
        radix_joint_launches += 1
    return out


def histogram_leaves_radix2(bins_t: torch.Tensor, grad: torch.Tensor,
                            hess: torch.Tensor, leaf_of_row: torch.Tensor,
                            leaves: torch.Tensor, *, n_bins: int,
                            hist_dtype: str = "float32",
                            out: Optional[torch.Tensor] = None,
                            gate: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Masked histogram f32 [K, F, n_bins, 4] of K leaves (the operands of
    :func:`histogram_leaves`)."""
    if not bins_t.is_cuda:
        return gated(lambda: histogram_leaves_radix2_plain(
            bins_t, grad, hess, leaf_of_row, leaves, n_bins=n_bins,
            hist_dtype=hist_dtype), out, gate)
    global radix2_launches
    out = _leaf_pass("radix", "lgbt_hist_radix2", "histogram_leaves_radix2",
                     bins_t, grad, hess, leaf_of_row, leaves, n_bins,
                     hist_dtype, out=out, gate=gate)
    if out.numel():
        radix2_launches += 1
    return out


def histogram_leaves_packed_plain(words_t: torch.Tensor, grad: torch.Tensor,
                                  hess: torch.Tensor,
                                  leaf_of_row: torch.Tensor,
                                  leaves: torch.Tensor, *, num_f: int,
                                  n_bins: int, hist_dtype: str = "float32"
                                  ) -> torch.Tensor:
    """Plain version of :func:`histogram_leaves_packed`."""
    def bin_of(f):
        return (words_t[f // 4] >> (8 * (f % 4))) & 255

    return _hist_plain(bin_of, num_f, grad, hess, leaf_of_row, None, leaves,
                       n_bins, hist_dtype)


def histogram_leaves_packed(words_t: torch.Tensor, grad: torch.Tensor,
                            hess: torch.Tensor, leaf_of_row: torch.Tensor,
                            leaves: torch.Tensor, *, num_f: int, n_bins: int,
                            hist_dtype: str = "float32",
                            out: Optional[torch.Tensor] = None,
                            gate: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Masked histogram f32 [K, num_f, n_bins, 4] from the transposed
    packed mirror words_t i32 [W, n] (byte j of word w, little-endian, is
    the bin of feature 4w + j; features >= num_f are dropped);
    ``out``/``gate``: see :func:`gated`."""
    if not words_t.is_cuda:
        return gated(lambda: histogram_leaves_packed_plain(
            words_t, grad, hess, leaf_of_row, leaves, num_f=num_f,
            n_bins=n_bins, hist_dtype=hist_dtype), out, gate)
    global packed_launches
    mode = _mode(hist_dtype)
    W, n = words_t.shape
    K = leaves.shape[0]
    if words_t.dtype != torch.int32:
        log.fatal("histogram_leaves_packed kernel takes i32 words")
    if W < 1 or 4 * W < num_f:
        log.fatal(f"histogram_leaves_packed: {W} words cannot hold {num_f} "
                  f"features")
    _check_pass("histogram_leaves_packed", n, grad, hess, leaf_of_row,
                leaves, n_bins, words_t.device)
    if n >= (1 << 31):
        log.fatal("histogram_leaves_packed counts rows in 32 bits: n < 2^31")
    words_t, grad, hess, leaf_of_row, leaves = _c(words_t, grad, hess,
                                                  leaf_of_row, leaves)
    gp = _gate_ptr(gate, out, words_t.device, "histogram_leaves_packed")
    out = _out(out, (K, num_f, n_bins, 4), words_t.device,
               "histogram_leaves_packed")
    if out.numel() == 0:
        return out
    code = cuda_lib.load("packed").lgbt_hist_packed(
        words_t.data_ptr(), W, n, num_f, grad.data_ptr(), hess.data_ptr(),
        leaf_of_row.data_ptr(), leaves.data_ptr(), K, n_bins, mode,
        out.data_ptr(), gp, cuda_lib.stream_handle(words_t))
    cuda_lib.check(code, "histogram_leaves_packed")
    packed_launches += 1
    _count_gate("histogram_leaves_packed", gate)
    return out


def histogram_rows_t_plain(bins_t: torch.Tensor, vals_t: torch.Tensor, *,
                           n_bins: int, hist_dtype: str = "float32"
                           ) -> torch.Tensor:
    """Plain version of :func:`histogram_rows_t` (rows summed in order)."""
    mode = _mode(hist_dtype)
    num_f, S = bins_t.shape
    C = vals_t.shape[0]
    v = vals_t.t()                                               # [S, C]
    if mode == 0:
        v = v.to(torch.int32).to(torch.int8).to(torch.int64)
    elif mode == 2:
        v = v.to(torch.bfloat16).to(torch.float32)
    cells = num_f * n_bins
    b = bins_t.long()
    base = torch.arange(num_f, device=b.device)[:, None] * n_bins
    idx = torch.where(b < n_bins, base + b, cells).reshape(-1)  # trash row
    acc = torch.zeros(cells + 1, C, dtype=v.dtype, device=v.device)
    acc.index_add_(0, idx, v.repeat(num_f, 1))
    return acc[:cells].reshape(num_f, n_bins, C).to(torch.float32)


def histogram_rows_t(bins_t: torch.Tensor, vals_t: torch.Tensor, *,
                     n_bins: int, hist_dtype: str = "float32"
                     ) -> torch.Tensor:
    """Histogram f32 [F, n_bins, C] of a row set: ``hist[f, b, c]`` sums
    ``vals_t[c, r]`` over the rows r with ``bins_t[f, r] == b``; bins >=
    ``n_bins`` are dropped.  bins_t: u8 [F, S]; vals_t: f32 [C, S] (rows
    that must not count carry zeros)."""
    if not bins_t.is_cuda:
        return histogram_rows_t_plain(bins_t, vals_t, n_bins=n_bins,
                                      hist_dtype=hist_dtype)
    global rows_launches
    mode = _mode(hist_dtype)
    num_f, S = bins_t.shape
    if vals_t.dim() != 2 or vals_t.shape[1] != S or vals_t.shape[0] < 1:
        log.fatal(f"histogram_rows_t: vals_t must be [C, {S}], got "
                  f"{tuple(vals_t.shape)}")
    C = vals_t.shape[0]
    if bins_t.dtype != torch.uint8 or vals_t.dtype != torch.float32:
        log.fatal("histogram_rows_t kernel takes u8 bins and f32 values")
    if vals_t.device != bins_t.device:
        log.fatal("histogram_rows_t: all operands must be on one device")
    if not 1 <= n_bins <= 256:
        log.fatal(f"histogram_rows_t: n_bins={n_bins} outside [1, 256]")
    bins_t, vals_t = _c(bins_t, vals_t)
    out = torch.empty(num_f, n_bins, C, dtype=torch.float32,
                      device=bins_t.device)
    code = cuda_lib.load("rows").lgbt_hist_rows(
        bins_t.data_ptr(), S, num_f, vals_t.data_ptr(), C, n_bins, mode,
        out.data_ptr(), cuda_lib.stream_handle(bins_t))
    cuda_lib.check(code, "histogram_rows_t")
    rows_launches += 1
    rows_launches_by_size[S] += 1
    return out


# ---- the kernels' fixed-point arithmetic, mirrored (csrc/hist_common.cuh
# fixed_shift, Fixed, Val<1>/Val<2>; the scale of absmax_kernel)

def absmax_bits(v: torch.Tensor) -> torch.Tensor:
    """i32 0-d: the f32 bit pattern of the largest finite |v| (0 when
    there is none; NaN and infinities ignored)."""
    a = v.abs()
    a = torch.where(torch.isfinite(a), a, torch.zeros_like(a))
    m = a.max() if a.numel() else torch.zeros((), dtype=torch.float32,
                                              device=v.device)
    return m.reshape(1).view(torch.int32)[0]


def fixed_shift(vmax_bits: int, n: int) -> int:
    """The fixed-point exponent s of one channel: n values below 2^e
    (vmax < 2^e) scaled by 2^s sum to less than 2^62."""
    vmax = torch.tensor([int(vmax_bits)], dtype=torch.int32).view(
        torch.float32).item()
    if not vmax > 0.0:
        return 0
    _, e = math.frexp(vmax)
    return 62 - max(int(n), 1).bit_length() - e


def _pow2(shifts, dev) -> torch.Tensor:
    """f64 [len(shifts)]: 2^s for each s, exactly."""
    return torch.tensor([math.ldexp(1.0, s) for s in shifts],
                        dtype=torch.float64, device=dev)


def _fix(v: torch.Tensor, scale: torch.Tensor, mode: int) -> torch.Tensor:
    """round(v * scale) in int64, half to even (after rounding v to bf16 in
    mode 2); ``scale`` (powers of two, f64) broadcasts against v."""
    if mode == 2:
        v = v.to(torch.bfloat16).to(torch.float32)
    return torch.round(v.double() * scale).to(torch.int64)


def _unfix(q: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """An int64 sum to f32: one rounding to f32, then the exact scale ``inv``
    (2^-s; rounding again only into f32's subnormals, as scalbnf does)."""
    return (q.to(torch.float32).double() * inv).to(torch.float32)


def histogram_rows_t_fixed(bins_t: torch.Tensor, vals_t: torch.Tensor, *,
                           n_bins: int, hist_dtype: str = "float32"
                           ) -> torch.Tensor:
    """:func:`histogram_rows_t` as the kernel computes it, bit for bit:
    each channel summed in int64 at 2^fixed_shift(max finite |channel|,
    S), in any order (int8 sums are exact: the plain version)."""
    mode = _mode(hist_dtype)
    if mode == 0:
        return histogram_rows_t_plain(bins_t, vals_t, n_bins=n_bins,
                                      hist_dtype=hist_dtype)
    num_f, S = bins_t.shape
    C = vals_t.shape[0]
    s = [fixed_shift(int(absmax_bits(vals_t[c])), S) for c in range(C)]
    dev = vals_t.device
    q = _fix(vals_t, _pow2(s, dev)[:, None], mode).t()             # [S, C]
    cells = num_f * n_bins
    b = bins_t.long()
    base = torch.arange(num_f, device=b.device)[:, None] * n_bins
    idx = torch.where(b < n_bins, base + b, cells).reshape(-1)
    acc = torch.zeros(cells + 1, C, dtype=torch.int64, device=q.device)
    acc.index_add_(0, idx, q.repeat(num_f, 1))
    return _unfix(acc[:cells], _pow2([-x for x in s], dev)).reshape(
        num_f, n_bins, C)


def histogram_radix_single_fixed(bins_t: torch.Tensor, grad: torch.Tensor,
                                 hess: torch.Tensor, lor: torch.Tensor, *,
                                 n_bins: int, hist_dtype: str = "float32"
                                 ) -> torch.Tensor:
    """:func:`histogram_radix_single` as the kernel computes it, bit for
    bit: grad and hess of the rows with ``lor >= 0`` summed in int64 at
    2^fixed_shift(max finite |grad| (|hess|) over all n rows, n), counts
    exactly (int8 sums are exact: the plain version)."""
    sel = torch.where(lor >= 0, 0, -1).to(torch.int32)
    leaves = torch.zeros(1, dtype=torch.int32, device=lor.device)
    return histogram_leaves_fixed(bins_t, grad, hess, sel, leaves,
                                  n_bins=n_bins, hist_dtype=hist_dtype)[0]
