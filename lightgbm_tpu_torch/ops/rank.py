"""Learning-to-rank gradients: the query bucket plan and the lambdarank pass.

Counterpart of the ranking arithmetic of ``lightgbm_tpu/objectives.py``
(``_pad_queries``, ``_rank_bucket_ladder``, ``_rank_buckets``,
``_lambdarank_pair_accum``, ``_xendcg_accum``, ``_pos_bias_newton``;
reference rank_objective.hpp).

:func:`lambdarank_gradients` is the lambdarank gradient call of one
boosting round.  On CUDA tensors it launches ``csrc/rank.cu`` (one launch
a call, one thread block a query straight from the query boundaries: no
bucket ladder).  The JAX package computes these gradients in XLA, not
Pallas, so the kernel replaces no TPU kernel; it exists because the plain
version materialises ~20 float32 ``[nq_b, T, Q_b]`` pair tensors a bucket
(several GB at MSLR-WEB30K's 2.27M documents), all of it device work.  On
CPU tensors it runs :func:`lambdarank_gradients_plain`, the JAX package's
bucketed pair arithmetic in PyTorch, which the tests hold against the JAX
package and ``chip_smoke.py`` holds the kernel against.

Sorting by descending score is stable (ties by document index, as
``jnp.argsort(..., stable=True)``) with the keys made canonical (``+ 0.0``:
a CUDA radix sort puts -0.0 before +0.0).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import log
from . import cuda_lib

#: launches of the CUDA kernel in this process (read by chip_smoke.py)
launches = 0

#: documents of one query the kernel stages in shared memory; a longer
#: query stages in a global scratch buffer (csrc/rank.cu ``kStage``)
KERNEL_STAGE_DOCS = 2048


# ------------------------------------------------------------ bucket plan
def _pad_queries(boundaries: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                   int]:
    """[nq, Q] doc-index matrix (padded with -1) + per-query counts."""
    sizes = np.diff(boundaries)
    q = int(sizes.max()) if len(sizes) else 1
    nq = len(sizes)
    idx = np.full((nq, q), -1, dtype=np.int32)
    for i in range(nq):
        s, e = boundaries[i], boundaries[i + 1]
        idx[i, :e - s] = np.arange(s, e, dtype=np.int32)
    return idx, sizes.astype(np.int32), q


def _rank_bucket_ladder(sizes: np.ndarray, spec) -> List[int]:
    """Query-length bucket caps, smallest to largest, covering every
    query.  ``spec`` is ``config.rank_query_buckets``: ``"auto"`` derives
    the next-power-of-two set of the observed lengths; an explicit list is
    used as-is (extended with the longest length when it falls short)."""
    qmax = int(sizes.max()) if len(sizes) else 1
    if isinstance(spec, str):           # "auto"
        return sorted({1 << max(int(s) - 1, 0).bit_length() for s in sizes}) \
            or [qmax]
    caps = sorted({int(b) for b in spec})
    if caps[-1] < qmax:
        caps.append(qmax)
    return caps


def _rank_buckets(boundaries: np.ndarray, spec
                  ) -> Tuple[List[Tuple[int, np.ndarray, np.ndarray]], int]:
    """Group queries into length buckets: ``([(cap, query_ids[nq_b],
    qidx[nq_b, cap])...], pad_rows)``, ``qidx`` the padded doc-index matrix
    (-1 pads) of the queries whose smallest cap >= their length, and
    ``pad_rows`` the padding slots across all buckets."""
    sizes = np.diff(np.asarray(boundaries)).astype(np.int64)
    caps = _rank_bucket_ladder(sizes, spec)
    assign = np.searchsorted(np.asarray(caps), sizes, side="left")
    out: List[Tuple[int, np.ndarray, np.ndarray]] = []
    pad_rows = 0
    for bi, cap in enumerate(caps):
        qids = np.flatnonzero(assign == bi)
        if not len(qids):
            continue
        idx = np.full((len(qids), cap), -1, np.int32)
        for r, qi in enumerate(qids):
            s, e = int(boundaries[qi]), int(boundaries[qi + 1])
            idx[r, :e - s] = np.arange(s, e, dtype=np.int32)
        pad_rows += int(len(qids) * cap - sizes[qids].sum())
        out.append((int(cap), qids.astype(np.int32), idx))
    return out, pad_rows


class Bucket(NamedTuple):
    """One query-length bucket on the device: ``qids`` the host's query
    ids [nq_b], ``safe`` i64 [nq_b, cap] doc indices (pads 0), ``valid``
    bool [nq_b, cap], ``inv_dcg`` f32 [nq_b] (lambdarank's inverse max DCG;
    None for rank_xendcg)."""
    cap: int
    qids: np.ndarray
    safe: torch.Tensor
    valid: torch.Tensor
    inv_dcg: Optional[torch.Tensor]


class RankPlan(NamedTuple):
    """A ranking objective's device tables, made once at ``init`` (nothing
    is copied from the host inside a captured round): the buckets of the
    plain version, the query boundaries i32 [nq + 1] and the inverse max
    DCG f32 [nq] of the kernel."""
    buckets: List[Bucket]
    bounds: torch.Tensor
    inv_dcg: Optional[torch.Tensor]
    qmax: int


def rank_plan(boundaries: np.ndarray, spec, device,
              inv_dcg: Optional[np.ndarray] = None) -> RankPlan:
    """The :class:`RankPlan` of the query ``boundaries`` under the bucket
    ladder ``spec`` on ``device``; ``inv_dcg`` float64 [nq] or None."""
    bounds = np.asarray(boundaries)
    buckets = []
    for cap, qids, idx in _rank_buckets(bounds, spec)[0]:
        inv = None if inv_dcg is None else torch.as_tensor(
            inv_dcg[qids], dtype=torch.float32, device=device)
        buckets.append(Bucket(
            cap, qids, torch.as_tensor(np.maximum(idx, 0).astype(np.int64),
                                       device=device),
            torch.as_tensor(idx >= 0, device=device), inv))
    sizes = np.diff(bounds)
    return RankPlan(
        buckets, torch.as_tensor(bounds.astype(np.int32), device=device),
        None if inv_dcg is None else torch.as_tensor(
            inv_dcg, dtype=torch.float32, device=device),
        int(sizes.max()) if len(sizes) else 1)


# ----------------------------------------------------- the plain versions
def _gather(x: torch.Tensor, b: Bucket, pad: float) -> torch.Tensor:
    """``x`` [n] at the bucket's slots, ``pad`` at its pads."""
    return torch.where(b.valid, x[b.safe], torch.full((), pad,
                                                      dtype=x.dtype,
                                                      device=x.device))


def _recip(x: torch.Tensor) -> torch.Tensor:
    """``1.0 / x`` rounded once, as XLA divides."""
    return torch.div(torch.ones_like(x), x)


def _lambdarank_pair_accum(score, label, gain_doc, b: Bucket,
                           g_acc, h_acc, *, sigmoid: float, trunc: int,
                           norm: bool):
    """Pairwise |dNDCG| lambda gradients of ONE query-length bucket added
    onto the per-doc accumulators (the JAX package's function, op for
    op): truncation-aware pairs in sorted space, [nq_b, T, Q] with T =
    min(trunc, Q); each doc belongs to one bucket, so the other buckets
    add +0.0 to its slot."""
    s = sigmoid
    valid = b.valid
    sc = _gather(score, b, -np.inf)                      # [nq_b, Q]
    gains = _gather(gain_doc, b, 0.0)
    lbl = _gather(label, b, -1.0)

    # rank of each doc by descending score, ties by index
    order = torch.argsort(-sc + 0.0, dim=1, stable=True)  # pos -> slot
    rank = torch.argsort(order, dim=1)                     # slot -> pos

    Q = sc.shape[1]
    T = int(min(trunc, Q))
    s_srt = sc.gather(1, order)                          # [nq_b, Q] desc
    g_srt = gains.gather(1, order)
    l_srt = lbl.gather(1, order)
    v_srt = valid.gather(1, order)
    disc = _recip(torch.log2(torch.arange(Q, dtype=torch.float32,
                                          device=sc.device) + 2.0))
    inv = b.inv_dcg[:, None, None]                       # [nq_b, 1, 1]

    sa = s_srt[:, :T, None]                              # [nq_b, T, 1]
    sb = s_srt[:, None, :]                               # [nq_b, 1, Q]
    ga_ = g_srt[:, :T, None]
    gb_ = g_srt[:, None, :]
    la_ = l_srt[:, :T, None]
    lb_ = l_srt[:, None, :]
    delta = ((ga_ - gb_) * (disc[None, :T, None] - disc[None, None, :])) \
        .abs() * inv                                     # [nq_b, T, Q]
    # each unordered pair once: position b strictly below position a
    ar = torch.arange(Q, device=sc.device)
    tri = ar[None, None, :] > ar[:T][None, :, None]
    pair_ok = (la_ != lb_) & tri & v_srt[:, :T, None] & v_srt[:, None, :]

    a_better = la_ > lb_
    diff_hl = torch.where(a_better, sa - sb, sb - sa)    # s_high - s_low
    diff_hl = torch.clamp(diff_hl, -50.0 / s, 50.0 / s)
    rho = _recip(1.0 + torch.exp(s * diff_hl))
    lam = -s * rho * delta                    # dL/ds for the better doc
    hes = s * s * rho * (1.0 - rho) * delta
    zero = torch.zeros((), dtype=lam.dtype, device=lam.device)
    lam = torch.where(pair_ok, lam, zero)
    hes = torch.where(pair_ok, hes, zero)

    # onto sorted positions: a gets +/-lam by label order, b the
    # negation; hessians add on both ends
    g_a = torch.where(a_better, lam, -lam)
    g_pos = torch.zeros_like(s_srt)
    g_pos[:, :T] += g_a.sum(dim=2)
    g_pos = g_pos - g_a.sum(dim=1)
    h_pos = torch.zeros_like(s_srt)
    h_pos[:, :T] += hes.sum(dim=2)
    h_pos = h_pos + hes.sum(dim=1)

    if norm:
        # reference norm_: scale by log2(1 + |sum lambda|) / |sum lambda|
        sum_lam = lam.abs().sum(dim=(1, 2))
        nf = torch.where(sum_lam > 0, torch.log2(1.0 + sum_lam)
                         / torch.clamp_min(sum_lam, 1e-20),
                         torch.ones_like(sum_lam))
        g_pos = g_pos * nf[:, None]
        h_pos = h_pos * nf[:, None]

    # sorted positions back to padded doc slots
    g_doc = g_pos.gather(1, rank)
    h_doc = h_pos.gather(1, rank)
    flat = b.safe.reshape(-1)
    g_acc = g_acc.index_add(0, flat, torch.where(valid, g_doc, zero)
                            .reshape(-1))
    h_acc = h_acc.index_add(0, flat, torch.where(valid, h_doc, zero)
                            .reshape(-1))
    return g_acc, h_acc


def lambdarank_gradients_plain(score, label, gain, plan: RankPlan,
                               weight=None, *, sigmoid: float, trunc: int,
                               norm: bool):
    """Plain PyTorch version of :func:`lambdarank_gradients`: every
    bucket's pair arithmetic, then the weights."""
    g = torch.zeros_like(score)
    h = torch.zeros_like(score)
    for b in plan.buckets:
        g, h = _lambdarank_pair_accum(score, label, gain, b, g, h,
                                      sigmoid=sigmoid, trunc=trunc,
                                      norm=norm)
    if weight is not None:
        g, h = g * weight, h * weight
    return g, h


def lambdarank_gradients(score, label, gain, plan: RankPlan, weight=None,
                         *, sigmoid: float, trunc: int, norm: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lambdarank grad and hess f32 [n] of the scores ``score`` f32 [n]:
    pairwise |dNDCG|-weighted lambdas of each query, truncated at
    ``trunc`` sorted positions, normalised per query (``norm``), times the
    weights.  ``label``, ``gain`` (each document's label gain) and
    ``weight`` f32 [n]; ``plan`` the queries.  One kernel launch on CUDA
    tensors (which read the plan's boundaries and inverse max DCG), the
    plain version on CPU tensors."""
    if not score.is_cuda:
        return lambdarank_gradients_plain(score, label, gain, plan, weight,
                                          sigmoid=sigmoid, trunc=trunc,
                                          norm=norm)
    global launches
    if not score.is_contiguous():
        score = score.contiguous()
    n = score.shape[0]
    dev = score.get_device()
    ops = (score, label, gain, plan.bounds, plan.inv_dcg) + \
        (() if weight is None else (weight,))
    if (score.dim() != 1 or any(not t.is_contiguous() or t.get_device() != dev
                                for t in ops)
            or any(t.dtype != torch.float32 or t.shape != (n,)
                   for t in (score, label, gain)
                   + (() if weight is None else (weight,)))
            or plan.bounds.dtype != torch.int32
            or plan.inv_dcg.dtype != torch.float32
            or plan.bounds.shape[0] != plan.inv_dcg.shape[0] + 1):
        log.fatal("lambdarank_gradients kernel takes contiguous f32 [n] "
                  "score, label, gain (and weight), i32 [nq + 1] bounds and "
                  "f32 [nq] inverse DCG on one CUDA device")
    nq = plan.inv_dcg.shape[0]
    grad = torch.empty_like(score)
    hess = torch.empty_like(score)
    # a query longer than the shared-memory staging stages its five
    # [Q] arrays in global memory, at its own offset of a [5, n] buffer
    scratch = torch.empty(5 * n if plan.qmax > KERNEL_STAGE_DOCS else 0,
                          dtype=torch.float32, device=score.device)
    code = cuda_lib.load("rank").lgbt_lambdarank(
        score.data_ptr(), label.data_ptr(), gain.data_ptr(),
        plan.bounds.data_ptr(), plan.inv_dcg.data_ptr(),
        None if weight is None else weight.data_ptr(), nq, n,
        float(sigmoid), int(trunc), int(bool(norm)), grad.data_ptr(),
        hess.data_ptr(), scratch.data_ptr() if scratch.numel() else None,
        cuda_lib.stream_handle(score))
    if code:
        cuda_lib.check(code, "lambdarank_gradients")
    launches += 1
    return grad, hess


def xendcg_accum(score, label, gumbel, b: Bucket, g_acc, h_acc):
    """XE-NDCG listwise gradients of ONE query-length bucket added onto the
    per-doc accumulators (the JAX package's ``_xendcg_accum``): Gumbel-
    perturbed relevance targets phi = max(2^y - 1 + gumbel, 0), normalised
    per query, against the softmax of the scores.  ``gumbel`` is the
    per-document noise [n]."""
    valid = b.valid
    sc = _gather(score, b, -1e30)
    lbl = _gather(label, b, 0.0)
    gum = _gather(gumbel, b, 0.0)
    zero = torch.zeros((), dtype=score.dtype, device=score.device)
    phi = torch.clamp_min(torch.pow(2.0, lbl) - 1.0 + gum, 0.0)
    phi = torch.where(valid, phi, zero)
    phi_sum = phi.sum(dim=1, keepdim=True)
    target = phi / torch.clamp_min(phi_sum, 1e-20)
    # jax.nn.softmax: exp of the row minus its max over the row's sum
    e = torch.exp(sc - sc.max(dim=1, keepdim=True).values)
    p = e / e.sum(dim=1, keepdim=True)
    p = torch.where(valid, p, zero)
    g_doc = p - target
    h_doc = p * (1.0 - p)
    flat = b.safe.reshape(-1)
    g_acc = g_acc.index_add(0, flat, torch.where(valid, g_doc, zero)
                            .reshape(-1))
    h_acc = h_acc.index_add(0, flat, torch.where(
        valid, torch.clamp_min(h_doc, 1e-15), zero).reshape(-1))
    return g_acc, h_acc


def pos_bias_newton(g, h, biases, order, counts, *, lr: float, reg: float):
    """One Newton step of the per-position bias factors (reference
    rank_objective.hpp:295 UpdatePositionBiasFactors; the JAX package's
    ``_pos_bias_newton``): the utility derivative at a position is
    -sum(lambda) there, L2-regularised per instance.  ``order`` i64 [n]
    sorts the documents by position (stable) and ``counts`` i64 [P] holds
    the documents a position, so the sums are segment reductions in a
    fixed order (no float atomics).  Returns the new f32 [P] biases."""
    first = -torch.segment_reduce(g[order], "sum", lengths=counts,
                                  unsafe=True, initial=0.0)
    second = -torch.segment_reduce(h[order], "sum", lengths=counts,
                                   unsafe=True, initial=0.0)
    cf = counts.to(biases.dtype)
    first = first - biases * reg * cf
    second = second - reg * cf
    return biases + lr * first / (second.abs() + 0.001)
