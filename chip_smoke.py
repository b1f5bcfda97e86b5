#!/usr/bin/env python3
"""Drive lightgbm_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device, ``nvcc`` (CUDA_HOME, PATH or /usr/local/cuda) and nothing
else: no jax, no network.  Phases, each of which fails the run on error:

1. environment and build: the card's name and power limit, the versions,
   and every kernel of ``lightgbm_tpu_torch/csrc`` compiled at once;
2. kernel checks: each of the eight kernels against its plain PyTorch
   version on the card, at the shapes of the HIGGS main path (n = 1M rows,
   F = 28 features, B = 256 bins, K = 42 leaves per round, T = 255 leaf
   values; B = 64 for the packed kernel), with its time, the plain
   version's, one PyTorch library call's where one computes the same
   function, and the least time the card could take (bytes at 3.35 TB/s or
   operations at the CUDA-core rate), plus edge checks off the main path,
   and leaf renewal's fixed-order sums (the same bits twice, host syncs
   counted);
3. the slice: ``train()`` on a 1M x 28 HIGGS-shaped synthetic set (seeded
   numpy) with the default configuration of the HIGGS recipe
   (``hist_kernel`` and ``stochastic_rounding`` unset: the radix kernels,
   the warm-up ladder and threefry rounding), 10 rounds on the card under
   the auto policy (int8 levels, 42 splits per round, leaf renewal),
   ``predict`` on a 200k held-out set, a profiled round, and the launch
   count of every kernel in that run; then the same recipe at
   ``max_bin=63`` (1M rows x 5 rounds, the packed kernel) and with
   ``hist_kernel=onehot`` (100k rows x 3 rounds, the flat kernel), each
   with its own launch counts;
4. cross-check: the default recipe at 100k rows x 5 rounds on the card and
   on the CPU (plain versions), the held-out set also a valid set scored on
   the device each round: tree 0's splits must match, the held-out AUCs
   agree within 1e-3, and each run's valid-set AUC agrees with its
   ``predict`` AUC within 1e-4; a second card run must give byte-identical
   model text.

It prints one JSON line with every kernel's numbers, the card's name and
power limit, and as its last line ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
CUDA_CORE_OPS_PER_S = 67e12   # H100 SXM f32 outside the tensor cores
N, F, B, K, T = 1_000_000, 28, 256, 42, 255
N64, W = 64, (F + 3) // 4     # the packed kernel's bins and words
RECIPE = dict(objective="binary", num_leaves=255, max_bin=255,
              learning_rate=0.1, min_data_in_leaf=0,
              min_sum_hessian_in_leaf=100, verbosity=-1)
#: PR 1's recipe: the flat kernel, deterministic rounding
ONEHOT = dict(hist_kernel="onehot", stochastic_rounding=False)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def synth_higgs(n, f, rng, w=None):
    """Higgs-shaped synthetic binary data (the generator of bench.py
    ``_synth_higgs``): continuous features, a noisy linear logit."""
    if w is None:
        w = rng.normal(size=f)
    feat = rng.normal(size=(n, f)).astype(np.float32)
    logits = feat @ w * 0.5
    label = (logits + rng.normal(scale=1.0, size=n) > 0).astype(np.float32)
    return feat, label, w


def time_ms(torch, fn, flush, reps=10):
    """Median device time of ``fn`` (ms) from CUDA events around each
    call, with the 50 MB L2 flushed before every call so inputs come from
    device memory, as they do in the training loop."""
    times = []
    for i in range(reps + 2):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        if i >= 2:
            times.append(s.elapsed_time(e))
    return float(np.median(times))


def bound_ms(nbytes, ops):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check_kernels(torch, dev):
    """Phase 2: every kernel against its plain version, timed."""
    from lightgbm_tpu_torch.ops import hist_kernels as HK
    from lightgbm_tpu_torch.ops import round_fuse as RF
    from lightgbm_tpu_torch.ops import table as TB
    from lightgbm_tpu_torch.ops.histogram import bins_to_words
    rng = np.random.default_rng(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = []

    def same(a, b, what):
        if a.shape != b.shape or not torch.equal(a, b):
            d = (a.double() - b.double()).abs().max().item() \
                if a.shape == b.shape else float("nan")
            fail(f"{what}: kernel differs from its plain version "
                 f"(max abs diff {d})")
        return 0.0

    def row(name, src, replaces, ms, plain_ms, lib_ms, nbytes, ops, err):
        b, by = bound_ms(nbytes, ops)
        rows.append(dict(name=name, route="cuda", source=src,
                         replaces=replaces, launches=0, max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                         library_ms=lib_ms))
        print(f"kernel {name}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms} bound_ms={b:.4f} ({by}) "
              f"max_abs_err={err}", flush=True)

    # -- 1. take: the score update's leaf-value gather, bitwise
    table = torch.as_tensor(rng.normal(size=T).astype(np.float32), device=dev)
    idx_edge = torch.as_tensor(rng.integers(-3, 300, size=N, dtype=np.int32),
                               device=dev)      # -1.. and T <= idx < 300
    same(TB.take_small_table(table, idx_edge),
         TB.take_small_table_plain(table, idx_edge), "take (out of range)")
    idx = torch.as_tensor(rng.integers(0, T, size=N, dtype=np.int32),
                          device=dev)           # the main path's leaf ids
    err = same(TB.take_small_table(table, idx),
               TB.take_small_table_plain(table, idx), "take")
    row("take_small_table", "lightgbm_tpu_torch/csrc/take.cu",
        "lightgbm_tpu/ops/table.py:32",
        time_ms(torch, lambda: TB.take_small_table(table, idx), flush),
        time_ms(torch, lambda: TB.take_small_table_plain(table, idx), flush),
        time_ms(torch, lambda: table.index_select(0, idx), flush),
        8 * N + 4 * T, N, err)

    # -- 2. masked K-leaf histogram (int8 levels: bitwise)
    bins_t = torch.as_tensor(rng.integers(0, B - 1, size=(F, N),
                                          dtype=np.uint8), device=dev)
    g = torch.as_tensor(rng.integers(-2, 3, size=N).astype(np.float32),
                        device=dev)
    h = torch.as_tensor(rng.integers(0, 5, size=N).astype(np.float32),
                        device=dev)
    lor = torch.as_tensor(rng.integers(0, 64, size=N, dtype=np.int32),
                          device=dev)
    leaves_np = rng.permutation(64)[:K].astype(np.int32)
    leaves_np[-2:] = leaves_np[0]                 # repeated dummy slots
    leaves = torch.as_tensor(leaves_np, device=dev)
    kw = dict(n_bins=B, hist_dtype="int8")
    err = same(HK.histogram_leaves(bins_t, g, h, lor, leaves, **kw),
               HK.histogram_leaves_plain(bins_t, g, h, lor, leaves, **kw),
               "histogram_leaves int8")
    # float32 mode: bitwise on integer-valued inputs (exact sums); on real
    # values the atomics' order varies, so each cell may differ from the
    # plain sum by 1e-5 of the cell's sum of |values| (f32 rounding of a
    # reordered sum of up to ~10^4 terms)
    kwf = dict(n_bins=B, hist_dtype="float32")
    same(HK.histogram_leaves(bins_t, g, h, lor, leaves, **kwf),
         HK.histogram_leaves_plain(bins_t, g, h, lor, leaves, **kwf),
         "histogram_leaves float32 (integer-valued)")
    gr = torch.as_tensor(rng.normal(size=N).astype(np.float32), device=dev)
    hr = torch.as_tensor(rng.random(N).astype(np.float32), device=dev)
    got = HK.histogram_leaves(bins_t, gr, hr, lor, leaves, **kwf)
    want = HK.histogram_leaves_plain(bins_t, gr, hr, lor, leaves, **kwf)
    mag = HK.histogram_leaves_plain(bins_t, gr.abs(), hr, lor, leaves,
                                    **kwf)
    if not bool(((got - want).abs() <= 1e-5 * mag.abs() + 1e-30).all()):
        fail("histogram_leaves float32: kernel outside 1e-5 of |values|")
    sel = torch.isin(lor, leaves)
    sel_rows = int(sel.sum().item())
    # library yardstick: ONE index_add_ of every (row, feature) value triple
    # into its (slot, feature, bin) cell, the cell index precomputed
    slot = (lor[None, :] == leaves[:, None]).to(torch.uint8).argmax(0)
    cell = torch.where(
        sel[None, :], (slot[None, :].long() * F
                       + torch.arange(F, device=dev)[:, None]) * B
        + bins_t.long(), K * F * B).reshape(-1)
    vals = torch.stack([g, h, torch.ones_like(g)], 1).repeat(F, 1)
    acc = torch.zeros(K * F * B + 1, 3, device=dev)
    row("histogram_leaves", "lightgbm_tpu_torch/csrc/hist.cu",
        "lightgbm_tpu/ops/hist_pallas.py:188",
        time_ms(torch, lambda: HK.histogram_leaves(bins_t, g, h, lor, leaves,
                                                   **kw), flush),
        time_ms(torch, lambda: HK.histogram_leaves_plain(
            bins_t, g, h, lor, leaves, **kw), flush),
        time_ms(torch, lambda: acc.index_add_(0, cell, vals), flush),
        F * N + 12 * N + 4 * K + 16 * K * F * B, 3 * F * sel_rows, err)
    del slot, cell, vals, acc

    # -- 3. payload histogram over a compacted bucket (int8: bitwise)
    bins_rows = bins_t.t().contiguous()
    words = bins_to_words(bins_rows)
    W = words.shape[1]
    S = (N // 4 + 2047) // 2048 * 2048            # the n/4 bucket
    cnt = torch.tensor([int(0.8 * S)], dtype=torch.int32, device=dev)
    payload = torch.cat([words[:S], g[:S].view(torch.int32)[:, None],
                         h[:S].view(torch.int32)[:, None],
                         lor[:S, None]], 1).contiguous()
    kwp = dict(num_f=F, n_bins=B, hist_dtype="int8")
    err = same(HK.histogram_payload(payload, leaves, cnt, **kwp),
               HK.histogram_payload_plain(payload, leaves, cnt, **kwp),
               "histogram_payload int8")
    c = int(cnt.item())
    sel_p = int(torch.isin(lor[:c], leaves).sum().item())
    row("histogram_payload", "lightgbm_tpu_torch/csrc/hist.cu",
        "lightgbm_tpu/ops/hist_pallas.py:318",
        time_ms(torch, lambda: HK.histogram_payload(payload, leaves, cnt,
                                                    **kwp), flush),
        time_ms(torch, lambda: HK.histogram_payload_plain(
            payload, leaves, cnt, **kwp), flush),
        None, c * 4 * (W + 3) + 4 * K + 4 + 16 * K * F * B,
        3 * F * sel_p, err)

    # -- 4. fused partition + payload (bitwise on all three outputs)
    par = np.sort(rng.permutation(64)[:K]).astype(np.int32)
    desc = dict(
        feats=rng.integers(0, F, size=K, dtype=np.int32),
        thr=rng.integers(0, B, size=K, dtype=np.int32),
        dl=rng.integers(0, 2, size=K, dtype=np.int32),
        nanb=np.where(rng.random(K) < 0.5, B - 2, -1).astype(np.int32),
        parents=par, new_leaves=(64 + np.arange(K)).astype(np.int32),
        validk=(np.arange(K) < K - 3).astype(np.int32),
        smaller=np.where(rng.random(K) < 0.5, par,
                         64 + np.arange(K)).astype(np.int32))
    d = {k: torch.as_tensor(v, device=dev) for k, v in desc.items()}
    mask = torch.ones(N, dtype=torch.int32, device=dev)
    args = (bins_t, words, g, h, lor, mask, d["feats"], d["thr"], d["dl"],
            d["nanb"], d["parents"], d["new_leaves"], d["validk"],
            d["smaller"])
    for a, b_, what in zip(RF.partition_payload(*args),
                           RF.partition_payload_plain(*args),
                           ("new leaf map", "sort key", "payload")):
        err = same(a, b_, f"partition_payload {what}")
    row("partition_payload", "lightgbm_tpu_torch/csrc/partition.cu",
        "lightgbm_tpu/ops/round_fuse.py:164",
        time_ms(torch, lambda: RF.partition_payload(*args), flush),
        time_ms(torch, lambda: RF.partition_payload_plain(*args), flush),
        None, N * (1 + 4 * W + 16) + N * (8 + 4 * (W + 3)), 2 * K * N, err)

    # -- 5-8. the radix and packed kernels of hist_kernel=auto (int8:
    # bitwise), each timed against one index_add_ of its cells
    def yardstick(bins_long, sel, slot, nslot, nb):
        """ONE index_add_ of every (row, feature) value triple into its
        (slot, feature, bin) cell, the cell index precomputed."""
        nf = bins_long.shape[0]
        cell = torch.where(
            sel[None, :], (slot[None, :].long() * nf
                           + torch.arange(nf, device=dev)[:, None]) * nb
            + bins_long, nslot * nf * nb).reshape(-1)
        vals = torch.stack([g, h, torch.ones_like(g)], 1).repeat(nf, 1)
        acc = torch.zeros(nslot * nf * nb + 1, 3, device=dev)
        return time_ms(torch, lambda: acc.index_add_(0, cell, vals), flush)

    def masked_slot(lor_, leaves_):
        eq = lor_[None, :] == leaves_[:, None]
        return eq.any(0), eq.to(torch.uint8).argmax(0)

    # radix_single: the root pass; ~5% of rows excluded (leaf -1)
    lor_root = torch.as_tensor(
        np.where(rng.random(N) < 0.05, -1, 0).astype(np.int32), device=dev)
    err = same(HK.histogram_radix_single(bins_t, g, h, lor_root, **kw),
               HK.histogram_radix_single_plain(bins_t, g, h, lor_root, **kw),
               "histogram_radix_single int8")
    sel = lor_root >= 0
    n_sel = int(sel.sum().item())
    row("histogram_radix_single", "lightgbm_tpu_torch/csrc/radix.cu",
        "lightgbm_tpu/ops/hist_pallas.py:753",
        time_ms(torch, lambda: HK.histogram_radix_single(
            bins_t, g, h, lor_root, **kw), flush),
        time_ms(torch, lambda: HK.histogram_radix_single_plain(
            bins_t, g, h, lor_root, **kw), flush),
        yardstick(bins_t.long(), sel, torch.zeros_like(lor_root), 1, B),
        F * N + 12 * N + 16 * F * B, 3 * F * n_sel, err)

    # radix_joint: ladder widths 1 and 4 (a repeated slot checked too)
    for G, lv in ((1, [7]), (4, [3, 9, 3, 60])):
        lvt = torch.tensor(lv, dtype=torch.int32, device=dev)
        same(HK.histogram_radix_joint(bins_t, g, h, lor, lvt, **kw),
             HK.histogram_radix_joint_plain(bins_t, g, h, lor, lvt, **kw),
             f"histogram_radix_joint int8 G={G}")
    lv4 = torch.tensor([3, 9, 21, 60], dtype=torch.int32, device=dev)
    err = same(HK.histogram_radix_joint(bins_t, g, h, lor, lv4, **kw),
               HK.histogram_radix_joint_plain(bins_t, g, h, lor, lv4, **kw),
               "histogram_radix_joint int8 G=4")
    sel, slot = masked_slot(lor, lv4)
    n_sel = int(sel.sum().item())
    row("histogram_radix_joint", "lightgbm_tpu_torch/csrc/radix.cu",
        "lightgbm_tpu/ops/hist_pallas.py:826",
        time_ms(torch, lambda: HK.histogram_radix_joint(
            bins_t, g, h, lor, lv4, **kw), flush),
        time_ms(torch, lambda: HK.histogram_radix_joint_plain(
            bins_t, g, h, lor, lv4, **kw), flush),
        yardstick(bins_t.long(), sel, slot, 4, B),
        F * N + 12 * N + 16 + 16 * 4 * F * B, 3 * F * n_sel, err)

    # radix2: width 16 and every K = 42 full pass (repeated dummy slots)
    same(HK.histogram_leaves_radix2(bins_t, g, h, lor, leaves[:16], **kw),
         HK.histogram_leaves_radix2_plain(bins_t, g, h, lor, leaves[:16],
                                          **kw),
         "histogram_leaves_radix2 int8 K=16")
    err = same(HK.histogram_leaves_radix2(bins_t, g, h, lor, leaves, **kw),
               HK.histogram_leaves_radix2_plain(bins_t, g, h, lor, leaves,
                                                **kw),
               "histogram_leaves_radix2 int8 K=42")
    sel, slot = masked_slot(lor, leaves)
    n_sel = int(sel.sum().item())
    row("histogram_leaves_radix2", "lightgbm_tpu_torch/csrc/radix.cu",
        "lightgbm_tpu/ops/hist_pallas.py:557",
        time_ms(torch, lambda: HK.histogram_leaves_radix2(
            bins_t, g, h, lor, leaves, **kw), flush),
        time_ms(torch, lambda: HK.histogram_leaves_radix2_plain(
            bins_t, g, h, lor, leaves, **kw), flush),
        yardstick(bins_t.long(), sel, slot, K, B),
        F * N + 12 * N + 4 * K + 16 * K * F * B, 3 * F * n_sel, err)

    # packed: the max_bin=63 recipe's masked passes, B = 64, W = 7 words
    bins_t64 = (bins_t % (N64 - 1)).contiguous()
    words_t = bins_to_words(bins_t64.t()).t().contiguous()
    kwk = dict(num_f=F, n_bins=N64, hist_dtype="int8")
    err = same(HK.histogram_leaves_packed(words_t, g, h, lor, leaves, **kwk),
               HK.histogram_leaves_packed_plain(words_t, g, h, lor, leaves,
                                                **kwk),
               "histogram_leaves_packed int8")
    row("histogram_leaves_packed", "lightgbm_tpu_torch/csrc/packed.cu",
        "lightgbm_tpu/ops/hist_pallas.py:446",
        time_ms(torch, lambda: HK.histogram_leaves_packed(
            words_t, g, h, lor, leaves, **kwk), flush),
        time_ms(torch, lambda: HK.histogram_leaves_packed_plain(
            words_t, g, h, lor, leaves, **kwk), flush),
        yardstick(bins_t64.long(), sel, slot, K, N64),
        4 * W * N + 12 * N + 4 * K + 16 * K * F * N64, 3 * F * n_sel, err)
    del bins_t64, words_t

    # -- edges of the four, bitwise: a ragged n, F = 30 (half a word of
    # padding, which holds garbage for the packed kernel), float32 and
    # bfloat16 on integer values; float32 on real values within 1e-5 of
    # each cell's sum of |values| (reordered f32 sums)
    ne, fe = min(N, 100_003), 30
    bins_e = torch.as_tensor(rng.integers(0, B - 1, size=(fe, ne),
                                          dtype=np.uint8), device=dev)
    words_e = bins_to_words(bins_e.t() % N64).t().contiguous()
    words_e[-1] |= torch.randint(0, 63, (ne,), dtype=torch.int32,
                                 device=dev) << 24
    lor_e = lor[:ne].contiguous()
    le = leaves[:16].contiguous()
    lor_re = torch.where(lor_e < 8, -1, 0).to(torch.int32)

    def four(gg, hh, mode):
        kwm = dict(n_bins=B, hist_dtype=mode)
        kwp = dict(num_f=fe, n_bins=N64, hist_dtype=mode)
        return (
            ("radix_single",
             HK.histogram_radix_single(bins_e, gg, hh, lor_re, **kwm),
             HK.histogram_radix_single_plain(bins_e, gg, hh, lor_re, **kwm)),
            ("radix_joint",
             HK.histogram_radix_joint(bins_e, gg, hh, lor_e, lv4, **kwm),
             HK.histogram_radix_joint_plain(bins_e, gg, hh, lor_e, lv4,
                                            **kwm)),
            ("radix2",
             HK.histogram_leaves_radix2(bins_e, gg, hh, lor_e, le, **kwm),
             HK.histogram_leaves_radix2_plain(bins_e, gg, hh, lor_e, le,
                                              **kwm)),
            ("packed",
             HK.histogram_leaves_packed(words_e, gg, hh, lor_e, le, **kwp),
             HK.histogram_leaves_packed_plain(words_e, gg, hh, lor_e, le,
                                              **kwp)))

    ge, he = g[:ne].contiguous(), h[:ne].contiguous()
    for mode in ("int8", "float32", "bfloat16"):
        for name, a, b_ in four(ge, he, mode):
            same(a, b_, f"{name} {mode} (n = {ne}, F = {fe})")
    gre, hre = gr[:ne].contiguous(), hr[:ne].contiguous()
    mags = four(gre.abs(), hre, "float32")
    for (name, a, b_), (_, _, m) in zip(four(gre, hre, "float32"), mags):
        if not bool(((a - b_).abs() <= 1e-5 * m.abs() + 1e-30).all()):
            fail(f"{name} float32 (real values): outside 1e-5 of |values|")
    print(f"kernel edges (radix/packed): n = {ne}, F = {fe}, int8 / f32 / "
          "bf16 bitwise on integer values, f32 on real values", flush=True)

    # -- edges off the main path, bitwise: 80 slots (two slot groups of
    # shared memory at 256 bins), leaf ids past the slot table (linear
    # search), a table larger than shared memory
    ne = min(N, 100_000)
    lor_e = torch.as_tensor(rng.integers(2990, 3100, size=ne,
                                         dtype=np.int32), device=dev)
    leaves_e = torch.arange(3000, 3080, dtype=torch.int32, device=dev)
    bins_e = bins_t[:, :ne].contiguous()
    same(HK.histogram_leaves(bins_e, g[:ne], h[:ne], lor_e, leaves_e, **kw),
         HK.histogram_leaves_plain(bins_e, g[:ne], h[:ne], lor_e, leaves_e,
                                   **kw), "histogram_leaves (80 slots)")
    pay_e = torch.cat([words[:ne], g[:ne].view(torch.int32)[:, None],
                       h[:ne].view(torch.int32)[:, None], lor_e[:, None]],
                      1).contiguous()
    cnt_e = torch.tensor([ne - 17], dtype=torch.int32, device=dev)
    same(HK.histogram_payload(pay_e, leaves_e, cnt_e, **kwp),
         HK.histogram_payload_plain(pay_e, leaves_e, cnt_e, **kwp),
         "histogram_payload (80 slots)")
    bins64 = (bins_e % 63).contiguous()
    kw64 = dict(n_bins=64, hist_dtype="int8")
    same(HK.histogram_leaves(bins64, g[:ne], h[:ne], lor[:ne], leaves, **kw64),
         HK.histogram_leaves_plain(bins64, g[:ne], h[:ne], lor[:ne], leaves,
                                   **kw64), "histogram_leaves (64 bins)")
    big = torch.as_tensor(rng.normal(size=3000).astype(np.float32),
                          device=dev)
    idx_big = torch.as_tensor(rng.integers(-2, 3100, size=ne,
                                           dtype=np.int32), device=dev)
    same(TB.take_small_table(big, idx_big),
         TB.take_small_table_plain(big, idx_big), "take (T = 3000)")
    print("kernel edges: 80 slots, leaf ids >= 2048, 64 bins, T = 3000: "
          "bitwise",
          flush=True)

    # -- leaf renewal's fixed-order sums on the card (no kernel of its own):
    # the same bits twice, close to float64 sums, host syncs counted
    from lightgbm_tpu_torch.ops.quantize import leaf_sums_sorted
    lor_l = idx.long()

    def syncing(fn):
        """fn() and the source lines of the host syncs it made."""
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return out, [f"{os.path.basename(w.filename)}:{w.lineno}"
                     for w in seen if "synchroniz" in str(w.message)]

    s1, at1 = syncing(lambda: leaf_sums_sorted(lor_l, gr, hr, T))
    s2, at2 = syncing(lambda: leaf_sums_sorted(lor_l, gr, hr, T))
    for a, b_ in zip(s1, s2):
        same(a, b_, "leaf renewal sums (two runs)")
    ref, mag = (torch.zeros(T, dtype=torch.float64, device=dev).index_add_(
        0, lor_l, v) for v in (gr.double(), gr.double().abs()))
    if not bool(((s1[0].double() - ref).abs() <= 1e-5 * mag).all()):
        fail("leaf renewal sums: off the float64 sums by more than 1e-5 of "
             "each leaf's sum of |values|")
    print(f"leaf renewal: identical twice; host syncs: first call "
          f"{len(at1)} {at1}, second call {len(at2)} {at2}", flush=True)
    return rows


def profile_round(torch, bst):
    """One more boosting round under torch.profiler: the device's busy
    share of the round and the kernels that take the time.  Informational,
    so a profiler that sees no device time reports 'not measured'."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            kern.append((us / 1e3, e.count, e.key))
    busy = sum(k[0] for k in kern)
    if busy <= 0:
        print("profile: device time not measured (the profiler saw none)",
              flush=True)
        return
    kern.sort(reverse=True)
    print(f"profile: one round {wall_ms:.1f} ms wall (profiled), device "
          f"busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%), "
          f"{sum(k[1] for k in kern)} kernel launches", flush=True)
    for ms, cnt, name in kern[:8]:
        print(f"  {ms:8.3f} ms {cnt:5d}x {name[:90]}", flush=True)


def auc(y, s):
    order = np.argsort(s, kind="mergesort")
    y = y[order]
    pos = y > 0
    ranks = np.arange(1, len(y) + 1)
    # ties are measure-zero on continuous predictions
    return float((ranks[pos].sum() - pos.sum() * (pos.sum() + 1) / 2)
                 / (pos.sum() * (~pos).sum()))


def train_slice(torch, lgbt, n_train, rounds, device_type=None, seed=0,
                valid=False, **extra):
    """Train the recipe (updated by ``extra``) on a seeded synthetic set;
    with ``valid`` the held-out set is also a valid set scored on the
    device each round."""
    rng = np.random.default_rng(seed)
    X, y, w = synth_higgs(n_train, F, rng)
    Xv, yv, _ = synth_higgs(200_000, F, rng, w)
    params = dict(RECIPE, **extra)
    if device_type is not None:
        params["device_type"] = device_type
    stamps = []

    def clock(env):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    t0 = time.perf_counter()
    ds = lgbt.Dataset(X, y, params={"max_bin": params["max_bin"],
                                    "verbosity": -1})
    ds.construct()
    t_data = time.perf_counter() - t0
    t1 = time.perf_counter()
    vs = [ds.create_valid(Xv, yv)] if valid else []
    if valid:
        params["metric"] = "auc"
    bst = lgbt.train(params, ds, num_boost_round=rounds, valid_sets=vs,
                     valid_names=["held_out"], callbacks=[clock])
    t_train = time.perf_counter() - t1
    steps = np.diff([t1] + stamps)
    pred = bst.predict(Xv)
    if pred.shape != (len(yv),) or not np.isfinite(pred).all():
        fail(f"predict gave shape {pred.shape} / non-finite values")
    a = auc(yv, pred)
    if valid and abs(bst.best_score["held_out"]["auc"] - a) > 1e-4:
        fail(f"valid-set AUC {bst.best_score['held_out']['auc']} (device "
             f"bin-space scores) vs predict's {a}")
    return bst, a, t_data, t_train, steps


def launch_counts(HK, RF, TB, prng):
    return {"take_small_table": TB.launches,
            "histogram_leaves": HK.leaves_launches,
            "histogram_payload": HK.payload_launches,
            "partition_payload": RF.launches,
            "histogram_radix_single": HK.radix_single_launches,
            "histogram_radix_joint": HK.radix_joint_launches,
            "histogram_leaves_radix2": HK.radix2_launches,
            "histogram_leaves_packed": HK.packed_launches,
            "threefry_ops": prng.launches}


def zero_counts(HK, RF, TB, prng):
    TB.launches = RF.launches = prng.launches = 0
    HK.leaves_launches = HK.payload_launches = 0
    HK.radix_single_launches = HK.radix_joint_launches = 0
    HK.radix2_launches = HK.packed_launches = 0


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import lightgbm_tpu_torch as lgbt
        from lightgbm_tpu_torch.ops import cuda_lib, prng
        from lightgbm_tpu_torch.ops import hist_kernels as HK
        from lightgbm_tpu_torch.ops import round_fuse as RF
        from lightgbm_tpu_torch.ops import table as TB
    except ImportError as e:
        fail(f"cannot import lightgbm_tpu_torch ({e}); run from a checkout")

    # ---- 1. environment and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    build_s = cuda_lib.build_all()
    print(f"kernel build: {build_s:.1f} s", flush=True)
    for name, text in sorted(cuda_lib.build_log.items()):
        for ln in text.splitlines():
            if "registers" in ln or "error" in ln.lower():
                print(f"  ptxas {name}: {ln.strip()}", flush=True)

    # ---- 2. kernel checks
    rows = check_kernels(torch, torch.device("cuda"))

    # ---- 3. the default recipe on the card; counts zeroed just before,
    # read just after
    zero_counts(HK, RF, TB, prng)
    torch.cuda.reset_peak_memory_stats()
    bst, auc_main, t_data, t_train, steps = train_slice(
        torch, lgbt, N, 10)
    counts = launch_counts(HK, RF, TB, prng)
    peak = torch.cuda.max_memory_allocated()
    print(f"slice (default recipe): dataset {t_data:.2f} s, train "
          f"{t_train:.2f} s, first iter {steps[0]:.3f} s, s/iter (2-10) "
          f"{float(np.mean(steps[1:])):.4f}, held-out AUC {auc_main:.6f}, "
          f"peak device memory {peak / 2**20:.1f} MiB, "
          f"trees {bst.num_trees()}", flush=True)
    print("slice kernels: " + json.dumps(counts), flush=True)
    g = bst._gbdt
    if g.hp.hist_kernel != "auto" or not g.config.stochastic_rounding:
        fail("the slice did not run the default hist_kernel=auto with "
             "stochastic rounding")
    need = ("histogram_radix_single", "histogram_radix_joint",
            "histogram_leaves_radix2", "histogram_payload",
            "partition_payload", "take_small_table")
    missing = [k for k in need if counts[k] <= 0]
    if missing:
        fail(f"the default recipe never launched {missing}")
    if not auc_main > 0.7:
        fail(f"held-out AUC {auc_main} is not that of a trained model")
    try:
        profile_round(torch, bst)
    except (RuntimeError, AttributeError) as e:   # informational phase
        print(f"profile: not measured ({type(e).__name__}: {e})", flush=True)
    launches = dict(counts)
    del bst

    # (a) max_bin=63: every masked pass takes the packed kernel
    zero_counts(HK, RF, TB, prng)
    bst, auc63, _, t63, steps63 = train_slice(torch, lgbt, N, 5, max_bin=63)
    c63 = launch_counts(HK, RF, TB, prng)
    print(f"slice (max_bin=63): train {t63:.2f} s, s/iter (2-5) "
          f"{float(np.mean(steps63[1:])):.4f}, held-out AUC {auc63:.6f}; "
          f"kernels {json.dumps(c63)}", flush=True)
    if bst._gbdt.hp.n_bins != N64:
        fail(f"max_bin=63 trained at {bst._gbdt.hp.n_bins} device bins")
    if c63["histogram_leaves_packed"] <= 0:
        fail("the max_bin=63 recipe never launched histogram_leaves_packed")
    if not auc63 > 0.7:
        fail(f"max_bin=63 held-out AUC {auc63} is not that of a trained "
             f"model")
    launches["histogram_leaves_packed"] = c63["histogram_leaves_packed"]
    del bst

    # (b) PR 1's onehot recipe at a smaller depth: the flat kernel
    zero_counts(HK, RF, TB, prng)
    bst, auc1h, _, t1h, _ = train_slice(torch, lgbt, 100_000, 3, **ONEHOT)
    c1h = launch_counts(HK, RF, TB, prng)
    print(f"slice (hist_kernel=onehot, 100k x 3): train {t1h:.2f} s, "
          f"held-out AUC {auc1h:.6f}; kernels {json.dumps(c1h)}", flush=True)
    if c1h["histogram_leaves"] <= 0:
        fail("the onehot recipe never launched histogram_leaves")
    launches["histogram_leaves"] = c1h["histogram_leaves"]
    del bst
    for r in rows:
        r["launches"] = launches[r["name"]]

    # ---- 4. cross-check: card vs CPU plain versions, and card vs card
    b_gpu, auc_gpu, *_ = train_slice(torch, lgbt, 100_000, 5, seed=1,
                                     valid=True)
    b_cpu, auc_cpu, *_ = train_slice(torch, lgbt, 100_000, 5, "cpu", seed=1,
                                     valid=True)
    t_g, t_c = b_gpu._gbdt.models[0], b_cpu._gbdt.models[0]
    if not (t_g.num_leaves == t_c.num_leaves
            and np.array_equal(t_g.split_feature, t_c.split_feature)
            and np.array_equal(t_g.threshold_bin, t_c.threshold_bin)):
        fail("tree 0 differs between the card and the CPU")
    print(f"cross-check: tree 0 identical ({t_g.num_leaves} leaves), "
          f"AUC card {auc_gpu:.6f} cpu {auc_cpu:.6f}", flush=True)
    if abs(auc_gpu - auc_cpu) > 1e-3:
        fail(f"AUC card {auc_gpu} vs cpu {auc_cpu} differ by more than 1e-3")
    b_again, *_ = train_slice(torch, lgbt, 100_000, 5, seed=1, valid=True)
    if b_again.model_to_string() != b_gpu.model_to_string():
        fail("two card trainings gave different model text")
    print("cross-check: two card trainings gave byte-identical model text",
          flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
