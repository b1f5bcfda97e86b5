#!/usr/bin/env python3
"""Drive lightgbm_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device, ``nvcc`` (CUDA_HOME, PATH or /usr/local/cuda) and nothing
else: no jax, no network.  Phases, each of which fails the run on error:

1. environment and build: the card's name and power limit, the versions,
   and every kernel of ``lightgbm_tpu_torch/csrc`` compiled at once (the
   forest and SHAP kernels of phase 6 and the rank kernel of phase 11
   included), with
   the atomic opcodes the radix-single, rows and masked cluster kernels
   compiled to (the masked one, in radix.cu, packed.cu and hist.cu, every
   row source and the root pass's selector included, must add with native
   ``ATOMS.ADD``, no compare-and-swap loop and no global atomic);
2. kernel checks: each of the eleven histogram, partition and take
   kernels against its plain PyTorch
   version on the card, at the shapes of the HIGGS main path (n = 1M rows,
   F = 28 features, B = 256 bins, K = 42 leaves per round, T = 255 leaf
   values; B = 64 for the packed kernel; S = 45,056 compacted rows of the
   90k-row strict path for the rows histogram; S = 251,904 row-major rows
   for ``histogram_leaves_rows``, which no training path calls), with its
   time, the plain version's, one PyTorch library call's where one
   computes the same function, and the least time the card could take
   (bytes at 3.35 TB/s or operations at the CUDA-core rate), plus edge
   checks off the main path;
   every histogram kernel called twice in float32 and in bfloat16 on real
   values must give the same bits, and their float32 times are printed
   beside the int8 ones; leaf renewal's fixed-order sums (the same bits
   twice, host syncs counted); then the two kernels the strict path calls
   most at the shapes it gives them ("path shape:" lines):
   ``histogram_radix_single`` at n = 90,000 with 1/2 and 1/32 of the rows
   selected (its scale given by ``pass_scale`` and found in the launch)
   and ``histogram_rows_t`` at S = 5,632, 11,264 and 45,056, each timed
   (one call between CUDA events, and its device time from the profiler)
   beside its byte bound (the rows these inputs need) and one index_add_
   of the same cells, held bit for bit against the fixed-point reference
   (float32 and bfloat16 on real values, also at S = 22,528 and 90,112
   and the edges: C = 8 with a ragged S, B = 64
   with bins past it, NaN and inf on excluded rows, an empty selection,
   an all-zero bucket, one row), with each wrapper's launches per call
   from the profiler; then the masked K-leaf pass of the batched grower
   (one cluster kernel behind ``histogram_leaves_radix2`` and
   ``histogram_leaves``) at n = 1M: radix2 at K = 16 and K = 42, leaves at
   K = 42 and at the pooled rounds' 84 slots, each held bit for bit
   against ``histogram_leaves_fixed`` (float32 and bfloat16 on real
   values) and timed in int8 and float32 beside its byte bound, with its
   launches per call; the packed pass (``histogram_leaves_packed``, every
   masked pass of max_bin=63: K = 1, 16, 42 at n = 1M, B = 64) held the
   same way against ``histogram_leaves_fixed`` on the unpacked bins, and
   the fused partition (``partition_payload`` at K = 42,
   ``partition_select`` at K = 42 and 1) against its plain version on
   every output, each timed with its launches per call (exactly one), and
   both partition kernels at their edges (two valid slots with one
   parent, ``smaller`` holding -1 and invalid slots' ids, split features
   -1, F and 4W - 1, leaf ids past 2048); then ``histogram_radix_joint``
   (G = 1, 4 and a repeated layout) and ``histogram_radix_single``'s 1M
   root pass, both the masked cluster kernel, held bit for bit against
   their plain versions and fixed-point references on uniform bins and on
   bins where 3 of the 28 features take 3 values, also at 200,000 rows
   with strict-style leaf ids, and timed on both (int8; float32 on uniform
   bins) beside their byte bounds and one index_add_ of the same cells,
   one launch per call each; then ``take_small_table`` at n = 1M, T = 255
   against
   ``index_select``, the two taken in turn (device and one-call ms), and
   ``histogram_payload`` at the four compaction buckets of 1M rows (S =
   251,904, 126,976, 63,488, 16,384; cnt = 0.8 S, K = 42; int8 and
   float32; and at K = 1, K = 4, F = 4 and F = 3 in float32, bfloat16 and
   int8) held bit for bit against ``histogram_payload_fixed`` (float32
   and bfloat16 on real values) and its plain version, each with its edges
   (take: a ragged n, T = 1 and 3000, indices -1 and T, an unaligned view;
   payload: cnt 0 and S, leaf ids past 2048, bins past n_bins, NaN and inf
   past cnt, an unaligned payload), its launches per call (exactly one),
   byte bound and library call;
3. the slice: ``train()`` on a 1M x 28 HIGGS-shaped synthetic set (seeded
   numpy) with the default configuration of the HIGGS recipe
   (``hist_kernel`` and ``stochastic_rounding`` unset: the radix kernels,
   the warm-up ladder and threefry rounding), 10 rounds on the card under
   the auto policy (int8 levels, 42 splits per round, leaf renewal),
   ``predict`` on a 200k held-out set, a profiled round, and the launch
   count of every kernel in that run; then the same recipe at
   ``max_bin=63`` (1M rows x 5 rounds, the packed kernel) and with
   ``hist_kernel=onehot`` (100k rows x 3 rounds, the flat kernel); the
   strict default (90k rows x 10 rounds, nothing else set: one split per
   pass, float32 histograms, radix-single per split) with its host reads
   per split and a profiled round; the same with
   ``tpu_leaf_hist=bucketed`` (90k x 5, the rows kernel); and the pooled
   default (1M x 10 with ``histogram_pool_size=8``: 128 slots,
   ``partition_select``) and ``deterministic=true`` (1M x 5: the batched
   grower in float32, twice, the two model texts equal), each with its own
   launch counts; the sha256 of the model text of the default recipe, the
   max_bin=63 run, the onehot run, the strict default, the bucketed run,
   the pooled run and the deterministic run, and the bucketed run's rows
   launches by S;
4. cross-check: the default recipe at 100k rows x 1 round on the card and
   on the CPU (plain versions), the held-out set also a valid set scored on
   the device each round: tree 0's splits must match, the held-out AUCs
   agree within 1e-3, and each run's valid-set AUC agrees with its
   ``predict`` AUC within 1e-4; a second card run must give byte-identical
   model text.  The strict default at 50k x 1 (seed 1): card and CPU AUCs
   within 1e-3, and two card runs byte-identical (the float32 path is
   deterministic); the pooled recipe at 100k (card 3 rounds, CPU 1): tree
   0 identical on the card and the CPU.

5. the fused round loop (``GBDT.train_fused``, each boosting round one
   replay of a captured CUDA graph): the default recipe, max_bin=63, the
   pooled default, onehot and ``deterministic=true`` at phase 3's sizes,
   each through ``train()`` with no per-round callback, twice: the model
   text must be phase 3's classic text both times; each with its s/round,
   peak device memory, graph replays, flag reads per boosting round and
   kernel launches per tree (counts zeroed just before, read just after);
   a profiled fused chunk of the default recipe (busy share, launches),
   the device time of a round that is not live, and the chunk's host
   reads by source line; six alternating fused/classic training
   pairs of the default recipe (the classic loop forced by patching
   ``GBDT.supports_fused``): median s/round, the pairs' mean difference
   and its standard error, the fused median no slower; early stopping on
   100k rows with the 200k-row valid set (metric=auc, learning_rate 1.0,
   patience 1): best_iteration, trees and the recorded evaluations as the
   classic loop's, the device AUC within 1e-4 of ``predict``'s.

6. prediction: the default recipe trained on a 1M-row synthetic set for
   100 rounds through the fused loop, then ``Booster.predict`` on a 1M-row
   held-out set (1e8 row-trees: the device forest predictor, the forest
   kernel of csrc/forest.cu launched once per row block, its launch count
   zeroed just before and read just after): the wall split into host
   binning, the copy to the card, the kernel (device ms from the
   profiler) and the copy back, rows per second and the held-out AUC;
   held bit for bit against the plain path-count version on the card (its
   time is row 12's library column), against the host float64 walk on
   20,000 rows (rtol 2e-5 / atol 2e-6), in leaves mode against the plain
   ``predict_forest_leaves`` (bitwise) and ``pred_leaf``'s host walk
   (exact), the same bits twice; a seeded synthetic forest with
   categorical nodes and both sentinel bins at 1M rows, bitwise.
   ``pred_contrib`` on 10,000 held-out rows through the SHAP kernel of
   csrc/shap.cu (one launch per tree and 4,096-row chunk, counted):
   additivity against ``raw_score`` (1e-4 relative), the same bits twice,
   the plain PyTorch version on the card over 10 trees (rtol 1e-5 / atol
   1e-6), the host float64 path on 200 rows over 10 trees (largest
   relative difference printed, fail above 1e-4), the wall split (host
   ``_go_left_matrix``, copies, kernel), and a 40-slot chain tree, above
   the kernel's register buckets, against the plain version; the plain
   path-count version's torch.matmul products alone (device ms, the
   profiler's GEMM kernels).

7. EFB-bundled training: 1M rows of F numeric columns plus 8 categorical
   variables of 32 levels one-hot encoded (256 sparse columns; EFB
   bundles the 284 features into a few dozen physical columns) and a
   200k-row valid set.  The decision-table variant of the fused partition
   (``partition_payload_table`` at K = 42, ``partition_select_table`` at
   K = 42 and the pooled 84, tables from the plan's inverse table) bit
   for bit against its plain version, and with an all-numeric (identity)
   table against the numeric kernels, one launch a call, timed beside its
   byte bound; the default recipe (nothing else set, EFB on) 10 rounds
   through the fused loop twice and the classic loop once: byte-identical
   text; the same data with ``enable_bundle=false`` (s/round, peak memory,
   AUC side by side); the pooled recipe (1M x 3: the select variant); a
   profiled fused chunk (the table partition's device ms and launches a
   tree); early stopping on the valid set (patience 1), fused and classic
   to the same best_iteration; ``Booster.predict`` of the bundled model on
   the valid rows through the forest kernel against the host walk; 100k x
   1 on the card against ``device_type=cpu`` (tree 0 identical, AUC within
   1e-3).

8. categorical features: 1M rows of the Data Expo 2009 airline on-time
   shape (the 8-column form of the szilard/benchm-ml benchmark: Month,
   DayofMonth, DayOfWeek, UniqueCarrier, Origin and Dest named in
   ``categorical_feature``, Origin and Dest 300 Zipf-drawn airports;
   DepTime and Distance numeric) and a 200k-row held-out set, phase 3's
   recipe: the default 10 rounds through the fused loop twice and the
   classic loop once (byte-identical text; s/round, peak memory, every
   kernel's launches a tree; the table partition launched, the numeric
   one never; a chunk of replays allocating nothing outside the graph's
   pool); the pooled default (1M x 5, 128 slots,
   ``partition_select_table``); the strict default at 90k x 5;
   ``max_cat_to_onehot=8`` at 100k (card 3 rounds, CPU 1: tree 0
   identical) and 100k x 5 with the held-out set as a valid set, on the
   card and the CPU (tree 0 identical, AUCs within 1e-3, the device
   valid AUC within 1e-4 of ``predict``'s); ``partition_payload_table`` and
   ``partition_select_table`` at K = 42 with categorical bitset rows bit
   for bit against their plain twins; the same columns as numeric codes
   (s/round and AUC beside); a profiled fused chunk (device ms a round of
   the sorts, the histogram passes, the partition and the rest).

9. row sampling and the other boosting modes, on phase 3's data and
   recipe: the bagged default (1M x 10, ``bagging_fraction=0.8,
   bagging_freq=5``) and the GOSS default (1M x 10,
   ``data_sample_strategy=goss``: five warm-up rounds, then five GOSS
   rounds in one chunk), each through the fused loop twice and the classic
   loop once to byte-identical text, with s/round beside the unbagged
   default's, kernel launches a tree (the path's kernels must run under
   the mask), the draw's launches and device ms alone, a profiled chunk
   (the masked passes' and the payload passes' device ms a round beside
   the unbagged chunk's) and a chunk of replays that allocates nothing;
   ``partition_payload`` and ``histogram_leaves_radix2`` at K = 42 on 1M
   rows with the bag as the mask, bit for bit against their plain
   versions, timed with and without it; the strict default bagged (90k x
   5, classic); pos/neg bagging (100k x 3), RF (100k x 5) and DART (100k
   x 5, its s/round beside the plain classic loop's, its train scores
   against ``predict``; one tree's contribution walked over 1M rows);
   bagged EFB and categorical cells at 100k x 5 (fused and classic to the
   same text); the bagged and GOSS (100k x 1, no warm-up)
   cells on the card and the CPU, tree 0 identical.
10. the other objectives and their metrics: multiclass (k = 7 trees a
   round, one class body replayed per class) on 581,012 Covertype-shaped
   rows (10 numeric, 4 + 40 one-hot columns that EFB bundles, Covertype's
   class counts) at the HIGGS recipe, 10 rounds fused twice and classic
   once to byte-identical text, with s/round beside 7 x phase 5's binary
   round, replays and flag reads a round, capture seconds, peak memory,
   the path's launches a tree and a profiled chunk; a 100k valid set with
   multi_logloss / multi_error on the device inside the round and early
   stopping (against the host's float64 values); ``Booster.predict`` of
   1M held-out rows through the forest kernel (k = 7) against the host
   walk, rows/s; multiclassova 100k x 3 (fused = classic); the
   regression family and the cross-entropies on phase 3's 1M x 28 rows,
   5 rounds each (fused twice and classic once to the same text; l1,
   quantile and MAPE classic with their host renewal's seconds a tree);
   multiclass (15 leaves), huber and quantile on the card against the
   CPU, tree 0 identical.
11. learning to rank on 2,270,296 synthetic documents of MSLR-WEB30K Fold
   1's shape (18,919 lognormal-length queries, 136 features, labels 0-4,
   a valid set of 6,306 queries): lambdarank at its defaults with 255
   leaves, 10 rounds through the fused loop with valid ndcg@1,3,5,10 in
   the round, twice to byte-identical text, with s/round, capture
   seconds, peak memory, launches a tree and a profiled chunk (the rank
   kernel against the passes); the rank kernel (``csrc/rank.cu``) against
   its plain version on the booster's scores (timed beside its bound) and
   on a skewed fixture (a query of one document, one of equal labels, one
   past the kernel's shared-memory staging, weights, norm on and off);
   rank_xendcg and position-debiased lambdarank through the classic loop.
12. split constraints on phase 3's 1M x 28 set and recipe: monotone
   constraints (on the six features of the largest logit weights, in
   their weights' directions; leaf renewal off, whose unclipped leaves
   break the order, as printed) fused with the basic method (10 rounds),
   intermediate, advanced and basic with ``monotone_penalty=2`` (5
   rounds each), each with s/round, launches a
   round, capture seconds, peak memory and the device time's share in
   split finding and the sequential record, and every model swept over
   each constrained feature's bin bounds on 1,000 held-out rows with no
   violation of the predictions' order; extra trees +
   ``feature_fraction_bynode=0.5`` + ``path_smooth=10`` + interaction
   sets {0..13}, {14..27}, fused twice and classic once to the same text,
   every root-to-leaf path inside one set; the strict learner at 90k rows
   (intermediate monotone, extra trees, by-node sampling, classic, 3
   rounds) with its launches a split; the basic and the extra-trees
   configurations on the card against the CPU (100k x 1, tree 0
   identical, AUC within 1e-3); and the threefry kernel
   (``csrc/prng.cu``) against its plain version bit for bit at the
   round's shapes (84 keys x 28 for each draw family), the strict
   learner's 4-way split and a 1M draw, twice, timed beside its bound.
13. forced splits, CEGB and linear trees (``check_learner_options``):
   a forced schedule three levels deep on phase 3's 1M x 28 set, 10
   rounds fused twice and classic once to the same text (the schedule
   held in every tree), pooled (``histogram_pool_size=8``) and a forced
   categorical root on the airline shape, each fused = classic, and the
   regression recipe (leaf renewal off) at 100k x 1 on the card and the
   CPU to the same trees' text; CEGB with split, coupled and lazy penalties (1M x 10,
   classic, twice to the same text, s/round beside the plain classic
   recipe's); linear trees on 1M rows of a piecewise-linear target (the
   batched float32 grower, classic) 100 rounds with s/round and launches
   a tree, ``Booster.predict`` of 1M held-out rows through the forest
   kernel's linear mode (bit for bit against the plain version on the
   card, both timed; the host walk on 20,000 rows), 5 rounds twice and
   the strict learner at 90k x 3 twice to the same text; the two entries
   of ``csrc/linear.cu`` (the leaves' normal equations, the linear leaf
   scores) against their plain versions on one tree of that booster
   (normal equations to 1e-5 of the largest value and the same bits
   twice, scores bit for bit), timed beside their bounds, and the linear
   fit's share of a round.
14. the training surface (``check_training_surface``): a numpy ``fobj``
   against the built-in objective, ``nan_policy``, ``init_model``
   continuation (the init scores through the forest kernel), ``cv`` and
   ``refit`` / ``rollback_one_iter`` on phase 3's set.
15. the user surfaces (``check_user_surfaces``; no new kernel, the
   launches of each part printed on a ``phase 15 kernels`` line): (a) a
   50,000-row CSV with a header and a ``.weight`` file and 10,000 LibSVM
   rows, ``Dataset(path)`` equal to the matrix's Dataset and 5 fused
   rounds to the matrix's text, the parse's MiB/s; (b) binary datasets
   (plain and EFB-bundled) saved, loaded and trained to the same text;
   (c) 1M x 4,000 one-hot CSR columns (8 exclusive groups) binned without
   a dense matrix (the resident set's growth under 4 GB), bundled into at
   most 64 columns of up to 256 bins, 5 fused rounds, the trainer's
   scores against ``Booster.predict`` of the CSR (host walk and forest
   kernel), 100k x 1 card against CPU to the same text; (d) the sklearn
   estimators to ``train()``'s texts; (e) ``feature_importance`` and
   ``dump_model`` against the model text, ``eval_train`` after
   ``set_leaf_output`` / ``merge_models`` / ``shuffle_models`` and a
   linear model's ``set_leaf_output`` against the metric of ``predict``,
   ``reset_training_data`` then fused rounds equal to the classic loop's,
   its live device memory no more than a fresh booster's; (f) the CLI in
   subprocesses (train, predict, convert_model; exit code 1 without a
   card).
16. the C API (``check_c_api``; no new kernel): through the port's
   ``liblgbtpu_capi.so`` (g++, built beside phase 1's kernels) in this
   process, a Dataset made by ``DatasetCreateFromMat`` from phase 3's 1M x
   28 rows: (a) a C ABI booster and a Python ``Booster`` on that one
   Dataset take turns for 5 rounds on the card, their texts equal, a C
   round against a Python round and the shim's cost a call; (b) 1,000
   ``PredictForMatSingleRowFast`` rows, each bitwise ``Booster.predict``
   of the row, one forest-kernel launch (leaves mode) a row; (c)
   ``CompiledPredictor`` (trained and from model text) over the default
   ladder, 120 mixed-size requests, exact mode bitwise against
   ``Booster.predict(raw_score=True)``, fast mode against the device
   predict, live device memory flat across the requests; (f) the model
   text loaded through the ABI predicts 100,000 rows on the card through
   the forest kernel's leaves, bitwise the host walk; (e) live device
   memory back within 1 MiB after ``FreeHandle``; then a pure C program
   (gcc) trains the same 5 rounds through ``LGBMTPU_*`` calls, its model
   text and predictions equal to the Python booster's, and (d) a pthread
   of that program trains a second booster on the first's dataset handle
   to the same text and bits.

It prints one JSON line with every kernel's numbers (launches: the fused
runs' for the kernels a fused run holds, the table partitions' those of
phases 7 and 8 together, the bucketed strict run's for
``histogram_rows_t``, phase 12 (a)-(c)'s for the threefry kernel, phase
13 (c)'s for the linear kernels and the forest kernel's linear mode,
phase 16's fast path, serving predictor and loaded-model predict added to
the forest kernel's; the "library device ms" line adds the index_add_
device times of rows 2, 7 and 8), the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --ab DIR`` instead compares ``take_small_table``,
``histogram_payload``, ``histogram_radix_single`` (the 1M root pass) and
``histogram_radix_joint`` with those of another checkout of the port in
DIR (``git archive`` of another commit), in one process, then alternates
the two packages' trainings: see ``ab_main``.
"""

import collections
import gc
import hashlib
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
CUDA_CORE_OPS_PER_S = 67e12   # H100 SXM f32 outside the tensor cores
N, F, B, K, T = 1_000_000, 28, 256, 42, 255
N64, W = 64, (F + 3) // 4     # the packed kernel's bins and words
N_STRICT = 90_000             # just under the auto policy's 100k switch
S_ROWS = 45_056               # the strict path's half bucket at 90k rows
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


def syncing(torch, fn):
    """fn() and the source locations of the host syncs it made."""
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


def bound_ms(nbytes, ops):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


#: masked_cluster's row sources (its third template argument)
MASKED_SOURCES = {"0": "bytes", "1": "words", "2": "payload", "3": "rows"}
#: the masked_cluster instantiations the libraries must hold, as
#: sass_atomics names them: every row source with the slot table, and
#: histogram_radix_single's root pass (bins_t, slot 0 for every leaf id
#: >= 0: "any"), each in modes 0-2
MASKED_KERNELS = {f"masked_cluster<{m}> {src}" for m in range(3)
                  for src in MASKED_SOURCES.values()} | {
                      f"masked_cluster<{m}> bytes any" for m in range(3)}


def sass_atomics(cuda_lib):
    """How the shared-memory adds of the radix-single, rows and masked
    cluster kernels compiled (the masked one, in every library that
    builds it, as "masked_cluster<mode> <row source>[ any]": bytes, the
    bins_t of histogram_leaves, histogram_leaves_radix2 and
    histogram_radix_joint, and with "any" the root pass of
    histogram_radix_single above 131,072 rows; words, the packed mirror of
    histogram_leaves_packed; payload, the rows of histogram_payload; rows,
    the row-major bins of histogram_leaves_rows): per kernel and mode (0
    int8, 1 float32, 2 bfloat16), the count of each atomic and reduction
    instruction in ``cuobjdump -sass`` of the built libraries, by opcode (a
    64-bit add that is not native shows as the compare-and-swap loop
    ``ATOMS.CAST.SPIN.64``, a global atomic as ``ATOMG``, ``RED`` or
    ``REDG``; ``REDUX`` is a warp reduction).  None when cuobjdump is
    missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    kern = re.compile(r"(radix_single_cluster|rows_channel|masked_cluster)"
                      r"ILi(\d)E(?:Li\d+ELi(\d)ELi(\d)E)?")
    # an instruction: its address, an optional predicate, its opcode
    instr = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                       r"([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)")
    found = {}
    # one cuobjdump a library, all started together, each into a file of
    # its own (a pipe would hold the others back while one is read)
    outs = [tempfile.TemporaryFile("w+") for _ in range(4)]
    procs = [subprocess.Popen([tool, "-sass", str(cuda_lib._lib_path(name))],
                              stdout=out, stderr=subprocess.DEVNULL)
             for name, out in zip(("radix", "rows", "packed", "hist"), outs)]
    try:
        for proc, out in zip(procs, outs):
            proc.wait(timeout=300)
            out.seek(0)
            text = out.read()
            key = None
            for ln in text.splitlines():
                if "Function :" in ln:
                    m = kern.search(ln)
                    key = None
                    if m:
                        key = f"{m.group(1)}<{m.group(2)}>"
                        if m.group(1) == "masked_cluster":
                            key += " " + MASKED_SOURCES[m.group(3)]
                            key += " any" if m.group(4) == "1" else ""
                elif key is not None:
                    o = instr.match(ln)
                    if o and o.group(1).startswith(("ATOM", "RED")):
                        c = found.setdefault(key, {})
                        c[o.group(1)] = c.get(o.group(1), 0) + 1
    finally:
        for proc, out in zip(procs, outs):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
    return found


#: device ms of the library call (one index_add_ into precomputed cells)
#: of the masked passes phase 2 times, by kernel
library_device = {}


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
    row("histogram_leaves", "lightgbm_tpu_torch/csrc/masked.cuh",
        "lightgbm_tpu/ops/hist_pallas.py:188",
        time_ms(torch, lambda: HK.histogram_leaves(bins_t, g, h, lor, leaves,
                                                   **kw), flush),
        time_ms(torch, lambda: HK.histogram_leaves_plain(
            bins_t, g, h, lor, leaves, **kw), flush),
        time_ms(torch, lambda: acc.index_add_(0, cell, vals), flush),
        F * N + 12 * N + 4 * K + 16 * K * F * B, 3 * F * sel_rows, err)
    library_device["histogram_leaves"] = device_per_call(
        torch, lambda: acc.index_add_(0, cell, vals))[1]
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
    # library yardstick: ONE index_add_ of every (row, feature) value triple
    # into its cell, taken from the payload's bin bytes and the row's leaf
    # slot; rows at or past cnt and rows of no slot go to a trash cell
    lor_p = payload[:, W + 2]
    sel = torch.isin(lor_p, leaves) & (torch.arange(S, device=dev) < cnt)
    slot = (lor_p[None, :] == leaves[:, None]).to(torch.uint8).argmax(0)
    fi = torch.arange(F, device=dev)
    pbin = (payload[:, fi // 4].t() >> (8 * (fi % 4))[:, None]) & 255
    cell = torch.where(sel[None, :], (slot[None, :].long() * F
                                      + fi[:, None]) * B + pbin.long(),
                       K * F * B).reshape(-1)
    vals = torch.stack([g[:S], h[:S], torch.ones_like(g[:S])], 1).repeat(F, 1)
    acc = torch.zeros(K * F * B + 1, 3, device=dev)
    row("histogram_payload", "lightgbm_tpu_torch/csrc/masked.cuh",
        "lightgbm_tpu/ops/hist_pallas.py:318",
        time_ms(torch, lambda: HK.histogram_payload(payload, leaves, cnt,
                                                    **kwp), flush),
        time_ms(torch, lambda: HK.histogram_payload_plain(
            payload, leaves, cnt, **kwp), flush),
        time_ms(torch, lambda: acc.index_add_(0, cell, vals), flush),
        c * 4 * (W + 3) + 4 * K + 4 + 16 * K * F * B,
        3 * F * sel_p, err)
    del lor_p, sel, slot, pbin, cell, vals, acc

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
    def yardstick(bins_long, sel, slot, nslot, nb, name=None):
        """ONE index_add_ of every (row, feature) value triple into its
        (slot, feature, bin) cell, the cell index precomputed; with
        ``name``, its device ms too (``library_device``)."""
        nf = bins_long.shape[0]
        cell = torch.where(
            sel[None, :], (slot[None, :].long() * nf
                           + torch.arange(nf, device=dev)[:, None]) * nb
            + bins_long, nslot * nf * nb).reshape(-1)
        vals = torch.stack([g, h, torch.ones_like(g)], 1).repeat(nf, 1)
        acc = torch.zeros(nslot * nf * nb + 1, 3, device=dev)
        if name is not None:
            library_device[name] = device_per_call(
                torch, lambda: acc.index_add_(0, cell, vals))[1]
        return time_ms(torch, lambda: acc.index_add_(0, cell, vals), flush)

    def masked_slot(lor_, leaves_):
        eq = lor_[None, :] == leaves_[:, None]
        return eq.any(0), eq.to(torch.uint8).argmax(0)

    # radix_single: the root pass; ~5% of rows excluded (leaf -1).  Bound:
    # every leaf id, then the bins, grad and hess of the selected rows
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
        4 * N + n_sel * (F + 8) + 16 * F * B, 3 * F * n_sel, err)

    # radix_joint: ladder widths 1 and 4 (a repeated slot checked too);
    # bound as radix_single's
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
        4 * N + n_sel * (F + 8) + 16 + 16 * 4 * F * B, 3 * F * n_sel, err)

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
    row("histogram_leaves_radix2", "lightgbm_tpu_torch/csrc/masked.cuh",
        "lightgbm_tpu/ops/hist_pallas.py:557",
        time_ms(torch, lambda: HK.histogram_leaves_radix2(
            bins_t, g, h, lor, leaves, **kw), flush),
        time_ms(torch, lambda: HK.histogram_leaves_radix2_plain(
            bins_t, g, h, lor, leaves, **kw), flush),
        yardstick(bins_t.long(), sel, slot, K, B, "histogram_leaves_radix2"),
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
        yardstick(bins_t64.long(), sel, slot, K, N64,
                  "histogram_leaves_packed"),
        4 * W * N + 12 * N + 4 * K + 16 * K * F * N64, 3 * F * n_sel, err)
    del bins_t64, words_t

    # leaves_rows: the masked pass from row-major bins u8 [S, F], at the
    # n/4 bucket of rows (no training path calls it: the JAX package
    # reaches it only under its LGBMTPU_NO_PAYLOAD_KERNEL hatch).  Bound:
    # the S leaf ids, then the bins, grad and hess of the selected rows
    br = bins_rows[:S]
    gs, hs, ls = g[:S], h[:S], lor[:S]
    err = same(HK.histogram_leaves_rows(br, gs, hs, ls, leaves, **kw),
               HK.histogram_leaves_rows_plain(br, gs, hs, ls, leaves, **kw),
               "histogram_leaves_rows int8")
    sel, slot = masked_slot(ls, leaves)
    n_sel = int(sel.sum().item())
    cell = torch.where(sel[None, :], (slot[None, :].long() * F
                                      + torch.arange(F, device=dev)[:, None])
                       * B + br.t().long(), K * F * B).reshape(-1)
    vals = torch.stack([gs, hs, torch.ones_like(gs)], 1).repeat(F, 1)
    acc = torch.zeros(K * F * B + 1, 3, device=dev)
    row("histogram_leaves_rows", "lightgbm_tpu_torch/csrc/masked.cuh",
        "lightgbm_tpu/ops/hist_pallas.py:308",
        time_ms(torch, lambda: HK.histogram_leaves_rows(
            br, gs, hs, ls, leaves, **kw), flush),
        time_ms(torch, lambda: HK.histogram_leaves_rows_plain(
            br, gs, hs, ls, leaves, **kw), flush),
        time_ms(torch, lambda: acc.index_add_(0, cell, vals), flush),
        4 * S + n_sel * (F + 8) + 4 * K + 16 * K * F * B, 3 * F * n_sel,
        err)
    del br, cell, vals, acc

    # -- rows histogram (the strict path's bucketed pass) at F = 28,
    # B = 256, C = 4 (grad, hess, valid, 0; a quarter of the rows masked)
    # and S = 45,056 and 90,112: int8 bitwise, float32 and bfloat16
    # bitwise on integer values, float32 on real values within 1e-5 of each
    # cell's sum of |values|
    def rows_vals(S, gg, hh):
        valid = (lor[:S] % 4 != 0).to(torch.float32)
        return torch.stack([gg[:S] * valid, hh[:S] * valid, valid,
                            torch.zeros_like(valid)]).contiguous()

    def rows_check(bs, vi, vr, nb, what):
        for mode in ("int8", "float32", "bfloat16"):
            kwr = dict(n_bins=nb, hist_dtype=mode)
            same(HK.histogram_rows_t(bs, vi, **kwr),
                 HK.histogram_rows_t_plain(bs, vi, **kwr),
                 f"histogram_rows_t {mode} ({what})")
        kwr = dict(n_bins=nb, hist_dtype="float32")
        got = HK.histogram_rows_t(bs, vr, **kwr)
        want = HK.histogram_rows_t_plain(bs, vr, **kwr)
        mag = HK.histogram_rows_t_plain(bs, vr.abs(), **kwr)
        if not bool(((got - want).abs() <= 1e-5 * mag + 1e-30).all()):
            fail(f"histogram_rows_t float32 ({what}, real values): outside "
                 f"1e-5 of |values|")
        return float((got - want).abs().max().item())

    for S in (2 * S_ROWS, S_ROWS):
        bs = bins_t[:, :S].contiguous()
        err = rows_check(bs, rows_vals(S, g, h), rows_vals(S, gr, hr), B,
                         f"S = {S}")
    vr = rows_vals(S_ROWS, gr, hr)
    cell = (torch.arange(F, device=dev)[:, None] * B + bs.long()).reshape(-1)
    vrep = vr.t().repeat(F, 1)
    acc = torch.zeros(F * B, 4, device=dev)
    kwr = dict(n_bins=B, hist_dtype="float32")
    row("histogram_rows_t", "lightgbm_tpu_torch/csrc/rows.cu",
        "lightgbm_tpu/ops/hist_pallas.py:124",
        time_ms(torch, lambda: HK.histogram_rows_t(bs, vr, **kwr), flush),
        time_ms(torch, lambda: HK.histogram_rows_t_plain(bs, vr, **kwr),
                flush),
        time_ms(torch, lambda: acc.index_add_(0, cell, vrep), flush),
        F * S_ROWS + 16 * S_ROWS + 16 * F * B, 4 * F * S_ROWS, err)
    del cell, vrep, acc
    # edge: C = 8, a ragged S, F = 30, B = 64 with bins past 63 (dropped)
    se = 45_001
    be = torch.as_tensor(rng.integers(0, 70, size=(30, se), dtype=np.uint8),
                         device=dev)
    vi8 = torch.as_tensor(rng.integers(-4, 5, size=(8, se)).astype(
        np.float32), device=dev)
    vr8 = torch.as_tensor(rng.normal(size=(8, se)).astype(np.float32),
                          device=dev)
    rows_check(be, vi8, vr8, N64, "C = 8, S = 45,001, F = 30, B = 64")
    print("kernel edges (rows): C = 8, S = 45,001, F = 30, B = 64", flush=True)

    # -- partition_select: partition_payload without the payload, K = 42
    # (3 invalid slots) and K = 1, a tenth of the rows masked out; bitwise
    mask_z = torch.as_tensor((rng.random(N) >= 0.1).astype(np.int32),
                             device=dev)
    names = ("feats", "thr", "dl", "nanb", "parents", "new_leaves", "validk",
             "smaller")

    def sel_args(k):
        return (bins_t, lor, mask_z) + tuple(d[nm][:k].contiguous()
                                             for nm in names)

    for k in (1, K):
        for a, b_, what in zip(RF.partition_select(*sel_args(k)),
                               RF.partition_select_plain(*sel_args(k)),
                               ("new leaf map", "sort key")):
            err = same(a, b_, f"partition_select {what} (K = {k})")
    moving = int(torch.isin(lor, d["parents"][d["validk"] > 0]).sum().item())
    args_k = sel_args(K)
    row("partition_select", "lightgbm_tpu_torch/csrc/partition.cu",
        "lightgbm_tpu/ops/round_fuse.py:76",
        time_ms(torch, lambda: RF.partition_select(*args_k), flush),
        time_ms(torch, lambda: RF.partition_select_plain(*args_k), flush),
        None, 8 * N + moving + 8 * N + 32 * K, 2 * K * N, err)

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

    # -- the partition kernels' edges, bitwise on every output, at the
    # ragged n and F = 30 above (W = 8; garbage in the padding bytes)
    words_p = bins_to_words(bins_e.t())
    words_p[:, -1] |= torch.as_tensor(rng.integers(0, 1 << 15, size=ne,
                                                   dtype=np.int32),
                                      device=dev) << 16
    mask_p, edges = partition_edges(rng, ne, fe, words_p.shape[1])
    mask_p = torch.as_tensor(mask_p, device=dev)
    for what, lor_p, dsc in edges:
        lor_p = torch.as_tensor(lor_p, device=dev)
        dsc = [torch.as_tensor(dsc[nm], device=dev) for nm in PART_DESC]
        args = (bins_e, words_p, ge, he, lor_p, mask_p, *dsc)
        for a, b_, out in zip(RF.partition_payload(*args),
                              RF.partition_payload_plain(*args),
                              ("new leaf map", "sort key", "payload")):
            same(a, b_, f"partition_payload {out} ({what})")
        args = (bins_e, lor_p, mask_p, *dsc)
        for a, b_, out in zip(RF.partition_select(*args),
                              RF.partition_select_plain(*args),
                              ("new leaf map", "sort key")):
            same(a, b_, f"partition_select {out} ({what})")
    print(f"kernel edges (partition): n = {ne}, F = {fe}, "
          + "; ".join(w for w, _, _ in edges) + ": bitwise", flush=True)

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

    s1, at1 = syncing(torch, lambda: leaf_sums_sorted(lor_l, gr, hr, T))
    s2, at2 = syncing(torch, lambda: leaf_sums_sorted(lor_l, gr, hr, T))
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


#: the partition kernels' slot descriptors, in their argument order
PART_DESC = ("feats", "thr", "dl", "nanb", "parents", "new_leaves", "validk",
             "smaller")


def partition_edges(rng, n, num_f, W):
    """The edges a leaf -> slot table must keep, K = 6 slots (4 valid) over
    leaf ids 0-8: (a bagging mask, [(what, leaf map, descriptors)]).  Two
    valid slots with one parent (their moves sum), also at K = 3, where the
    kernel takes its loops and no tables; ``smaller`` holding -1
    and the ids of invalid slots; split features -1, F and 4W - 1; leaf ids
    past the 2048-entry table."""
    K = 6
    base = rng.integers(0, 9, size=n).astype(np.int32)

    def desc():
        par = rng.permutation(9)[:K].astype(np.int32)
        nl = (9 + np.arange(K)).astype(np.int32)
        return dict(
            feats=rng.integers(0, num_f, size=K, dtype=np.int32),
            thr=rng.integers(0, 256, size=K, dtype=np.int32),
            dl=rng.integers(0, 2, size=K, dtype=np.int32),
            nanb=np.where(rng.random(K) < 0.5, 200, -1).astype(np.int32),
            parents=par, new_leaves=nl,
            validk=(np.arange(K) < 4).astype(np.int32),
            smaller=np.where(rng.random(K) < 0.5, par, nl).astype(np.int32))

    edges = []
    d = desc()
    d["parents"][:] = [2, 2, 5, 2, 7, 2]
    edges.append(("two valid slots with one parent", base, d))
    edges.append(("the same at K = 3 (the loops, no tables)", base,
                  {nm: v[:3].copy() for nm, v in d.items()}))
    d = desc()
    d["smaller"][:] = [-1, d["parents"][1], d["new_leaves"][2], -1,
                       d["parents"][4], d["parents"][5]]
    edges.append(("smaller holds -1 and invalid slots' ids", base, d))
    d = desc()
    d["feats"][:] = [-1, num_f, 4 * W - 1, 3, -7, 1000]
    d["thr"][:3] = 0
    edges.append(("split features -1, F, 4W - 1", base, d))
    d = desc()
    d["parents"] += 2995
    d["parents"][1] = d["parents"][0]
    d["new_leaves"] += 3991
    d["smaller"] = np.where(rng.random(K) < 0.5, d["parents"],
                            d["new_leaves"]).astype(np.int32)
    d["smaller"][0] = 2047
    edges.append(("leaf ids >= 2048", base + 2995, d))
    return (rng.random(n) >= 0.2).astype(np.int32), edges


def device_work(prof):
    """[(name, count, device us)] of the kernels, memsets and copies in a
    torch.profiler window."""
    work = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            work.append((e.key, e.count, us))
    return work


def host_launches(prof):
    """The launch, memset and copy calls the host made in the window."""
    return sum(e.count for e in prof.key_averages() if re.match(
        r"cu(da)?(LaunchKernel|LaunchCooperativeKernel|Memset|Memcpy)",
        e.key))


#: the device work of the latest device_per_call window, by name
last_window = {}
#: windows measured again because the profiler lost a record
lost_windows = []
#: [(name, count, device us)] of the latest device_per_call window
last_work = []


def device_per_call(torch, fn, reps=10, tries=5):
    """(launches, device ms) per call of ``fn`` (kernels and memsets,
    inputs warm in L2), from the profiler; (None, None) when it saw no
    device record.  Beside time_ms, which also holds the host's time to
    reach the launch, this is the kernel's own time.  CUPTI now and then
    loses a kernel's device record, so a window whose device records
    disagree with the launch calls the host made in it, or that holds no
    record at all, is measured again,
    up to ``tries`` windows in all; if the last still disagrees, the
    host's launch calls count the launches and the records seen give
    their mean time (the "profiler:" line lists such windows as kept)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        work = device_work(prof)
        n = sum(w[1] for w in work)
        launched = host_launches(prof)
        # a window with no record at all (CUPTI lost the whole window, the
        # host's calls too) is measured again like one that disagrees
        if n == launched and n:
            break
        lost_windows.append(dict(device=n, host=launched,
                                 kept=attempt == tries - 1))
    last_window.clear()
    last_window.update((name[:60], cnt) for name, cnt, _ in work)
    last_work[:] = work
    last_window["host launches"] = launched
    us = sum(w[2] for w in work)
    if not n:
        return None, None
    return launched / reps, us / 1e3 / n * launched / reps


def launches_per_call(torch, fn):
    return device_per_call(torch, fn)[0]


def check_path_shapes(torch, dev):
    """Phase 2b: the two kernels the strict path calls most, at the shapes
    it gives them, held bit for bit against the fixed-point reference
    (float32 and bfloat16 on real values) and timed beside their byte
    bound and one index_add_ of the same cells:
    ``histogram_radix_single`` at n = 90,000 with 1/2 and 1/32 of the rows
    selected (the per-tree scale given, as the strict grower gives it, and
    not given), ``histogram_rows_t`` at the bucket sizes of 90k rows; plus
    the edges and each wrapper's launches per call."""
    from lightgbm_tpu_torch.ops import hist_kernels as HK
    rng = np.random.default_rng(7)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    out = {"radix_single": [], "rows_t": [], "launches_per_call": {}}

    def t(a):
        return torch.as_tensor(a, device=dev)

    def bitwise(a, b, what):
        if a.shape != b.shape or not torch.equal(a.view(torch.int32),
                                                 b.view(torch.int32)):
            d = ((a.double() - b.double()).abs().max().item()
                 if a.shape == b.shape else float("nan"))
            fail(f"{what}: kernel differs from the fixed-point reference "
                 f"(max abs diff {d})")

    def radix_fixed(bins, g, h, lor, nb, what):
        for mode in ("float32", "bfloat16"):
            kw = dict(n_bins=nb, hist_dtype=mode)
            ref = HK.histogram_radix_single_fixed(bins, g, h, lor, **kw)
            bitwise(HK.histogram_radix_single(bins, g, h, lor, **kw), ref,
                    f"histogram_radix_single {mode} ({what})")
            bitwise(HK.histogram_radix_single(
                bins, g, h, lor, scale=HK.pass_scale(g, h), **kw), ref,
                f"histogram_radix_single {mode}, scale given ({what})")

    # -- radix_single, n = 90,000: NaN grad on the excluded rows
    n = N_STRICT
    bins = t(rng.integers(0, B - 1, size=(F, n), dtype=np.uint8))
    gr = t(rng.normal(size=n).astype(np.float32))
    hr = t(rng.random(n).astype(np.float32))
    gi = t(rng.integers(-2, 3, size=n).astype(np.float32))
    hi = t(rng.integers(0, 5, size=n).astype(np.float32))
    for frac, tag in ((0.5, "1/2"), (1 / 32, "1/32"), (0.0, "empty")):
        lor = t(np.where(rng.random(n) < frac, 0, -1).astype(np.int32))
        g = torch.where(lor >= 0, gr, torch.full_like(gr, float("nan")))
        radix_fixed(bins, g, hr, lor, B, f"n = {n}, {tag} selected")
        kw8 = dict(n_bins=B, hist_dtype="int8")
        same8 = HK.histogram_radix_single(bins, gi, hi, lor, **kw8)
        bitwise(same8, HK.histogram_radix_single_plain(bins, gi, hi, lor,
                                                       **kw8),
                f"histogram_radix_single int8 (n = {n}, {tag})")
        if frac == 0.0:
            continue
        sel = lor >= 0
        n_sel = int(sel.sum().item())
        sc = HK.pass_scale(g, hr)
        kw = dict(n_bins=B, hist_dtype="float32")
        cell = torch.where(sel[None, :], torch.arange(F, device=dev)[:, None]
                           * B + bins.long(), F * B).reshape(-1)
        vals = torch.stack([g, hr, torch.ones_like(hr)], 1).repeat(F, 1)
        acc = torch.zeros(F * B + 1, 3, device=dev)
        b_ms, b_by = bound_ms(4 * n + n_sel * (F + 8) + 8 + 16 * F * B,
                              3 * F * n_sel)
        def given():
            return HK.histogram_radix_single(bins, g, hr, lor, scale=sc,
                                             **kw)

        def found():
            return HK.histogram_radix_single(bins, g, hr, lor, **kw)

        def lib():
            return acc.index_add_(0, cell, vals)

        r = dict(n=n, selected=n_sel, mode="float32",
                 ms_scale_given=time_ms(torch, given, flush),
                 ms_scale_found=time_ms(torch, found, flush),
                 ms_int8=time_ms(torch, lambda: HK.histogram_radix_single(
                     bins, gi, hi, lor, **kw8), flush),
                 bound_ms=b_ms, bound_by=b_by,
                 index_add_ms=time_ms(torch, lib, flush),
                 device_ms_scale_given=device_per_call(torch, given)[1],
                 index_add_device_ms=device_per_call(torch, lib)[1])
        out["radix_single"].append(r)
        print("path shape: " + json.dumps(r), flush=True)
        if frac == 0.5:
            lpc = out["launches_per_call"]
            lpc["histogram_radix_single (n = 90,000, f32, scale given)"] = \
                launches_per_call(torch, given)
            lpc["histogram_radix_single (n = 90,000, f32, scale found)"] = \
                launches_per_call(torch, found)
            lpc["pass_scale (n = 90,000)"] = launches_per_call(
                torch, lambda: HK.pass_scale(g, hr))
        del cell, vals, acc
    # edges: a ragged n (the scalar row loop), F = 30, B = 64 with bins past
    # 63 dropped, NaN and inf on excluded rows
    ne = 100_003
    bins_e = t(rng.integers(0, 70, size=(30, ne), dtype=np.uint8))
    lor_e = t(np.where(rng.random(ne) < 0.3, 0, -1).astype(np.int32))
    g_e = t(rng.normal(size=ne).astype(np.float32))
    g_e = torch.where(lor_e >= 0, g_e, torch.full_like(g_e, float("inf")))
    h_e = t(rng.random(ne).astype(np.float32))
    radix_fixed(bins_e, g_e, h_e, lor_e, N64, f"n = {ne}, F = 30, B = 64")

    # -- rows_t at the bucket sizes of 90k rows: C = 4 (grad, hess, valid,
    # 0), a quarter of the rows masked
    big = 2 * S_ROWS
    bins_w = t(rng.integers(0, B - 1, size=(F, big), dtype=np.uint8))
    g_w = t(rng.normal(size=big).astype(np.float32))
    h_w = t(rng.random(big).astype(np.float32))
    gi_w = t(rng.integers(-2, 3, size=big).astype(np.float32))
    hi_w = t(rng.integers(0, 5, size=big).astype(np.float32))
    valid = t((rng.random(big) >= 0.25).astype(np.float32))

    def vals_of(gg, hh, S):
        v = valid[:S]
        return torch.stack([gg[:S] * v, hh[:S] * v, v,
                            torch.zeros_like(v)]).contiguous()

    def rows_fixed(bs, vr, vi, nb, what):
        for mode in ("float32", "bfloat16"):
            kw = dict(n_bins=nb, hist_dtype=mode)
            bitwise(HK.histogram_rows_t(bs, vr, **kw),
                    HK.histogram_rows_t_fixed(bs, vr, **kw),
                    f"histogram_rows_t {mode} ({what})")
        for mode in ("int8", "float32", "bfloat16"):
            kw = dict(n_bins=nb, hist_dtype=mode)
            bitwise(HK.histogram_rows_t(bs, vi, **kw),
                    HK.histogram_rows_t_plain(bs, vi, **kw),
                    f"histogram_rows_t {mode}, integer values ({what})")

    for S in (5_632, 11_264, 22_528, S_ROWS, big):
        bs = bins_w[:, :S].contiguous()
        vr, vi = vals_of(g_w, h_w, S), vals_of(gi_w, hi_w, S)
        rows_fixed(bs, vr, vi, B, f"S = {S}")
        if S not in (5_632, 11_264, S_ROWS):
            continue
        cell = (torch.arange(F, device=dev)[:, None] * B
                + bs.long()).reshape(-1)
        acc = torch.zeros(F * B, 4, device=dev)
        b_ms, b_by = bound_ms(F * S + 16 * S + 16 * F * B, 4 * F * S)
        r = dict(S=S, C=4)
        for mode, v in (("float32", vr), ("int8", vi)):
            kw = dict(n_bins=B, hist_dtype=mode)
            r[f"ms_{mode}"] = time_ms(
                torch, lambda: HK.histogram_rows_t(bs, v, **kw), flush)
            r[f"device_ms_{mode}"] = device_per_call(
                torch, lambda: HK.histogram_rows_t(bs, v, **kw))[1]
        vrep = vr.t().repeat(F, 1)

        def lib():
            return acc.index_add_(0, cell, vrep)

        r.update(bound_ms=b_ms, bound_by=b_by,
                 index_add_ms=time_ms(torch, lib, flush),
                 index_add_device_ms=device_per_call(torch, lib)[1])
        out["rows_t"].append(r)
        print("path shape: " + json.dumps(r), flush=True)
        if S == 5_632:
            out["launches_per_call"]["histogram_rows_t (S = 5,632, f32)"] = \
                launches_per_call(torch, lambda: HK.histogram_rows_t(
                    bs, vr, n_bins=B, hist_dtype="float32"))
        del cell, acc, vrep
    # edges: C = 8, a ragged S, F = 30, B = 64 with bins past 63; an empty
    # bucket (all values zero); a single row
    se = 45_001
    be = t(rng.integers(0, 70, size=(30, se), dtype=np.uint8))
    rows_fixed(be, t(rng.normal(size=(8, se)).astype(np.float32)),
               t(rng.integers(-4, 5, size=(8, se)).astype(np.float32)), N64,
               "C = 8, S = 45,001, F = 30, B = 64")
    z = torch.zeros(4, 5_632, device=dev)
    rows_fixed(bins_w[:, :5_632].contiguous(), z, z, B, "all values zero")
    one = vals_of(g_w, h_w, 1)
    rows_fixed(bins_w[:, :1].contiguous(), one, one.round(), B, "S = 1")
    print("path shapes: both kernels equal the fixed-point reference bit "
          "for bit (f32, bf16 on real values; int8/f32/bf16 on integer "
          "values) at every shape and edge; launches per call "
          + json.dumps(out["launches_per_call"]), flush=True)
    want_one = [(k, v) for k, v in out["launches_per_call"].items()
                if "pass_scale" not in k and v != 1]
    if want_one:
        fail(f"more than one launch per call: {want_one}")
    return out


def check_masked_shapes(torch, dev):
    """Phase 2c: the masked K-leaf pass of the batched grower at n = 1M
    (``histogram_leaves_radix2`` at K = 16, the warm-up ladder's width, and
    K = 42, every full pass of the default recipe; ``histogram_leaves`` at
    K = 42, the onehot recipe's, and at the pooled rounds' 84 slots): held
    bit for bit against ``histogram_leaves_fixed`` (float32 and bfloat16 on
    real values), then timed in int8 (the path's dtype) and float32 (one
    call after an L2 flush, and the profiler's device time) beside its byte
    bound, with its launches per call."""
    from lightgbm_tpu_torch.ops import hist_kernels as HK
    rng = np.random.default_rng(11)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def t(a):
        return torch.as_tensor(a, device=dev)

    bins = t(rng.integers(0, B - 1, size=(F, N), dtype=np.uint8))
    gi = t(rng.integers(-2, 3, size=N).astype(np.float32))
    hi = t(rng.integers(0, 5, size=N).astype(np.float32))
    gr = t(rng.normal(size=N).astype(np.float32))
    hr = t(rng.random(N).astype(np.float32))
    out = []
    for name, fn, k, ids in (
            ("histogram_leaves_radix2", HK.histogram_leaves_radix2, 16, 64),
            ("histogram_leaves_radix2", HK.histogram_leaves_radix2, K, 64),
            ("histogram_leaves", HK.histogram_leaves, K, 64),
            ("histogram_leaves", HK.histogram_leaves, 2 * K, 128)):
        lor = t(rng.integers(0, ids, size=N, dtype=np.int32))
        lv = rng.permutation(ids)[:k].astype(np.int32)
        lv[-2:] = lv[0]                           # repeated dummy slots
        leaves = t(lv)
        for mode in ("float32", "bfloat16"):
            kw = dict(n_bins=B, hist_dtype=mode)
            got = fn(bins, gr, hr, lor, leaves, **kw)
            want = HK.histogram_leaves_fixed(bins, gr, hr, lor, leaves, **kw)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                d = (got.double() - want.double()).abs().max().item()
                fail(f"{name} {mode} (K = {k}): kernel differs from the "
                     f"fixed-point reference (max abs diff {d})")
        n_sel = int(torch.isin(lor, leaves).sum().item())
        b_ms, b_by = bound_ms(F * N + 12 * N + 4 * k + 16 * k * F * B,
                              3 * F * n_sel)
        r = dict(kernel=name, n=N, K=k, selected=n_sel)
        for mode, g, h in (("int8", gi, hi), ("float32", gr, hr)):
            def call(g=g, h=h, mode=mode):
                return fn(bins, g, h, lor, leaves, n_bins=B, hist_dtype=mode)

            r[f"ms_{mode}"] = time_ms(torch, call, flush)
            r[f"launches_{mode}"], r[f"device_ms_{mode}"] = \
                device_per_call(torch, call)
            if r[f"launches_{mode}"] != 1:
                r[f"window_{mode}"] = dict(last_window)   # 10 calls
        r.update(bound_ms=b_ms, bound_by=b_by)
        out.append(r)
        print("path shape: " + json.dumps(r), flush=True)
        del lor, leaves
    print("path shapes (masked pass): both wrappers equal "
          "histogram_leaves_fixed bit for bit (f32, bf16 on real values) at "
          "K = 16, 42, 84", flush=True)
    many = [(r["kernel"], r["K"], r["launches_int8"], r["launches_float32"])
            for r in out
            if r["launches_int8"] != 1 or r["launches_float32"] != 1]
    if many:
        fail(f"masked pass: more than one launch per call: {many}")
    return out


def packed_inputs(torch, dev, rng, n=N):
    """The max_bin=63 masked pass's operands at n rows, F = 28: bins
    [F, n] (B = 64), their packed mirror words_t [W, n], integer and real
    grad/hess, a leaf map over 64 leaf ids and the root's (5% of rows
    excluded)."""
    def t(a):
        return torch.as_tensor(a, device=dev)
    from lightgbm_tpu_torch.ops.histogram import bins_to_words
    bins = t(rng.integers(0, N64 - 1, size=(F, n), dtype=np.uint8))
    return dict(
        bins=bins, words_t=bins_to_words(bins.t()).t().contiguous(),
        gi=t(rng.integers(-2, 3, size=n).astype(np.float32)),
        hi=t(rng.integers(0, 5, size=n).astype(np.float32)),
        gr=t(rng.normal(size=n).astype(np.float32)),
        hr=t(rng.random(n).astype(np.float32)),
        lor=t(rng.integers(0, 64, size=n, dtype=np.int32)),
        lor_root=t(np.where(rng.random(n) < 0.05, -1, 0).astype(np.int32)))


def packed_leaves(torch, dev, rng, k):
    """K slot leaf ids: the root's [0], else K of the 64 ids with the last
    two repeating the first (dummy slots)."""
    if k == 1:
        return torch.zeros(1, dtype=torch.int32, device=dev)
    lv = rng.permutation(64)[:k].astype(np.int32)
    lv[-2:] = lv[0]
    return torch.as_tensor(lv, device=dev)


def partition_inputs(torch, dev, rng, n=N):
    """The fused partition's operands at the default round's shape: n rows,
    F = 28 (W = 7 words), a tenth of the rows masked out, K = 42 slots over
    64 leaf ids (the last 3 invalid)."""
    from lightgbm_tpu_torch.ops.histogram import bins_to_words

    def t(a):
        return torch.as_tensor(a, device=dev)
    bins = t(rng.integers(0, B - 1, size=(F, n), dtype=np.uint8))
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
    return dict(bins=bins, words=bins_to_words(bins.t()),
                g=t(rng.normal(size=n).astype(np.float32)),
                h=t(rng.random(n).astype(np.float32)),
                lor=t(rng.integers(0, 64, size=n, dtype=np.int32)),
                mask=t((rng.random(n) >= 0.1).astype(np.int32)),
                desc=[t(desc[nm]) for nm in PART_DESC])


def check_packed_partition_shapes(torch, dev):
    """Phase 2d: the two kernels this slice redesigned, at the shapes the
    main path gives them, n = 1M: ``histogram_leaves_packed`` (every masked
    pass of max_bin=63: the root K = 1, the ladder's 16, the full K = 42;
    F = 28, B = 64, W = 7) held bit for bit against its plain version (int8
    and integer values) and against ``histogram_leaves_fixed`` on the
    unpacked bins (float32 and bfloat16 on real values), timed in int8 and
    float32; ``partition_payload`` (K = 42, every default round) and
    ``partition_select`` (K = 42 and 1, the pooled rounds) bit for bit on
    every output; each with its one-call ms, device ms, launches per call
    (exactly 1) and byte bound."""
    from lightgbm_tpu_torch.ops import hist_kernels as HK
    from lightgbm_tpu_torch.ops import round_fuse as RF
    rng = np.random.default_rng(13)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    x = packed_inputs(torch, dev, rng)
    out = []
    for k in (1, 16, K):
        lv = packed_leaves(torch, dev, rng, k)
        lor = x["lor_root"] if k == 1 else x["lor"]
        for mode in ("int8", "float32", "bfloat16"):
            kw = dict(num_f=F, n_bins=N64, hist_dtype=mode)
            got = HK.histogram_leaves_packed(x["words_t"], x["gi"], x["hi"],
                                             lor, lv, **kw)
            if not torch.equal(got, HK.histogram_leaves_packed_plain(
                    x["words_t"], x["gi"], x["hi"], lor, lv, **kw)):
                fail(f"histogram_leaves_packed {mode} (K = {k}, integer "
                     f"values): kernel differs from its plain version")
            if mode == "int8":
                continue
            got = HK.histogram_leaves_packed(x["words_t"], x["gr"], x["hr"],
                                             lor, lv, **kw)
            want = HK.histogram_leaves_fixed(x["bins"], x["gr"], x["hr"],
                                             lor, lv, n_bins=N64,
                                             hist_dtype=mode)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                d = (got.double() - want.double()).abs().max().item()
                fail(f"histogram_leaves_packed {mode} (K = {k}): kernel "
                     f"differs from the fixed-point reference on the "
                     f"unpacked bins (max abs diff {d})")
        n_sel = int(torch.isin(lor, lv).sum().item())
        # bytes: words, grad, hess, leaf ids and the K ids read once, the
        # f32 [K, F, 64, 4] output written once
        b_ms, b_by = bound_ms(4 * W * N + 12 * N + 4 * k + 16 * k * F * N64,
                              3 * F * n_sel)
        r = dict(kernel="histogram_leaves_packed", n=N, F=F, B=N64, K=k,
                 selected=n_sel)
        for mode, g, h in (("int8", x["gi"], x["hi"]),
                           ("float32", x["gr"], x["hr"])):
            def call(g=g, h=h, mode=mode, lor=lor, lv=lv):
                return HK.histogram_leaves_packed(
                    x["words_t"], g, h, lor, lv, num_f=F, n_bins=N64,
                    hist_dtype=mode)

            r[f"ms_{mode}"] = time_ms(torch, call, flush)
            r[f"launches_{mode}"], r[f"device_ms_{mode}"] = \
                device_per_call(torch, call)
            if r[f"launches_{mode}"] != 1:
                r[f"window_{mode}"] = dict(last_window)
        r.update(bound_ms=b_ms, bound_by=b_by)
        out.append(r)
        print("path shape: " + json.dumps(r), flush=True)
    del x
    p = partition_inputs(torch, dev, rng)
    rows_in = (p["bins"], p["words"], p["g"], p["h"], p["lor"], p["mask"])
    for k in (K, 1):
        dsc = [d[:k].contiguous() for d in p["desc"]]
        calls = [("partition_select", RF.partition_select,
                  RF.partition_select_plain,
                  (p["bins"], p["lor"], p["mask"], *dsc))]
        if k == K:
            calls.insert(0, ("partition_payload", RF.partition_payload,
                             RF.partition_payload_plain, (*rows_in, *dsc)))
        valid_par = dsc[4][dsc[6] > 0]
        moving = int(torch.isin(p["lor"], valid_par).sum().item())
        for name, fn, plain, args in calls:
            for a, b_, what in zip(fn(*args), plain(*args),
                                   ("new leaf map", "sort key", "payload")):
                if not torch.equal(a, b_):
                    fail(f"{name} {what} (K = {k}): kernel differs from its "
                         f"plain version")
            if name == "partition_payload":     # words, grad, hess, lor,
                nbytes = N * (4 * W + 16) + N * (8 + 4 * (W + 3))  # mask
            else:                                # lor, mask, moving bins
                nbytes = 8 * N + moving + 8 * N
            b_ms, b_by = bound_ms(nbytes + 32 * k, 2 * k * N)
            r = dict(kernel=name, n=N, W=W, K=k, moving=moving)

            def call(fn=fn, args=args):
                return fn(*args)

            r["ms"] = time_ms(torch, call, flush)
            r["launches"], r["device_ms"] = device_per_call(torch, call)
            if r["launches"] != 1:
                r["window"] = dict(last_window)
            r.update(bound_ms=b_ms, bound_by=b_by)
            out.append(r)
            print("path shape: " + json.dumps(r), flush=True)
    print("path shapes (packed pass, partition): histogram_leaves_packed "
          "equals its plain version (int8, integer values) and "
          "histogram_leaves_fixed on the unpacked bins bit for bit (f32, "
          "bf16 on real values) at K = 1, 16, 42; both partition kernels "
          "equal their plain versions on every output", flush=True)
    many = [(r["kernel"], r["K"]) for r in out
            if any(r[key] != 1 for key in r if key.startswith("launches"))]
    if many:
        fail(f"packed pass / partition: more than one launch per call: "
             f"{many}")
    return out


#: features that take 3 values in the skewed bins (3 of 28, as HIGGS's
#: b-tag columns do after binning)
SKEWED_FEATURES = (4, 12, 20)


def skewed_bins(torch, bins, rng):
    """A copy of bins u8 [F, n] in which SKEWED_FEATURES take only bins 0, 1
    and 2 (half, 30% and 20% of rows): a warp's lanes then share a few
    cells, the case that serializes shared-memory adds."""
    out = bins.clone()
    for f in SKEWED_FEATURES:
        out[f] = torch.as_tensor(rng.choice(3, size=bins.shape[1],
                                            p=[0.5, 0.3, 0.2]).astype(
            np.uint8), device=bins.device)
    return out


def check_radix_shapes(torch, dev):
    """Phase 2e: ``histogram_radix_joint`` and ``histogram_radix_single``'s
    root pass above 131,072 rows, both masked.cuh's cluster kernel, held
    bit for bit against their plain versions (int8, and float32/bfloat16 on
    integer values) and the fixed-point references (float32/bfloat16 on
    real values, radix_single also with the scale given) at n = 1M on
    uniform bins and on bins where 3 of the 28 features take 3 values (the
    root pass with 5% of rows excluded; joint G = 1, 4 and a repeated
    layout), and at n = 200,000 with strict-style leaf ids (1/32 of rows
    selected, leaf 37; joint over 128 ids); then timed on both bin sets in
    int8 and on the uniform bins in float32 (one-call ms, the profiler's
    device ms and launches per call, exactly one) beside the byte bound
    (the leaf ids, then the selected rows' bins, grad and hess) and one
    index_add_ of the same cells."""
    from lightgbm_tpu_torch.ops import hist_kernels as HK
    rng = np.random.default_rng(17)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def t(a):
        return torch.as_tensor(a, device=dev)
    bins = t(rng.integers(0, B - 1, size=(F, N), dtype=np.uint8))
    sets = {"uniform": bins, "skewed": skewed_bins(torch, bins, rng)}
    gi = t(rng.integers(-2, 3, size=N).astype(np.float32))
    hi = t(rng.integers(0, 5, size=N).astype(np.float32))
    gr = t(rng.normal(size=N).astype(np.float32))
    hr = t(rng.random(N).astype(np.float32))
    lor = t(rng.integers(0, 64, size=N, dtype=np.int32))
    lv = rng.permutation(64)[:4].astype(np.int32)
    joints = {"G = 1": t(lv[:1]), "G = 4": t(lv),
              "G = 4 repeated": t(lv[[0, 1, 0, 0]])}
    lor_root = t(np.where(rng.random(N) < 0.05, -1, 0).astype(np.int32))

    def bitwise(a, b, what):
        if a.shape != b.shape or not torch.equal(a.view(torch.int32),
                                                 b.view(torch.int32)):
            d = ((a.double() - b.double()).abs().max().item()
                 if a.shape == b.shape else float("nan"))
            fail(f"{what}: kernel differs (max abs diff {d})")

    def hold(kernel, plain, fixed, args, what, scale=False):
        """args(g, h) -> the call's operands"""
        for mode in ("int8", "float32", "bfloat16"):
            kw = dict(n_bins=B, hist_dtype=mode)
            bitwise(kernel(*args(gi, hi), **kw), plain(*args(gi, hi), **kw),
                    f"{what} {mode}, integer values, vs plain")
            if mode == "int8":
                continue
            ref = fixed(*args(gr, hr), **kw)
            bitwise(kernel(*args(gr, hr), **kw), ref,
                    f"{what} {mode} vs fixed-point")
            if scale:
                sc = HK.pass_scale(*args(gr, hr)[1:3])
                bitwise(kernel(*args(gr, hr), scale=sc, **kw), ref,
                        f"{what} {mode}, scale given, vs fixed-point")

    for bk, bb in sets.items():
        hold(HK.histogram_radix_single, HK.histogram_radix_single_plain,
             HK.histogram_radix_single_fixed,
             lambda g, h, bb=bb: (bb, g, h, lor_root),
             f"histogram_radix_single (n = 1M, {bk})", scale=True)
        for jn, lvt in joints.items():
            hold(HK.histogram_radix_joint, HK.histogram_radix_joint_plain,
                 HK.histogram_leaves_fixed,
                 lambda g, h, bb=bb, lvt=lvt: (bb, g, h, lor, lvt),
                 f"histogram_radix_joint ({jn}, n = 1M, {bk})")
    # strict-style leaf ids at 200,000 rows (the cluster kernel too: above
    # 131,072 rows), NaN grad on the excluded rows
    n2 = 200_000
    sel2 = rng.random(n2) < 1 / 32
    lor2 = t(np.where(sel2, 37, -1).astype(np.int32))
    lor3 = t(rng.integers(0, 128, size=n2, dtype=np.int32))
    b2 = bins[:, :n2].contiguous()
    nan = float("nan")

    def args2(g, h):
        return (b2, torch.where(lor2 >= 0, g[:n2], nan), h[:n2].contiguous(),
                lor2)

    hold(HK.histogram_radix_single, HK.histogram_radix_single_plain,
         HK.histogram_radix_single_fixed, args2,
         f"histogram_radix_single (n = {n2}, 1/32 selected, leaf 37)",
         scale=True)
    hold(HK.histogram_radix_joint, HK.histogram_radix_joint_plain,
         HK.histogram_leaves_fixed,
         lambda g, h: (b2, g[:n2].contiguous(), h[:n2].contiguous(), lor3,
                       joints["G = 4"]),
         f"histogram_radix_joint (G = 4, n = {n2}, 1/32 selected)")
    print("path shapes (radix): histogram_radix_single (1M root, 200,000 "
          "strict ids) and histogram_radix_joint (G = 1, 4, repeated) equal "
          "their plain versions and the fixed-point references bit for bit "
          "on uniform and skewed bins", flush=True)

    out = []
    vals = torch.stack([gi, hi, torch.ones_like(gi)], 1).repeat(F, 1)
    fi = torch.arange(F, device=dev)[:, None]
    for name, make, sel, slot, nslot in (
            ("histogram_radix_single (1M root)",
             lambda bb, g, h, mode: lambda: HK.histogram_radix_single(
                 bb, g, h, lor_root, n_bins=B, hist_dtype=mode),
             lor_root >= 0, torch.zeros_like(lor_root), 1),
            ("histogram_radix_joint (G = 4)",
             lambda bb, g, h, mode: lambda: HK.histogram_radix_joint(
                 bb, g, h, lor, joints["G = 4"], n_bins=B, hist_dtype=mode),
             torch.isin(lor, joints["G = 4"]),
             (lor[None, :] == joints["G = 4"][:, None]).to(
                 torch.uint8).argmax(0), 4),
            ("histogram_radix_joint (G = 1)",
             lambda bb, g, h, mode: lambda: HK.histogram_radix_joint(
                 bb, g, h, lor, joints["G = 1"], n_bins=B, hist_dtype=mode),
             lor == joints["G = 1"][0], torch.zeros_like(lor), 1)):
        n_sel = int(sel.sum().item())
        b_ms, b_by = bound_ms(4 * N + n_sel * (F + 8) + 4 * nslot
                              + 16 * nslot * F * B, 3 * F * n_sel)
        for bk, bb in sets.items():
            r = dict(kernel=name, bins=bk, selected=n_sel, bound_ms=b_ms,
                     bound_by=b_by)
            for mode, g, h in (("int8", gi, hi), ("float32", gr, hr)):
                if mode == "float32" and bk == "skewed":
                    continue
                call = make(bb, g, h, mode)
                r[f"ms_{mode}"] = time_ms(torch, call, flush)
                r[f"launches_{mode}"], r[f"device_ms_{mode}"] = \
                    device_per_call(torch, call)
            # library: ONE index_add_ of every (row, feature) value triple
            # into its (slot, feature, bin) cell, the cell index precomputed
            cell = torch.where(sel[None, :], (slot[None, :].long() * F + fi)
                               * B + bb.long(), nslot * F * B).reshape(-1)
            acc = torch.zeros(nslot * F * B + 1, 3, device=dev)

            def lib():
                return acc.index_add_(0, cell, vals)

            r.update(library_ms=time_ms(torch, lib, flush),
                     library_device_ms=device_per_call(torch, lib)[1])
            out.append(r)
            print("path shape: " + json.dumps(r), flush=True)
            del cell, acc
    many = [(r["kernel"], r["bins"], r.get("launches_int8"),
             r.get("launches_float32")) for r in out
            if r["launches_int8"] != 1
            or r.get("launches_float32", 1) != 1]
    if many:
        fail(f"radix passes: more than one launch per call: {many}")
    return out


def check_leaves_rows(torch, dev):
    """Phase 2e, continued: ``histogram_leaves_rows`` (the masked pass from
    row-major bins u8 [S, F]; no training path calls it) at S = 251,904,
    F = 28, K = 42 (repeated slots; one 32-bit load gives a row's four
    bins of a block's features) and at a ragged S = 100,003 with F = 30
    (a byte a bin): int8 and float32/bfloat16 on integer values against
    its plain version, float32/bfloat16 on real values against
    ``histogram_leaves_fixed`` on the transposed bins, bit for bit; timed
    at S = 251,904 in int8 and float32 with its launches per call (exactly
    one) beside its byte bound and one index_add_ of the same cells."""
    from lightgbm_tpu_torch.ops import hist_kernels as HK
    rng = np.random.default_rng(19)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def t(a):
        return torch.as_tensor(a, device=dev)

    lv = rng.permutation(64)[:K].astype(np.int32)
    lv[-2:] = lv[0]
    leaves = t(lv)
    r = None
    for S, nf in ((BUCKETS[0], F), (100_003, 30)):
        br = t(rng.integers(0, B - 1, size=(S, nf), dtype=np.uint8))
        lor = t(rng.integers(0, 64, size=S, dtype=np.int32))
        gi = t(rng.integers(-2, 3, size=S).astype(np.float32))
        hi = t(rng.integers(0, 5, size=S).astype(np.float32))
        gr = t(rng.normal(size=S).astype(np.float32))
        hr = t(rng.random(S).astype(np.float32))
        for mode in ("int8", "float32", "bfloat16"):
            kw = dict(n_bins=B, hist_dtype=mode)
            checks = [(HK.histogram_leaves_rows(br, gi, hi, lor, leaves, **kw),
                       HK.histogram_leaves_rows_plain(br, gi, hi, lor, leaves,
                                                      **kw), "plain")]
            if mode != "int8":
                checks.append((
                    HK.histogram_leaves_rows(br, gr, hr, lor, leaves, **kw),
                    HK.histogram_leaves_fixed(br.t().contiguous(), gr, hr,
                                              lor, leaves, **kw),
                    "the fixed-point reference"))
            for a, b_, what in checks:
                if not torch.equal(a.view(torch.int32), b_.view(torch.int32)):
                    d = (a.double() - b_.double()).abs().max().item()
                    fail(f"histogram_leaves_rows {mode} (S = {S}, F = {nf}) "
                         f"differs from {what} (max abs diff {d})")
        if r is not None:
            continue
        sel = torch.isin(lor, leaves)
        n_sel = int(sel.sum().item())
        b_ms, b_by = bound_ms(4 * S + n_sel * (F + 8) + 4 * K
                              + 16 * K * F * B, 3 * F * n_sel)
        r = dict(kernel="histogram_leaves_rows", S=S, K=K, selected=n_sel,
                 bound_ms=b_ms, bound_by=b_by)
        for mode, g, h in (("int8", gi, hi), ("float32", gr, hr)):
            def call(g=g, h=h, mode=mode):
                return HK.histogram_leaves_rows(br, g, h, lor, leaves,
                                                n_bins=B, hist_dtype=mode)

            r[f"ms_{mode}"] = time_ms(torch, call, flush)
            r[f"launches_{mode}"], r[f"device_ms_{mode}"] = \
                device_per_call(torch, call)
        slot = (lor[None, :] == leaves[:, None]).to(torch.uint8).argmax(0)
        cell = torch.where(sel[None, :], (slot[None, :].long() * F
                                          + torch.arange(F, device=dev)[
                                              :, None]) * B + br.t().long(),
                           K * F * B).reshape(-1)
        vals = torch.stack([gi, hi, torch.ones_like(gi)], 1).repeat(F, 1)
        acc = torch.zeros(K * F * B + 1, 3, device=dev)

        def lib():
            return acc.index_add_(0, cell, vals)

        r.update(library_ms=time_ms(torch, lib, flush),
                 library_device_ms=device_per_call(torch, lib)[1])
        print("path shape: " + json.dumps(r), flush=True)
        del cell, vals, acc
    print("path shapes (rows-major): histogram_leaves_rows equals its plain "
          "version and the fixed-point reference bit for bit at S = "
          f"{BUCKETS[0]} (F = 28) and S = 100,003 (F = 30)", flush=True)
    if r["launches_int8"] != 1 or r["launches_float32"] != 1:
        fail(f"histogram_leaves_rows: not one launch per call: {r}")
    return r


def payload_bucket(torch, dev, rng, S, real, lor_ids=64):
    """A compacted payload i32 [S, W+3] as the default recipe gathers it:
    F = 28 bins in W = 7 words, grad and hess bits (integer levels, or real
    values), leaf ids in [0, lor_ids)."""
    bins = rng.integers(0, B - 1, size=(S, 4 * W), dtype=np.uint8)
    bins[:, F:] = 0
    if real:
        g = rng.normal(size=S).astype(np.float32)
        h = rng.random(S).astype(np.float32)
    else:
        g = rng.integers(-2, 3, size=S).astype(np.float32)
        h = rng.integers(0, 5, size=S).astype(np.float32)
    lor = rng.integers(0, lor_ids, size=S, dtype=np.int32)
    return torch.as_tensor(np.ascontiguousarray(np.concatenate(
        [bins.view(np.int32), g.view(np.int32)[:, None],
         h.view(np.int32)[:, None], lor[:, None]], 1)), device=dev)


def payload_bytes(S, c, mode, k=K, f=F, w=W):
    """The bytes the payload pass must move: the rows below cnt (4(w+3)
    bytes each), grad and hess of the rows past it in float32/bfloat16 (the
    scale is over all S rows), the k ids, cnt and the f32 [k, f, B, 4]
    output."""
    past = 8 * (S - c) if mode != "int8" else 0
    return c * 4 * (w + 3) + past + 4 * k + 4 + 16 * k * f * B


#: the four compaction buckets of 1M rows (ops/histogram.py): n/4, n/8,
#: n/16 and n/64, each rounded up to 2048
BUCKETS = tuple((N // d + 2047) // 2048 * 2048 for d in (4, 8, 16, 64))


def alternating(torch, calls, flush, rounds=4):
    """Device ms (profiler, warm L2) and one-call ms (events, L2 flushed)
    of each named call, the calls taken in turn, forwards then backwards,
    ``rounds`` times: medians, launches per call and the lists."""
    res = {k: dict(device_ms=[], ms=[]) for k in calls}
    order = list(calls)
    for i in range(rounds):
        for k in (order if i % 2 == 0 else order[::-1]):
            nl, dms = device_per_call(torch, calls[k])
            res[k]["launches"] = nl
            res[k]["device_ms"].append(dms)
            res[k]["ms"].append(time_ms(torch, calls[k], flush, reps=20))
            if nl != 1:
                res[k]["window"] = dict(last_window)
    for r in res.values():
        r["device_ms_median"] = float(np.median(r["device_ms"]))
        r["ms_median"] = float(np.median(r["ms"]))
    return res


def check_take_payload_shapes(torch, dev):
    """Phase 2f: the two kernels this slice redesigned, at the shapes the
    main path gives them.  ``take_small_table`` (the score update) at
    n = 1M, T = 255 against ``index_select`` on the same operands, the two
    taken in turn in this process (device ms from the profiler, one-call ms
    from events), plus its edges bit for bit (n = 1M + 3, n = 1 and 3,
    T = 1, T = 3000, indices -1 and T, a view that is not 16-byte aligned).
    ``histogram_payload`` (the default recipe's compacted pass) at the four
    buckets of 1M rows with cnt = 0.8 S and K = 42 in int8 and float32,
    held bit for bit against ``histogram_payload_fixed`` (float32 and
    bfloat16 on real values) and its plain version (int8, integer values),
    plus its edges (cnt 0 and S, leaf ids >= 2048, bins >= n_bins, NaN and
    inf past cnt, a payload that is not 16-byte aligned).  Each shape: one-
    call ms, device ms, launches per call (exactly 1), byte bound, and one
    library call's one-call and device ms (``index_select``; one
    ``index_add_`` of the same cells)."""
    from lightgbm_tpu_torch.ops import hist_kernels as HK
    from lightgbm_tpu_torch.ops import table as TB
    rng = np.random.default_rng(19)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    out = []

    def t(a):
        return torch.as_tensor(a, device=dev)

    def bitwise(a, b, what):
        if a.shape != b.shape or not torch.equal(a.view(torch.int32),
                                                 b.view(torch.int32)):
            d = ((a.double() - b.double()).abs().max().item()
                 if a.shape == b.shape else float("nan"))
            fail(f"{what}: kernel differs from its reference (max abs diff "
                 f"{d})")

    # -- take: edges, then the main path's shape against index_select
    for n, tt, lo, hi in ((N + 3, T, -1, T + 1), (1, T, -1, T + 1),
                          (3, T, -1, T + 1), (4099, 1, -1, 2),
                          (N + 3, 3000, -1, 3001), (5000, 3000, -5, 4000)):
        table = t(rng.normal(size=tt).astype(np.float32))
        idx = t(rng.integers(lo, hi, size=n, dtype=np.int32))
        idx[::7] = -1
        idx[1::7] = tt
        for v, tag in ((idx, ""), (idx[1:], ", not 16-byte aligned")):
            bitwise(TB.take_small_table(table, v),
                    TB.take_small_table_plain(table, v),
                    f"take_small_table (n = {v.shape[0]}, T = {tt}{tag})")
    table = t(rng.normal(size=T).astype(np.float32))
    idx = t(rng.integers(0, T, size=N, dtype=np.int32))
    bitwise(TB.take_small_table(table, idx),
            TB.take_small_table_plain(table, idx), "take_small_table")
    b_ms, b_by = bound_ms(8 * N + 4 * T, N)
    res = alternating(torch, {
        "take_small_table": lambda: TB.take_small_table(table, idx),
        "index_select": lambda: table.index_select(0, idx)}, flush,
        rounds=8)
    mine, lib = res["take_small_table"], res["index_select"]
    r = dict(kernel="take_small_table", n=N, T=T, ms=mine["ms_median"],
             device_ms=mine["device_ms_median"], launches=mine["launches"],
             bound_ms=b_ms, bound_by=b_by, library_ms=lib["ms_median"],
             library_device_ms=lib["device_ms_median"],
             alternating=res)
    out.append(r)
    print("path shape: " + json.dumps(r), flush=True)

    # -- payload: the four buckets, int8 and float32
    lv = rng.permutation(64)[:K].astype(np.int32)
    lv[-2:] = lv[0]                               # repeated dummy slots
    leaves = t(lv)
    fi = torch.arange(F, device=dev)
    for S in BUCKETS:
        c = int(0.8 * S)
        cnt = torch.tensor([c], dtype=torch.int32, device=dev)
        pay = {"int8": payload_bucket(torch, dev, rng, S, False),
               "float32": payload_bucket(torch, dev, rng, S, True)}
        for mode in ("float32", "bfloat16"):
            kw = dict(num_f=F, n_bins=B, hist_dtype=mode)
            bitwise(HK.histogram_payload(pay["float32"], leaves, cnt, **kw),
                    HK.histogram_payload_fixed(pay["float32"], leaves, cnt,
                                               **kw),
                    f"histogram_payload {mode} (S = {S}, real values)")
        for mode in ("int8", "float32", "bfloat16"):
            kw = dict(num_f=F, n_bins=B, hist_dtype=mode)
            bitwise(HK.histogram_payload(pay["int8"], leaves, cnt, **kw),
                    HK.histogram_payload_plain(pay["int8"], leaves, cnt,
                                               **kw),
                    f"histogram_payload {mode} (S = {S}, integer values)")
        for mode, p in pay.items():
            lor_p = p[:, W + 2]
            sel = torch.isin(lor_p, leaves) & (torch.arange(
                S, device=dev) < c)
            slot = (lor_p[None, :] == leaves[:, None]).to(
                torch.uint8).argmax(0)
            pbin = (p[:, fi // 4].t() >> (8 * (fi % 4))[:, None]) & 255
            cell = torch.where(sel[None, :], (slot[None, :].long() * F
                                              + fi[:, None]) * B
                               + pbin.long(), K * F * B).reshape(-1)
            gv = p[:, W].view(torch.float32)
            hv = p[:, W + 1].view(torch.float32)
            vals = torch.stack([gv, hv, torch.ones_like(gv)],
                               1).repeat(F, 1)
            acc = torch.zeros(K * F * B + 1, 3, device=dev)
            b_ms, b_by = bound_ms(payload_bytes(S, c, mode),
                                  3 * F * int(sel.sum().item()))

            def call(p=p, mode=mode):
                return HK.histogram_payload(p, leaves, cnt, num_f=F,
                                            n_bins=B, hist_dtype=mode)

            def libcall(acc=acc, cell=cell, vals=vals):
                return acc.index_add_(0, cell, vals)

            r = dict(kernel="histogram_payload", S=S, cnt=c, K=K,
                     mode=mode, ms=time_ms(torch, call, flush, reps=20))
            r["launches"], r["device_ms"] = device_per_call(torch, call)
            if r["launches"] != 1:
                r["window"] = dict(last_window)
            r.update(bound_ms=b_ms, bound_by=b_by,
                     library_ms=time_ms(torch, libcall, flush),
                     library_device_ms=device_per_call(torch, libcall)[1])
            out.append(r)
            print("path shape: " + json.dumps(r), flush=True)
            del cell, vals, acc, pbin, slot, sel
    # few slots (K = 1, 4: the warm-up ladder's compacted rounds) and few
    # features (F = 4, 3 in W = 1 word), whose plans take other cluster
    # sizes (up to 16, non-portable), at every bucket: float32 and
    # bfloat16 bit for bit against the fixed-point reference on real
    # values, int8 against the plain version on integer values
    for S in BUCKETS:
        c = int(0.8 * S)
        cnt = torch.tensor([c], dtype=torch.int32, device=dev)
        pr = payload_bucket(torch, dev, rng, S, True)
        pint = payload_bucket(torch, dev, rng, S, False)
        for tag, nf, lvx in (("K = 1", F, leaves[:1]),
                             ("K = 4", F, leaves[:4]),
                             ("F = 4", 4, leaves), ("F = 3", 3, leaves)):
            cols = list(range(W + 3)) if nf == F else [0, W, W + 1, W + 2]
            for mode in ("float32", "bfloat16", "int8"):
                pp = (pint if mode == "int8" else pr)[:, cols].contiguous()
                kw = dict(num_f=nf, n_bins=B, hist_dtype=mode)
                ref = (HK.histogram_payload_plain if mode == "int8"
                       else HK.histogram_payload_fixed)

                def call(pp=pp, lvx=lvx, kw=kw):
                    return HK.histogram_payload(pp, lvx, cnt, **kw)

                bitwise(call(), ref(pp, lvx, cnt, **kw),
                        f"histogram_payload {mode} ({tag}, S = {S})")
                b_ms, b_by = bound_ms(
                    payload_bytes(S, c, mode, lvx.shape[0], nf,
                                  len(cols) - 3),
                    3 * nf * int(torch.isin(pp[:c, -1], lvx).sum().item()))
                r = dict(kernel="histogram_payload", S=S, cnt=c,
                         K=lvx.shape[0], F=nf, mode=mode,
                         ms=time_ms(torch, call, flush, reps=20))
                r["launches"], r["device_ms"] = device_per_call(torch, call)
                if r["launches"] != 1:
                    r["window"] = dict(last_window)
                r.update(bound_ms=b_ms, bound_by=b_by)
                out.append(r)
                print("path shape: " + json.dumps(r), flush=True)
        del pr, pint
    # edges at the smallest bucket, bit for bit
    S = BUCKETS[-1]
    base = payload_bucket(torch, dev, rng, S + 1, True)
    for tag in ("cnt = 0", "cnt = S", "leaf ids >= 2048", "bins >= n_bins",
                "NaN and inf past cnt", "not 16-byte aligned"):
        p, c, lvx, nb = base[:S].clone(), int(0.8 * S), leaves, B
        if tag == "cnt = 0":
            c = 0
        elif tag == "cnt = S":
            c = S
        elif tag == "leaf ids >= 2048":
            p[:, W + 2] += 2990
            lvx = (leaves + 2990).to(torch.int32)
        elif tag == "bins >= n_bins":
            nb = 200
        elif tag == "NaN and inf past cnt":
            p[c::2, W] = torch.tensor([float("nan")], device=dev).view(
                torch.int32)
            p[c + 1::2, W] = torch.tensor([float("inf")], device=dev).view(
                torch.int32)
            p[c::3, W + 1] = torch.tensor([float("-inf")], device=dev).view(
                torch.int32)
        else:
            p = base[1:]
        cnt = torch.tensor([c], dtype=torch.int32, device=dev)
        for mode in ("float32", "bfloat16"):
            kw = dict(num_f=F, n_bins=nb, hist_dtype=mode)
            bitwise(HK.histogram_payload(p, lvx, cnt, **kw),
                    HK.histogram_payload_fixed(p, lvx, cnt, **kw),
                    f"histogram_payload {mode} ({tag})")
        pi = p.clone()
        pi[:, W] = pi[:, W].view(torch.float32).round().clamp(
            -3, 3).nan_to_num(0, 0, 0).view(torch.int32)
        kw = dict(num_f=F, n_bins=nb, hist_dtype="int8")
        bitwise(HK.histogram_payload(pi, lvx, cnt, **kw),
                HK.histogram_payload_plain(pi, lvx, cnt, **kw),
                f"histogram_payload int8 ({tag})")
    print("path shapes (take, payload): take_small_table equals its plain "
          "version at every shape and edge; histogram_payload equals "
          "histogram_payload_fixed bit for bit (f32, bf16 on real values) "
          "and its plain version (int8/f32/bf16 on integer values) at the "
          "four buckets, K = 1 and 4, F = 3 and 4, and every edge",
          flush=True)
    many = [(r["kernel"], r.get("S"), r.get("mode")) for r in out
            if r["launches"] != 1]
    if many:
        fail(f"take / payload: more than one launch per call: {many}")
    return out


def check_determinism(torch, dev):
    """Every histogram kernel twice in float32 and in bfloat16 on real
    values at the main path's shapes: identical bits, or the run fails.
    Returns each one's float32 time beside its int8 time (ms, integer
    levels), from the same inputs."""
    from lightgbm_tpu_torch.ops import hist_kernels as HK
    from lightgbm_tpu_torch.ops.histogram import bins_to_words
    rng = np.random.default_rng(5)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def t(a):
        return torch.as_tensor(a, device=dev)

    bins_t = t(rng.integers(0, B - 1, size=(F, N), dtype=np.uint8))
    words_t = bins_to_words((bins_t % (N64 - 1)).t()).t().contiguous()
    words = bins_to_words(bins_t.t())
    lor = t(rng.integers(0, 64, size=N, dtype=np.int32))
    leaves = t(rng.permutation(64)[:K].astype(np.int32))
    lv4 = leaves[:4].contiguous()
    lor_root = torch.where(lor < 3, -1, 0).to(torch.int32)
    S = (N // 4 + 2047) // 2048 * 2048
    cnt = torch.tensor([int(0.8 * S)], dtype=torch.int32, device=dev)
    vals = {"real": (t(rng.normal(size=N).astype(np.float32)),
                     t(rng.random(N).astype(np.float32))),
            "int": (t(rng.integers(-2, 3, size=N).astype(np.float32)),
                    t(rng.integers(0, 5, size=N).astype(np.float32)))}
    pay, rows = {}, {}
    for v, (gg, hh) in vals.items():
        pay[v] = torch.cat([words[:S], gg[:S].view(torch.int32)[:, None],
                            hh[:S].view(torch.int32)[:, None],
                            lor[:S, None]], 1).contiguous()
        rows[v] = torch.stack([gg[:S_ROWS], hh[:S_ROWS],
                               torch.ones_like(gg[:S_ROWS]),
                               torch.zeros_like(gg[:S_ROWS])]).contiguous()
    kern = {
        "histogram_leaves": lambda v, m: HK.histogram_leaves(
            bins_t, *vals[v], lor, leaves, n_bins=B, hist_dtype=m),
        "histogram_payload": lambda v, m: HK.histogram_payload(
            pay[v], leaves, cnt, num_f=F, n_bins=B, hist_dtype=m),
        "histogram_radix_single": lambda v, m: HK.histogram_radix_single(
            bins_t, *vals[v], lor_root, n_bins=B, hist_dtype=m),
        "histogram_radix_joint": lambda v, m: HK.histogram_radix_joint(
            bins_t, *vals[v], lor, lv4, n_bins=B, hist_dtype=m),
        "histogram_leaves_radix2": lambda v, m: HK.histogram_leaves_radix2(
            bins_t, *vals[v], lor, leaves, n_bins=B, hist_dtype=m),
        "histogram_leaves_packed": lambda v, m: HK.histogram_leaves_packed(
            words_t, *vals[v], lor, leaves, num_f=F, n_bins=N64,
            hist_dtype=m),
        "histogram_rows_t": lambda v, m: HK.histogram_rows_t(
            bins_t[:, :S_ROWS].contiguous(), rows[v], n_bins=B,
            hist_dtype=m),
    }
    times = {}
    for name, fn in kern.items():
        for mode in ("float32", "bfloat16"):
            a, b_ = fn("real", mode), fn("real", mode)
            if not torch.equal(a.view(torch.int32), b_.view(torch.int32)):
                fail(f"{name} {mode}: two calls on the same inputs gave "
                     f"different bits")
        times[name] = {
            "float32": time_ms(torch, lambda: fn("real", "float32"), flush),
            "int8": time_ms(torch, lambda: fn("int", "int8"), flush)}
    print("determinism: every histogram kernel gave identical bits twice "
          "in float32 and bfloat16 on real values", flush=True)
    print("kernel float32 vs int8 times (ms): " + json.dumps(times),
          flush=True)
    return times


def profiler_work(prof, what):
    """device_work(prof), or None (printed as not measured) when the
    profiler itself fails or saw no device time; the work it profiled
    ran outside this, so its own errors fail the run."""
    try:
        work = device_work(prof)
    except (RuntimeError, AttributeError) as e:
        print(f"{what}: not measured (the profiler: {type(e).__name__}: "
              f"{e})", flush=True)
        return None
    if sum(us for _, _, us in work) <= 0:
        print(f"{what}: device time not measured (the profiler saw none)",
              flush=True)
        return None
    return work


def profile_round(torch, bst):
    """One more boosting round under torch.profiler: the device's busy
    share of the round and the kernels that take the time.  Informational:
    a profiler that fails or sees no device time reports 'not measured'.
    Returns the round's kernel launches (None when not measured)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    work = profiler_work(prof, "profile")
    if work is None:
        return None
    kern = [(us / 1e3, cnt, name) for name, cnt, us in work]
    busy = sum(k[0] for k in kern)
    kern.sort(reverse=True)
    launches = sum(k[1] for k in kern)
    print(f"profile: one round {wall_ms:.1f} ms wall (profiled), device "
          f"busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%), "
          f"{launches} kernel launches", flush=True)
    for ms, cnt, name in kern[:8]:
        print(f"  {ms:8.3f} ms {cnt:5d}x {name[:90]}", flush=True)
    return launches


def auc(y, s):
    """Area under the ROC curve: the Mann-Whitney statistic, a tied
    (positive, negative) pair counted half, as LightGBM's auc metric
    counts it (a model of a few trees predicts many equal scores)."""
    order = np.argsort(s, kind="mergesort")
    s, y = np.asarray(s)[order], y[order]
    pos = y > 0
    # each run of equal scores takes the mean of its 1-based ranks
    start = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    size = np.diff(np.r_[start, len(s)])
    ranks = np.repeat(start + (size + 1) / 2, size)
    return float((ranks[pos].sum() - pos.sum() * (pos.sum() + 1) / 2)
                 / (pos.sum() * (~pos).sum()))


#: the binned HIGGS-shaped sets by (rows, seed, max_bin): the same seed
#: gives the same rows, so the trainings of phases 3-5 and 9 that share
#: them bin once
SLICE_DATA = {}


def slice_data(lgbt, n_train, seed=0, max_bin=255, fresh=False):
    """(Dataset, X, y, Xv, yv, dataset seconds) of ``n_train`` seeded
    HIGGS-shaped rows and their 200,000-row held-out set, binned at
    ``max_bin`` once (the seconds are those of that construction); with
    ``fresh`` binned anew into a Dataset of its own, kept nowhere."""
    key = (n_train, seed, max_bin)
    if fresh or key not in SLICE_DATA:
        rng = np.random.default_rng(seed)
        X, y, w = synth_higgs(n_train, F, rng)
        Xv, yv, _ = synth_higgs(200_000, F, rng, w)
        t0 = time.perf_counter()
        ds = lgbt.Dataset(X, y, params={"max_bin": max_bin,
                                        "verbosity": -1})
        ds.construct()
        got = (ds, X, y, Xv, yv, time.perf_counter() - t0)
        if fresh:
            return got
        SLICE_DATA[key] = got
    return SLICE_DATA[key]


def train_slice(torch, lgbt, n_train, rounds, device_type=None, seed=0,
                valid=False, fresh=False, **extra):
    """Train the recipe (updated by ``extra``) on a seeded synthetic set;
    with ``valid`` the held-out set is also a valid set scored on the
    device each round.  The set is :func:`slice_data`'s (``fresh``: binned
    anew for this training); the dataset seconds returned are those of its
    construction."""
    params = dict(RECIPE, **extra)
    if device_type is not None:
        params["device_type"] = device_type
    stamps = []

    def clock(env):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    ds, _, _, Xv, yv, t_data = slice_data(lgbt, n_train, seed,
                                          params["max_bin"], fresh)
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
    from lightgbm_tpu_torch.ops import rank as RK
    return {"take_small_table": TB.launches,
            "histogram_leaves": HK.leaves_launches,
            "histogram_leaves_rows": HK.leaves_rows_launches,
            "histogram_payload": HK.payload_launches,
            "partition_payload": RF.launches,
            "partition_select": RF.select_launches,
            "partition_payload_table": RF.table_launches,
            "partition_select_table": RF.select_table_launches,
            "histogram_rows_t": HK.rows_launches,
            "histogram_radix_single": HK.radix_single_launches,
            "histogram_radix_joint": HK.radix_joint_launches,
            "histogram_leaves_radix2": HK.radix2_launches,
            "histogram_leaves_packed": HK.packed_launches,
            "lambdarank_grad": RK.launches,
            "threefry_ops": prng.launches}


def zero_counts(HK, RF, TB, prng):
    from lightgbm_tpu_torch.ops import rank as RK
    RK.launches = 0
    HK.zero_gate_counts()
    TB.launches = RF.launches = RF.select_launches = prng.launches = 0
    RF.table_launches = RF.select_table_launches = 0
    HK.leaves_launches = HK.payload_launches = HK.rows_launches = 0
    HK.leaves_rows_launches = 0
    HK.radix_single_launches = HK.radix_joint_launches = 0
    HK.radix2_launches = HK.packed_launches = 0
    HK.rows_launches_by_size.clear()


def text_sha256(bst):
    """sha256 of the whole model text."""
    return hashlib.sha256(bst.model_to_string().encode()).hexdigest()


def trees_text(bst):
    """The model text without its parameters block."""
    return bst.model_to_string().split("parameters:")[0]


def trees_sha256(bst):
    """sha256 of :func:`trees_text`."""
    return hashlib.sha256(trees_text(bst).encode()).hexdigest()


def leading_agreement(a, b):
    """How many of two trees' splits agree, in node order, before the
    first that differs."""
    k = 0
    for fa, fb, ta, tb in zip(a.split_feature, b.split_feature,
                              a.threshold_bin, b.threshold_bin):
        if fa != fb or ta != tb:
            break
        k += 1
    return k


# ---- phase 5: the fused round loop

def fused_train(torch, lgbt, ds, rounds, classic=False, **extra):
    """``train()`` of the recipe (updated by ``extra``) on the constructed
    Dataset ``ds`` with no per-round callback: the fused loop; with
    ``classic``, the classic loop, forced by patching
    ``GBDT.supports_fused`` as the JAX package's tests do (a per-round
    clock then stamps its rounds).  Returns (booster, s/round, the whole
    train() call's wall seconds, peak device MiB).  s/round, each round's
    host work included: the classic loop's rounds 2.. (a stamp after each
    round's tree is built; the first round's one-time work left out), the
    fused loop's chunk walls over their rounds (``FusedRound.walls``: from
    before the chunk's inputs are staged to after its trees are built, the
    warm-up round and capture left out)."""
    from lightgbm_tpu_torch.boosting import gbdt as G
    params = dict(RECIPE, **extra)
    stamps, cbs = [], []
    orig = G.GBDT.supports_fused
    if classic:
        G.GBDT.supports_fused = lambda self: False

        def clock(env):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        cbs = [clock]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        bst = lgbt.train(params, ds, num_boost_round=rounds, callbacks=cbs)
    finally:
        G.GBDT.supports_fused = orig
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    frs = list(bst._gbdt._fused_cache.values())
    if classic:
        if frs:
            fail("the forced classic loop ran the fused round")
        per = float(np.mean(np.diff([t0] + stamps)[1:]))
    else:
        if len(frs) != 1 or frs[0].graphs is None:
            fail("train() with no per-round callback did not replay the "
                 "fused round's CUDA graphs")
        per = (sum(w for w, _ in frs[0].walls)
               / sum(r for _, r in frs[0].walls))
    return bst, per, wall, peak


#: the kernel symbols (torch.profiler names) each group of wrapper counters
#: launches: a wrapper call is one launch of its group's symbol
SYMBOLS = (
    (("histogram_leaves", "histogram_leaves_radix2",
      "histogram_radix_joint"), r"masked_cluster<\d+, \d+, 0, 0>"),
    (("histogram_radix_single",),
     r"masked_cluster<\d+, \d+, 0, 1>|radix_single_cluster"),
    (("histogram_leaves_packed",), r"masked_cluster<\d+, \d+, 1, "),
    (("histogram_payload",), r"masked_cluster<\d+, \d+, 2, "),
    (("histogram_leaves_rows",), r"masked_cluster<\d+, \d+, 3, "),
    (("partition_payload",), r"partition_kernel<true, \d+, false>"),
    (("partition_select",), r"partition_kernel<false, \d+, false>"),
    (("partition_payload_table",), r"partition_kernel<true, \d+, true>"),
    (("partition_select_table",), r"partition_kernel<false, \d+, true>"),
    (("take_small_table",), r"take_kernel"),
    (("histogram_rows_t",), r"rows_channel"),
    (("lambdarank_grad",), r"lambdarank_kernel"))


def symbol_mismatch(work, booked):
    """The groups of SYMBOLS whose launches in the profiler's ``work``
    differ from the wrappers' ``booked`` counts: {group: (profiler,
    wrappers)}."""
    out = {}
    for names, rx in SYMBOLS:
        seen = sum(c for nm, c, _ in work if re.search(rx, nm))
        want = sum(booked[k] for k in names)
        if seen != want:
            out["+".join(names)] = (seen, want)
    return out


def check_fused(torch, lgbt, classic_sha, HK, RF, TB, prng):
    """Phase 5: the fused round loop on the card.  The five trainings of
    phase 3 with a batched grower, each through ``train()`` with no
    per-round callback (each boosting round one replay of a captured CUDA
    graph) and twice: the model text must be phase 3's classic text, both
    times; each run's kernel launches (counts zeroed just before, read just
    after) with its graph replays, flag reads and extra one-round replays.
    Then a profiled fused chunk of the default recipe (busy share,
    launches, host reads by source line), six alternating fused/classic
    training pairs of the default recipe, and early stopping with the
    200k-row valid set (metric=auc): best_iteration as the classic loop's,
    device AUC within 1e-4 of predict's.  Returns the fused launches of
    the kernels each run's path holds."""
    from lightgbm_tpu_torch.boosting import fused_graph as FG
    data = {mb: slice_data(lgbt, N, 0, mb)[0] for mb in (255, 63)}
    _, _, _, Xv, yv, _ = slice_data(lgbt, N)
    data["100k"] = slice_data(lgbt, 100_000)[0]
    runs = (("default", 255, 10, {}), ("max_bin=63", 63, 5, {"max_bin": 63}),
            ("pooled", 255, 10, {"histogram_pool_size": 8}),
            ("onehot", "100k", 3, ONEHOT),
            ("deterministic", 255, 5, {"deterministic": True}))
    need = {"default": ("histogram_radix_single", "histogram_radix_joint",
                        "histogram_leaves_radix2", "histogram_payload",
                        "partition_payload", "take_small_table"),
            "max_bin=63": ("histogram_leaves_packed", "histogram_payload",
                           "partition_payload", "take_small_table"),
            "pooled": ("partition_select", "histogram_leaves",
                       "take_small_table"),
            "onehot": ("histogram_leaves", "histogram_payload",
                       "take_small_table"),
            "deterministic": ("histogram_payload", "partition_payload",
                              "take_small_table")}
    launches = {}
    for name, d, rounds, extra in runs:
        shas = []
        for rep in range(2):
            zero_counts(HK, RF, TB, prng)
            FG.counts.update(replays=0, reads=0, extra=0, rounds=0)
            bst, per, wall, peak = fused_train(torch, lgbt, data[d], rounds,
                                               **extra)
            counts = launch_counts(HK, RF, TB, prng)
            on = HK.gate_counts()
            fc = dict(FG.counts)
            shas.append(text_sha256(bst))
            if rep == 0:
                FUSED_S_ROUND[name] = per
                missing = [k for k in need[name] if counts[k] <= 0]
                if missing:
                    fail(f"the fused {name} run never launched {missing}")
                if any(v > counts[k] for k, v in on.items()):
                    fail(f"fused {name}: gate-on counts {on} above the "
                         f"launches {counts}")
                # one flag read per replay, a replay per round and more
                # only for a tree still growing
                if (fc["rounds"] != rounds
                        or fc["reads"] != fc["replays"]
                        or fc["replays"] < rounds + fc["extra"]):
                    fail(f"fused {name}: rounds/replays/reads {fc}")
                fr = next(iter(bst._gbdt._fused_cache.values()))
                print(f"fused ({name}, {rounds} rounds, {fr.R} K-wide "
                      f"rounds a tree after the ladder): s/round {per:.5f} "
                      f"(the chunk's wall: staging, replays, the transfer, "
                      f"the trees built), train() {wall:.3f} s in all, "
                      f"warm-up round and capture "
                      f"{fr.capture_s:.2f} s, peak device memory "
                      f"{peak:.1f} MiB, graph replays {fc['replays']} "
                      f"(one-round extra {fc['extra']}), flag reads "
                      f"{fc['reads']} ({fc['reads'] / rounds:.2f} per "
                      f"boosting round); kernel launches (the eager "
                      f"warm-up round's and the replays') "
                      f"{json.dumps({k: v for k, v in counts.items() if v})}"
                      f", of them with the gate on (device count; a masked "
                      f"pass gated off exits at once, a payload pass takes "
                      f"no row) {json.dumps(on)}",
                      flush=True)
                for k in need[name]:
                    launches.setdefault(k, counts[k])
            del bst
        if shas[0] != shas[1] or shas[0] != classic_sha[name]:
            fail(f"fused {name}: model text sha256 {shas} vs the classic "
                 f"loop's {classic_sha[name]}")
        print(f"model text sha256 (fused {name}): {shas[0]}, twice, equal "
              f"to the classic loop's", flush=True)
        torch.cuda.empty_cache()

    # a profiled fused chunk of the default recipe (the graph of train()'s
    # chunk of 10 replayed again): its busy share over the window's wall,
    # and the wrappers' launch counts held against the profiler's kernels
    # (a window whose records disagree is measured again, up to 3 in all)
    bst, _, _, _ = fused_train(torch, lgbt, data[255], 10)
    g = bst._gbdt
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(3):
        FG.counts.update(replays=0, reads=0, extra=0, rounds=0)
        zero_counts(HK, RF, TB, prng)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            g.train_fused(10)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        work = profiler_work(prof, "fused profile")
        if work is None:
            fail("fused profile: the busy share and launches were not "
                 "measured")
        booked = launch_counts(HK, RF, TB, prng)
        bad = symbol_mismatch(work, booked)
        if not bad:
            break
        print(f"fused profile: profiler vs wrapper launches {bad}; "
              f"measured again", flush=True)
    else:
        fail(f"fused profile: the wrappers' launch counts disagree with the "
             f"profiler's kernels: {bad}")
    kern = sorted(((us / 1e3, cnt, nm) for nm, cnt, us in work),
                  reverse=True)
    busy = sum(k[0] for k in kern)
    n_l = sum(k[1] for k in kern)
    print(f"fused profile (default, a chunk of 10 rounds, CUDA activity "
          f"only): {wall:.1f} ms wall, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}% of the window), {n_l} kernel launches "
          f"({n_l / 10:.0f} a round), graph replays {FG.counts['replays']}, "
          f"flag reads {FG.counts['reads']}", flush=True)
    for ms, cnt, nm in kern[:10]:
        print(f"  {ms:8.3f} ms {cnt:6d}x {nm[:90]}", flush=True)
    per_tree = {k: v / 10 for k, v in booked.items() if v}
    on_tree = {k: v / 10 for k, v in HK.gate_counts().items()}
    print(f"fused launches per tree (default, the chunk's replays; equal to "
          f"the profiler's by kernel): {json.dumps(per_tree)}; with the gate "
          f"on (device count) {json.dumps(on_tree)}", flush=True)
    # a round that is not live: the captured tree is complete, so one more
    # of its rounds (run eagerly here) changes nothing; its device work is
    # what the fixed budget's spare rounds cost
    fr = g._fused_cache[(10, 0, None, False)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fr.tree.round(fr.tree.K)
        torch.cuda.synchronize()
    dw = profiler_work(prof, "fused: a round that is not live")
    if dw is not None:
        print(f"fused: a round that is not live (K = {fr.tree.K}) costs "
              f"{sum(us for _, _, us in dw) / 1e3:.3f} ms of device time in "
              f"{sum(c for _, c, _ in dw)} launches", flush=True)
    _, where = syncing(torch, lambda: g.train_fused(10))
    by = collections.Counter(where)
    src, first = inspect.getsourcelines(FG.FusedRound._step)
    flag_line = first + next(i for i, ln in enumerate(src)
                             if "flag.item()" in ln)
    print(f"fused host reads (default, a chunk of 10 rounds): "
          f"{sum(by.values())} in all, by source line "
          f"{json.dumps(dict(by))}; at the flag read "
          f"{by.get(f'fused_graph.py:{flag_line}', 0) / 10:.2f} per "
          f"boosting round", flush=True)
    del bst, g

    # six alternating fused/classic pairs of the default recipe
    per = {"fused": [], "classic": []}
    whole = {"fused": [], "classic": []}
    texts = set()
    for _ in range(6):
        for loop in ("fused", "classic"):
            bst, sr, wall, _ = fused_train(torch, lgbt, data[255], 10,
                                           classic=loop == "classic")
            per[loop].append(sr)
            whole[loop].append(wall / 10)
            texts.add(bst.model_to_string())
            del bst
    if len(texts) != 1:
        fail("alternating pairs: the fused and classic model texts differ")
    for tag, d in (("s/round (fused: chunk walls without the capture; "
                    "classic: rounds 2-10)", per),
                   ("train() wall / 10 (everything)", whole)):
        diff = np.array(d["fused"]) - np.array(d["classic"])
        pairs = [[round(f, 5), round(c, 5)]
                 for f, c in zip(d["fused"], d["classic"])]
        print(f"fused vs classic (default, 1M x 10, six alternating pairs, "
              f"{tag}): median fused {np.median(d['fused']):.5f} classic "
              f"{np.median(d['classic']):.5f}, fused - classic "
              f"{diff.mean():+.5f} +- "
              f"{diff.std(ddof=1) / np.sqrt(len(diff)):.5f} (pairs fused "
              f"won: {int((diff < 0).sum())}); model text equal; pairs "
              f"(fused, classic) {json.dumps(pairs)}", flush=True)
    med_f, med_c = np.median(per["fused"]), np.median(per["classic"])
    if not med_f <= med_c:
        fail(f"the fused loop's median s/round {med_f} is slower than the "
             f"classic loop's {med_c}")

    # early stopping with the 200k-row valid set
    res = {}
    for loop in ("fused", "classic"):
        ds = slice_data(lgbt, 100_000, fresh=True)[0]
        vs = ds.create_valid(Xv, yv)
        from lightgbm_tpu_torch.boosting import gbdt as G
        orig = G.GBDT.supports_fused
        if loop == "classic":
            G.GBDT.supports_fused = lambda self: False
        rec = {}
        FG.counts.update(replays=0, reads=0, extra=0, rounds=0)
        try:
            t0 = time.perf_counter()
            bst = lgbt.train(dict(RECIPE, metric="auc", learning_rate=1.0),
                             ds, num_boost_round=100, valid_sets=[vs],
                             valid_names=["held_out"],
                             callbacks=[lgbt.early_stopping(1, verbose=False),
                                        lgbt.record_evaluation(rec)])
            t_es = time.perf_counter() - t0
        finally:
            G.GBDT.supports_fused = orig
        # predict() walks the trees on the host at this size: once, for
        # the fused booster (the classic run's best iteration, trees and
        # recorded evaluations are held to the fused run's)
        a = auc(yv, bst.predict(Xv)) if loop == "fused" else None
        res[loop] = (bst.best_iteration, bst.num_trees(),
                     bst.best_score["held_out"]["auc"], a, rec, t_es,
                     (FG.counts["rounds"], FG.counts["extra"]))
        del bst
    (bi_f, nt_f, dev_f, a_f, rec_f, t_f, r_f), \
        (bi_c, nt_c, dev_c, a_c, rec_c, t_c, _) = res["fused"], \
        res["classic"]
    print(f"early stopping (100k x <= 100, lr 1.0, 200k valid, auc, "
          f"patience 1): best_iteration fused {bi_f} classic {bi_c}, trees "
          f"{nt_f} / {nt_c}, fused rounds run {r_f[0]} (one-round extra "
          f"replays {r_f[1]}), device AUC fused "
          f"{dev_f:.6f} classic {dev_c:.6f}, predict AUC {a_f:.6f}, "
          f"recorded evaluations equal {rec_f == rec_c}, train s fused "
          f"{t_f:.2f} classic {t_c:.2f}", flush=True)
    if bi_f != bi_c or nt_f != nt_c or rec_f != rec_c:
        fail("early stopping: the fused loop and the classic loop differ")
    if abs(dev_f - a_f) > 1e-4:
        fail(f"early stopping: device AUC {dev_f} vs predict's {a_f}")
    return launches


# ---- A/B against another checkout: python3 chip_smoke.py --ab DIR

# ---- phase 6: prediction (the device forest predictor and TreeSHAP)

#: rows of the held-out set phase 6 predicts (1M x 100 trees: 1e8
#: row-trees, above DEVICE_PREDICT_MIN_WORK), of its host checks, and of
#: pred_contrib through the SHAP kernel
N_HOST_CHECK = 20_000
N_SHAP = 10_000
N_SHAP_HOST = 200


def random_children(rng, L):
    """Children (left, right: i32 [L - 1], the model text's encoding,
    -(leaf + 1) for a leaf) of a seeded random binary tree of L leaves,
    grown by splitting a random leaf; a node's children have larger ids."""
    ni = L - 1
    lc, rc = np.full(ni, -1, np.int32), np.full(ni, -1, np.int32)
    open_ = [(0, None)]                  # (leaf, (parent node, is_left))
    for nd in range(ni):
        i = int(rng.integers(len(open_)))
        open_[i], open_[-1] = open_[-1], open_[i]
        leaf, parent = open_.pop()
        if parent is not None:
            (lc if parent[1] else rc)[parent[0]] = nd
        lc[nd], rc[nd] = -(leaf + 1), -(nd + 2)
        open_ += [(leaf, (nd, True)), (nd + 1, (nd, False))]
    return lc, rc


def synthetic_bitset_forest(rng, T, L, num_f, cat_feats, cat_bins, n_bins):
    """A seeded random stacked forest with categorical nodes, as the
    numpy fields of a BitsetForest with its children: T random binary
    trees of L leaves over ``num_f`` features; a node on a categorical
    feature is a bitset node (membership random, the unseen and NaN
    sentinel bins ``cat_bins``, ``cat_bins + 1`` included at random);
    numeric nodes a random threshold, NaN bin and default direction."""
    from types import SimpleNamespace
    from lightgbm_tpu_torch.boosting.gbdt import _leaf_path_masks
    ni = L - 1
    Bc = cat_bins + 2
    d = dict(feat=rng.integers(0, num_f, size=(T, ni)).astype(np.int32),
             thr=rng.integers(0, n_bins, size=(T, ni)).astype(np.int32),
             dl=rng.random((T, ni)) < 0.5,
             nanb=rng.integers(n_bins - 2, n_bins, size=(T, ni))
             .astype(np.int32),
             mpos=np.zeros((T, L, ni), np.float32),
             mneg=np.zeros((T, L, ni), np.float32),
             depth=np.full((T, L), -1, np.int32),
             value=rng.normal(size=(T, L)).astype(np.float32),
             cls=np.zeros(T, np.int32),
             left=np.zeros((T, ni), np.int32),
             right=np.zeros((T, ni), np.int32))
    cat_nodes = []
    for t in range(T):
        lc, rc = random_children(rng, L)
        d["left"][t], d["right"][t] = lc, rc
        _leaf_path_masks(SimpleNamespace(num_leaves=L, left_child=lc,
                                         right_child=rc),
                         d["mpos"][t], d["mneg"][t], d["depth"][t])
        cat_nodes.append([nd for nd in range(ni)
                          if int(d["feat"][t, nd]) in cat_feats])
    C = max(1, max(len(c) for c in cat_nodes))
    d["catn"] = np.full((T, C), ni, np.int32)
    d["catf"] = np.zeros((T, C), np.int32)
    d["catb"] = np.zeros((T, C, Bc), np.float32)
    for t, nodes in enumerate(cat_nodes):
        for c, nd in enumerate(nodes):
            d["catn"][t, c] = nd
            d["catf"][t, c] = d["feat"][t, nd]
            d["catb"][t, c] = rng.random(Bc) < 0.4
    return d


def synthetic_chain_tree(lgbt_tree_cls, num_slots):
    """A tree of ``num_slots + 2`` leaves whose deepest path splits on
    ``num_slots`` distinct features (a chain: each node's left child a
    leaf), leaf covers halving down the chain."""
    nl = num_slots + 2
    ni = nl - 1
    t = lgbt_tree_cls(nl)
    t.split_feature = (np.arange(ni) % num_slots).astype(np.int32)
    t.threshold = np.linspace(-0.5, 0.5, ni)
    t.decision_type = np.zeros(ni, np.int32)
    t.left_child = np.array([-(i + 1) for i in range(ni)], np.int32)
    t.right_child = np.array(list(range(1, ni)) + [-nl], np.int32)
    t.leaf_value = np.linspace(-1.0, 1.0, nl)
    counts = np.maximum(1000 >> np.minimum(np.arange(nl), 12), 3)
    t.leaf_count = counts.astype(np.int64)
    t.internal_count = np.array([counts[i:].sum() for i in range(ni)],
                                np.int64)
    return t


def synthetic_tree(tree_cls, rng, L, num_f):
    """A seeded random tree of L leaves for TreeSHAP: random splits on
    ``num_f`` features (real thresholds, NaN default directions), leaf
    counts and internal counts that add up."""
    ni = L - 1
    t = tree_cls(L)
    lc, rc = random_children(rng, L)
    t.left_child, t.right_child = lc, rc
    t.split_feature = rng.integers(0, num_f, size=ni).astype(np.int32)
    t.threshold = rng.normal(size=ni)
    t.decision_type = ((rng.random(ni) < 0.5) * 2 + (2 << 2)).astype(
        np.int32)                          # NaN missing, either default
    t.leaf_value = rng.normal(size=L)
    t.leaf_count = rng.integers(1, 50, size=L).astype(np.int64)
    cnt = np.zeros(ni, np.int64)
    for nd in range(ni - 1, -1, -1):       # children have larger ids
        cnt[nd] = sum(t.leaf_count[-c - 1] if c < 0 else cnt[c]
                      for c in (lc[nd], rc[nd]))
    t.internal_count = cnt
    return t


def check_predict_edges(torch, dev):
    """Phase 6's edges: the code paths of the two kernels the main path
    does not take, each bitwise (forest) or to float32 rounding (SHAP)
    against its plain version on the card.  Forest: 120 features (bins
    read from device memory, not staged), a tree of 8,192 leaves (nodes
    read from device memory), k = 3 class routing, a ragged n, a column
    slice of a wider bin matrix (a row stride other than n), i32 bins;
    SHAP: a tree of 4,096 leaves (the [L, S] contributions in a global
    scratch) and one of 17,000 (the row's decisions read from device
    memory, ni > 16,384)."""
    from lightgbm_tpu_torch.models import predict as MP
    from lightgbm_tpu_torch.models import shap as MS
    from lightgbm_tpu_torch.models.tree import Tree
    from lightgbm_tpu_torch.ops import forest_kernels as FK
    from lightgbm_tpu_torch.ops import shap_kernels as SK
    rng = np.random.default_rng(12)
    cases = []

    def forest(T, L, num_f, k=1, cat=()):
        d = synthetic_bitset_forest(rng, T, L, num_f, cat, 32, 256)
        d["cls"] = (np.arange(T) % k).astype(np.int32)
        if not cat:
            d = {f: v for f, v in d.items()
                 if f in MP.ForestArrays._fields}
        return MP.forest_from_numpy(d, dev)

    def bins(num_f, n, dtype=np.uint8):
        return torch.as_tensor(rng.integers(0, 256, size=(num_f, n))
                               .astype(dtype), device=dev)

    wide = bins(28, 70_000)
    cases = [("F = 120", forest(8, 64, 120), bins(120, 50_003), 1, ()),
             ("L = 8,192", forest(2, 8192, 28), bins(28, 20_000), 1, ()),
             ("k = 3", forest(9, 32, 28, k=3), bins(28, 3_001), 3, ()),
             ("column slice", forest(4, 64, 28), wide[:, 1_000:41_000], 1,
              ()),
             ("i32 bins", forest(4, 64, 28), bins(28, 9_999, np.int32), 1,
              ())]
    for what, f, b, k, cat in cases:
        got = FK.forest_values(f, b, k, cat)
        if not torch.equal(got, MP.predict_numeric_forest(f, b, k)) or \
                not torch.equal(FK.forest_leaves(f, b, cat),
                                MP.predict_forest_leaves(f, b, cat)):
            fail(f"forest kernel vs plain at its edge: {what}")
    for L in (4096, 17_000):
        t = synthetic_tree(Tree, rng, L, F)
        X = rng.normal(size=(64, F))
        X[rng.random(X.shape) < 0.05] = np.nan
        tb = SK.tree_tables(MS._paths_of(t, F), dev)
        gl = SK.go_left_to_device(MS._go_left_matrix(t, X), dev)
        got, want = SK.tree_shap(tb, gl), SK.tree_shap_plain(tb, gl)
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
            fail(f"SHAP kernel vs plain at L = {L}: max abs diff "
                 f"{(got - want).abs().max().item()}")
    print("predict edges: forest kernel bitwise against the plain version "
          "(values and leaves) at F = 120, L = 8,192, k = 3, n = 3,001, a "
          "column slice, i32 bins; SHAP kernel against the plain version "
          "at L = 4,096 and 17,000 leaves (rtol 1e-5 / atol 1e-6)",
          flush=True)


def check_predict(torch, lgbt):
    """Phase 6: prediction on the card.  The default recipe trained on the
    1M-row synthetic set for 100 rounds through the fused loop, then
    ``Booster.predict`` on a 1M-row held-out set (1e8 row-trees: the
    device forest predictor, one forest-kernel launch per row block), its
    wall split into host binning, the copy to the card, the kernel and the
    copy back, rows per second and the held-out AUC; held bit for bit
    against the plain path-count version on the card (whose time, its
    torch.matmul products inside, is row 12's library column), against
    the host float64 walk on 20,000 rows (rtol 2e-5 / atol 2e-6), in
    leaves mode against the plain version and ``pred_leaf``'s host walk,
    the same bits twice; a seeded synthetic forest with categorical nodes
    and both sentinel bins at 1M rows, bitwise against the plain version.
    Then ``pred_contrib`` on 10,000 held-out rows through the SHAP kernel:
    additivity against raw_score (1e-4 relative), the same bits twice, the
    plain PyTorch version on the card with num_iteration=10 (rtol 1e-5 /
    atol 1e-6), the host float64 path on 200 rows (largest relative
    difference printed, fail above 1e-4), its wall split (host decisions,
    copies, kernel), and a 40-slot chain tree (above the kernel's register
    buckets) against the plain version; between the two, the kernels'
    edges (``check_predict_edges``).  Returns rows 12 and 13 of the
    kernels line."""
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.models import predict as MP
    from lightgbm_tpu_torch.models import shap as MS
    from lightgbm_tpu_torch.models.tree import Tree
    from lightgbm_tpu_torch.ops import forest_kernels as FK
    from lightgbm_tpu_torch.ops import shap_kernels as SK
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    t_phase = time.perf_counter()
    rng = np.random.default_rng(6)
    X, y, w = synth_higgs(N, F, rng)
    Xv, yv, _ = synth_higgs(N, F, rng, w)
    t0 = time.perf_counter()
    ds = lgbt.Dataset(X, y, params={"max_bin": 255, "verbosity": -1})
    ds.construct()
    t_ds = time.perf_counter() - t0
    bst, per, wall, _ = fused_train(torch, lgbt, ds, 100)
    g = bst._gbdt
    T_ = len(g.models)
    print(f"predict: default recipe {N:,} x {T_} trees through the fused "
          f"loop (dataset {t_ds:.2f} s, {per:.4f} s a round, train() "
          f"{wall:.2f} s)", flush=True)
    if T_ != 100 or N * T_ < GBDT.DEVICE_PREDICT_MIN_WORK:
        fail(f"phase 6 trained {T_} trees")

    # -- Booster.predict above the threshold: counts zeroed just before,
    # read just after
    FK.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = bst.predict(Xv, raw_score=True)
    t_pred = time.perf_counter() - t0
    n_fk = FK.launches
    blocks = -(-N // GBDT.PREDICT_BLOCK_ROWS)
    if n_fk < blocks:
        fail(f"Booster.predict over {N:,} rows x {T_} trees launched the "
             f"forest kernel {n_fk} times for {blocks} row blocks")
    if raw.shape != (N,) or not np.isfinite(raw).all():
        fail(f"predict gave shape {raw.shape} / non-finite values")
    a = auc(yv, raw)
    if not a > 0.7:
        fail(f"held-out AUC {a} is not that of a trained model")
    # the same steps one at a time: binning, copy, kernel, copy back
    t0 = time.perf_counter()
    bins_np = g.train_set.bin_external(Xv)
    t_bin = time.perf_counter() - t0
    t0 = time.perf_counter()
    bins_t = torch.as_tensor(np.ascontiguousarray(bins_np.T), device=dev)
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    fa = g._forest_arrays(g.models, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = FK.forest_values(fa, bins_t, 1)
    torch.cuda.synchronize()
    t_kern = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_host = out.double().cpu().numpy()[:, 0]
    t_d2h = time.perf_counter() - t0
    _, dev_ms = device_per_call(torch, lambda: FK.forest_values(fa, bins_t,
                                                                1), reps=5)
    print(f"predict {N:,} x {T_}: Booster.predict {t_pred:.3f} s "
          f"({N / t_pred:,.0f} rows/s), {n_fk} forest-kernel launch(es); "
          f"split: host binning {t_bin:.3f} s, copy to the card "
          f"{t_h2d:.4f} s, kernel {t_kern:.4f} s (device "
          f"{dev_ms if dev_ms is None else round(dev_ms, 4)} ms, profiler), "
          f"copy back {t_d2h:.4f} s; held-out AUC {a:.6f}", flush=True)
    if not np.array_equal(out_host, raw):
        fail("Booster.predict's raw scores differ from the forest kernel's")
    plain = MP.predict_numeric_forest(fa, bins_t, 1)
    if not torch.equal(out, plain):
        d = (out - plain).abs().max().item()
        fail(f"forest kernel vs the plain path-count version: max abs "
             f"diff {d}")
    if not torch.equal(FK.forest_values(fa, bins_t, 1), out):
        fail("the forest kernel gave other bits on a second call")
    host = bst.predict(Xv[:N_HOST_CHECK], raw_score=True)   # host walk
    if not np.allclose(raw[:N_HOST_CHECK], host, rtol=2e-5, atol=2e-6):
        fail(f"device predict vs the host float64 walk: max abs diff "
             f"{np.abs(raw[:N_HOST_CHECK] - host).max()}")
    leaves = FK.forest_leaves(fa, bins_t)
    if not torch.equal(leaves, MP.predict_forest_leaves(fa, bins_t)):
        fail("forest kernel leaves vs the plain predict_forest_leaves")
    host_leaves = bst.predict(Xv[:N_HOST_CHECK], pred_leaf=True)
    if not np.array_equal(leaves[:, :N_HOST_CHECK].cpu().numpy().T,
                          host_leaves):
        fail("forest kernel leaves vs pred_leaf's host walk")
    ms = time_ms(torch, lambda: FK.forest_values(fa, bins_t, 1), flush)
    plain_ms = time_ms(torch, lambda: MP.predict_numeric_forest(
        fa, bins_t, 1), flush, reps=3)
    leaves_ms = time_ms(torch, lambda: FK.forest_leaves(fa, bins_t), flush,
                        reps=3)
    # the plain version's torch.matmul products alone (row 12's library
    # call), device time from the profiler: its GEMM kernels in one call
    _, plain_dev = device_per_call(torch, lambda: MP.predict_numeric_forest(
        fa, bins_t, 1), reps=1)
    gemm = [(c, us) for nm, c, us in last_work
            if re.search(r"gemm|xmma|cutlass", nm, re.I)]
    mm_ms = sum(us for _, us in gemm) / 1e3
    print(f"predict shape: plain path-count version, one call: device "
          f"{plain_dev} ms (profiler), of it its torch.matmul products "
          f"{mm_ms:.4f} ms in {sum(c for c, _ in gemm)} GEMM launches",
          flush=True)
    # bound: the bins, the output and the forest once; the node steps this
    # run's rows take (each row's path length in each tree)
    depth = fa.depth.long()
    steps = int(torch.gather(depth, 1, leaves.long()).sum().item())
    p = FK.pack_forest(fa)
    fbytes = sum(x.numel() * x.element_size() for x in p)
    b12, by12 = bound_ms(N * F + 4 * N + fbytes, steps)
    print(f"predict shape: forest kernel {N:,} x {T_} trees (L = "
          f"{fa.depth.shape[1]}): one call {ms:.4f} ms, device "
          f"{dev_ms} ms, leaves mode {leaves_ms:.4f} ms; plain path-count "
          f"version {plain_ms:.4f} ms; {steps:,} node steps (mean depth "
          f"{steps / N / T_:.2f}), bound {b12:.4f} ms ({by12}); bitwise "
          f"against the plain version, values and leaves, twice", flush=True)
    del plain, leaves, out

    # -- categorical nodes, both sentinels: a synthetic BitsetForest
    cat_feats = (3, 11, 19)
    fd = synthetic_bitset_forest(np.random.default_rng(11), 20, 64, F,
                                 cat_feats, 32, 256)
    fb = MP.forest_from_numpy(fd, dev)
    cb = rng.integers(0, 256, size=(F, N)).astype(np.int32)
    for cf in cat_feats:
        cb[cf] = rng.integers(0, 34, size=N)        # 32 bins + sentinels
    cb_t = torch.as_tensor(cb, device=dev)
    got = FK.forest_values(fb, cb_t, 1, cat_feats)
    want = MP.predict_bitset_forest(fb, cb_t, 1, cat_feats)
    gl_ = FK.forest_leaves(fb, cb_t, cat_feats)
    wl_ = MP.predict_forest_leaves(fb, cb_t, cat_feats)
    n_cat = int((fb.catn < 63).sum().item())
    if not torch.equal(got, want) or not torch.equal(gl_, wl_):
        fail("forest kernel vs plain on the categorical synthetic forest")
    print(f"predict (categorical): 20 synthetic trees of 64 leaves, "
          f"{n_cat} bitset nodes on 3 of 28 features, 1M rows with both "
          f"sentinel bins: values and leaves bitwise against the plain "
          f"version", flush=True)
    del cb_t, got, want, gl_, wl_, bins_t

    check_predict_edges(torch, dev)

    # -- pred_contrib through the SHAP kernel
    Xs = Xv[:N_SHAP]
    SK.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    contrib = bst.predict(Xs, pred_contrib=True)
    t_shap = time.perf_counter() - t0
    n_sk = SK.launches
    chunks = -(-N_SHAP // MS._DEVICE_CHUNK_ROWS)
    if n_sk != T_ * chunks:
        fail(f"pred_contrib launched the SHAP kernel {n_sk} times, not "
             f"{T_ * chunks}")
    raw_s = bst.predict(Xs, raw_score=True)
    rel = np.abs(contrib.sum(1) - raw_s).max() / np.abs(raw_s).max()
    if contrib.shape != (N_SHAP, F + 1) or not rel <= 1e-4:
        fail(f"pred_contrib shape {contrib.shape}, additivity {rel}")
    if not np.array_equal(bst.predict(Xs, pred_contrib=True), contrib):
        fail("pred_contrib gave other bits on a second call")
    # the wall split, step by step (the tables are cached by now)
    tg = th2d = tk = td2h = 0.0
    Ss = []
    for tr in g.models:
        tp = MS._paths_of(tr, F)
        tb = SK.tree_tables(tp, dev)
        Ss.append(tp.S)
        for r0 in range(0, N_SHAP, MS._DEVICE_CHUNK_ROWS):
            t0 = time.perf_counter()
            gl = MS._go_left_matrix(tr, Xs[r0:r0 + MS._DEVICE_CHUNK_ROWS])
            t1 = time.perf_counter()
            gd = SK.go_left_to_device(gl, dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            o = SK.tree_shap(tb, gd)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            o.cpu().numpy()
            t4 = time.perf_counter()
            tg, th2d, tk, td2h = (tg + t1 - t0, th2d + t2 - t1,
                                  tk + t3 - t2, td2h + t4 - t3)
    print(f"pred_contrib {N_SHAP} x {T_} trees: {t_shap:.3f} s "
          f"({N_SHAP / t_shap:,.0f} rows/s), {n_sk} SHAP-kernel launches, "
          f"S = {min(Ss)}..{max(Ss)}; split: host _go_left_matrix "
          f"{tg:.3f} s, copies to the card {th2d:.3f} s, kernel {tk:.3f} s, "
          f"copies back {td2h:.3f} s; additivity {rel:.2e} relative; the "
          f"same bits twice", flush=True)
    # plain torch on the card, 10 trees
    k_ = MS.predict_contrib(g.models, Xs, F, 1, 0, 10, force_device=True,
                            device=dev)
    kernel_shap = SK.tree_shap
    SK.tree_shap = SK.tree_shap_plain
    try:
        p_ = MS.predict_contrib(g.models, Xs, F, 1, 0, 10,
                                force_device=True, device=dev)
    finally:
        SK.tree_shap = kernel_shap
    if not np.allclose(k_, p_, rtol=1e-5, atol=1e-6):
        fail(f"SHAP kernel vs the plain version (10 trees): max abs diff "
             f"{np.abs(k_ - p_).max()}")
    k200 = MS.predict_contrib(g.models, Xs[:N_SHAP_HOST], F, 1, 0, 10,
                              force_device=True, device=dev)
    t0 = time.perf_counter()
    h200 = MS.predict_contrib(g.models, Xs[:N_SHAP_HOST], F, 1, 0, 10)
    t_h = time.perf_counter() - t0
    rel_h = np.abs(k200 - h200).max() / np.abs(h200).max()
    print(f"pred_contrib checks: kernel vs plain PyTorch on the card (10 "
          f"trees, {N_SHAP} rows) max abs diff {np.abs(k_ - p_).max():.3e}; "
          f"vs the host float64 path ({N_SHAP_HOST} rows, 10 trees, "
          f"{t_h:.1f} s) largest relative difference {rel_h:.3e}",
          flush=True)
    if not rel_h <= 1e-4:
        fail(f"SHAP kernel vs the host float64 path: {rel_h}")
    # one S above the register buckets: a 40-slot chain tree
    chain = synthetic_chain_tree(Tree, 40)
    Xc = np.random.default_rng(3).normal(size=(N_SHAP_HOST, 44)) * 0.5
    if MS._paths_of(chain, 44).S <= SK.REGISTER_SLOTS:
        fail("the chain tree does not exceed the register buckets")
    kc = MS.predict_contrib([chain], Xc, 44, force_device=True, device=dev)
    SK.tree_shap = SK.tree_shap_plain
    try:
        pc = MS.predict_contrib([chain], Xc, 44, force_device=True,
                                device=dev)
    finally:
        SK.tree_shap = kernel_shap
    dc = np.abs(kc - pc).max()
    print(f"pred_contrib (S = {MS._paths_of(chain, 44).S}, global path "
          f"state): kernel vs plain max abs diff {dc:.3e}", flush=True)
    if not np.allclose(kc, pc, rtol=1e-5, atol=1e-6):
        fail(f"SHAP kernel vs plain at S = 40: max abs diff {dc}")
    # row 13's one call: tree 0's first chunk
    tp = MS._paths_of(g.models[0], F)
    tb = SK.tree_tables(tp, dev)
    gd = SK.go_left_to_device(MS._go_left_matrix(
        g.models[0], Xs[:MS._DEVICE_CHUNK_ROWS]), dev)
    if not torch.equal(SK.tree_shap(tb, gd), SK.tree_shap(tb, gd)):
        fail("the SHAP kernel gave other bits on a second call")
    ms13 = time_ms(torch, lambda: SK.tree_shap(tb, gd), flush)
    _, dev13 = device_per_call(torch, lambda: SK.tree_shap(tb, gd), reps=5)
    plain13 = time_ms(torch, lambda: SK.tree_shap_plain(tb, gd), flush,
                      reps=3)
    Lp, S = tp.feats.shape
    n_ = MS._DEVICE_CHUNK_ROWS
    b13, by13 = bound_ms(n_ * gd.shape[1] + 4 * n_ * (F + 1),
                         2 * n_ * Lp * (S * S + S))
    err13 = float(np.abs(k_ - p_).max())
    print(f"predict shape: SHAP kernel, one chunk of {n_} rows, tree 0 "
          f"(L = {Lp}, S = {S}): one call {ms13:.4f} ms, device {dev13} ms, "
          f"plain {plain13:.2f} ms, bound {b13:.4f} ms ({by13})", flush=True)
    print(f"phase 6: {time.perf_counter() - t_phase:.1f} s", flush=True)

    def kernel_row(name, src, replaces, launches, err, ms_, plain_, b, by,
                   lib):
        return dict(name=name, route="cuda", source=src, replaces=replaces,
                    launches=launches, max_abs_err=err, ms=ms_,
                    plain_ms=plain_, bound_ms=b, bound_by=by,
                    library_ms=lib)

    return [kernel_row("forest_values", "lightgbm_tpu_torch/csrc/forest.cu",
                       "lightgbm_tpu/models/predict.py:355", n_fk, 0.0, ms,
                       plain_ms, b12, by12, plain_ms),
            kernel_row("tree_shap", "lightgbm_tpu_torch/csrc/shap.cu",
                       "lightgbm_tpu/models/shap.py:304", n_sk, err13,
                       ms13, plain13, b13, by13, None)]


# ---- phase 7: EFB-bundled training

#: phase 7's data: bench.py's HIGGS-shaped numeric columns plus N_CAT
#: categorical variables of CAT_LEVELS levels, one-hot encoded
N_CAT, CAT_LEVELS = 8, 32
N_BVALID = 200_000
N_BCROSS = 100_000


def synth_bundled(n, rng, w=None):
    """synth_higgs's F numeric columns plus N_CAT categorical variables of
    CAT_LEVELS levels one-hot encoded as N_CAT * CAT_LEVELS sparse columns,
    the hot entry N(1.5, 0.2) (tests/test_efb.py's fixture): the
    Flight-Delay / Allstate shape EFB exists for.  The label depends on
    the numeric columns and on three of the blocks."""
    if w is None:
        w = (rng.normal(size=F), rng.normal(size=(3, CAT_LEVELS)))
    num = rng.normal(size=(n, F)).astype(np.float32)
    idx = rng.integers(0, CAT_LEVELS, size=(n, N_CAT))
    X = np.zeros((n, F + N_CAT * CAT_LEVELS), np.float32)
    X[:, :F] = num
    r = np.arange(n)
    for c in range(N_CAT):
        X[r, F + c * CAT_LEVELS + idx[:, c]] = rng.normal(1.5, 0.2, size=n)
    logit = num @ w[0] * 0.5 + sum(w[1][j][idx[:, j]] for j in range(3))
    y = (logit + rng.normal(size=n) > 0).astype(np.float32)
    return X, y, w


def table_slots(rng, inner, k, leaves):
    """k split descriptors over a bundle plan, as a bundled round makes
    them: features of multi-member bundles that are not their bundle's
    first member first, the rest at random; distinct parents among
    ``leaves`` leaf ids, the last 3 slots invalid."""
    plan = inner.bundle_plan
    later = [f for m in plan.bundles if len(m) > 1 for f in m[1:]]
    feats = np.concatenate([rng.permutation(later)[:k // 2], rng.integers(
        0, len(plan.feat_col), size=k - min(k // 2, len(later)))])
    feats = feats[:k].astype(np.int32)
    nb = inner.num_bins_array()
    par = rng.permutation(leaves)[:k].astype(np.int32)
    new = (leaves + np.arange(k)).astype(np.int32)
    return dict(
        feats=feats,
        thr=np.array([rng.integers(0, max(nb[f] - 1, 1)) for f in feats],
                     np.int32),
        dl=rng.integers(0, 2, size=k, dtype=np.int32),
        nanb=inner.nan_bin_array()[feats].astype(np.int32),
        parents=par, new_leaves=new,
        validk=(np.arange(k) < k - 3).astype(np.int32),
        smaller=np.where(rng.random(k) < 0.5, par, new).astype(np.int32))


def check_table_partition(torch, RF, inner, flush):
    """The decision-table partition on the card at phase 7's shapes (n =
    1M, the bundle plan of the 1M set): ``partition_payload_table`` at K
    = 42 and ``partition_select_table`` at K = 42 and the pooled 84, each
    bit for bit against its plain version on every output, with tables
    built by ``decision_table`` from the plan's inverse table; with an
    all-numeric (identity) table, bit for bit the numeric
    ``partition_payload`` / ``partition_select``; one launch a call; one
    call and device ms beside the byte bound.  Returns the two kernel
    rows (launches filled in later)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    n, Fb = inner.bins.shape
    Bd = inner.device_n_bins()
    plan = inner.bundle_plan
    bins_t = torch.as_tensor(np.ascontiguousarray(inner.bins.T), device=dev)
    words = torch.as_tensor(inner.packed_mirror(), device=dev)
    W = words.shape[1]
    feat_col = torch.as_tensor(plan.feat_col, device=dev)
    inv = torch.as_tensor(plan.inv_table[:, :Bd], device=dev)
    g = torch.as_tensor(rng.normal(size=n).astype(np.float32), device=dev)
    h = torch.as_tensor(rng.random(n).astype(np.float32), device=dev)
    lor = torch.as_tensor(rng.integers(0, 128, size=n, dtype=np.int32),
                          device=dev)
    mask = torch.as_tensor((rng.random(n) >= 0.1).astype(np.int32),
                           device=dev)
    ident_col = torch.arange(Fb, dtype=torch.int32, device=dev)
    ident_inv = torch.arange(Bd, dtype=torch.int32,
                             device=dev)[None, :].repeat(Fb, 1)

    def same(a, b, what):
        if a.shape != b.shape or not torch.equal(a, b):
            fail(f"{what}: kernel differs from its plain version")

    rows, sl = [], {}
    for k in (K, 2 * K):
        d = {nm: torch.as_tensor(v, device=dev)
             for nm, v in table_slots(rng, inner, k, 128).items()}
        cols, tab = RF.decision_table(d["feats"], d["thr"], d["dl"],
                                      d["nanb"], feat_col=feat_col,
                                      inv_table=inv)
        rest = tuple(d[nm] for nm in PART_DESC[4:])
        sargs = (bins_t, lor, mask, cols, tab, *rest)
        for a, b_, out in zip(RF.partition_select_table(*sargs),
                              RF.partition_select_table_plain(*sargs),
                              ("new leaf map", "sort key")):
            same(a, b_, f"partition_select_table {out} (K = {k})")
        pargs = (bins_t, words, g, h, lor, mask, cols, tab, *rest)
        if k == K:
            for a, b_, out in zip(RF.partition_payload_table(*pargs),
                                  RF.partition_payload_table_plain(*pargs),
                                  ("new leaf map", "sort key", "payload")):
                same(a, b_, f"partition_payload_table {out} (K = {k})")
        # an all-numeric plan: the identity table is the numeric rule
        fp = torch.as_tensor(rng.integers(0, Fb, size=k, dtype=np.int32),
                             device=dev)
        num = (fp, d["thr"], d["dl"], d["nanb"])
        cid, tid = RF.decision_table(*num, feat_col=ident_col,
                                     inv_table=ident_inv)
        for a, b_, out in zip(
                RF.partition_select_table(bins_t, lor, mask, cid, tid, *rest),
                RF.partition_select(bins_t, lor, mask, *num, *rest),
                ("new leaf map", "sort key")):
            same(a, b_, f"partition_select_table (identity table) vs "
                        f"partition_select {out} (K = {k})")
        for a, b_, out in zip(
                RF.partition_payload_table(bins_t, words, g, h, lor, mask,
                                           cid, tid, *rest),
                RF.partition_payload(bins_t, words, g, h, lor, mask, *num,
                                     *rest),
                ("new leaf map", "sort key", "payload")):
            same(a, b_, f"partition_payload_table (identity table) vs "
                        f"partition_payload {out} (K = {k})")
        moving = int(torch.isin(lor, d["parents"][d["validk"] > 0]).sum())
        sl[k] = (sargs, pargs, moving)
    # shared memory of a payload block at K = 84 (the widest table) and
    # this plan's W: leaf table, descriptors, the table, the row tile
    head = ((2048 + 2048 // 32 + 4 + 8 * 2 * K + 3) // 4 * 4) * 4
    tile = min(1024, (32 * 1024 // (4 * (W + 3))) // 4 * 4) * 4 * (W + 3)
    smem = head + (2 * K * Bd + 15) // 16 * 16 + tile
    print(f"table partition: n = {n:,}, Fb = {Fb} columns (W = {W} words), "
          f"B = {Bd}, tables of {K} x {Bd} and {2 * K} x {Bd} bytes; "
          f"payload block shared memory at K = {2 * K}: {smem:,} bytes of "
          f"232,448", flush=True)

    def row(name, fn, plain, nbytes, k):
        if launches_per_call(torch, fn) != 1:
            fail(f"{name}: {launches_per_call(torch, fn)} launches a call")
        _, dms = device_per_call(torch, fn)
        ms = time_ms(torch, fn, flush)
        pms = time_ms(torch, plain, flush, reps=3)
        b, by = bound_ms(nbytes, 2 * k * n)
        print(f"kernel {name} (K = {k}): ms={ms:.4f} device_ms={dms} "
              f"plain_ms={pms:.4f} bound_ms={b:.4f} ({by}); bitwise vs "
              f"plain and (identity table) vs the numeric kernel; one "
              f"launch a call", flush=True)
        return dict(name=name, route="cuda",
                    source="lightgbm_tpu_torch/csrc/partition.cu",
                    replaces=("lightgbm_tpu/ops/round_fuse.py:164"
                              if "payload" in name else
                              "lightgbm_tpu/ops/round_fuse.py:76"),
                    launches=0, max_abs_err=0.0, ms=ms, plain_ms=pms,
                    bound_ms=b, bound_by=by, library_ms=None)

    sargs, pargs, mv = sl[K]
    tbytes = K * Bd + 20 * K
    rows.append(row("partition_payload_table",
                    lambda: RF.partition_payload_table(*pargs),
                    lambda: RF.partition_payload_table_plain(*pargs),
                    n * (4 * W + 16) + n * (4 * (W + 3) + 8) + tbytes, K))
    sargs, _, mv = sl[2 * K]
    rows.append(row("partition_select_table",
                    lambda: RF.partition_select_table(*sargs),
                    lambda: RF.partition_select_table_plain(*sargs),
                    8 * n + mv + 8 * n + 2 * K * Bd + 40 * K, 2 * K))
    RF.table_launches = RF.select_table_launches = 0
    return rows


def check_bundled(torch, lgbt, HK, RF, TB, prng):
    """Phase 7: EFB-bundled training on the card.  1M rows of synth_bundled
    (F numeric columns plus 256 one-hot columns; EFB bundles the 284
    features into a few dozen physical columns) and a 200k-row valid set:
    the decision-table partition's kernel checks (check_table_partition);
    the default recipe, nothing else set, 10 rounds through the fused loop
    twice (the same text byte for byte) and the classic loop once (the
    same text), with s/round, peak memory and held-out AUC beside the same
    data with ``enable_bundle=false``; the pooled recipe (1M x 3,
    ``histogram_pool_size=8``: ``partition_select_table``); a profiled
    fused chunk (the table partition's device ms and launches a tree, the
    wrappers' counts equal to the profiler's kernels); early stopping on
    the valid set (patience 1), fused and classic to the same
    best_iteration;
    ``Booster.predict`` of the bundled model on the valid rows through the
    forest kernel, against the host walk; 100k x 1 on the card against
    ``device_type=cpu``: tree 0 identical, AUC within 1e-3.  Returns the
    table partition's kernel rows with the fused runs' launches."""
    from lightgbm_tpu_torch.boosting import fused_graph as FG
    from lightgbm_tpu_torch.boosting import gbdt as G
    from lightgbm_tpu_torch.ops import forest_kernels as FK
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(7)
    X, y, w = synth_bundled(N, rng)
    Xv, yv, _ = synth_bundled(N_BVALID, rng, w)
    t0 = time.perf_counter()
    ds = lgbt.Dataset(X, y, params={"max_bin": 255}).construct()
    t_ds = time.perf_counter() - t0
    inner = ds.inner
    Fv, Fb = inner.num_features, inner.bins.shape[1]
    if inner.bundle_plan is None:
        fail("phase 7: EFB did not bundle the one-hot columns")
    print(f"bundled: {N:,} rows, Fv = {Fv} features in Fb = {Fb} columns "
          f"(device bins {inner.device_n_bins()}), dataset {t_ds:.2f} s; "
          f"unbundled u8 bins {N * Fv / 1e6:.1f} MB, bundled "
          f"{N * Fb / 1e6:.1f} MB; the expanded [{K}, {Fv}, "
          f"{inner.device_n_bins()}, 4] f32 round tensor "
          f"{K * Fv * inner.device_n_bins() * 16 / 1e6:.1f} MB", flush=True)
    rows = check_table_partition(torch, RF, inner, flush)

    # the default recipe, fused twice and classic once: counts zeroed just
    # before the first fused run, read just after
    zero_counts(HK, RF, TB, prng)
    FG.counts.update(replays=0, reads=0, extra=0, rounds=0)
    bst, per_f, wall_f, peak_f = fused_train(torch, lgbt, ds, 10)
    counts = launch_counts(HK, RF, TB, prng)
    fc = dict(FG.counts)
    if counts["partition_payload_table"] <= 0 or counts["partition_payload"]:
        fail(f"bundled fused run: partition launches {counts}")
    if fc["rounds"] != 10 or fc["reads"] != fc["replays"]:
        fail(f"bundled fused run: rounds/replays/reads {fc}")
    a_f = auc(yv, bst.predict(Xv))
    text = bst.model_to_string()
    again, *_ = fused_train(torch, lgbt, ds, 10)
    classic, per_c, _, peak_c = fused_train(torch, lgbt, ds, 10,
                                            classic=True)
    if again.model_to_string() != text:
        fail("bundled: two fused card trainings gave different model text")
    if classic.model_to_string() != text:
        fail("bundled: the classic loop's model text differs from the "
             "fused loop's")
    print(f"bundled (default recipe, 1M x 10, fused): s/round {per_f:.5f}, "
          f"train() {wall_f:.3f} s, peak device memory {peak_f:.1f} MiB, "
          f"held-out AUC {a_f:.6f}, replays {fc['replays']} (extra "
          f"{fc['extra']}), flag reads {fc['reads']}; kernel launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}; classic "
          f"s/round {per_c:.5f}, peak {peak_c:.1f} MiB", flush=True)
    print(f"model text sha256 (bundled, 1M x 10): {text_sha256(bst)}; "
          f"fused twice and classic once: byte-identical", flush=True)
    launches = {"partition_payload_table": counts["partition_payload_table"]}
    del again, classic

    # the same data with enable_bundle=false
    t0 = time.perf_counter()
    ds_off = lgbt.Dataset(X, y, params={"max_bin": 255, "verbosity": -1,
                                        "enable_bundle": False}).construct()
    t_off = time.perf_counter() - t0
    off, per_o, wall_o, peak_o = fused_train(torch, lgbt, ds_off, 10,
                                             enable_bundle=False)
    if off._gbdt.bundle is not None:
        fail("enable_bundle=false trained with a bundle")
    a_o = auc(yv, off.predict(Xv))
    print(f"bundled vs enable_bundle=false (1M x 10, fused; {Fb} vs "
          f"{off._gbdt.bins.shape[1]} columns): s/round {per_f:.5f} vs "
          f"{per_o:.5f}, train() {wall_f:.3f} vs {wall_o:.3f} s, peak "
          f"{peak_f:.1f} vs {peak_o:.1f} MiB, held-out AUC {a_f:.6f} vs "
          f"{a_o:.6f} (dataset {t_ds:.2f} vs {t_off:.2f} s)", flush=True)
    del off, ds_off

    # the pooled recipe: partition_select_table
    zero_counts(HK, RF, TB, prng)
    pooled, per_p, _, peak_p = fused_train(torch, lgbt, ds, 3,
                                           histogram_pool_size=8)
    tp = {"partition_payload_table": RF.table_launches,
          "partition_select_table": RF.select_table_launches}
    if tp["partition_select_table"] <= 0 or tp["partition_payload_table"]:
        fail(f"bundled pooled run: table partition launches {tp}")
    launches["partition_select_table"] = tp["partition_select_table"]
    print(f"bundled pooled (histogram_pool_size=8, 1M x 3, fused): s/round "
          f"{per_p:.5f}, peak {peak_p:.1f} MiB, "
          f"{pooled._gbdt.hp.hist_pool_slots} slots; table partition "
          f"launches {json.dumps(tp)}", flush=True)
    del pooled

    # a profiled fused chunk: the table partition's device time
    g = bst._gbdt
    for attempt in range(3):
        zero_counts(HK, RF, TB, prng)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            g.train_fused(10)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        work = profiler_work(prof, "bundled profile")
        if work is None:
            fail("bundled profile: not measured")
        booked = launch_counts(HK, RF, TB, prng)
        bad = symbol_mismatch(work, booked)
        if not bad:
            break
    else:
        fail(f"bundled profile: wrapper launches vs the profiler's {bad}")
    tab = [(cnt, us) for nm, cnt, us in work
           if re.search(r"partition_kernel<true, \d+, true>", nm)]
    t_cnt = sum(c for c, _ in tab)
    t_us = sum(u for _, u in tab)
    busy = sum(us for _, _, us in work) / 1e3
    print(f"bundled profile (a chunk of 10 fused rounds): {wall:.1f} ms "
          f"wall, device busy {busy:.2f} ms, {sum(c for _, c, _ in work)} "
          f"launches; the table partition {t_cnt / 10:.1f} launches a tree, "
          f"{t_us / 1e3 / max(t_cnt, 1):.4f} ms of device time a launch "
          f"({t_us / 1e4:.3f} ms a tree)", flush=True)
    for ms, cnt, nm in sorted(((us / 1e3, cnt, nm) for nm, cnt, us in work),
                              reverse=True)[:6]:
        print(f"  {ms:8.3f} ms {cnt:6d}x {nm[:90]}", flush=True)
    del bst, g

    # early stopping on the valid set, fused and classic, trained on the
    # first 100k rows (the cross-check's data; 1M rows at lr 0.5 do not
    # stop within 100 rounds)
    dsx = lgbt.Dataset(X[:N_BCROSS], y[:N_BCROSS],
                       params={"max_bin": 255, "verbosity": -1}).construct()
    vs = dsx.create_valid(Xv, yv)
    res = {}
    for loop in ("fused", "classic"):
        orig = G.GBDT.supports_fused
        if loop == "classic":
            G.GBDT.supports_fused = lambda self: False
        try:
            t0 = time.perf_counter()
            b = lgbt.train(dict(RECIPE, metric="auc", learning_rate=1.0),
                           dsx, num_boost_round=100, valid_sets=[vs],
                           valid_names=["held_out"],
                           callbacks=[lgbt.early_stopping(1, verbose=False)])
            t_es = time.perf_counter() - t0
        finally:
            G.GBDT.supports_fused = orig
        res[loop] = (b.best_iteration, b.num_trees(),
                     b.best_score["held_out"]["auc"], t_es)
        es_model = b
    (bi_f, nt_f, dev_f, t_f), (bi_c, nt_c, dev_c, t_c) = res["fused"], \
        res["classic"]
    print(f"bundled early stopping ({N_BCROSS:,} x <= 100, lr 1.0, 200k "
          f"valid, auc, "
          f"patience 1): best_iteration fused {bi_f} classic {bi_c}, trees "
          f"{nt_f} / {nt_c}, device AUC {dev_f:.6f} / {dev_c:.6f}, train s "
          f"{t_f:.2f} / {t_c:.2f}", flush=True)
    if bi_f != bi_c or nt_f != nt_c or dev_f != dev_c:
        fail("bundled early stopping: the fused and classic loops differ")
    if not 0 < bi_f < 100:
        fail(f"bundled early stopping did not stop early ({bi_f})")

    # Booster.predict of the bundled model through the forest kernel
    # (N_BVALID rows x its trees is below DEVICE_PREDICT_MIN_WORK, so the
    # threshold is lowered for this call, as the CPU tests lower it)
    FK.launches = 0
    orig = G.GBDT.DEVICE_PREDICT_MIN_WORK
    G.GBDT.DEVICE_PREDICT_MIN_WORK = 0
    try:
        t0 = time.perf_counter()
        raw = es_model.predict(Xv, raw_score=True)
        t_pred = time.perf_counter() - t0
    finally:
        G.GBDT.DEVICE_PREDICT_MIN_WORK = orig
    n_fk = FK.launches
    host = es_model.predict(Xv[:N_HOST_CHECK], raw_score=True)
    if n_fk < 1 or not np.allclose(raw[:N_HOST_CHECK], host, rtol=2e-5,
                                   atol=2e-6):
        fail(f"bundled predict: {n_fk} forest launches, max abs diff vs "
             f"the host walk {np.abs(raw[:N_HOST_CHECK] - host).max()}")
    a_p = auc(yv, raw)
    print(f"bundled predict ({N_BVALID:,} valid rows x {nt_f} trees, the "
          f"forest kernel: {n_fk} launch(es)): {t_pred:.3f} s, AUC "
          f"{a_p:.6f} (device valid AUC {dev_f:.6f}); within rtol 2e-5 / "
          f"atol 2e-6 of the host walk on {N_HOST_CHECK:,} rows",
          flush=True)
    del es_model, vs, raw

    # cross-check: 100k x 1 on the card against the CPU
    t0 = time.perf_counter()
    b_gpu, _, _, _ = fused_train(torch, lgbt, dsx, 1)
    b_cpu = lgbt.train(dict(RECIPE, device_type="cpu"), dsx,
                       num_boost_round=1)
    t_x = time.perf_counter() - t0
    t_g, t_c = b_gpu._gbdt.models[0], b_cpu._gbdt.models[0]
    a_g, a_c = auc(yv, b_gpu.predict(Xv)), auc(yv, b_cpu.predict(Xv))
    if not (t_g.num_leaves == t_c.num_leaves
            and np.array_equal(t_g.split_feature, t_c.split_feature)
            and np.array_equal(t_g.threshold_bin, t_c.threshold_bin)
            and np.array_equal(t_g.decision_type, t_c.decision_type)):
        fail("bundled cross-check: tree 0 differs between the card and the "
             "CPU")
    if abs(a_g - a_c) > 1e-3:
        fail(f"bundled cross-check: AUC card {a_g} vs cpu {a_c}")
    print(f"bundled cross-check ({N_BCROSS:,} x 1): tree 0 identical "
          f"({t_g.num_leaves} leaves), AUC card {a_g:.6f} cpu {a_c:.6f} "
          f"({t_x:.1f} s)", flush=True)
    print(f"phase 7: {time.perf_counter() - t_phase:.1f} s", flush=True)
    for r in rows:
        r["launches"] = launches[r["name"]]
    return rows


# ---- phase 8: categorical features

#: phase 8's data: the Data Expo 2009 airline on-time shape in the 8-column
#: form of the szilard/benchm-ml benchmark (LightGBM's own categorical
#: experiment): its columns, the levels of the categorical ones and their
#: positions
AIR_COLS = ("Month", "DayofMonth", "DayOfWeek", "DepTime", "UniqueCarrier",
            "Origin", "Dest", "Distance")
AIR_LEVELS = dict(Month=12, DayofMonth=31, DayOfWeek=7, UniqueCarrier=22,
                  Origin=300, Dest=300)
AIR_CAT = [0, 1, 2, 4, 5, 6]
N_AVALID = 200_000
N_ACROSS = 100_000


def synth_airline(n, rng, eff=None):
    """Seeded rows of the airline shape: Month, DayofMonth, DayOfWeek,
    UniqueCarrier, Origin and Dest integer-coded (Origin and Dest drawn
    Zipf-like from 300 airports, so the rarest fold into bin 0 past
    max_bin), DepTime (hhmm, 0-2359) and Distance (log-normal miles); the
    label dep_delayed_15min from per-level effects of the carrier, origin,
    destination and month, a departure-hour term and logistic noise."""
    if eff is None:
        eff = {c: rng.normal(0.0, sd, AIR_LEVELS[c])
               for c, sd in (("Month", 0.3), ("UniqueCarrier", 0.4),
                             ("Origin", 0.5), ("Dest", 0.5))}
    zipf = 1.0 / np.arange(1, 301) ** 1.1
    zipf /= zipf.sum()
    month = rng.integers(0, 12, n)
    carrier = rng.integers(0, 22, n)
    origin = rng.choice(300, n, p=zipf)
    dest = rng.choice(300, n, p=zipf)
    hour = np.clip(rng.normal(13.5, 4.5, n), 0.0, 23.99)
    X = np.empty((n, 8), np.float32)
    X[:, 0] = month + 1
    X[:, 1] = rng.integers(1, 32, n)
    X[:, 2] = rng.integers(1, 8, n)
    X[:, 3] = np.floor(hour) * 100 + np.floor(hour % 1 * 60)
    X[:, 4], X[:, 5], X[:, 6] = carrier, origin, dest
    X[:, 7] = np.clip(rng.lognormal(6.4, 0.6, n), 30, 5000).round()
    logit = (eff["Month"][month] + eff["UniqueCarrier"][carrier]
             + eff["Origin"][origin] + eff["Dest"][dest]
             + 0.12 * (hour - 13.5) - 1.4)
    y = (logit + rng.logistic(size=n) > 0).astype(np.float32)
    return X, y, eff


#: phase 8's constructed airline Dataset, which phase 13 trains on again
AIR_DATA = {}


def airline_dataset(lgbt, X=None, y=None):
    """The 1M-row airline-shaped Dataset of phase 8 (``synth_airline`` of
    seed 8), binned once and kept in AIR_DATA."""
    if "train" not in AIR_DATA:
        if X is None:
            X, y, _ = synth_airline(N, np.random.default_rng(8))
        AIR_DATA["train"] = lgbt.Dataset(
            X, y, params={"max_bin": 255, "verbosity": -1},
            feature_name=list(AIR_COLS),
            categorical_feature=AIR_CAT).construct()
    return AIR_DATA["train"]


def check_cat_table_partition(torch, RF, inner, flush):
    """Phase 8 (f): ``partition_payload_table`` and
    ``partition_select_table`` at K = 42 on the 1M airline rows, the
    categorical slots' table rows random bitsets (``decision_table`` with
    ``is_cat``), each bit for bit against its plain twin on every output,
    one launch a call, timed beside its byte bound."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(18)
    n, Fb = inner.bins.shape
    Bd = inner.device_n_bins()
    cat_np = inner.categorical_array()
    nb = inner.num_bins_array()
    bins_t = torch.as_tensor(np.ascontiguousarray(inner.bins.T), device=dev)
    words = torch.as_tensor(inner.packed_mirror(), device=dev)
    W = words.shape[1]
    g = torch.as_tensor(rng.normal(size=n).astype(np.float32), device=dev)
    h = torch.as_tensor(rng.random(n).astype(np.float32), device=dev)
    lor = torch.as_tensor(rng.integers(0, 128, size=n, dtype=np.int32),
                          device=dev)
    mask = torch.as_tensor((rng.random(n) >= 0.1).astype(np.int32),
                           device=dev)
    feats = rng.integers(0, Fb, K).astype(np.int32)
    par = rng.permutation(128)[:K].astype(np.int32)
    new = (128 + np.arange(K)).astype(np.int32)
    d = {nm: torch.as_tensor(v, device=dev) for nm, v in dict(
        feats=feats,
        thr=np.array([rng.integers(0, max(nb[f] - 1, 1)) for f in feats],
                     np.int32),
        dl=rng.integers(0, 2, size=K, dtype=np.int32),
        nanb=inner.nan_bin_array()[feats].astype(np.int32),
        parents=par, new_leaves=new,
        validk=(np.arange(K) < K - 3).astype(np.int32),
        smaller=np.where(rng.random(K) < 0.5, par, new).astype(
            np.int32)).items()}
    bitsets = torch.as_tensor(rng.random((K, Bd)) < 0.5, device=dev)
    cols, tab = RF.decision_table(
        d["feats"], d["thr"], d["dl"], d["nanb"],
        is_cat=torch.as_tensor(cat_np, device=dev), bitsets=bitsets)
    catk = torch.as_tensor(cat_np[feats], device=dev)
    if not (torch.equal(tab[catk].bool(), bitsets[catk])
            and torch.equal(cols, d["feats"])):
        fail("decision_table: a categorical slot's row is not its bitset")
    rest = tuple(d[nm] for nm in PART_DESC[4:])
    sargs = (bins_t, lor, mask, cols, tab, *rest)
    pargs = (bins_t, words, g, h, lor, mask, cols, tab, *rest)
    for kern, plain, args, outs in (
            (RF.partition_select_table, RF.partition_select_table_plain,
             sargs, ("new leaf map", "sort key")),
            (RF.partition_payload_table, RF.partition_payload_table_plain,
             pargs, ("new leaf map", "sort key", "payload"))):
        for a, b_, out in zip(kern(*args), plain(*args), outs):
            if a.shape != b_.shape or not torch.equal(a, b_):
                fail(f"{kern.__name__} {out} (categorical table, K = "
                     f"{K}): kernel differs from its plain version")
    moving = int(torch.isin(lor, d["parents"][d["validk"] > 0]).sum())
    for name, fn, plain, nbytes in (
            ("partition_payload_table",
             lambda: RF.partition_payload_table(*pargs),
             lambda: RF.partition_payload_table_plain(*pargs),
             n * (4 * W + 16) + n * (4 * (W + 3) + 8) + K * Bd + 20 * K),
            ("partition_select_table",
             lambda: RF.partition_select_table(*sargs),
             lambda: RF.partition_select_table_plain(*sargs),
             8 * n + moving + 8 * n + K * Bd + 20 * K)):
        lpc = launches_per_call(torch, fn)
        if lpc != 1:
            fail(f"{name} (categorical table): {lpc} launches a call")
        _, dms = device_per_call(torch, fn)
        ms = time_ms(torch, fn, flush)
        pms = time_ms(torch, plain, flush, reps=3)
        b, by = bound_ms(nbytes, 2 * K * n)
        print(f"kernel {name} (categorical table, K = {K}, n = {n:,}, Fb "
              f"= {Fb}, W = {W}, B = {Bd}): ms={ms:.4f} device_ms={dms} "
              f"plain_ms={pms:.4f} bound_ms={b:.4f} ({by}); bitwise vs "
              f"plain on every output; one launch a call", flush=True)
    RF.table_launches = RF.select_table_launches = 0


def split_profile(work, rounds):
    """ms of device time a round by group: the sorts (split finding's
    sorted-subset scans and bitsets, PyTorch's sort kernels), the
    histogram passes, the partition and the rest (PyTorch's elementwise,
    scan and indexing kernels: the rest of split finding and the round's
    bookkeeping)."""
    groups = collections.Counter()
    for nm, cnt, us in work:
        if re.search(r"[Ss]ort", nm):
            key = "sorts"
        elif re.search(r"masked_cluster|radix_single_cluster|rows_channel",
                       nm):
            key = "histogram passes"
        elif "partition_kernel" in nm:
            key = "partition"
        else:
            key = "rest"
        groups[key] += us / 1e3 / rounds
    return {k: round(v, 4) for k, v in sorted(groups.items())}


def check_categorical(torch, lgbt, HK, RF, TB, prng):
    """Phase 8: categorical features on the card, on the airline shape
    (synth_airline: 1M training rows, a 200k held-out set, the six
    categorical columns named in ``categorical_feature``, phase 3's
    recipe).  (a) the default recipe 10 rounds through the fused loop
    twice and the classic loop once: byte-identical text, s/round, peak
    memory, every kernel's launches a tree (counts zeroed just before the
    first fused run, read just after; the table partition must run, the
    numeric one never), and a second fused chunk that allocates nothing;
    (b) the pooled default (``histogram_pool_size=4``: 128 slots of the 8
    columns' histograms, 1M x 5: ``partition_select_table``); (c) the strict default at 90k x 5; (d)
    ``max_cat_to_onehot=8`` (DayOfWeek one-hot) at 100k x 3, tree 0 equal
    on the card and the CPU; (e) 100k x 5 on the card and the CPU with the
    held-out set as a valid set: tree 0 equal, AUCs within 1e-3, each
    run's device valid AUC within 1e-4 of its ``predict`` AUC; (f) the two
    table kernels at K = 42 with categorical bitset rows
    (check_cat_table_partition); (g) the same columns trained as numeric
    codes (s/round and AUC beside the categorical run); (h) a profiled
    fused chunk: the device time of the sorts against the histogram
    passes.  Returns the table kernels' launches in (a) and (b)."""
    from lightgbm_tpu_torch.boosting import fused_graph as FG
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(8)
    X, y, eff = synth_airline(N, rng)
    Xv, yv, _ = synth_airline(N_AVALID, rng, eff)
    t0 = time.perf_counter()
    ds = airline_dataset(lgbt, X, y)
    t_ds = time.perf_counter() - t0
    inner = ds.inner
    nb = inner.num_bins_array()
    if list(np.flatnonzero(inner.categorical_array())) != AIR_CAT:
        fail(f"phase 8: categorical columns "
             f"{np.flatnonzero(inner.categorical_array())}")
    print(f"categorical (airline shape): {N:,} rows x {len(AIR_COLS)} "
          f"columns, categorical {[AIR_COLS[c] for c in AIR_CAT]}, bins "
          f"{dict(zip(AIR_COLS, nb.tolist()))}, dataset {t_ds:.2f} s, "
          f"delayed share {y.mean():.4f}", flush=True)

    # (a) the default recipe: fused twice, classic once
    zero_counts(HK, RF, TB, prng)
    FG.counts.update(replays=0, reads=0, extra=0, rounds=0)
    bst, per_f, wall_f, peak_f = fused_train(torch, lgbt, ds, 10)
    counts = launch_counts(HK, RF, TB, prng)
    fc = dict(FG.counts)
    g = bst._gbdt
    if not g.hp.has_categorical or not g._use_batched_grower():
        fail("phase 8: the default recipe did not take the batched grower "
             "with categorical splits")
    need = ("partition_payload_table", "take_small_table",
            "histogram_radix_single", "histogram_payload")
    if any(counts[k] <= 0 for k in need) or counts["partition_payload"]:
        fail(f"categorical fused run: kernel launches {counts}")
    if fc["rounds"] != 10 or fc["reads"] != fc["replays"]:
        fail(f"categorical fused run: rounds/replays/reads {fc}")
    n_cat = sum(len(t.cat_threshold) for t in g.models)
    if n_cat < 10:
        fail(f"categorical fused run: {n_cat} categorical splits in 10 "
             f"trees")
    a_f = auc(yv, bst.predict(Xv))
    text = bst.model_to_string()
    again, *_ = fused_train(torch, lgbt, ds, 10)
    classic, per_c, _, peak_c = fused_train(torch, lgbt, ds, 10,
                                            classic=True)
    if again.model_to_string() != text:
        fail("categorical: two fused card trainings gave different text")
    if classic.model_to_string() != text:
        fail("categorical: the classic loop's model text differs from the "
             "fused loop's")
    per_tree = {k: v / 10 for k, v in counts.items() if v}
    print(f"categorical (default recipe, 1M x 10, fused): s/round "
          f"{per_f:.5f}, train() {wall_f:.3f} s, peak device memory "
          f"{peak_f:.1f} MiB, held-out AUC {a_f:.6f}, {n_cat} categorical "
          f"splits in 10 trees, replays {fc['replays']} (extra "
          f"{fc['extra']}), flag reads {fc['reads']}; kernel launches a "
          f"tree {json.dumps(per_tree)}; classic s/round {per_c:.5f}, peak "
          f"{peak_c:.1f} MiB", flush=True)
    print(f"model text sha256 (categorical, 1M x 10): {text_sha256(bst)}; "
          f"fused twice and classic once: byte-identical", flush=True)
    launches = {"partition_payload_table": counts["partition_payload_table"],
                "partition_select_table": 0}
    del again, classic

    # (h) a profiled fused chunk, then one that must allocate nothing
    for attempt in range(3):
        zero_counts(HK, RF, TB, prng)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            g.train_fused(10)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        work = profiler_work(prof, "categorical profile")
        if work is None:
            fail("categorical profile: not measured")
        bad = symbol_mismatch(work, launch_counts(HK, RF, TB, prng))
        if not bad:
            break
    else:
        fail(f"categorical profile: wrapper launches vs the profiler's "
             f"{bad}")
    busy = sum(us for _, _, us in work) / 1e3
    n_sort = sum(c for nm, c, _ in work if re.search(r"[Ss]ort", nm))
    print(f"categorical profile (a chunk of 10 fused rounds): {wall:.1f} ms "
          f"wall, device busy {busy:.2f} ms, "
          f"{sum(c for _, c, _ in work)} launches ({n_sort / 10:.1f} sort "
          f"launches a round); device ms a round by group "
          f"{json.dumps(split_profile(work, 10))}", flush=True)
    for ms, cnt, nm in sorted(((us / 1e3, cnt, nm) for nm, cnt, us in work),
                              reverse=True)[:8]:
        print(f"  {ms:8.3f} ms {cnt:6d}x {nm[:90]}", flush=True)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    g.train_fused(10)
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    print(f"categorical capture: a chunk of 10 replays allocated "
          f"{mem1 - mem0} bytes outside the graph's pool (device memory "
          f"{mem0:,} -> {mem1:,})", flush=True)
    if mem1 != mem0:
        fail("categorical fused chunk allocated device memory outside the "
             "graph's pool")
    del bst, g

    # (b) the pooled default: 4 MB hold 128 of the 8 columns' leaf
    # histograms, as 8 MB hold 128 of phase 3's 28 columns'
    zero_counts(HK, RF, TB, prng)
    pooled, per_p, _, peak_p = fused_train(torch, lgbt, ds, 5,
                                           histogram_pool_size=4)
    if pooled._gbdt.hp.hist_pool_slots != 128:
        fail(f"histogram_pool_size=4 gave {pooled._gbdt.hp.hist_pool_slots} "
             f"slots, not 128")
    tp = {"partition_payload_table": RF.table_launches,
          "partition_select_table": RF.select_table_launches,
          "partition_select": RF.select_launches}
    if tp["partition_select_table"] <= 0 or tp["partition_payload_table"] \
            or tp["partition_select"]:
        fail(f"categorical pooled run: partition launches {tp}")
    launches["partition_select_table"] = tp["partition_select_table"]
    print(f"categorical pooled (histogram_pool_size=4, 1M x 5, fused): "
          f"s/round {per_p:.5f}, peak {peak_p:.1f} MiB, "
          f"{pooled._gbdt.hp.hist_pool_slots} slots, AUC "
          f"{auc(yv, pooled.predict(Xv)):.6f}; partition launches "
          f"{json.dumps(tp)}", flush=True)
    del pooled

    # (g) the same columns as numeric codes
    ds_num = lgbt.Dataset(X, y, params={"max_bin": 255,
                                        "verbosity": -1}).construct()
    num, per_n, wall_n, peak_n = fused_train(torch, lgbt, ds_num, 10)
    if num._gbdt.hp.has_categorical:
        fail("the numeric-code run trained with categorical splits")
    a_n = auc(yv, num.predict(Xv))
    print(f"categorical vs numeric codes (1M x 10, fused): s/round "
          f"{per_f:.5f} vs {per_n:.5f}, peak {peak_f:.1f} vs {peak_n:.1f} "
          f"MiB, held-out AUC {a_f:.6f} vs {a_n:.6f}", flush=True)
    del num, ds_num

    # (c) the strict default at 90k rows
    dss = lgbt.Dataset(X[:N_STRICT], y[:N_STRICT],
                       params={"max_bin": 255, "verbosity": -1},
                       categorical_feature=AIR_CAT).construct()
    strict, per_s, wall_s, _ = fused_train(torch, lgbt, dss, 5,
                                           classic=True)
    gs = strict._gbdt
    if gs._use_batched_grower() or gs.hp.hist_dtype != "float32":
        fail("phase 8 (c): the strict default did not run the strict "
             "float32 learner")
    n_cs = sum(len(t.cat_threshold) for t in gs.models)
    print(f"categorical strict default ({N_STRICT:,} x 5, classic): s/round "
          f"{per_s:.4f}, train() {wall_s:.2f} s, {n_cs} categorical splits, "
          f"held-out AUC {auc(yv, strict.predict(Xv)):.6f}", flush=True)
    if n_cs < 5:
        fail(f"phase 8 (c): {n_cs} categorical splits in the strict run")
    del strict, dss

    # (d) max_cat_to_onehot=8 (DayOfWeek one-hot), (e) the cross-check
    dsx = lgbt.Dataset(X[:N_ACROSS], y[:N_ACROSS],
                       params={"max_bin": 255, "verbosity": -1},
                       categorical_feature=AIR_CAT).construct()

    def tree0_equal(a, b):
        ta, tb = a._gbdt.models[0], b._gbdt.models[0]
        return (ta.num_leaves == tb.num_leaves
                and np.array_equal(ta.split_feature, tb.split_feature)
                and np.array_equal(ta.threshold_bin, tb.threshold_bin)
                and np.array_equal(ta.decision_type, tb.decision_type)
                and ta.cat_threshold == tb.cat_threshold)

    t0 = time.perf_counter()
    oh = dict(RECIPE, max_cat_to_onehot=8)
    o_gpu = lgbt.train(oh, dsx, num_boost_round=3)
    # tree 0 is compared: the CPU grows that one
    o_cpu = lgbt.train(dict(oh, device_type="cpu"), dsx, num_boost_round=1)
    dow = AIR_COLS.index("DayOfWeek")
    onehot_nodes = sum(int(((t.decision_type & 1) > 0)[
        np.asarray(t.split_feature) == dow].sum())
        for t in o_gpu._gbdt.models)
    if not tree0_equal(o_gpu, o_cpu):
        fail("phase 8 (d): tree 0 differs between the card and the CPU")
    print(f"categorical max_cat_to_onehot=8 ({N_ACROSS:,}; card 3 rounds, "
          f"CPU 1): tree 0 identical on the card and the CPU "
          f"({o_gpu._gbdt.models[0].num_leaves} leaves), {onehot_nodes} "
          f"DayOfWeek nodes ({time.perf_counter() - t0:.1f} s)", flush=True)
    del o_gpu, o_cpu

    # 5 rounds: held-out airports folded into bin 0 (past max_bin) take
    # bin 0's side in the valid scoring and go right in predict's walk of
    # the raw codes, in the JAX package too; after one tree that share of
    # the rows moves the AUC by more than 1e-4 (0.701863 against
    # 0.701544), after five it no longer does
    t0 = time.perf_counter()
    vs = dsx.create_valid(Xv, yv)
    res = {}
    for dt in ("cuda", "cpu"):
        b = lgbt.train(dict(RECIPE, metric="auc", device_type=dt), dsx,
                       num_boost_round=5, valid_sets=[vs],
                       valid_names=["held_out"])
        a_pred = auc(yv, b.predict(Xv))
        a_dev = b.best_score["held_out"]["auc"]
        if abs(a_dev - a_pred) > 1e-4:
            fail(f"phase 8 (e) {dt}: valid AUC {a_dev} vs predict's "
                 f"{a_pred}")
        res[dt] = (b, a_pred, a_dev)
    (b_g, a_g, v_g), (b_c, a_c, v_c) = res["cuda"], res["cpu"]
    if not tree0_equal(b_g, b_c):
        fail("phase 8 (e): tree 0 differs between the card and the CPU")
    if abs(a_g - a_c) > 1e-3:
        fail(f"phase 8 (e): AUC card {a_g} vs cpu {a_c}")
    print(f"categorical cross-check ({N_ACROSS:,} x 5, 200k valid): tree 0 "
          f"identical ({b_g._gbdt.models[0].num_leaves} leaves), AUC card "
          f"{a_g:.6f} cpu {a_c:.6f}, valid-set AUC card {v_g:.6f} cpu "
          f"{v_c:.6f} ({time.perf_counter() - t0:.1f} s)", flush=True)
    del res, b_g, b_c, vs, dsx

    # (f) the table kernels with categorical bitset rows
    check_cat_table_partition(torch, RF, inner, flush)
    print(f"phase 8: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# ---- phase 9: row sampling and the boosting modes

#: LightGBM's Parameters-Tuning values for bagging
BAG = dict(bagging_fraction=0.8, bagging_freq=5)
#: GOSS at its defaults (top_rate 0.2, other_rate 0.1): with the recipe's
#: learning_rate 0.1 and 10 rounds, rounds 0-4 are the warm-up
GOSS = dict(data_sample_strategy="goss")
N_SCROSS = 100_000


def pass_groups(work, rounds):
    """ms of device time a round of the masked passes on the bins
    (``masked_cluster`` with row source 0, the root pass included), the
    compacted payload passes (row source 2), the fused partition, the
    lambdarank gradients and the rest."""
    groups = collections.Counter()
    for nm, cnt, us in work:
        if "lambdarank_kernel" in nm:
            key = "rank gradients"
        elif re.search(r"masked_cluster<\d+, \d+, 0, |radix_single_cluster",
                       nm):
            key = "masked passes"
        elif re.search(r"masked_cluster<\d+, \d+, 2, ", nm):
            key = "payload passes"
        elif "partition_kernel" in nm:
            key = "partition"
        else:
            key = "rest"
        groups[key] += us / 1e3 / rounds
    return {k: round(v, 4) for k, v in sorted(groups.items())}


#: spin kernels that open profiled_chunk's window (~50 us each)
PREROLL_SPINS = 500


def profiled_chunk(torch, g, what, HK, RF, TB, prng, rounds=5):
    """A fused chunk of ``rounds`` rounds of booster ``g`` under the
    profiler (its device work grouped by :func:`pass_groups`, the wrappers'
    launches held against the profiler's kernels; the window opens with
    PREROLL_SPINS spin kernels, and a chunk whose kernel records disagree
    with the wrappers is measured again, up to 3 chunks, as CUPTI now and
    then loses records: the disagreeing chunks are printed), then a chunk
    that must allocate nothing outside the graph's pool.  Returns the
    groups."""
    from torch.profiler import ProfilerActivity, profile
    lost = []
    for attempt in range(3):
        zero_counts(HK, RF, TB, prng)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # CUPTI has been seen to drop the first records of a window
            # (143 of them, ~3 ms, in a phase-11 chunk): the window opens
            # with 25 ms of spin kernels, left out of the work below
            for _ in range(PREROLL_SPINS):
                torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
            g.train_fused(rounds)
            torch.cuda.synchronize()
        work = profiler_work(prof, f"{what} profile")
        if work is None:
            fail(f"{what} profile: not measured")
        work = [w for w in work if "spin_kernel" not in w[0]]
        bad = symbol_mismatch(work, launch_counts(HK, RF, TB, prng))
        if not bad:
            break
        lost.append(bad)
    else:
        fail(f"{what} profile: wrapper launches vs the profiler's {bad}")
    groups = pass_groups(work, rounds)
    on = {k: v / rounds for k, v in HK.gate_counts().items()}
    busy = sum(us for _, _, us in work) / 1e3 / rounds
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    g.train_fused(rounds)
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    print(f"{what} profile (a chunk of {rounds} fused rounds): device ms a "
          f"round {busy:.3f}, by group {json.dumps(groups)}, "
          f"{sum(c for _, c, _ in work) / rounds:.1f} launches a round, "
          f"gated passes that did work a round {json.dumps(on)}; a chunk "
          f"of {rounds} replays allocated {mem1 - mem0} bytes outside the "
          f"graph's pool; chunks measured again after a lost record "
          f"(profiler, wrappers): {lost}", flush=True)
    if mem1 != mem0:
        fail(f"{what}: a fused chunk allocated device memory outside the "
             f"graph's pool")
    return groups


def sample_draw_cost(torch, g, it, flush):
    """(one-call ms, launches, device ms) of booster ``g``'s captured draw
    (sample_strategy.py ``device_sample_fn``) alone, at iteration ``it``,
    on its current gradients."""
    fn = g._device_sample_fn()
    k0, k1, act = g.sample_strategy.round_words(it)
    dev = g.device
    w0, w1 = (torch.tensor(v, dtype=torch.int64, device=dev)
              for v in (k0, k1))
    active = torch.tensor(bool(act), device=dev)
    grad, hess = g.objective.get_gradients(g.scores[:, 0])
    gg, hh = grad[:, None], hess[:, None]

    def call():
        return fn(w0, w1, active, gg, hh)
    ms = time_ms(torch, call, flush)
    launches, dev_ms = device_per_call(torch, call)
    return ms, launches, dev_ms


def check_bag_kernels(torch, HK, RF, flush):
    """The fused partition and the masked K-leaf pass at K = 42 on 1M rows
    with the bagged default's bag of iteration 0 as the mask, each bit for
    bit against its plain version on the card (the pass in int8, the
    path's dtype, and in float32 against the fixed-point reference), timed
    with and without the bag: the masked pass reads every row either way."""
    from lightgbm_tpu_torch.boosting.sample_strategy import \
        create_sample_strategy
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Metadata
    dev = torch.device("cuda")
    strat = create_sample_strategy(Config(dict(BAG)), N)
    fn = strat.device_sample_fn(Metadata(N), dev)
    k0, k1, act = strat.round_words(0)
    z = torch.zeros(N, 1, device=dev)
    bag = fn(k0, k1, bool(act), z, z)[0]
    share = float(bag.float().mean().item())
    rng = np.random.default_rng(19)
    p = partition_inputs(torch, dev, rng)
    mask = bag.to(torch.int32)
    args = (p["bins"], p["words"], p["g"], p["h"], p["lor"], mask, *p["desc"])
    got = RF.partition_payload(*args)
    want = RF.partition_payload_plain(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail("partition_payload with the bag differs from its plain version")
    outside = (mask == 0) & (got[2][:, -1] != -1)
    if bool(outside.any()):
        fail("partition_payload: an out-of-bag row kept its leaf in the "
             "payload")
    def part(m):
        return lambda: RF.partition_payload(
            p["bins"], p["words"], p["g"], p["h"], p["lor"], m, *p["desc"])
    ms_bag = time_ms(torch, part(mask), flush)
    dev_bag = device_per_call(torch, part(mask))[1]
    lv = rng.permutation(64)[:K].astype(np.int32)
    leaves = torch.as_tensor(lv, device=dev)
    lor_b = torch.where(bag, p["lor"], -1)
    gi = torch.as_tensor(rng.integers(-2, 3, N).astype(np.float32),
                         device=dev)
    hi = torch.as_tensor(rng.integers(0, 5, N).astype(np.float32),
                         device=dev)
    kw = dict(n_bins=B)
    h8 = HK.histogram_leaves_radix2(p["bins"], gi, hi, lor_b, leaves,
                                    hist_dtype="int8", **kw)
    if not torch.equal(h8, HK.histogram_leaves_plain(
            p["bins"], gi, hi, lor_b, leaves, hist_dtype="int8", **kw)):
        fail("histogram_leaves_radix2 (int8) with the bag differs from its "
             "plain version")
    hf = HK.histogram_leaves_radix2(p["bins"], p["g"], p["h"], lor_b,
                                    leaves, hist_dtype="float32", **kw)
    if not torch.equal(hf, HK.histogram_leaves_fixed(
            p["bins"], p["g"], p["h"], lor_b, leaves, hist_dtype="float32",
            **kw)):
        fail("histogram_leaves_radix2 (float32) with the bag differs from "
             "the fixed-point reference")
    sel_bag = int(torch.isin(lor_b, leaves).sum().item())
    sel_all = int(torch.isin(p["lor"], leaves).sum().item())
    def hist(lor):
        return lambda: HK.histogram_leaves_radix2(
            p["bins"], gi, hi, lor, leaves, hist_dtype="int8", **kw)
    pass_bag, pass_all = (time_ms(torch, hist(lor), flush)
                          for lor in (lor_b, p["lor"]))
    pdev_bag, pdev_all = (device_per_call(torch, hist(lor))[1]
                          for lor in (lor_b, p["lor"]))
    ones = torch.ones_like(mask)
    ms_all = time_ms(torch, part(ones), flush)
    dev_all = device_per_call(torch, part(ones))[1]
    print(f"bag kernels (1M rows, K = 42, the bag of iteration 0: "
          f"{share:.4f} of the rows): partition_payload and "
          f"histogram_leaves_radix2 (int8 vs plain, float32 vs fixed-point) "
          f"bit for bit; with the bag / every row, one-call ms (device "
          f"ms): partition {ms_bag:.4f} ({dev_bag:.4f}) / {ms_all:.4f} "
          f"({dev_all:.4f}), masked pass {pass_bag:.4f} ({pdev_bag:.4f}) / "
          f"{pass_all:.4f} ({pdev_all:.4f}) ({sel_bag:,} / {sel_all:,} rows "
          f"selected)", flush=True)


def check_sampling(torch, lgbt, HK, RF, TB, prng):
    """Phase 9: row sampling and the other boosting modes on the card,
    on phase 3's data and recipe.  (a) the bagged default (1M x 10,
    bagging_fraction 0.8, bagging_freq 5): the unbagged default first
    (s/round beside), then fused twice and classic once to the same text,
    kernel launches a tree (counts zeroed just before the first bagged
    run, read just after), the draw's launches and device ms, a profiled
    chunk against the unbagged one's (masked passes, payload passes) and a
    chunk of replays that allocates nothing; (b) the GOSS default (1M x 10:
    five warm-up rounds, then five GOSS rounds in one chunk) the same way;
    (c) the bag's kernels against their plain versions
    (check_bag_kernels); (d) the strict default bagged (90k x 5, classic);
    (e) pos/neg bagging (100k x 3), RF (100k x 5) and DART (100k x 5,
    s/round beside the plain classic loop, and one tree's contribution
    walked over 1M rows, what each drop costs); (f) bagged EFB and
    categorical cells at phase 7's and 8's 100k cross-check sizes; (g)
    the bagged and GOSS (100k x 1: no warm-up) cells on the
    card and the CPU, tree 0 identical.  Returns the bagged run's
    launches."""
    from lightgbm_tpu_torch.boosting import fused_graph as FG
    from lightgbm_tpu_torch.boosting.dart import DART
    from lightgbm_tpu_torch.boosting.gbdt import _tree_to_arrays_stub
    from lightgbm_tpu_torch.boosting.rf import RF as RandomForest
    from lightgbm_tpu_torch.models.predict import predict_bins_tree
    t_phase = time.perf_counter()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    ds, X, y, Xv, yv, _ = slice_data(lgbt, N)

    plain, per_0, _, peak_0 = fused_train(torch, lgbt, ds, 10)
    per_0c = fused_train(torch, lgbt, ds, 10, classic=True)[1]
    groups_0 = profiled_chunk(torch, plain._gbdt, "unbagged", HK, RF, TB,
                              prng)
    # the threefry ops a captured round launches (stochastic rounding's
    # two draws; the bag's or GOSS's one more)
    i_prng = list(FG._COUNTERS).index((prng, "launches"))
    prng_0 = list(plain._gbdt._fused_cache.values())[0] \
        .graph_launches["main"][i_prng]
    del plain

    out = {}
    for name, extra in (("bagged", BAG), ("GOSS", GOSS)):
        zero_counts(HK, RF, TB, prng)
        FG.counts.update(replays=0, reads=0, extra=0, rounds=0)
        bst, per_f, wall_f, peak_f = fused_train(torch, lgbt, ds, 10,
                                                 **extra)
        counts = launch_counts(HK, RF, TB, prng)
        fc = dict(FG.counts)
        g = bst._gbdt
        fr = list(g._fused_cache.values())[0]
        if fr.sample_fn is None:
            fail(f"{name} default: the fused round holds no draw")
        need = ("take_small_table", "histogram_radix_single",
                "histogram_radix_joint", "histogram_leaves_radix2",
                "histogram_payload", "partition_payload", "threefry_ops")
        if any(counts[k] <= 0 for k in need):
            fail(f"{name} fused run: kernel launches {counts}")
        if fc["rounds"] != 10 or fc["reads"] != fc["replays"]:
            fail(f"{name} fused run: rounds/replays/reads {fc}")
        text = bst.model_to_string()
        again, *_ = fused_train(torch, lgbt, ds, 10, **extra)
        classic, per_c, _, _ = fused_train(torch, lgbt, ds, 10,
                                           classic=True, **extra)
        if again.model_to_string() != text:
            fail(f"{name}: two fused card trainings gave different text")
        if classic.model_to_string() != text:
            fail(f"{name}: the classic loop's text differs from the fused "
                 f"loop's")
        del again, classic
        # in-bag rows only in the counts: a tree's leaves count the bag
        n_in = [int(sum(t.leaf_count)) for t in g.models]
        a = auc(yv, bst.predict(Xv))
        it = 0 if name == "bagged" else 7
        d_ms, d_launch, d_dev = sample_draw_cost(torch, g, it, flush)
        prng_round = fr.graph_launches["main"][i_prng]
        per_tree = {k: v / 10 for k, v in counts.items() if v}
        print(f"{name} default (1M x 10, fused): s/round {per_f:.5f} "
              f"(unbagged {per_0:.5f}), train() {wall_f:.3f} s, peak "
              f"{peak_f:.1f} MiB (unbagged {peak_0:.1f}), held-out AUC "
              f"{a:.6f}, rows counted by each tree {n_in}; classic s/round "
              f"{per_c:.5f} (unbagged {per_0c:.5f}); fused twice and classic "
              f"once: byte-identical; "
              f"replays {fc['replays']} (extra {fc['extra']}), flag reads "
              f"{fc['reads']}; kernel launches a tree {json.dumps(per_tree)}",
              flush=True)
        print(f"{name} draw (iteration {it}, 1M rows, alone): one call "
              f"{d_ms:.4f} ms, {d_launch} launches, device {d_dev:.4f} ms; "
              f"threefry ops a captured round {prng_round} (unbagged "
              f"{prng_0})", flush=True)
        print(f"model text sha256 ({name} default, 1M x 10): "
              f"{text_sha256(bst)}", flush=True)
        groups = profiled_chunk(torch, g, name, HK, RF, TB, prng)
        print(f"{name} vs unbagged, device ms a round by group: "
              f"{json.dumps(groups)} vs {json.dumps(groups_0)}", flush=True)
        out[name] = counts
        if name == "bagged":
            # one tree's contribution walked over 1M rows (DART walks each
            # dropped tree twice a round and its new tree once more)
            arrs = _tree_to_arrays_stub(g.models[0], g.train_set, g.device)
            walk = time_ms(torch, lambda: predict_bins_tree(
                arrs, g.bins, g.nan_bin_arr, g.bundle), flush, reps=5)
            del arrs
        del bst, g, fr

    # (c) the bag's kernels
    check_bag_kernels(torch, HK, RF, flush)

    # (d) the strict default, bagged: 90k rows, classic
    dss = lgbt.Dataset(X[:N_STRICT], y[:N_STRICT],
                       params={"max_bin": 255, "verbosity": -1}).construct()
    zero_counts(HK, RF, TB, prng)
    strict, per_s, wall_s, _ = fused_train(torch, lgbt, dss, 5,
                                           classic=True, **BAG)
    gs = strict._gbdt
    if gs._use_batched_grower() or gs.supports_fused():
        fail("phase 9 (d): the strict bagged run did not take the strict "
             "learner in the classic loop")
    if HK.radix_single_launches <= 0:
        fail("phase 9 (d): the strict bagged run never launched "
             "histogram_radix_single")
    print(f"strict bagged ({N_STRICT:,} x 5, classic): s/round {per_s:.4f}, "
          f"train() {wall_s:.2f} s, held-out AUC "
          f"{auc(yv, strict.predict(Xv)):.6f}, radix-single launches "
          f"{HK.radix_single_launches}", flush=True)
    del strict, dss

    # (e) pos/neg bagging, RF and DART at 100k rows
    dsx = lgbt.Dataset(X[:N_SCROSS], y[:N_SCROSS],
                       params={"max_bin": 255, "verbosity": -1}).construct()
    pn, per_pn, _, _ = fused_train(
        torch, lgbt, dsx, 3, pos_bagging_fraction=0.5,
        neg_bagging_fraction=0.3, bagging_freq=1)
    print(f"pos/neg bagging ({N_SCROSS:,} x 3, fused, 0.5 / 0.3): s/round "
          f"{per_pn:.5f}, held-out AUC {auc(yv, pn.predict(Xv)):.6f}, rows "
          f"counted by tree 0 {int(sum(pn._gbdt.models[0].leaf_count))}",
          flush=True)
    del pn
    rf, per_rf, _, _ = fused_train(torch, lgbt, dsx, 5, classic=True,
                                   boosting="rf", bagging_fraction=0.8,
                                   bagging_freq=1)
    if not isinstance(rf._gbdt, RandomForest):
        fail("boosting=rf did not build the RF booster")
    a_rf = auc(yv, rf.predict(Xv))
    print(f"RF ({N_SCROSS:,} x 5, classic): s/round {per_rf:.5f}, held-out "
          f"AUC {a_rf:.6f}, tree shrinkage "
          f"{rf._gbdt.models[1].shrinkage:.3f}", flush=True)
    if not a_rf > 0.7:
        fail(f"RF held-out AUC {a_rf}")
    del rf
    base, per_b, _, _ = fused_train(torch, lgbt, dsx, 5, classic=True)
    dart, per_d, _, _ = fused_train(torch, lgbt, dsx, 5, classic=True,
                                    boosting="dart", drop_rate=0.1,
                                    skip_drop=0.5)
    gd = dart._gbdt
    if not isinstance(gd, DART):
        fail("boosting=dart did not build the DART booster")
    pd = dart.predict(X[:N_SCROSS], raw_score=True)
    drift = float(np.abs(pd - gd._host_scores(gd.scores)).max())
    if drift > 1e-3:
        fail(f"DART: train scores drift {drift} from predict")
    scaled = sum(abs(t.shrinkage - 0.1) > 1e-12 for t in gd.models)
    del base
    print(f"DART ({N_SCROSS:,} x 5, classic, drop_rate 0.1, skip_drop 0.5): "
          f"s/round {per_d:.5f} (the plain classic loop {per_b:.5f}), "
          f"{scaled} trees rescaled, train scores within {drift:.2e} of "
          f"predict; one tree's contribution over 1M rows {walk:.3f} ms "
          f"(a drop walks it twice a round, a new tree once more)",
          flush=True)
    del dart, gd

    # (f) bagged EFB and categorical cells, 100k rows, fused and classic
    rng7 = np.random.default_rng(7)
    Xb, yb, _ = synth_bundled(N_BCROSS, rng7)
    dsb = lgbt.Dataset(Xb, yb, params={"max_bin": 255,
                                       "verbosity": -1}).construct()
    rng8 = np.random.default_rng(8)
    Xa, ya, _ = synth_airline(N_ACROSS, rng8)
    dsa = lgbt.Dataset(Xa, ya, params={"max_bin": 255, "verbosity": -1},
                       feature_name=list(AIR_COLS),
                       categorical_feature=AIR_CAT).construct()
    for what, d in (("EFB", dsb), ("categorical", dsa)):
        zero_counts(HK, RF, TB, prng)
        fb, per_x, _, _ = fused_train(torch, lgbt, d, 5, **BAG)
        if RF.table_launches <= 0:
            fail(f"bagged {what}: the table partition never ran")
        cb, *_ = fused_train(torch, lgbt, d, 5, classic=True, **BAG)
        if fb.model_to_string() != cb.model_to_string():
            fail(f"bagged {what}: fused and classic text differ")
        gx = fb._gbdt
        if what == "EFB" and gx.bundle is None:
            fail("bagged EFB: the data was not bundled")
        if what == "categorical" and not gx.hp.has_categorical:
            fail("bagged categorical: no categorical splits")
        print(f"bagged {what} ({d.inner.num_data:,} x 5, fused): s/round "
              f"{per_x:.5f}, table partition launches {RF.table_launches}; "
              f"fused and classic byte-identical", flush=True)
        del fb, cb
    del dsb, dsa

    # (g) card vs CPU: tree 0 of the bagged and GOSS cells
    def tree0_equal(a, b):
        ta, tb = a._gbdt.models[0], b._gbdt.models[0]
        return (ta.num_leaves == tb.num_leaves
                and np.array_equal(ta.split_feature, tb.split_feature)
                and np.array_equal(ta.threshold_bin, tb.threshold_bin)
                and np.array_equal(ta.leaf_count, tb.leaf_count))

    for what, rounds, extra in (("bagged", 1, BAG), ("GOSS", 1, GOSS)):
        t0 = time.perf_counter()
        b_g = lgbt.train(dict(RECIPE, **extra), dsx, num_boost_round=rounds)
        b_c = lgbt.train(dict(RECIPE, device_type="cpu", **extra), dsx,
                         num_boost_round=rounds)
        a_g, a_c = auc(yv, b_g.predict(Xv)), auc(yv, b_c.predict(Xv))
        if not tree0_equal(b_g, b_c):
            fail(f"{what} cross-check: tree 0 differs between the card and "
                 f"the CPU")
        if abs(a_g - a_c) > 1e-3:
            fail(f"{what} cross-check: AUC card {a_g} vs cpu {a_c}")
        print(f"{what} cross-check ({N_SCROSS:,} x {rounds}): tree 0 "
              f"identical ({b_g._gbdt.models[0].num_leaves} leaves, "
              f"{int(sum(b_g._gbdt.models[0].leaf_count)):,} rows counted), "
              f"AUC card {a_g:.6f} cpu {a_c:.6f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        del b_g, b_c
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out["bagged"]


# ---- phase 10: the other objectives and their metrics

#: UCI Covertype's shape: 581,012 rows, 10 numeric columns, 4 wilderness
#: and 40 soil-type one-hot columns, 7 classes with its class counts
COVTYPE_COUNTS = (211_840, 283_301, 35_754, 2_747, 9_493, 17_367, 20_510)
N_COV, N_COV_VALID, N_COV_CROSS = 581_012, 100_000, 100_000
#: the regression family on phase 3's data: a label for each objective
FAMILY = ("huber", "fair", "poisson", "gamma", "tweedie", "cross_entropy",
          "cross_entropy_lambda", "regression_l1", "quantile", "mape")
#: the objectives that renew their leaves on the host (classic loop)
RENEW = ("regression_l1", "quantile", "mape")
#: the multiclass runs' kernels: rows 1, 3, 8-10 and 14
MC_KERNELS = ("take_small_table", "histogram_payload",
              "histogram_leaves_radix2", "histogram_radix_single",
              "histogram_radix_joint", "partition_payload_table")
#: the fused default's s/round of phase 5 (check_fused), for phase 10
FUSED_S_ROUND = {}


def synth_covertype(n, rng, w=None):
    """Covertype-shaped synthetic data: class c's rows draw the 10 numeric
    columns from N(mu_c, 1) and the wilderness area (4) and soil type (40)
    from class-dependent Dirichlet draws, one-hot encoded (0/1, one hot
    column in each block: EFB bundles each block); the classes in
    Covertype's proportions (exactly its counts at n = 581,012)."""
    k = len(COVTYPE_COUNTS)
    if w is None:
        w = (rng.normal(scale=0.6, size=(k, 10)),
             rng.dirichlet(np.full(4, 0.7), size=k),
             rng.dirichlet(np.full(40, 0.3), size=k))
    counts = np.floor(np.array(COVTYPE_COUNTS) * n / N_COV).astype(int)
    counts[1] += n - counts.sum()
    y = np.repeat(np.arange(k), counts)
    rng.shuffle(y)
    X = np.zeros((n, 54), np.float32)
    X[:, :10] = w[0][y] + rng.normal(size=(n, 10))
    r = np.arange(n)
    for off, probs in ((10, w[1]), (14, w[2])):
        cum = np.cumsum(probs, axis=1)[y]
        cat = np.minimum((rng.random(n)[:, None] > cum).sum(1),
                         probs.shape[1] - 1)
        X[r, off + cat] = 1.0
    return X, y.astype(np.float32), w


def family_label(objective, X, w, rng):
    """A label of ``objective``'s family on phase 3's features: Student-t
    noise (3 dof) around the logit for the regression losses, Poisson
    counts, Gamma draws, zero-inflated Gamma (Tweedie) draws, probabilities
    for the cross-entropies."""
    n = X.shape[0]
    z = X @ w * 0.5
    if objective == "poisson":
        return rng.poisson(np.exp(0.3 * z)).astype(np.float32)
    if objective == "gamma":
        return rng.gamma(2.0, np.exp(0.3 * z) / 2.0).astype(np.float32)
    if objective == "tweedie":
        return np.where(rng.random(n) < 0.4, 0.0, rng.gamma(
            2.0, np.exp(0.3 * z) / 2.0)).astype(np.float32)
    if objective.startswith("cross_entropy"):
        return (1.0 / (1.0 + np.exp(-(z + rng.normal(size=n))))) \
            .astype(np.float32)
    return (z + rng.standard_t(3, size=n)).astype(np.float32)


def trees_equal(a, b):
    return (a.num_leaves == b.num_leaves
            and np.array_equal(a.split_feature, b.split_feature)
            and np.array_equal(a.threshold_bin, b.threshold_bin)
            and np.array_equal(a.leaf_count, b.leaf_count))


def check_objectives(torch, lgbt, HK, RF, TB, prng):
    """Phase 10: the other objectives on the card.  (a) multiclass (k = 7)
    on 581,012 Covertype-shaped rows at the HIGGS recipe, 10 rounds (70
    trees) fused twice and classic once to the same text: s/round beside
    7 x phase 5's binary fused round, graph replays and flag reads a
    round, the capture's seconds, peak memory, the path's kernel launches
    a tree (rows 1, 3, 8-10, 14; counts zeroed just before, read just
    after), a profiled chunk of 1 round; (b) a 100k-row valid set with
    multi_logloss and multi_error evaluated inside the round and early
    stopping (fused; the last round's values against the host's float64
    evaluation of the valid scores); (c)
    ``Booster.predict`` of 1M held-out rows through the forest kernel (k
    = 7) against the host walk on 20,000 rows (rtol 2e-5 / atol 2e-6),
    rows/s; (d) multiclassova 100k x 3, fused and classic to the same
    text; (e) the regression family on phase 3's 1M x 28 rows, 5 rounds
    each: the fused objectives fused twice and classic once to the same
    text, l1 / quantile / MAPE classic with their host renewal's seconds
    a tree; (f) card against CPU: multiclass 100k at 15 leaves (round 0's
    7 trees; the CPU trains one round), huber and quantile 100k (tree 0, quantile's
    host-renewed leaf values too; the CPU trains one round)."""
    from lightgbm_tpu_torch.basic import _host_raw
    from lightgbm_tpu_torch.boosting import fused_graph as FG
    from lightgbm_tpu_torch.boosting import gbdt as G
    from lightgbm_tpu_torch.ops import forest_kernels as FK
    t_phase = time.perf_counter()
    rng = np.random.default_rng(10)
    X, y, w = synth_covertype(N_COV, rng)
    if not np.array_equal(np.bincount(y.astype(int)), COVTYPE_COUNTS):
        fail("phase 10: the class counts are not Covertype's")
    Xv, yv, _ = synth_covertype(N_COV_VALID, rng, w)
    Xh, yh, _ = synth_covertype(N, rng, w)
    t0 = time.perf_counter()
    ds = lgbt.Dataset(X, y, params={"max_bin": 255,
                                    "verbosity": -1}).construct()
    t_ds = time.perf_counter() - t0
    if ds.inner.bundle_plan is None:
        fail("phase 10: EFB did not bundle the one-hot columns")
    MC = dict(objective="multiclass", num_class=7)

    # (a) multiclass, fused twice and classic once
    zero_counts(HK, RF, TB, prng)
    FG.counts.update(replays=0, reads=0, extra=0, rounds=0)
    bst, per_f, wall_f, peak_f = fused_train(torch, lgbt, ds, 10, **MC)
    counts = launch_counts(HK, RF, TB, prng)
    fc = dict(FG.counts)
    g = bst._gbdt
    fr = next(iter(g._fused_cache.values()))
    if len(g.models) != 70 or fr.k != 7:
        fail(f"multiclass: {len(g.models)} trees, k = {fr.k}")
    missing = [k for k in MC_KERNELS if counts[k] <= 0]
    if missing or counts["partition_payload"]:
        fail(f"multiclass fused run: kernel launches {counts}")
    # a round: the gradients' graph, then one class body and its flag
    # read a class (more only for a tree still growing)
    if (fc["rounds"] != 10 or fc["replays"] != fc["reads"] + 10
            or fc["reads"] < 70 + fc["extra"]):
        fail(f"multiclass fused run: rounds/replays/reads {fc}")
    text = bst.model_to_string()
    again, *_ = fused_train(torch, lgbt, ds, 10, **MC)
    classic, per_c, _, peak_c = fused_train(torch, lgbt, ds, 10,
                                            classic=True, **MC)
    if again.model_to_string() != text:
        fail("multiclass: two fused card trainings gave different text")
    if classic.model_to_string() != text:
        fail("multiclass: the classic loop's text differs from the fused "
             "loop's")
    del again, classic
    per_tree = {k: round(v / 70, 2) for k, v in counts.items() if v}
    binary = FUSED_S_ROUND.get("default")
    # the valid rows through the forest kernel: below the threshold the
    # host walks the 70 trees (ten rounds of k = 7) a row, which (c) holds
    # the kernel against
    g.DEVICE_PREDICT_MIN_WORK = 0
    acc = float((bst.predict(Xv).argmax(1) == yv).mean())
    del g.DEVICE_PREDICT_MIN_WORK
    print(f"multiclass (Covertype shape {N_COV:,} x 54 in "
          f"{ds.inner.bins.shape[1]} columns, k = 7, 10 rounds = 70 trees; "
          f"dataset {t_ds:.2f} s): fused s/round {per_f:.5f} (7 x phase 5's "
          f"binary fused round at 1M x 28: "
          f"{'not measured' if binary is None else f'{7 * binary:.5f}'}), "
          f"classic {per_c:.5f}; train() {wall_f:.3f} s, warm-up round and "
          f"capture {fr.capture_s:.3f} s, peak {peak_f:.1f} MiB (classic "
          f"{peak_c:.1f}); replays {fc['replays']} (extra {fc['extra']}) "
          f"and flag reads {fc['reads']} in 10 rounds; launches a replay "
          f"{json.dumps({k: sum(v) for k, v in fr.graph_launches.items()})}"
          f"; valid accuracy {acc:.4f}; fused twice and classic once: "
          f"byte-identical", flush=True)
    print("multiclass kernel launches a tree: " + json.dumps(per_tree),
          flush=True)
    print(f"model text sha256 (multiclass, Covertype shape, 10 rounds): "
          f"{text_sha256(bst)}", flush=True)
    profiled_chunk(torch, g, "multiclass", HK, RF, TB, prng, rounds=1)
    del bst, g, fr

    # (b) a valid set evaluated inside the round, early stopping: the
    # round's float32 device values against the host's float64 evaluation
    # of the valid scores the fused loop leaves
    rec = {}
    t0 = time.perf_counter()
    vs = ds.create_valid(Xv, yv)
    bf = lgbt.train(dict(RECIPE, **MC, learning_rate=0.5,
                         metric=["multi_logloss", "multi_error"]),
                    ds, num_boost_round=30, valid_sets=[vs],
                    valid_names=["v"],
                    callbacks=[lgbt.early_stopping(3, verbose=False),
                               lgbt.record_evaluation(rec)])
    torch.cuda.synchronize()
    t_es = time.perf_counter() - t0
    gf = bf._gbdt
    ev = rec["v"]
    rounds_es = len(ev["multi_logloss"])
    if not gf._fused_cache:
        fail("multiclass early stopping: the fused loop did not run")
    if gf.iter_ != rounds_es or not 0 < bf.best_iteration <= rounds_es:
        fail(f"multiclass early stopping: {gf.iter_} rounds trained, "
             f"{rounds_es} evaluated, best {bf.best_iteration}")
    host_scores = gf._host_scores(gf.valid_scores[0])
    host = {m.NAME: m.eval(host_scores, gf.objective)[0][1]
            for m in gf.valid_metrics[0]}
    for name, val in host.items():
        if not np.isclose(ev[name][-1], val, rtol=1e-5, atol=1e-7):
            fail(f"multiclass early stopping: {name} in the round "
                 f"{ev[name][-1]} vs the host's {val}")
    print(f"multiclass early stopping (lr 0.5, <= 30 rounds, {N_COV_VALID:,}"
          f" valid rows, multi_logloss and multi_error on the device inside "
          f"the round, fused): best iteration {bf.best_iteration} of "
          f"{rounds_es} rounds, {t_es:.2f} s; the last round's values "
          f"{ev['multi_logloss'][-1]:.6f} / {ev['multi_error'][-1]:.6f} vs "
          f"the host's float64 {host['multi_logloss']:.6f} / "
          f"{host['multi_error']:.6f}", flush=True)
    del bf, gf

    # (c) Booster.predict of 1M held-out rows through the forest kernel
    bst, *_ = fused_train(torch, lgbt, ds, 10, **MC)
    g = bst._gbdt
    FK.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = bst.predict(Xh, raw_score=True)
    t_pred = time.perf_counter() - t0
    n_fk = FK.launches
    prob = bst.predict(Xh[:20_000])
    host = _host_raw(g.models, Xh[:20_000].astype(np.float64), 7, 0, 10)
    err = float(np.abs(raw[:20_000] - host).max())
    if (n_fk < 1 or raw.shape != (N, 7)
            or not np.allclose(raw[:20_000], host, rtol=2e-5, atol=2e-6)):
        fail(f"multiclass predict: {n_fk} forest launches, shape "
             f"{raw.shape}, max |device - host| {err}")
    if not np.allclose(prob.sum(1), 1.0, atol=1e-5):
        fail("multiclass predict: probabilities do not sum to 1")
    acc_h = float((raw.argmax(1) == yh).mean())
    print(f"multiclass predict ({N:,} held-out rows x 70 trees, k = 7): "
          f"{t_pred:.3f} s, {N / t_pred:,.0f} rows/s, {n_fk} forest-kernel "
          f"launch(es), max |device - host walk| {err:.2e} on 20,000 rows, "
          f"accuracy {acc_h:.4f}", flush=True)
    del bst, g, raw

    # (d) one-vs-all at 100k x 3
    dsc = lgbt.Dataset(X[:N_COV_CROSS], y[:N_COV_CROSS],
                       params={"max_bin": 255, "verbosity": -1}).construct()
    OVA = dict(objective="multiclassova", num_class=7)
    ova, per_o, _, _ = fused_train(torch, lgbt, dsc, 3, **OVA)
    ova_c, per_oc, _, _ = fused_train(torch, lgbt, dsc, 3, classic=True,
                                      **OVA)
    if ova.model_to_string() != ova_c.model_to_string():
        fail("multiclassova: fused and classic text differ")
    print(f"multiclassova ({N_COV_CROSS:,} x 3, k = 7): fused s/round "
          f"{per_o:.5f}, classic {per_oc:.5f}; fused and classic "
          f"byte-identical", flush=True)
    del ova, ova_c

    # (f) card vs CPU, multiclass: round 0's seven trees, cut to 15 leaves
    # (the CPU trains one round: seven 255-leaf trees take it ~50 s; at
    # 100k rows both take the batched int8 learner, exact on both)
    t0 = time.perf_counter()
    MCX = dict(RECIPE, **MC, num_leaves=15)
    b_g = lgbt.train(MCX, dsc, num_boost_round=3)
    b_c = lgbt.train(dict(MCX, device_type="cpu"), dsc, num_boost_round=1)
    same = [trees_equal(a, b) for a, b in zip(b_g._gbdt.models[:7],
                                              b_c._gbdt.models)]
    if len(same) != 7 or not all(same):
        fail(f"multiclass cross-check: round 0's trees card vs CPU {same}")
    print(f"multiclass cross-check ({N_COV_CROSS:,} rows, 15 leaves; card 3 "
          f"rounds, CPU 1): round 0's 7 trees identical "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    del b_g, b_c, dsc, ds

    # (e) the regression family on phase 3's data
    rng = np.random.default_rng(0)
    Xr, yr, wr = synth_higgs(N, F, rng)
    dsr = lgbt.Dataset(Xr, yr, params={"max_bin": 255,
                                       "verbosity": -1}).construct()
    renew_s = []
    real_renew = G.GBDT._renew_leaves

    def timed_renew(self, *a):
        t0 = time.perf_counter()
        try:
            return real_renew(self, *a)
        finally:
            if self.objective.need_renew_tree_output:
                renew_s.append(time.perf_counter() - t0)

    labels = {}
    for objective in FAMILY:
        labels[objective] = family_label(objective, Xr, wr,
                                         np.random.default_rng(11))
        dsr.inner.metadata.set_label(labels[objective])
        extra = dict(objective=objective)
        if objective in RENEW:
            renew_s.clear()
            G.GBDT._renew_leaves = timed_renew
            try:
                b, per, wall, _ = fused_train(torch, lgbt, dsr, 5,
                                              classic=True, **extra)
            finally:
                G.GBDT._renew_leaves = real_renew
            if len(renew_s) != 5 or b._gbdt.supports_fused():
                fail(f"{objective}: {len(renew_s)} host renewals in 5 "
                     f"rounds, fused admitted {b._gbdt.supports_fused()}")
            print(f"{objective} (1M x 28, 5 rounds, classic): s/round "
                  f"{per:.5f}, host renewal {np.mean(renew_s):.4f} s a tree "
                  f"({100 * np.mean(renew_s) / per:.1f}% of the round), "
                  f"train() {wall:.2f} s; sha256 {text_sha256(b)}",
                  flush=True)
            del b
            continue
        zero_counts(HK, RF, TB, prng)
        b, per, wall, _ = fused_train(torch, lgbt, dsr, 5, **extra)
        c1 = launch_counts(HK, RF, TB, prng)
        t1 = b.model_to_string()
        again, *_ = fused_train(torch, lgbt, dsr, 5, **extra)
        classic, per_c, _, _ = fused_train(torch, lgbt, dsr, 5,
                                           classic=True, **extra)
        if again.model_to_string() != t1 or classic.model_to_string() != t1:
            fail(f"{objective}: fused twice and classic once gave different "
                 f"text")
        if any(c1[k] <= 0 for k in ("take_small_table", "partition_payload",
                                    "histogram_radix_single")):
            fail(f"{objective} fused run: kernel launches {c1}")
        p = b.predict(Xr[:10_000])
        if p.shape != (10_000,) or not np.isfinite(p).all():
            fail(f"{objective}: predict gave {p.shape} / non-finite values")
        print(f"{objective} (1M x 28, 5 rounds): fused s/round {per:.5f}, "
              f"classic {per_c:.5f}, train() {wall:.2f} s; fused twice and "
              f"classic once byte-identical; sha256 {text_sha256(b)}",
              flush=True)
        del b, again, classic

    # (f) card vs CPU, huber and quantile: tree 0 (the CPU trains one
    # round)
    for objective in ("huber", "quantile"):
        dsx = lgbt.Dataset(Xr[:N_SCROSS], labels[objective][:N_SCROSS],
                           params={"max_bin": 255,
                                   "verbosity": -1}).construct()
        t0 = time.perf_counter()
        b_g = lgbt.train(dict(RECIPE, objective=objective), dsx,
                         num_boost_round=3)
        b_c = lgbt.train(dict(RECIPE, objective=objective,
                              device_type="cpu"), dsx, num_boost_round=1)
        t_g, t_c = b_g._gbdt.models[0], b_c._gbdt.models[0]
        # quantile's leaves are the host's float64 percentiles: equal too
        renewed = objective in RENEW
        if not (trees_equal(t_g, t_c) and (
                not renewed or np.array_equal(t_g.leaf_value,
                                              t_c.leaf_value))):
            fail(f"{objective} cross-check: tree 0 differs between the card "
                 f"and the CPU")
        print(f"{objective} cross-check ({N_SCROSS:,}; card 3 rounds, CPU "
              f"1): tree 0 identical{', leaf values too' if renewed else ''}"
              f" ({t_g.num_leaves} leaves), "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del b_g, b_c, dsx
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


# ---- phase 11: learning to rank

#: MSLR-WEB30K Fold 1's shape: 2,270,296 training documents in 18,919
#: queries, 136 features, relevance labels 0-4; its validation fold has
#: 6,306 queries
N_MSLR, Q_MSLR, F_MSLR, Q_MSLR_VALID = 2_270_296, 18_919, 136, 6_306
#: the longest MSLR-WEB30K query and the mean length
Q_MSLR_MAX, Q_MSLR_MEAN = 1251, 120
#: shares of the labels 0-4 (about MSLR-WEB30K's)
MSLR_LABELS = (0.514, 0.325, 0.134, 0.019, 0.008)
#: the phase's lambdarank: the objective's defaults (truncation 30,
#: lambdarank_norm), 255 leaves, learning rate 0.1, NDCG at 1, 3, 5, 10
RANK = dict(objective="lambdarank", num_leaves=255, max_bin=255,
            learning_rate=0.1, metric="ndcg", eval_at=[1, 3, 5, 10],
            verbosity=-1)
#: the rank kernel against its plain version: max |kernel - plain| over
#: the largest |plain| value, for grad and hess (float32 sums of up to
#: ~Q terms in another order, and the card's exp / log2 where PyTorch's
#: own kernels use theirs)
RANK_TOL = 1e-5


def mslr_sizes(nq, total, rng):
    """``nq`` lognormal query lengths (mean ~120), clipped to [1, 1251],
    summing to ``total`` (documents added to or taken from queries drawn
    at random)."""
    mu = np.log(Q_MSLR_MEAN) - 0.18
    sizes = np.clip(np.round(rng.lognormal(mu, 0.6, nq)), 1,
                    Q_MSLR_MAX).astype(np.int64)
    while sizes.sum() != total:
        d = total - int(sizes.sum())
        idx = rng.integers(0, nq, abs(d))
        np.add.at(sizes, idx, np.sign(d))
        sizes = np.clip(sizes, 1, Q_MSLR_MAX)
    return sizes


def synth_mslr(sizes, rng, w=None):
    """MSLR-WEB30K-shaped data: 136 features from standard-normal latent
    values, the even columns as integer counts (floor(exp(1.5 + v)), as
    MSLR's term counts and stream lengths) and the odd ones as scores
    rounded to two decimals (MSLR's features have a few significant
    digits; both keep the host's binning to seconds), a relevance signal
    on 40 latent values plus a query effect and noise, cut into the labels
    0-4 at MSLR's shares; positions are each document's displayed slot
    (its index in the query), clipped at 29."""
    n = int(sizes.sum())
    if w is None:
        w = np.zeros(F_MSLR, np.float32)
        w[rng.permutation(F_MSLR)[:40]] = rng.normal(size=40)
    V = rng.standard_normal((n, F_MSLR), dtype=np.float32)
    z = V @ w * 0.3 + np.repeat(rng.normal(size=len(sizes)), sizes) * 0.5 \
        + rng.normal(size=n)
    y = np.digitize(z, np.quantile(z, np.cumsum(MSLR_LABELS)[:-1])) \
        .astype(np.float32)
    X = np.round(V, 2)
    X[:, 0::2] = np.floor(np.exp(1.5 + V[:, 0::2]))
    starts = np.repeat(np.cumsum(sizes) - sizes, sizes)
    pos = np.minimum(np.arange(n) - starts, 29).astype(np.int32)
    return X, y, pos, w


def rank_pair_work(score, label, bounds, trunc):
    """(pairs, sort compares) of a lambdarank call on these scores: the
    pairs of sorted positions a < b, a < min(trunc, Q), whose labels
    differ (the kernel's arithmetic runs on those only), and sum Q log2 Q
    over the queries."""
    pairs, sort_ops = 0, 0.0
    for q in range(len(bounds) - 1):
        s, e = int(bounds[q]), int(bounds[q + 1])
        Q = e - s
        if Q < 2:
            continue
        lab = label[s:e][np.argsort(-score[s:e], kind="stable")]
        T = min(trunc, Q)
        pairs += int(np.triu(lab[:T, None] != lab[None, :], 1).sum())
        sort_ops += Q * np.log2(Q)
    return pairs, sort_ops


def rank_kernel_vs_plain(torch, RK, score, obj, what, flush=None):
    """The rank kernel against its plain version on ``obj``'s tables and
    ``score``: max |difference| over the largest |plain value| of grad and
    hess (must stay under RANK_TOL), the same bits on a second call, one
    launch a call; with ``flush``, also its one-call ms, device ms and the
    plain version's ms.  Returns (max |difference|, relative error,
    timings or None)."""
    cfg = obj.config
    kw = dict(sigmoid=float(cfg.sigmoid),
              trunc=int(cfg.lambdarank_truncation_level),
              norm=bool(cfg.lambdarank_norm))
    args = (score, obj._label, obj._gain_of_doc, obj._plan, obj._weight)
    before = RK.launches
    g, h = RK.lambdarank_gradients(*args, **kw)
    g2, h2 = RK.lambdarank_gradients(*args, **kw)
    if RK.launches - before != 2:
        fail(f"{what}: {RK.launches - before} kernel launches in 2 calls")
    gp, hp = RK.lambdarank_gradients_plain(*args, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(g, g2) and torch.equal(h, h2)):
        fail(f"{what}: two kernel calls gave different bits")
    errs, abs_err = [], 0.0
    for got, want in ((g, gp), (h, hp)):
        top = float(want.abs().max())
        err = float((got - want).abs().max())
        abs_err = max(abs_err, err)
        errs.append(err / top if top > 0 else err)
        if not bool(torch.isfinite(got).all()):
            fail(f"{what}: non-finite kernel values")
    rel = max(errs)
    if rel > RANK_TOL:
        fail(f"{what}: kernel vs plain {errs} of the largest |value| "
             f"(tolerance {RANK_TOL})")
    if flush is None:
        return abs_err, rel, None
    fn = lambda: RK.lambdarank_gradients(*args, **kw)  # noqa: E731
    nl, dms = device_per_call(torch, fn)
    if nl != 1:
        fail(f"{what}: {nl} launches a call")
    ms = time_ms(torch, fn, flush)
    pms = time_ms(torch, lambda: RK.lambdarank_gradients_plain(*args, **kw),
                  flush, reps=3)
    return abs_err, rel, (ms, dms, pms)


def rank_fixture(torch, rng, weighted, norm, dev="cuda"):
    """The skewed fixture's lambdarank objective on the card: 300
    lognormal query lengths, a query of length 1, one whose labels are
    all equal (inverse max DCG 0), one of 3,000 documents (longer than
    the kernel's shared-memory staging); random labels 0-4, weights or
    none, ``lambdarank_norm`` on or off.  Returns (objective, scores)."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.objectives import create_objective
    from lightgbm_tpu_torch.ops.rank import KERNEL_STAGE_DOCS
    sizes = np.concatenate([np.clip(np.round(rng.lognormal(3.5, 1.0, 300)),
                                    2, 900).astype(np.int64),
                            [1, 40, KERNEL_STAGE_DOCS + 952]])
    n = int(sizes.sum())
    y = rng.integers(0, 5, n).astype(np.float32)
    s = int(sizes[:-2].sum())
    y[s:s + 40] = 2.0
    md = Metadata(n)
    md.set_label(y)
    md.set_group(sizes)
    if weighted:
        md.set_weight(rng.uniform(0.5, 1.5, n).astype(np.float32))
    obj = create_objective(Config(dict(objective="lambdarank",
                                       lambdarank_norm=norm)))
    obj.init(md, n, torch.device(dev))
    # rounded scores: ties inside queries
    score = torch.as_tensor(np.round(rng.normal(size=n), 1)
                            .astype(np.float32), device=dev)
    return obj, score


def rank_train(torch, lgbt, ds, vs, rounds, fused=True, **extra):
    """``train()`` of RANK (updated by ``extra``) on ``ds`` with the valid
    set ``vs`` and record_evaluation, through the fused loop (``fused``)
    or the classic loop, which the configuration must take by itself:
    (booster, recorded valid metrics, s/round, train() wall s, peak MiB).
    s/round: the fused loop's chunk walls over their rounds (capture left
    out), the classic loop's rounds 2.. (a clock after each round)."""
    rec, stamps = {}, []
    cbs = [lgbt.record_evaluation(rec)]
    params = dict(RANK, **extra)

    def clock(env):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    if not fused:
        cbs.append(clock)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bst = lgbt.train(params, ds, num_boost_round=rounds, valid_sets=[vs],
                     valid_names=["v"], callbacks=cbs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    frs = list(bst._gbdt._fused_cache.values())
    if fused != bool(frs):
        fail(f"ranking ({params['objective']}): the fused loop ran "
             f"{bool(frs)}, expected {fused}")
    if fused:
        per = (sum(w for w, _ in frs[0].walls)
               / sum(r for _, r in frs[0].walls))
    else:
        per = float(np.mean(np.diff([t0] + stamps)[1:]))
    return bst, rec["v"], per, wall, peak


def check_ranking(torch, lgbt, HK, RF, TB, prng):
    """Phase 11: learning to rank on 2,270,296 synthetic documents of
    MSLR-WEB30K Fold 1's shape (18,919 queries, 136 features, labels 0-4)
    with a valid set of 6,306 queries.  (a) lambdarank at its defaults,
    255 leaves, 10 rounds through the fused loop with ndcg@1,3,5,10 of
    the valid set inside the round, twice to the same text: s/round,
    capture seconds, peak memory, the kernels' launches a tree (counts
    zeroed just before, read just after), the round's device values
    against the host's float64 NDCG of the valid scores; a profiled chunk
    of 5 rounds (the rank kernel against the passes); (b) the rank kernel
    against its plain version on the booster's real scores (timed) and
    on the skewed fixture (a query of length 1, one of equal labels, one
    past the shared-memory staging; weights; norm on and off); (c)
    rank_xendcg and position-debiased lambdarank (displayed slots 0-29),
    3 rounds each through the classic loop.  Returns (the kernels-line
    row of the rank kernel, the fused run's launch counts)."""
    from lightgbm_tpu_torch.ops import rank as RK
    t_phase = time.perf_counter()
    rng = np.random.default_rng(15)
    sizes = mslr_sizes(Q_MSLR, N_MSLR, rng)
    X, y, pos, w = synth_mslr(sizes, rng)
    vsizes = mslr_sizes(Q_MSLR_VALID, int(Q_MSLR_VALID * Q_MSLR_MEAN), rng)
    Xv, yv, _, _ = synth_mslr(vsizes, rng, w)
    t0 = time.perf_counter()
    ds = lgbt.Dataset(X, y, group=sizes, params={"max_bin": 255,
                                                 "verbosity": -1})
    vs = ds.create_valid(Xv, yv, group=vsizes)
    ds.construct()
    vs.construct()
    t_ds = time.perf_counter() - t0
    n, nv = len(y), len(yv)
    print(f"ranking data (MSLR-WEB30K Fold 1 shape): {n:,} documents in "
          f"{len(sizes):,} queries (length mean {sizes.mean():.1f}, max "
          f"{sizes.max()}), {F_MSLR} features, labels "
          f"{np.bincount(y.astype(int)).tolist()}; valid {nv:,} in "
          f"{len(vsizes):,} queries; datasets {t_ds:.2f} s", flush=True)

    # (a) lambdarank through the fused loop, twice
    zero_counts(HK, RF, TB, prng)
    bst, ev, per, wall, peak = rank_train(torch, lgbt, ds, vs, 10)
    counts = launch_counts(HK, RF, TB, prng)
    g = bst._gbdt
    fr = next(iter(g._fused_cache.values()))
    if len(g.models) != 10 or counts["lambdarank_grad"] < 10:
        fail(f"lambdarank fused run: {len(g.models)} trees, launches "
             f"{counts}")
    text = bst.model_to_string()
    again, ev2, *_ = rank_train(torch, lgbt, ds, vs, 10)
    if again.model_to_string() != text or ev2 != ev:
        fail("lambdarank: two fused card trainings gave different text or "
             "evaluations")
    del again
    host = g.valid_metrics[0][0].eval(g._host_scores(g.valid_scores[0]))
    for name, val in host:
        if not np.isclose(ev[name][-1], val, rtol=1e-5, atol=1e-6):
            fail(f"lambdarank: {name} in the round {ev[name][-1]} vs the "
                 f"host's float64 {val}")
    per_tree = {k: round(v / 10, 2) for k, v in counts.items() if v}
    last = " / ".join(f"{ev['ndcg@%d' % k][-1]:.6f}" for k in (1, 3, 5, 10))
    print(f"lambdarank ({n:,} x {F_MSLR}, 255 leaves, 10 rounds, fused, "
          f"valid NDCG in the round): s/round {per:.5f}, train() "
          f"{wall:.3f} s, warm-up round and capture {fr.capture_s:.3f} s, "
          f"peak {peak:.1f} MiB; launches a replay "
          f"{json.dumps({k: sum(v) for k, v in fr.graph_launches.items()})}"
          f"; valid ndcg@1/3/5/10 {last}"
          f" (round 1: {ev['ndcg@10'][0]:.6f} at 10); the last round's "
          f"values within 1e-5 of the host's float64; two runs "
          f"byte-identical", flush=True)
    print("lambdarank kernel launches a tree: " + json.dumps(per_tree),
          flush=True)
    print(f"model text sha256 (lambdarank, MSLR shape, 10 rounds): "
          f"{text_sha256(bst)}", flush=True)
    # 10 rounds: the chunk length of the run above, so the window replays
    # its graphs (no warm-up round or capture inside it)
    profiled_chunk(torch, g, "lambdarank", HK, RF, TB, prng)

    # (b) the kernel against its plain version: the booster's scores
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    score = g.scores[:, 0].contiguous()
    abs_err, rel, (ms, dms, pms) = rank_kernel_vs_plain(
        torch, RK, score, g.objective, "rank kernel (MSLR shape)", flush)
    sc_h = score.cpu().numpy()
    bounds = np.asarray(ds.inner.metadata.query_boundaries)
    pairs, sort_ops = rank_pair_work(sc_h, y, bounds, 30)
    nbytes = 20 * n + 8 * len(sizes) + 4
    bnd, by = bound_ms(nbytes, 25 * pairs + float(sort_ops))
    print(f"kernel lambdarank_grad ({n:,} documents, {len(sizes):,} "
          f"queries, truncation 30, norm, the booster's scores after "
          f"{g.iter_} rounds): ms={ms:.4f} device_ms={dms} plain_ms={pms:.4f} "
          f"bound_ms={bnd:.4f} ({by}: {pairs:,} pairs with different "
          f"labels x 25 operations + {sort_ops:,.0f} sort compares, "
          f"{nbytes:,} bytes); max |kernel - plain| {abs_err:.3e}, "
          f"{rel:.2e} of the largest |value|; the same bits twice; one "
          f"launch a call",
          flush=True)
    frng = np.random.default_rng(16)
    errs = {}
    for weighted in (False, True):
        for norm in (True, False):
            obj, sc = rank_fixture(torch, frng, weighted, norm)
            errs[f"weights={weighted},norm={norm}"] = rank_kernel_vs_plain(
                torch, RK, sc, obj, f"rank kernel (skewed fixture, "
                f"weights={weighted}, norm={norm})")[1]
    print(f"rank kernel, skewed fixture ({obj._plan.bounds.shape[0] - 1} "
          f"queries: length 1, equal labels, {obj._plan.qmax} documents "
          f"past the {RK.KERNEL_STAGE_DOCS}-document staging): max "
          f"|kernel - plain| of the largest |value| "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}",
          flush=True)
    del bst, g, fr
    RK.launches = 0

    # (c) rank_xendcg and position-debiased lambdarank, classic loop
    md = ds.inner.metadata
    for what, position, extra in (
            ("rank_xendcg", None, dict(objective="rank_xendcg")),
            ("lambdarank, position-debiased", pos, {})):
        # the binned set takes the positions (Dataset(position=...) sets
        # the same metadata; binning 2.27M x 136 again would cost a minute)
        md.set_position(position)
        b, ev, per, wall, _ = rank_train(torch, lgbt, ds, vs, 3,
                                         fused=False, **extra)
        md.set_position(None)
        gb = b._gbdt
        if gb.supports_fused() or len(gb.models) != 3:
            fail(f"{what}: fused admitted {gb.supports_fused()}, "
                 f"{len(gb.models)} trees")
        p = b.predict(Xv[:10_000])
        if p.shape != (min(nv, 10_000),) or not np.isfinite(p).all():
            fail(f"{what}: predict gave {p.shape} / non-finite values")
        bias = ""
        if position is not None:
            bv = gb.objective._pos_biases.cpu().numpy()
            if not np.isfinite(bv).all() or not np.abs(bv).max() > 0:
                fail(f"{what}: position biases {bv}")
            bias = (f"; position biases (slots 0, 1, 29) "
                    f"{bv[0]:.5f} / {bv[1]:.5f} / {bv[-1]:.5f}")
        print(f"{what} ({n:,} x {F_MSLR}, 3 rounds, classic): s/round "
              f"{per:.5f}, train() {wall:.2f} s; valid ndcg@10 "
              f"{ev['ndcg@10'][-1]:.6f}{bias}", flush=True)
        del b, gb
    del ds, vs
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s", flush=True)
    row = dict(name="lambdarank_grad", route="cuda",
               source="lightgbm_tpu_torch/csrc/rank.cu",
               replaces="lightgbm_tpu/objectives.py:585",
               launches=counts["lambdarank_grad"], max_abs_err=abs_err,
               ms=ms,
               plain_ms=pms, bound_ms=bnd, bound_by=by, library_ms=None)
    return row, counts


# ---- phase 12: split constraints

def monotone_directions(seed=0, k=6):
    """Phase 12's monotone constraints on :func:`slice_data`'s set of
    ``seed``: the ``k`` features of the largest |weight| of its logit,
    each in its weight's direction (synth_higgs draws the weights first),
    0 elsewhere.  Features the trees seldom split on would leave the
    methods nothing to constrain."""
    w = np.random.default_rng(seed).normal(size=F)
    mono = [0] * F
    for f in np.argsort(-np.abs(w))[:k]:
        mono[int(f)] = 1 if w[f] > 0 else -1
    return mono


#: phase 12 (b)'s configuration: extra trees, by-node sampling, path
#: smoothing and two interaction sets
EXTRA_12 = dict(extra_trees=True, feature_fraction_bynode=0.5,
                path_smooth=10.0,
                interaction_constraints="[%s],[%s]" % (
                    ",".join(map(str, range(14))),
                    ",".join(map(str, range(14, F)))))
#: the 32-bit operations of one threefry2x32 cipher (key schedule 2, the
#: two initial adds, 20 rounds of add, rotate (3) and xor, 5 injections of
#: 3) and of turning its words into a uniform (xor, shift, or, subtract,
#: max)
CIPHER_OPS, UNIFORM_OPS = 119, 5


def path_sets(tree):
    """The feature sets of every root-to-leaf path of ``tree``."""
    out = []

    def walk(node, acc):
        if node < 0:
            out.append(acc)
            return
        acc = acc | {int(tree.split_feature[node])}
        walk(int(tree.left_child[node]), acc)
        walk(int(tree.right_child[node]), acc)

    if tree.num_leaves > 1:
        walk(0, set())
    return out


def monotone_violations(torch, bst, ds, Xv, mono):
    """Violations of the predictions' order when each constrained feature
    of 1,000 held-out rows sweeps over its bins (every bin bound), the
    other features fixed: the rows binned once, a bin column swept, the
    raw scores from the forest kernel."""
    from lightgbm_tpu_torch.ops import forest_kernels
    g = bst._gbdt
    forest = g._forest_arrays(g.models, 1)
    base = ds.inner.bin_external(Xv[:1000])
    nb = ds.inner.num_bins_array()
    nanb = ds.inner.nan_bin_array()
    bad = 0
    for f, d in enumerate(mono):
        if d == 0:
            continue
        m = int(nb[f]) - int(nanb[f] >= 0)
        bins = np.repeat(base, m, axis=0)
        bins[:, f] = np.tile(np.arange(m, dtype=bins.dtype), len(base))
        out = forest_kernels.forest_values(
            forest, torch.as_tensor(np.ascontiguousarray(bins.T),
                                    device="cuda"), 1, ())
        p = out[:, 0].double().cpu().numpy().reshape(len(base), m)
        bad += int((np.diff(p, axis=1) * d < 0).sum())
    return bad


def constraint_shares(torch, bst):
    """One more tree of ``bst`` through the classic loop, its second
    full-width grow round (K slots) under the profiler: that round's
    device ms and the shares of it in split finding (the children's best
    splits with their draws and masks, the advanced method's
    per-threshold bounds) and in the box methods' sequential record."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from lightgbm_tpu_torch.learner import batch_grower as BG
    wrapped = {"split finding": [(BG.BatchedTree, "child_best"),
                                 (BG, "advanced_split_bounds")],
               "sequential record": [(BG.BatchedTree, "_record_boxes")]}
    saved = [(BG.BatchedTree, "round", BG.BatchedTree.round)]
    for part, places in wrapped.items():
        for obj, name in places:
            real = getattr(obj, name)

            def wrap(*a, _real=real, _part=part, **k):
                with record_function(_part):
                    return _real(*a, **k)
            saved.append((obj, name, real))
            setattr(obj, name, wrap)
    full, box = [0], {}
    real_round = saved[0][2]

    def one_round(tree, Kr):
        if Kr == tree.K and full[0] == 1:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                real_round(tree, Kr)
                torch.cuda.synchronize()
            box["prof"] = prof
        else:
            real_round(tree, Kr)
        full[0] += Kr == tree.K
    BG.BatchedTree.round = one_round
    try:
        bst._gbdt.train_one_iter()
        torch.cuda.synchronize()
    finally:
        for obj, name, real in saved:
            setattr(obj, name, real)
    prof = box.get("prof")
    work = None if prof is None else profiler_work(prof, "grow round")
    if work is None:
        return None, {}
    total = sum(us for _, _, us in work)
    shares = {}
    for e in prof.key_averages():
        if e.key in wrapped:
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0)
            shares[e.key] = round(us / total, 4)
    return total / 1e3, shares


def fused_chunk_cost(torch, g, rounds):
    """(device ms, kernel launches) a round of a fused chunk of ``rounds``
    rounds of booster ``g`` (its graphs already captured), from the
    profiler; (None, None) when it saw nothing."""
    from torch.profiler import ProfilerActivity, profile
    g.train_fused(rounds)   # captures a chunk of this length, if new
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PREROLL_SPINS):
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        g.train_fused(rounds)
        torch.cuda.synchronize()
    work = profiler_work(prof, "fused chunk")
    if work is None:
        return None, None
    work = [w for w in work if "spin_kernel" not in w[0]]
    return (sum(us for _, _, us in work) / 1e3 / rounds,
            sum(c for _, c, _ in work) / rounds)


def check_draw_kernel(torch, prng, flush):
    """The threefry kernel against its plain version, bit for bit and the
    same bits twice, one launch a call: a batched round's draws (84 node
    keys x 28 features: the by-node key and each extra-trees family), the
    strict learner's split(fold_in(key, i), 4) keys and a 1M draw; timed
    at the round's shape.  Returns the kernels-line row (launches set by
    the caller)."""
    rng = np.random.default_rng(12)
    dev = "cuda"
    key = torch.tensor([[int(v) for v in rng.integers(0, 2 ** 32, 2)]],
                       dtype=torch.int64, device=dev)
    node = torch.as_tensor(rng.integers(0, 2 * T, size=2 * K),
                           dtype=torch.int64, device=dev)
    cases = [("node keys", key.expand(2 * K, 2), F, [node])]
    cases += [(f"extra-trees family {j}", key.expand(2 * K, 2), F,
               [node, (j, 0)]) for j in range(3)]
    cases += [("strict split(fold_in(key, 13), 4)", key.expand(4, 2), F,
               [(13, 0), (0, 1)]),
              ("strict extra-trees keys", key.expand(2, 2), F,
               [(13, 0), (2, 1), (0, 0)]),
              ("1M keys x 1", key.expand(1 << 20, 2), 1,
               [(0, 1)]),
              ("1 key x 1M", key, 1 << 20, [])]
    for what, keys, n, path in cases:
        before = prng.draw_launches
        a = prng.draw(keys, n, path)
        b = prng.draw(keys, n, path)
        if prng.draw_launches - before != 2:
            fail(f"threefry {what}: {prng.draw_launches - before} launches "
                 f"in 2 calls")
        want = prng.draw_plain(keys, n, path)
        torch.cuda.synchronize()
        if not (torch.equal(a, b) and torch.equal(a, want)):
            fail(f"threefry {what}: kernel vs plain bits differ "
                 f"({int((a != want).sum())} of {a.numel()})")
    print(f"threefry kernel: bitwise equal to its plain version and to "
          f"itself twice at {', '.join(c[0] for c in cases)}", flush=True)
    keys, path = key.expand(2 * K, 2), [node, (0, 0)]
    fn = lambda: prng.draw(keys, F, path)  # noqa: E731
    nl, dms = device_per_call(torch, fn)
    if nl != 1:
        fail(f"threefry: {nl} launches a call")
    ms = time_ms(torch, fn, flush)
    pms = time_ms(torch, lambda: prng.draw_plain(keys, F, path), flush,
                  reps=3)
    N_, S_ = 2 * K, len(path)
    nbytes = 4 * N_ * F + 8 * (2 + N_)
    ops = N_ * S_ * CIPHER_OPS + N_ * F * (CIPHER_OPS + UNIFORM_OPS)
    bnd, by = bound_ms(nbytes, ops)
    big = key.expand(1 << 20, 2)
    bms = time_ms(torch, lambda: prng.draw(big, 1, [(0, 1)]), flush)
    bbnd, bby = bound_ms(4 << 20, (1 << 20) * (2 * CIPHER_OPS + UNIFORM_OPS))
    print(f"kernel threefry_draw ({N_} keys x {F}, a fold-in and a split "
          f"a key, one extra-trees family of a round): ms={ms:.4f} "
          f"device_ms={dms} plain_ms={pms:.4f} bound_ms={bnd:.6f} ({by}: "
          f"{ops:,} integer operations, {nbytes:,} bytes); 1M keys x 1: "
          f"ms={bms:.4f} bound_ms={bbnd:.4f} ({bby})", flush=True)
    return dict(name="threefry_draw", route="cuda",
                source="lightgbm_tpu_torch/csrc/prng.cu",
                replaces="lightgbm_tpu/ops/split.py:347",
                launches=0, max_abs_err=0.0, ms=ms, plain_ms=pms,
                bound_ms=bnd, bound_by=by, library_ms=None,
                device_ms=dms)


def check_constraints(torch, lgbt, HK, RF, TB, prng):
    """Phase 12: split constraints on phase 3's binned 1M x 28 set and
    recipe.  (a) monotone constraints fused (basic 10 rounds;
    intermediate, advanced and basic with monotone_penalty=2 5 rounds
    each), each model swept for violations; (b) extra trees + by-node
    sampling + path smoothing + interaction sets, fused twice and classic
    once; (c) the strict learner at 90k rows, classic; (d) card vs CPU;
    (e) the threefry kernel against its plain version.  Counts are zeroed
    before (a) and read after (c).  Returns the threefry kernel's row."""
    from lightgbm_tpu_torch.boosting import fused_graph as FG
    t_phase = time.perf_counter()
    ds, _, _, Xv, yv, _ = slice_data(lgbt, N, 0, 255)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    mono = monotone_directions()
    print(f"phase 12 monotone constraints: {mono}", flush=True)

    def mark(what):
        print(f"phase 12 {what}: {time.perf_counter() - t_phase:.1f} s",
              flush=True)
    zero_counts(HK, RF, TB, prng)
    prng.draw_launches = 0
    trees = 0
    base_per = None

    # (a) monotone constraints through the fused loop.  Leaf renewal (on by
    # default with int8 levels) replaces the clipped outputs by the true
    # gradients' unconstrained ones, in the JAX package too, so the
    # monotone runs turn it off; the default's violations are printed
    bst, *_ = fused_train(torch, lgbt, ds, 5, monotone_constraints=mono)
    trees += 5
    print(f"monotone basic with the default leaf renewal (1M x 28, 5 "
          f"rounds, fused): violations of the predictions' order "
          f"{monotone_violations(torch, bst, ds, Xv, mono)} (the renewed "
          f"leaves are not clipped, as in the JAX package)", flush=True)
    del bst
    for what, rounds, extra in (
            ("basic", 10, {}),
            ("intermediate", 5,
             dict(monotone_constraints_method="intermediate")),
            ("advanced", 5, dict(monotone_constraints_method="advanced")),
            ("basic, monotone_penalty=2", 5, dict(monotone_penalty=2.0))):
        replays0 = FG.counts["replays"]
        bst, per, wall, peak = fused_train(
            torch, lgbt, ds, rounds, monotone_constraints=mono,
            quant_train_renew_leaf=False, **extra)
        g = bst._gbdt
        fr = next(iter(g._fused_cache.values()))
        trees += len(g.models)
        if len(g.models) != rounds or not g.hp.use_monotone:
            fail(f"monotone {what}: {len(g.models)} trees, "
                 f"use_monotone={g.hp.use_monotone}")
        replays = FG.counts["replays"] - replays0
        t0 = time.perf_counter()
        bad = monotone_violations(torch, bst, ds, Xv, mono)
        a = auc(yv, bst.predict(Xv))
        t1 = time.perf_counter()
        # a fused round and a classic grow round, profiled, after the
        # counted run
        dms, nl = fused_chunk_cost(torch, g, 1)
        t2 = time.perf_counter()
        rms, shares = constraint_shares(torch, bst)
        t3 = time.perf_counter()
        mark(f"(a) {what}: checks {t1 - t0:.1f} s, fused profile "
             f"{t2 - t1:.1f} s, classic profile {t3 - t2:.1f} s")
        print(f"monotone {what} (1M x 28, {rounds} rounds, fused, no leaf "
              f"renewal): s/round "
              f"{per:.5f}, train() {wall:.2f} s, warm-up round and capture "
              f"{fr.capture_s:.2f} s, peak {peak:.1f} MiB, graph replays "
              f"{replays}, held-out AUC {a:.6f}; violations of the "
              f"predictions' order over 1,000 rows x each constrained "
              f"feature's bin bounds: {bad}; a fused round profiled: "
              f"device ms {dms}, launches {nl}; a full-width classic grow "
              f"round profiled: device ms {rms}, shares "
              f"{json.dumps(shares)}", flush=True)
        if bad:
            fail(f"monotone {what}: {bad} violations of the monotone order")
        if not a > 0.7:
            fail(f"monotone {what}: held-out AUC {a}")
        if what == "basic":
            base_per = per
        del bst, g, fr

    mark("(a)")

    # (b) extra trees, by-node sampling, path smoothing, interaction sets
    bst, per, wall, peak = fused_train(torch, lgbt, ds, 5, **EXTRA_12)
    again, *_ = fused_train(torch, lgbt, ds, 5, **EXTRA_12)
    classic, per_c, *_ = fused_train(torch, lgbt, ds, 5, classic=True,
                                     **EXTRA_12)
    trees += 15
    text = bst.model_to_string()
    if again.model_to_string() != text:
        fail("extra trees: two fused card trainings gave different text")
    if classic.model_to_string() != text:
        fail("extra trees: fused and classic text differ")
    sets = [set(range(14)), set(range(14, F))]
    paths = [p for t in bst._gbdt.models for p in path_sets(t)]
    if not paths or not all(any(p <= st for st in sets) for p in paths):
        fail("extra trees: a root-to-leaf path leaves its interaction set")
    a = auc(yv, bst.predict(Xv))
    print(f"extra trees + by-node 0.5 + path_smooth 10 + interaction sets "
          f"(1M x 28, 5 rounds): fused s/round {per:.5f} (classic "
          f"{per_c:.5f}; the basic monotone fused {base_per:.5f}), peak "
          f"{peak:.1f} MiB, held-out AUC {a:.6f}; {len(paths)} paths, each "
          f"inside one set; two fused runs and the classic run "
          f"byte-identical; sha256 {text_sha256(bst)}", flush=True)
    del bst, again, classic
    mark("(b)")

    # (c) the strict learner, classic: intermediate monotone, extra trees,
    # by-node sampling
    sbst, a_s, _, t_s, steps = train_slice(
        torch, lgbt, N_STRICT, 3, monotone_constraints=mono,
        monotone_constraints_method="intermediate", extra_trees=True,
        feature_fraction_bynode=0.5)
    sg = sbst._gbdt
    if sg._use_batched_grower() or sg.hp.hist_dtype != "float32":
        fail("phase 12 (c) did not take the strict learner")
    trees += 3
    counts = launch_counts(HK, RF, TB, prng)
    counts["threefry_draw"] = prng.draw_launches
    if counts["threefry_draw"] <= 0:
        fail("phase 12 never launched the threefry kernel")
    sds, _, _, sXv, _, _ = slice_data(lgbt, N_STRICT)
    bad = monotone_violations(torch, sbst, sds, sXv, mono)
    if bad:
        fail(f"strict monotone: {bad} violations of the monotone order")
    n_launch = profile_round(torch, sbst)
    sp = sg.models[-1].num_leaves - 1
    print(f"strict (90k x 28, intermediate monotone + extra trees + by-node "
          f"0.5, 3 rounds, classic): s/round (2-3) "
          f"{float(np.mean(steps[1:])):.4f}, held-out AUC {a_s:.6f}, "
          f"{n_launch} launches in a round of {sp} splits "
          f"({(n_launch or 0) / max(sp, 1):.1f} a split); violations "
          f"{bad}", flush=True)
    print(f"phase 12 kernel launches ({trees} trees of (a)-(c)): "
          f"{json.dumps(counts)}; threefry a tree "
          f"{counts['threefry_draw'] / trees:.2f}", flush=True)
    del sbst, sg
    mark("(c)")

    # (d) the card against the CPU at phase 4's cross-check size
    for what, extra in (("basic monotone", dict(
            monotone_constraints=mono, quant_train_renew_leaf=False)),
            ("extra trees", EXTRA_12)):
        b_g, a_g, *_ = train_slice(torch, lgbt, 100_000, 1, seed=1,
                                   **extra)
        b_c, a_c, *_ = train_slice(torch, lgbt, 100_000, 1, "cpu", seed=1,
                                   **extra)
        t_g, t_c = b_g._gbdt.models[0], b_c._gbdt.models[0]
        if not (t_g.num_leaves == t_c.num_leaves
                and np.array_equal(t_g.split_feature, t_c.split_feature)
                and np.array_equal(t_g.threshold_bin, t_c.threshold_bin)):
            fail(f"phase 12 (d) {what}: tree 0 differs between the card "
                 f"and the CPU")
        if abs(a_g - a_c) > 1e-3:
            fail(f"phase 12 (d) {what}: AUC card {a_g} vs cpu {a_c}")
        print(f"cross-check ({what}, 100k x 1): tree 0 identical "
              f"({t_g.num_leaves} leaves), AUC card {a_g:.6f} cpu "
              f"{a_c:.6f}, the trees' text (parameters aside) equal: "
              f"{trees_text(b_g) == trees_text(b_c)}", flush=True)
        del b_g, b_c
    mark("(d)")

    # (e) the kernel against its plain version
    row = check_draw_kernel(torch, prng, flush)
    row["launches"] = counts["threefry_draw"]
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return row


# ---- phase 13: forced splits, CEGB and linear trees

#: phase 13 (a)'s forced schedule on phase 3's features, three levels deep:
#: BFS entries root (0), its left (1) and right (3) children, then the
#: left-left (2) and right-right (4) grandchildren
FORCED_13 = {"feature": 0, "threshold": 0.0,
             "left": {"feature": 1, "threshold": 0.3,
                      "left": {"feature": 2, "threshold": -0.2}},
             "right": {"feature": 3, "threshold": 0.1,
                       "right": {"feature": 4, "threshold": 0.5}}}
#: the splits' original features in tree node order when every entry holds
FORCED_13_NODES = [0, 1, 3, 2, 4]
#: (a)'s forced categorical root on the airline set: UniqueCarrier code 3
#: alone left, then DepTime at noon on its left
FORCED_AIR = {"feature": 4, "threshold": 3,
              "left": {"feature": 3, "threshold": 1200.0}}
#: (b)'s CEGB penalties on phase 3's 28 features: a split penalty per row,
#: a coupled penalty a feature, a lazy penalty a (row, feature)
CEGB_13 = dict(cegb_penalty_split=1e-6, cegb_penalty_feature_coupled=[20.0] * F,
               cegb_penalty_feature_lazy=[2e-4] * F)
#: (c)'s linear-tree recipe: phase 3's, a regression target
LINEAR_13 = dict(objective="regression", linear_tree=True)


def synth_piecewise(n, rng):
    """HIGGS-shaped features (phase 3's generator's columns) with a
    piecewise-linear regression target: linear in three features, the
    slope of one switching with the sign of another, and noise."""
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = (1.5 * X[:, 0] + np.where(X[:, 1] > 0, 2.0 * X[:, 2], -X[:, 2])
         - 0.8 * X[:, 3] * (X[:, 4] > 0.5)
         + 0.3 * rng.normal(size=n)).astype(np.float32)
    return X, y


def forced_schedule_held(bst, nodes):
    """How many of the model's trees split their first nodes on the
    schedule's features (every entry held)."""
    k = len(nodes)
    return sum(1 for t in bst._gbdt.models
               if list(t.split_feature[:k]) == nodes)


def linear_launches(LK):
    return {"linear_normal_equations": LK.normal_launches,
            "linear_leaf_scores": LK.score_launches}


def check_linear_kernels(torch, LK, g, flush):
    """(d) the two entries of csrc/linear.cu against their plain versions
    on one tree of the 1M-row linear booster ``g`` (its rows' leaves and
    its leaves' path features): the normal equations to 1e-5 of each
    output's largest |value| (they sum in another order) and the same
    bits twice, also under a bag; the scores bit for bit; each timed
    (one call, device time, the plain version) beside its bound.  Returns
    the two kernels-line rows (launches set by the caller) and the fit's
    one-tree device time."""
    from lightgbm_tpu_torch.learner.linear import (fit_linear_leaves,
                                                   leaf_features)
    gr, hs = g.boosting_gradients()
    gr, hs = gr[:, 0].contiguous(), hs[:, 0].contiguous()
    arrays, lor = g._grow(gr, hs, None, None)
    raw = g.raw_dev
    n = raw.shape[0]
    feat = leaf_features(arrays.leaf_path & ~g.is_cat_arr[None, :], 16)
    L, Kf = feat.shape
    D = Kf + 1
    bag = torch.rand(n, device=raw.device) < 0.8
    rows = []
    worst = 0.0
    f64 = [x.double() for x in (raw, gr, hs)]
    for what, mask in (("all rows", None), ("a bag of 0.8", bag)):
        a = LK.normal_equations(raw, lor, feat, gr, hs, mask)
        b = LK.normal_equations(raw, lor, feat, gr, hs, mask)
        p = LK.normal_equations_plain(raw, lor, feat, gr, hs, mask)
        r = LK.normal_equations_plain(f64[0], lor, feat, f64[1], f64[2],
                                      mask)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail(f"linear normal equations ({what}): other bits on a "
                 f"second call")
        errs = []
        for x, y, z, name in zip(a, p, r, ("XtHX", "Xtg", "count")):
            # float32 sums of up to ~1e5 products a leaf, in two orders
            big = y.abs().max().clamp(min=1.0)
            worst = max(worst, (x - y).abs().max().item())
            rel = ((x - y).abs().max() / big).item()
            errs.append(f"{name} {rel:.2e} (vs float64: kernel "
                        f"{((x - z).abs().max() / big).item():.2e}, plain "
                        f"{((y - z).abs().max() / big).item():.2e})")
            if not rel <= 2e-4:
                fail(f"linear normal equations ({what}): {name} differs "
                     f"from the plain version by {rel:.3g} of its largest")
        if not torch.equal(a[2], p[2]):
            fail(f"linear normal equations ({what}): the counts differ")
        print(f"linear normal equations ({what}): kernel vs plain, of the "
              f"largest |value|: {'; '.join(errs)}", flush=True)
    del f64, r
    fn = lambda: LK.normal_equations(raw, lor, feat, gr, hs, None)  # noqa
    nl, dms = device_per_call(torch, fn, reps=5)
    kern = [(c, us) for nm, c, us in last_work if "normal_kernel" in nm]
    kms = sum(us for _, us in kern) / 1e3 / max(sum(c for c, _ in kern), 1)
    ms = time_ms(torch, fn, flush)
    pms = time_ms(torch, lambda: LK.normal_equations_plain(
        raw, lor, feat, gr, hs, None), flush, reps=3)
    active = (feat < raw.shape[1]).sum(1)                  # [L]
    reads = int(active[lor.long()].sum().item())
    nbytes = n * (4 + 4 + 4) + 4 * reads + 4 * L * (D * D + D + 1)
    P = D * (D + 1) // 2
    ops = n * (3 * P + 2 * D + 1)
    bnd, by = bound_ms(nbytes, ops)
    print(f"kernel linear_normal_equations ({n:,} rows, {L} leaves, D = "
          f"{D}): ms={ms:.4f} device_ms={dms} (the whole call, its sort "
          f"and run table included; {nl} launches) kernel device_ms="
          f"{kms:.4f} plain_ms={pms:.4f} bound_ms={bnd:.5f} ({by}: "
          f"{nbytes:,} bytes, {ops:,} operations); max abs difference "
          f"from the plain version {worst:.3g} (within 2e-4 of the largest "
          f"|value|), the same bits twice",
          flush=True)
    rows.append(dict(name="linear_normal_equations", route="cuda",
                     source="lightgbm_tpu_torch/csrc/linear.cu",
                     replaces="lightgbm_tpu/learner/linear.py:33",
                     launches=0, max_abs_err=worst, ms=ms, plain_ms=pms,
                     bound_ms=bnd, bound_by=by, library_ms=None,
                     device_ms=dms, kernel_device_ms=kms))
    lam = float(g.config.linear_lambda)
    fit = lambda: fit_linear_leaves(  # noqa: E731
        raw, lor, arrays.leaf_path, ~g.is_cat_arr, gr, hs, None,
        arrays.leaf_value, lam)
    fit_ms = time_ms(torch, fit, flush, reps=5)
    const, coeff = fit()
    from lightgbm_tpu_torch.learner.linear import linear_leaf_scores
    sfeat = leaf_features(coeff != 0.0, 16)
    scoef = torch.cat([coeff, torch.zeros_like(coeff[:, :1])], 1) \
        .gather(1, sfeat)
    sargs = (raw, lor, sfeat, scoef, const, arrays.leaf_value)
    a = LK.leaf_scores(*sargs)
    b = LK.leaf_scores(*sargs)
    p = LK.leaf_scores_plain(*sargs)
    torch.cuda.synchronize()
    if not (torch.equal(a, b) and torch.equal(a, p)):
        fail(f"linear leaf scores vs plain: max abs diff "
             f"{(a - p).abs().max().item()}")
    if not torch.equal(a, linear_leaf_scores(raw, lor, const, coeff,
                                             arrays.leaf_value)):
        fail("linear_leaf_scores and the scores kernel differ")
    fn = lambda: LK.leaf_scores(*sargs)  # noqa: E731
    nl, dms = device_per_call(torch, fn, reps=5)
    ms = time_ms(torch, fn, flush)
    pms = time_ms(torch, lambda: LK.leaf_scores_plain(*sargs), flush,
                  reps=3)
    used = (scoef != 0).sum(1)[lor.long()]
    nnz = int(used.sum().item())
    nbytes = n * (4 + 4) + 4 * nnz + 4 * (2 * L * Kf + 2 * L)
    bnd, by = bound_ms(nbytes, 2 * nnz + n)
    print(f"kernel linear_leaf_scores ({n:,} rows, {nnz / n:.2f} "
          f"coefficients a row): ms={ms:.4f} device_ms={dms} ({nl} "
          f"launches) plain_ms={pms:.4f} bound_ms={bnd:.5f} ({by}); "
          f"bitwise equal to the plain version, twice; the fit of one tree "
          f"(normal equations, solve, coefficients) {fit_ms:.4f} ms",
          flush=True)
    rows.append(dict(name="linear_leaf_scores", route="cuda",
                     source="lightgbm_tpu_torch/csrc/linear.cu",
                     replaces="lightgbm_tpu/learner/linear.py:130",
                     launches=0, max_abs_err=0.0, ms=ms, plain_ms=pms,
                     bound_ms=bnd, bound_by=by, library_ms=None,
                     device_ms=dms))
    score_ms = rows[-1]["ms"]
    return rows, fit_ms, score_ms


def check_learner_options(torch, lgbt, HK, RF, TB, prng):
    """Phase 13: forced splits, CEGB and linear trees on the card.  (a)
    forced splits (FORCED_13, three levels, written to a temporary file) on
    phase 3's 1M x 28 set and recipe, 10 rounds fused twice and classic
    once to the same text, the schedule held in every tree, s/round; the
    pooled recipe (``histogram_pool_size=8``) 5 rounds fused and classic;
    a forced categorical root on the airline set (FORCED_AIR) 5 rounds
    fused and classic; the regression recipe (leaf renewal off: every
    number exact) at 100k x 1 on the card and the CPU to the same trees'
    text.  (b) CEGB (CEGB_13, lazy penalties:
    the [n, F] acquisition state) 10 rounds classic twice to the same text,
    s/round beside the plain classic recipe's.  (c) linear trees on 1M rows
    of a piecewise-linear target (the batched grower in float32, classic),
    100 rounds with s/round and each linear kernel's launches a tree, 5
    rounds twice to the same text, the strict learner at 90k x 3 twice;
    ``Booster.predict`` of 1M held-out rows through the forest kernel's
    linear mode (launches counted), against the host walk on 20,000 rows
    and, bit for bit, the plain version on the card (both timed).  (d) the
    linear kernels against their plain versions (check_linear_kernels) and
    the fit's share of a linear round.  The linear kernels' counts are
    zeroed just before (c) and read just after its prediction.  Returns
    the three kernels-line rows."""
    import tempfile
    from lightgbm_tpu_torch.boosting import fused_graph as FG
    from lightgbm_tpu_torch.boosting.gbdt import GBDT, forest_bitset_arrays
    from lightgbm_tpu_torch.models import predict as MP
    from lightgbm_tpu_torch.ops import forest_kernels as FK
    from lightgbm_tpu_torch.ops import linear_kernels as LK
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def mark(what):
        print(f"phase 13 {what}: {time.perf_counter() - t_phase:.1f} s",
              flush=True)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_forced_")
    try:
        path = os.path.join(tmp, "forced.json")
        with open(path, "w") as fh:
            json.dump(FORCED_13, fh)
        path_air = os.path.join(tmp, "forced_air.json")
        with open(path_air, "w") as fh:
            json.dump(FORCED_AIR, fh)

        # (a) forced splits, fused twice and classic once
        ds, _, _, _, _, _ = slice_data(lgbt, N, 0, 255)
        zero_counts(HK, RF, TB, prng)
        FG.counts.update(replays=0, reads=0, extra=0, rounds=0)
        b1, per_f, wall_f, peak_f = fused_train(
            torch, lgbt, ds, 10, forcedsplits_filename=path)
        counts = launch_counts(HK, RF, TB, prng)
        fc = dict(FG.counts)
        g = b1._gbdt
        if g.forced is None or len(g.forced.leaf) != 5 or \
                not g._use_batched_grower():
            fail("phase 13 (a): the forced schedule did not reach the "
                 "batched grower")
        held = forced_schedule_held(b1, FORCED_13_NODES)
        if held != len(g.models):
            fail(f"phase 13 (a): the schedule held in {held} of "
                 f"{len(g.models)} trees")
        b2, per_f2, _, _ = fused_train(torch, lgbt, ds, 10,
                                       forcedsplits_filename=path)
        bc, per_c, wall_c, _ = fused_train(torch, lgbt, ds, 10,
                                           classic=True,
                                           forcedsplits_filename=path)
        if not (b1.model_to_string() == b2.model_to_string()
                == bc.model_to_string()):
            fail("phase 13 (a): forced splits, fused twice and classic: "
                 "the model texts differ")
        trees = len(g.models)
        print(f"forced splits (1M x 28, 10 rounds, a schedule of 5 entries "
              f"three levels deep, held in every tree): fused s/round "
              f"{per_f:.5f} / {per_f2:.5f}, classic {per_c:.5f}; train() "
              f"{wall_f:.2f} s fused, {wall_c:.2f} s classic; peak "
              f"{peak_f:.1f} MiB; replays {fc['replays']}, flag reads "
              f"{fc['reads']}, extra rounds {fc['extra']}; launches a tree "
              f"{json.dumps({k: round(v / trees, 2) for k, v in counts.items() if v})}; "
              f"fused twice and classic to the same text (the trees' text "
              f"sha256 {trees_sha256(b1)}; the parameters name a temporary "
              f"file)", flush=True)
        del b1, b2, bc
        bp, per_p, _, _ = fused_train(torch, lgbt, ds, 5,
                                      forcedsplits_filename=path,
                                      histogram_pool_size=8)
        bpc, per_pc, _, _ = fused_train(torch, lgbt, ds, 5, classic=True,
                                        forcedsplits_filename=path,
                                        histogram_pool_size=8)
        if bp._gbdt.hp.hist_pool_slots != 128 or \
                bp.model_to_string() != bpc.model_to_string():
            fail("phase 13 (a): pooled forced splits: fused and classic "
                 "texts differ (or the pool was not engaged)")
        print(f"forced splits, pooled (histogram_pool_size=8, 1M x 5): "
              f"fused s/round {per_p:.5f}, classic {per_pc:.5f}, schedule "
              f"held in {forced_schedule_held(bp, FORCED_13_NODES)} of 5 "
              f"trees, fused = classic text", flush=True)
        del bp, bpc
        mark("(a) HIGGS shape")
        dsa = airline_dataset(lgbt)
        ba, per_a, _, _ = fused_train(torch, lgbt, dsa, 5,
                                      forcedsplits_filename=path_air)
        bac, per_ac, _, _ = fused_train(torch, lgbt, dsa, 5, classic=True,
                                        forcedsplits_filename=path_air)
        t0 = ba._gbdt.models[0]
        if ba.model_to_string() != bac.model_to_string() or \
                t0.split_feature[0] != 4 or not t0.decision_type[0] & 1:
            fail("phase 13 (a): the forced categorical root: fused and "
                 "classic texts differ, or tree 0's root is not the "
                 "categorical split on UniqueCarrier")
        print(f"forced splits, categorical root (airline shape, 1M x 5): "
              f"fused s/round {per_a:.5f}, classic {per_ac:.5f}; root "
              f"UniqueCarrier in {{{t0.cat_threshold[0]}}} left, schedule "
              f"held in {forced_schedule_held(ba, [4, 3])} of 5 trees, "
              f"fused = classic text", flush=True)
        del ba, bac, dsa
        AIR_DATA.clear()
        t0 = time.perf_counter()
        # regression (exact gradients) without leaf renewal, whose float
        # sums run in another order on the card: every number is exact
        reg = dict(objective="regression", forcedsplits_filename=path,
                   quant_train_renew_leaf=False)
        b_g, *_ = train_slice(torch, lgbt, 100_000, 1, seed=1, **reg)
        b_c, *_ = train_slice(torch, lgbt, 100_000, 1, "cpu", seed=1, **reg)
        if trees_text(b_g) != trees_text(b_c):
            fail("phase 13 (a): forced splits, regression 100k x 1: the "
                 "card's trees' text differs from the CPU's")
        print(f"cross-check (forced splits, regression, leaf renewal off, "
              f"100k x 1): the card's trees' text equals the CPU's "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        del b_g, b_c
        mark("(a)")

        # (b) CEGB with lazy penalties, classic twice
        b0, per_0, _, _ = fused_train(torch, lgbt, ds, 5, classic=True)
        del b0
        zero_counts(HK, RF, TB, prng)
        torch.cuda.reset_peak_memory_stats()
        bc1, per_cg, wall_cg, peak_cg = fused_train(torch, lgbt, ds, 10,
                                                    classic=True, **CEGB_13)
        counts = launch_counts(HK, RF, TB, prng)
        gc = bc1._gbdt
        st = gc.cegb
        if st is None or st.used_rows is None or \
                tuple(st.used_rows.shape) != (N, F) or gc.supports_fused():
            fail("phase 13 (b): CEGB's lazy state missing or the fused loop "
                 "admitted")
        bc2, *_ = fused_train(torch, lgbt, ds, 10, classic=True, **CEGB_13)
        if bc1.model_to_string() != bc2.model_to_string():
            fail("phase 13 (b): two CEGB card runs gave different text")
        used = int(st.feature_used.sum().item())
        acq = float(st.used_rows.float().mean().item())
        print(f"CEGB (1M x 28, 10 rounds classic, split / coupled / lazy "
              f"penalties): s/round {per_cg:.5f} (the plain classic recipe "
              f"{per_0:.5f}), train() {wall_cg:.2f} s, peak {peak_cg:.1f} "
              f"MiB, acquisition state {st.used_rows.numel() / 2**20:.1f} "
              f"MiB bool; {used} of {F} features used, {acq:.4f} of the "
              f"(row, feature) pairs acquired; launches a tree "
              f"{json.dumps({k: round(v / 10, 2) for k, v in counts.items() if v})}; "
              f"two runs to the same text", flush=True)
        del bc1, bc2, st
        mark("(b)")

        # (c) linear trees: counts zeroed just before, read after predict
        rng = np.random.default_rng(13)
        X, y = synth_piecewise(N, rng)
        Xv, yv = synth_piecewise(N, rng)
        t0 = time.perf_counter()
        dsl = lgbt.Dataset(X, y, params={"max_bin": 255, "verbosity": -1,
                                         "linear_tree": True}).construct()
        t_ds = time.perf_counter() - t0
        LK.normal_launches = LK.score_launches = 0
        FK.launches = 0
        torch.cuda.reset_peak_memory_stats()
        bl, per_l, wall_l, peak_l = fused_train(torch, lgbt, dsl, 100,
                                                classic=True, **LINEAR_13)
        lin_train = linear_launches(LK)
        gl = bl._gbdt
        T_ = len(gl.models)
        if not (gl.linear and gl._use_batched_grower()
                and gl.hp.hist_dtype == "float32"
                and all(t.is_linear for t in gl.models[1:])):
            fail("phase 13 (c): the linear run did not take the batched "
                 "float32 grower with linear leaves")
        if min(lin_train.values()) < T_ - 1:
            fail(f"phase 13 (c): linear kernel launches {lin_train} for "
                 f"{T_} trees")
        FK.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = bl.predict(Xv)
        t_pred = time.perf_counter() - t0
        n_fk = FK.launches
        lin_counts = dict(lin_train, forest_linear=n_fk)
        if n_fk < 1:
            fail("phase 13 (c): Booster.predict of the linear model did "
                 "not launch the forest kernel")
        rmse = float(np.sqrt(np.mean((pred - yv) ** 2)))
        host = bl.predict(Xv[:N_HOST_CHECK])
        if not np.allclose(pred[:N_HOST_CHECK], host, rtol=2e-5, atol=2e-6):
            fail(f"phase 13 (c): linear predict vs the host walk: max abs "
                 f"diff {np.abs(pred[:N_HOST_CHECK] - host).max()}")
        leaves_n = sum(t.num_leaves for t in gl.models) / T_
        nfeat = np.mean([len(f) for t in gl.models for f in t.leaf_features
                         if t.is_linear])
        print(f"linear trees (1M x 28 piecewise-linear target, 100 rounds "
              f"classic, batched float32): dataset {t_ds:.2f} s, s/round "
              f"{per_l:.5f}, train() {wall_l:.2f} s, peak {peak_l:.1f} MiB; "
              f"{leaves_n:.1f} leaves a tree, {nfeat:.2f} features a "
              f"leaf's model; launches {json.dumps(lin_train)} for {T_} "
              f"trees; held-out RMSE {rmse:.5f} (target sd "
              f"{float(yv.std()):.5f})", flush=True)
        # the prediction's steps on the card: the kernel and the plain
        # version on the same device inputs
        t0 = time.perf_counter()
        fb, lin_np, cat_feats = forest_bitset_arrays(gl.models, 1,
                                                     gl.train_set)
        t_tab = time.perf_counter() - t0
        forest = MP.forest_from_numpy(fb, dev)
        cols = np.nonzero(lin_np["featmask"].any((0, 1)))[0]
        lin = MP.forest_from_numpy(dict(
            const=lin_np["const"], coeff=lin_np["coeff"][..., cols],
            featmask=lin_np["featmask"][..., cols]), dev)
        t0 = time.perf_counter()
        bins_np = gl.train_set.bin_external_pred(Xv)
        t_bin = time.perf_counter() - t0
        t0 = time.perf_counter()
        bins_t = torch.as_tensor(np.ascontiguousarray(bins_np.T),
                                 device=dev)
        raw_t = torch.as_tensor(np.ascontiguousarray(
            Xv[:, cols].astype(np.float32).T), device=dev)
        torch.cuda.synchronize()
        t_copy = time.perf_counter() - t0
        del bins_np
        fn = lambda: FK.forest_values(forest, bins_t, 1, cat_feats,  # noqa
                                      lin=lin, raw_t=raw_t)
        out = fn()
        plain_fn = lambda: MP.predict_bitset_forest(  # noqa: E731
            forest, bins_t, 1, cat_feats, lin=lin,
            raw=torch.nan_to_num(raw_t, nan=0.0).t(),
            raw_nan=torch.isnan(raw_t).to(torch.float32))
        plain = plain_fn()
        if not (torch.equal(out, plain) and torch.equal(fn(), out)):
            fail(f"forest kernel linear mode vs the plain version: max abs "
                 f"diff {(out - plain).abs().max().item()}")
        if not np.array_equal(out.double().cpu().numpy()[:, 0], pred):
            fail("phase 13 (c): Booster.predict's values differ from the "
                 "forest kernel's")
        nl, dms = device_per_call(torch, fn, reps=5)
        ms = time_ms(torch, fn, flush)
        pms = time_ms(torch, plain_fn, flush, reps=1)
        plain_forest_ms = time_ms(torch, lambda: FK.forest_values(
            forest, bins_t, 1, cat_feats), flush)
        leaves = FK.forest_leaves(forest, bins_t, cat_feats)
        steps = int(torch.gather(forest.depth.long(), 1,
                                 leaves.long()).sum().item())
        pk = FK.pack_linear(lin)
        nnz = int((pk.feat >= 0).sum(-1).gather(1, leaves.long())
                  .sum().item())
        p = FK.pack_forest(forest, cat_feats)
        fbytes = sum(x.numel() * x.element_size() for x in p) + sum(
            x.numel() * x.element_size() for x in pk)
        nbytes = bins_t.numel() * 4 + raw_t.numel() * 4 + 4 * N + fbytes
        bnd, by = bound_ms(nbytes, steps + 2 * nnz)
        print(f"predict (linear, {N:,} x {T_} trees): Booster.predict "
              f"{t_pred:.3f} s ({N / t_pred:,.0f} rows/s), {n_fk} forest-"
              f"kernel launch(es); its steps: the forest's host tables "
              f"{t_tab:.3f} s, host binning {t_bin:.3f} s, bins and raw "
              f"columns to the card {t_copy:.3f} s; the forest kernel's "
              f"linear mode one call {ms:.4f} ms, device {dms} ms ({nl} "
              f"launches a call, the tables' packing included); the same "
              f"forest without its linear leaves {plain_forest_ms:.4f} ms; "
              f"the plain version on the card (the only card path before "
              f"the linear mode) {pms:.4f} ms; {steps:,} node steps and "
              f"{nnz:,} coefficients, bound {bnd:.4f} ms ({by}); bitwise "
              f"equal to the plain version, twice; host walk on "
              f"{N_HOST_CHECK:,} rows within rtol 2e-5 / atol 2e-6",
              flush=True)
        forest_row = dict(name="forest_linear", route="cuda",
                          source="lightgbm_tpu_torch/csrc/forest.cu",
                          replaces="lightgbm_tpu/models/predict.py:340",
                          launches=n_fk, max_abs_err=0.0, ms=ms,
                          plain_ms=pms, bound_ms=bnd, bound_by=by,
                          library_ms=None, device_ms=dms)
        del out, plain, leaves, bins_t, raw_t
        # two runs of 5 rounds, and the strict learner at 90k rows
        l1, *_ = fused_train(torch, lgbt, dsl, 5, classic=True, **LINEAR_13)
        l2, *_ = fused_train(torch, lgbt, dsl, 5, classic=True, **LINEAR_13)
        if l1.model_to_string() != l2.model_to_string():
            fail("phase 13 (c): two linear card runs gave different text")
        if [t.to_text(i) for i, t in enumerate(l1._gbdt.models)] != \
                [t.to_text(i) for i, t in enumerate(gl.models[:5])]:
            fail("phase 13 (c): the 5-round linear run's trees differ from "
                 "the 100-round run's first trees")
        del l1, l2
        dss = lgbt.Dataset(X[:N_STRICT], y[:N_STRICT],
                           params={"max_bin": 255, "verbosity": -1,
                                   "linear_tree": True}).construct()
        s1, per_s, _, _ = fused_train(torch, lgbt, dss, 3, classic=True,
                                      **LINEAR_13)
        s2, *_ = fused_train(torch, lgbt, dss, 3, classic=True, **LINEAR_13)
        if s1._gbdt._use_batched_grower() or \
                s1.model_to_string() != s2.model_to_string():
            fail("phase 13 (c): the strict linear run took the batched "
                 "grower, or two runs differ")
        print(f"linear trees, strict ({N_STRICT:,} x 3 classic): s/round "
              f"{per_s:.5f}, two runs to the same text; 1M x 5 twice to "
              f"the same text", flush=True)
        del s1, s2, dss
        mark("(c)")

        # (d) the linear kernels against their plain versions
        rows, fit_ms, score_ms = check_linear_kernels(torch, LK, gl, flush)
        for r in rows:
            r["launches"] = lin_counts[r["name"]]
        print(f"linear round (1M rows): the fit {fit_ms:.4f} ms and the "
              f"scores {score_ms:.4f} ms of {per_l * 1e3:.3f} ms a round "
              f"({(fit_ms + score_ms) / (per_l * 1e3):.4f} of it)",
              flush=True)
        print("phase 13 kernels (linear, 1M x 100, and its predict): "
              + json.dumps(lin_counts), flush=True)
        del bl, gl, dsl
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows + [forest_row]


# ---- phase 14: the training surface

def surface_fobj(spent, poison_at=None):
    """Phase 14's custom binary logloss in numpy: (grad, hess) of the
    sigmoid at the raw scores, float64; with ``poison_at`` the gradients of
    that call (that boosting round) are NaN.  The seconds spent inside are
    added to ``spent["fobj"]``."""
    calls = []

    def fobj(preds, data):
        t0 = time.perf_counter()
        p = 1.0 / (1.0 + np.exp(-preds))
        g = p - data.get_label()
        h = p * (1.0 - p)
        if poison_at is not None and len(calls) == poison_at:
            g = np.full_like(g, np.nan)
        calls.append(1)
        spent["fobj"] += time.perf_counter() - t0
        return g, h
    return fobj


def check_training_surface(torch, lgbt, HK, RF, TB, prng, card):
    """Phase 14: the training surface on phase 3's 1M x 28 set and recipe
    (``num_leaves=255``) with its 200,000 held-out rows.  (a) a custom
    binary logloss ``fobj`` in numpy, 10 rounds, against the built-in
    ``binary`` objective with ``boost_from_average=false``, both through
    the classic loop: s/round of each, the ``fobj`` round's share in the
    callback and in the host-card copies (the scores' copy to the host
    timed in the round, the gradients' upload timed apart on the same
    arrays), the held-out AUC of each (within 1e-3), the ``fobj`` text's
    sha256 twice (equal).  (b) that ``fobj`` with NaN gradients at round 3
    under ``skip_round`` (9 trees of 10), ``raise`` (the message names
    round 3) and ``halt_and_keep_best`` (3 trees, ``best_iteration`` 3),
    with the counters.  (c) ``init_model`` continuation, 5 + 5 rounds: the
    init scores of the training and held-out rows through the forest
    kernel (``DEVICE_PREDICT_MIN_WORK`` lowered for the call: 1M x 5 trees
    is below it), its launches counted (zeroed just before, read just
    after); the continued booster's raw predictions equal the init
    model's plus the new trees' within 1e-5, and so does its held-out
    score cache.  (d) ``cv(nfold=5)`` at 1M rows x 5 rounds with
    ``metric=auc``: seconds and the peak and live device memory at each
    fold's end (no growth from fold 2 on).  (e) ``refit`` of (a)'s
    built-in booster on the 1M rows and ``rollback_one_iter``, timed; the
    scores after the rollback equal those of that run at its round 9
    within 1e-5.  Returns the forest kernel's launches in (c)."""
    from lightgbm_tpu_torch.boosting import gbdt as G
    from lightgbm_tpu_torch.ops import forest_kernels as FK
    t_phase = time.perf_counter()
    dev = torch.device("cuda")

    def mark(what):
        print(f"phase 14 {what}: {time.perf_counter() - t_phase:.1f} s",
              flush=True)

    ds, X, y, Xv, yv, _ = slice_data(lgbt, N, 0, 255)
    spent = {"fobj": 0.0, "d2h": 0.0}
    real_preds = lgbt.Booster._current_train_preds

    def timed_preds(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_preds(self)
        spent["d2h"] += time.perf_counter() - t0
        return out

    def clocked(rounds, stamps, snap=None):
        def clock(env):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            if snap is not None and env.iteration == rounds - 2:
                snap.append(env.model._gbdt.scores.clone())
        return clock

    # (a) fobj against the built-in objective, both classic
    zero_counts(HK, RF, TB, prng)
    stamps_f = []
    lgbt.Booster._current_train_preds = timed_preds
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b_f = lgbt.train(dict(RECIPE), ds, 10,
                         fobj=surface_fobj(spent),
                         callbacks=[clocked(10, stamps_f)])
        wall_f = time.perf_counter() - t0
    finally:
        lgbt.Booster._current_train_preds = real_preds
    counts_f = launch_counts(HK, RF, TB, prng)
    g = b_f._gbdt
    if g.objective is not None or g.supports_fused() or \
            b_f.num_trees() != 10:
        fail("phase 14 (a): the fobj run did not train 10 custom-gradient "
             "trees")
    per_f = float(np.mean(np.diff(stamps_f)))
    # the gradients' upload, the same two arrays, timed apart
    gh = surface_fobj({"fobj": 0.0})(b_f._current_train_preds(), ds)
    n = ds.num_data()
    ups = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in gh:
            torch.as_tensor(np.asarray(a, np.float32).reshape(
                n, 1, order="F"), device=dev)
        torch.cuda.synchronize()
        ups.append(time.perf_counter() - t0)
    h2d = float(np.median(ups))
    stamps_b, snap = [], []
    t0 = time.perf_counter()
    b_b = lgbt.train(dict(RECIPE, boost_from_average=False), ds, 10,
                     callbacks=[clocked(10, stamps_b, snap)])
    if b_b._gbdt._fused_cache:
        fail("phase 14 (a): the built-in run took the fused loop")
    per_b = float(np.mean(np.diff(stamps_b)))
    auc_f = auc(yv, b_f.predict(Xv, raw_score=True))
    auc_b = auc(yv, b_b.predict(Xv, raw_score=True))
    sha_f = text_sha256(b_f)
    b_f2 = lgbt.train(dict(RECIPE), ds, 10, fobj=surface_fobj({"fobj": 0}))
    sha_f2 = text_sha256(b_f2)
    del b_f2
    print(f"phase 14 (a) fobj (numpy binary logloss, 1M x 10, classic): "
          f"s/round {per_f:.5f} (rounds 2-10), the built-in binary "
          f"(boost_from_average=false, classic) {per_b:.5f}; of the fobj "
          f"rounds' {wall_f:.3f} s: callback {spent['fobj']:.3f} s "
          f"({spent['fobj'] / wall_f:.4f}), scores to the host "
          f"{spent['d2h']:.3f} s ({spent['d2h'] / wall_f:.4f}), gradients "
          f"to the card {10 * h2d:.3f} s ({10 * h2d / wall_f:.4f}, timed "
          f"apart); held-out AUC fobj {auc_f:.6f} built-in {auc_b:.6f}; "
          f"fobj model text sha256 {sha_f} and {sha_f2}; card {card}",
          flush=True)
    print("phase 14 kernels (fobj, 1M x 10, classic): "
          + json.dumps(counts_f), flush=True)
    if abs(auc_f - auc_b) > 1e-3 or not auc_f > 0.7:
        fail(f"phase 14 (a): held-out AUC fobj {auc_f} vs built-in {auc_b}")
    if sha_f != sha_f2:
        fail("phase 14 (a): two fobj card runs gave different model text")
    for k_ in ("histogram_payload", "partition_payload", "take_small_table"):
        if counts_f[k_] <= 0:
            fail(f"phase 14 (a): the fobj run never launched {k_}")
    del b_f
    mark("(a)")

    # (b) nan_policy: NaN gradients at round 3
    vs = ds.create_valid(Xv, yv)
    got = {}
    for policy in ("skip_round", "raise", "halt_and_keep_best"):
        rec = {}
        p = dict(RECIPE, nan_policy=policy, metric="auc")
        try:
            b = lgbt.train(p, ds, 10, valid_sets=[vs], valid_names=["v"],
                           fobj=surface_fobj({"fobj": 0.0}, poison_at=3),
                           callbacks=[lgbt.record_evaluation(rec)])
        except lgbt.LightGBMError as e:
            if policy != "raise" or "round 3" not in str(e):
                fail(f"phase 14 (b) {policy}: {e}")
            got[policy] = str(e)
            continue
        c = b.telemetry()["counters"]
        got[policy] = dict(trees=b.num_trees(),
                           best_iteration=b.best_iteration,
                           recorded=len(rec["v"]["auc"]),
                           counters={k_: v for k_, v in c.items()
                                     if k_.startswith("nan_")})
        del b
    if "round 3" not in got.get("raise", ""):
        fail("phase 14 (b): nan_policy=raise did not raise at round 3")
    sk, hk = got["skip_round"], got["halt_and_keep_best"]
    if not (sk["trees"] == 9 and sk["counters"].get("nan_rounds_skipped")
            == 1 and sk["recorded"] == 10):
        fail(f"phase 14 (b) skip_round: {sk}")
    if not (hk["trees"] == 3 and hk["best_iteration"] == 3
            and hk["recorded"] == 3
            and hk["counters"].get("nan_guard_halts") == 1):
        fail(f"phase 14 (b) halt_and_keep_best: {hk}")
    print("phase 14 (b) nan_policy (NaN gradients at round 3, 1M x 10): "
          + json.dumps(got), flush=True)
    del vs
    mark("(b)")

    # (c) init_model continuation 5 + 5, the init scores through the
    # forest kernel
    dsc = lgbt.Dataset(X, y, params={"max_bin": 255, "verbosity": -1},
                       free_raw_data=False).construct()
    b1 = lgbt.train(dict(RECIPE), dsc, 5)
    old_min = G.GBDT.DEVICE_PREDICT_MIN_WORK
    G.GBDT.DEVICE_PREDICT_MIN_WORK = 0
    try:
        FK.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vsc = dsc.create_valid(Xv, yv)
        rec = {}
        b2 = lgbt.train(dict(RECIPE, metric="auc"), dsc, 5, init_model=b1,
                        valid_sets=[vsc], valid_names=["v"],
                        callbacks=[lgbt.record_evaluation(rec)])
        torch.cuda.synchronize()
        t_cont = time.perf_counter() - t0
        n_fk = FK.launches
        raw2 = b2.predict(Xv, raw_score=True)
        raw1 = b1.predict(Xv, raw_score=True)
        new = b2.predict(Xv, raw_score=True, start_iteration=5)
    finally:
        G.GBDT.DEVICE_PREDICT_MIN_WORK = old_min
    g2 = b2._gbdt
    err_pred = float(np.abs(raw2 - (raw1 + new)).max())
    err_cache = float(np.abs(g2.valid_scores[0][:, 0].cpu().numpy()
                             - raw2).max())
    print(f"phase 14 (c) init_model 5 + 5 (1M rows, the held-out set "
          f"scored in the round): {t_cont:.3f} s, forest kernel launches "
          f"{n_fk} (the init scores of 1M training and 200,000 held-out "
          f"rows), trees {b2.num_trees()}, num_init_iteration "
          f"{g2.num_init_iteration}, fused {bool(g2._fused_cache)}; "
          f"|predict - (init + new trees)| max {err_pred:.3e}, |held-out "
          f"score cache - predict| max {err_cache:.3e}, held-out AUC "
          f"{rec['v']['auc'][-1]:.6f}", flush=True)
    if n_fk < 2 or b2.num_trees() != 10 or g2.num_init_iteration != 5:
        fail(f"phase 14 (c): {n_fk} forest launches, {b2.num_trees()} "
             f"trees")
    if err_pred > 1e-5 or err_cache > 1e-5:
        fail(f"phase 14 (c): continued predictions off by {err_pred} / "
             f"{err_cache}")
    del b1, b2, g2, dsc, vsc
    mark("(c)")

    # (d) cv: five folds, no growth of device memory from fold to fold
    folds = []
    state = {"t": time.perf_counter()}

    def fold_end(env):
        if env.iteration == env.end_iteration - 1:
            torch.cuda.synchronize()
            now = time.perf_counter()
            folds.append((now - state["t"],
                          torch.cuda.max_memory_allocated() / 2**20,
                          torch.cuda.memory_allocated() / 2**20))
            state["t"] = now
            torch.cuda.reset_peak_memory_stats()
    fold_end.order = 40
    fold_end.fused_safe = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = state["t"] = time.perf_counter()
    res = lgbt.cv(dict(RECIPE, metric="auc"), ds, 5, nfold=5, seed=0,
                  callbacks=[fold_end])
    t_cv = time.perf_counter() - t0
    curve = res["valid auc-mean"]
    print(f"phase 14 (d) cv (nfold=5, 1M rows x 5 rounds, metric=auc, "
          f"fused folds): {t_cv:.2f} s; per fold (s, peak MiB, live MiB "
          f"at its end) {json.dumps([[round(a, 3), round(b, 1), round(c, 1)] for a, b, c in folds])}; valid auc-mean "
          f"{[round(v, 6) for v in curve]}, stdv "
          f"{[round(v, 6) for v in res['valid auc-stdv']]}", flush=True)
    if len(folds) != 5 or len(curve) != 5 or not curve[-1] > 0.7:
        fail(f"phase 14 (d): {len(folds)} folds, curve {curve}")
    if any(f[1] > folds[1][1] + 16 or f[2] > folds[1][2] + 16
           for f in folds[2:]):
        fail(f"phase 14 (d): device memory grew from fold 2 on: {folds}")
    mark("(d)")

    # (e) refit and rollback of (a)'s built-in booster
    t0 = time.perf_counter()
    r = b_b.refit(X, y)
    t_refit = time.perf_counter() - t0
    raw_r = r.predict(Xv, raw_score=True)
    auc_r = auc(yv, raw_r)
    moved = float(np.abs(raw_r - b_b.predict(Xv, raw_score=True)).max())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b_b.rollback_one_iter()
    torch.cuda.synchronize()
    t_rb = time.perf_counter() - t0
    err_rb = float((b_b._gbdt.scores - snap[0]).abs().max())
    print(f"phase 14 (e) refit (1M rows x 10 trees, decay 0.9): "
          f"{t_refit:.3f} s, held-out AUC {auc_r:.6f} (before {auc_b:.6f}),"
          f" raw scores moved by up to {moved:.3e};"
          f" rollback_one_iter {t_rb * 1e3:.2f} ms, |scores - round 9's| "
          f"max {err_rb:.3e}, trees {b_b.num_trees()}", flush=True)
    if b_b.num_trees() != 9 or err_rb > 1e-5 or not auc_r > 0.7:
        fail(f"phase 14 (e): rollback left {b_b.num_trees()} trees, scores "
             f"off by {err_rb}, refit AUC {auc_r}")
    del b_b, r, snap
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return n_fk


# ---- phase 15: the user surfaces

#: phase 15 (a)'s file rows (phase 3's first rows) and LibSVM rows, cut
#: from 200,000 and 50,000 for the phase's time budget (the host's text
#: parse and write run at ~7 MiB/s)
N_FILE, N_LIBSVM = 50_000, 10_000
#: the auto policy's four settings, given explicitly where the rows are
#: below its 100,000-row switch (and on the CLI, which passes every
#: parameter explicitly): the batched int8 recipe, the fused loop
AUTO4 = dict(tpu_split_batch=42, tpu_hist_dtype="int8",
             use_quantized_grad=True, quant_train_renew_leaf=True)
FILE_RECIPE = dict(RECIPE, **AUTO4)
#: phase 15 (c)'s wide sparse set (tests/test_ingestion.py:314-390):
#: 8 exclusive groups of 500 one-hot columns, seed 11; its forest-kernel
#: predict takes the first of the 50,000 rows' three 16,777-row blocks,
#: and its card-vs-CPU check 50,000 rows (cut from 50,000 and 100,000 for
#: the phase's budget: the host bins 4,000 columns a block, the CPU trains
#: on the plain versions)
N_WIDE, WIDE_GROUPS, WIDE_MEMBERS = 1_000_000, 8, 500
N_WIDE_FOREST, N_WIDE_CROSS = 16_777, 50_000
#: (e)'s linear model's rows, and the live device memory (the bytes its
#: tensors requested) a booster reset to a subset may hold beyond a fresh
#: booster's on it (one 1M-row float32 vector is 3.8 MiB)
N_LIN, MEM_SLACK_MIB = 200_000, 1.0
WIDE_PARAMS = dict(objective="binary", num_leaves=15, verbosity=-1,
                   max_bin=63, min_data_in_leaf=20, tpu_split_batch=4,
                   tpu_hist_dtype="float32", metric="auc")


def synth_wide_sparse(n, rng):
    """tests/test_ingestion.py's Allstate-shaped CSR matrix: each row one
    indicator in each of ``WIDE_GROUPS`` groups of ``WIDE_MEMBERS``
    columns; the label depends on group 0's member."""
    import scipy.sparse as sp
    member = rng.integers(0, WIDE_MEMBERS, size=(n, WIDE_GROUPS))
    rows = np.repeat(np.arange(n), WIDE_GROUPS)
    cols = (np.arange(WIDE_GROUPS)[None, :] * WIDE_MEMBERS + member).ravel()
    X = sp.csr_matrix((np.ones(n * WIDE_GROUPS), (rows, cols)),
                      shape=(n, WIDE_GROUPS * WIDE_MEMBERS))
    y = ((member[:, 0] % 7 < 3).astype(np.float64)
         + 0.3 * rng.normal(size=n) > 0.5).astype(np.float64)
    return X, y


class RssPeak:
    """The process's resident set, sampled every 10 ms from
    /proc/self/statm in a thread while the block runs: ``grew`` is the
    peak minus the resident set at entry, in bytes."""

    def _rss(self):
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def __enter__(self):
        import threading
        self.start = self.peak = self._rss()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.01):
                self.peak = max(self.peak, self._rss())
        self._t = threading.Thread(target=sample, daemon=True)
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        self.peak = max(self.peak, self._rss())
        self.grew = self.peak - self.start
        return False


def fused_s_round(bst):
    """s/round of a fused ``train()``: its chunk walls over their rounds
    (``FusedRound.walls``, the capture left out)."""
    frs = list(bst._gbdt._fused_cache.values())
    if len(frs) != 1 or frs[0].graphs is None:
        fail("a phase 15 training expected on the fused loop did not "
             "replay its CUDA graphs")
    return (sum(w for w, _ in frs[0].walls)
            / sum(r for _, r in frs[0].walls))


def write_csv(path, y, X, header):
    """y then X as '%.17g' CSV (float64 round trip), with a header."""
    M = np.column_stack([np.asarray(y, np.float64),
                         np.asarray(X, np.float64)])
    np.savetxt(path, M, fmt="%.17g", delimiter=",", comments="",
               header=",".join(header))


def write_libsvm(path, y, X):
    """y then 1-based index:value pairs of the nonzeros, '%.17g'."""
    with open(path, "w") as f:
        for lab, row in zip(y, np.asarray(X, np.float64)):
            nz = np.flatnonzero(row)
            f.write(f"{lab:.17g} " + " ".join(
                f"{j + 1}:{row[j]:.17g}" for j in nz) + "\n")


def cli_argv(csv, out):
    """The CLI's training arguments on (a)'s file: ``FILE_RECIPE`` (the
    CLI, like the JAX package's, passes every parameter explicitly, and
    the auto policy yields to explicit settings)."""
    return [f"data={csv}", "header=true", "objective=binary",
            "num_leaves=255", "max_bin=255", "learning_rate=0.1",
            "min_data_in_leaf=0", "min_sum_hessian_in_leaf=100",
            "num_iterations=5", "tpu_split_batch=42",
            "tpu_hist_dtype=int8", "use_quantized_grad=true",
            "quant_train_renew_leaf=true", "verbosity=-1",
            f"output_model={out}"]


def check_user_surfaces(torch, lgbt, HK, RF, TB, prng, card):
    """Phase 15: the user surfaces on the card, no new kernel.  (a) phase
    3's first ``N_FILE`` rows as a CSV with a header, a label column and a
    ``.weight`` companion, and ``N_LIBSVM`` rows as LibSVM:
    ``Dataset(path)`` gives the in-memory Dataset's bins, label and
    weights; 5 fused rounds (``FILE_RECIPE``) from the file give the
    matrix's model text; the parse time and MiB/s.  (b) ``save_binary`` /
    ``load_binary`` of (a)'s Dataset and of an ``N_FILE``-row
    phase-7-shaped bundled one: 5 fused rounds from each loaded file give
    the original's text; the file sizes.  (c) the
    Allstate shape of tests/test_ingestion.py (1M rows, 8 x 500 one-hot
    columns, seed 11) from CSR: construction s and the host's resident
    set growth (under 4 GB; dense float64 would be 32 GB), the bundled
    columns (at most 64), ``device_n_bins``, the kernels the batched
    grower launched, 5 fused rounds' s/round; the trainer's scores against
    ``Booster.predict`` of the CSR on 50,000 rows (the JAX test's
    collision ceiling: under 0.1% of rows off by more than 1e-4, the rest
    within rtol 1e-5), that predict of its first ``N_WIDE_FOREST`` rows
    on the forest kernel (``DEVICE_PREDICT_MIN_WORK`` lowered for the
    call) against the host walk; ``N_WIDE_CROSS`` rows of that binning x
    1 round on the card and the CPU to the same text
    (regression with leaf renewal off: exact gradients, so the two
    devices can share the text).  (d) ``LGBMClassifier(n_estimators=20)``
    on phase 3's 1M rows with the 200,000-row held-out set as its
    ``eval_set`` and ``early_stopping_rounds=5`` to ``train()``'s text,
    ``predict_proba[:, 1]`` equal to ``booster_.predict``, its s/round
    beside phase 5's; an ``LGBMRegressor`` and an ``LGBMRanker`` at
    100,000 rows x 5 to ``train()``'s texts.  (e) on a card booster (phase
    3's set, 5 fused rounds): ``feature_importance`` against the text's
    split counts and summed gains, ``dump_model``'s leaf values against
    the text's; after ``set_leaf_output``, ``merge_models`` (a second
    booster without boost-from-average, whose folded bias the score cache
    would leave out, as in the JAX package; then its text loaded, whose
    thresholds the rebuild bins) and ``shuffle_models``,
    ``eval_train`` equal to the metric of ``predict(raw_score=True)``, and
    so after a linear model's ``set_leaf_output`` (``N_LIN`` rows x 3; the
    rebuild one linear-scores launch a linear tree);
    ``reset_training_data`` to a 500,000-row subset, 5 more fused rounds
    equal to the classic loop's, its live device memory at most
    ``MEM_SLACK_MIB`` over a fresh booster's of 5 fused rounds on the
    subset.  (f) the CLI (``python3 -m lightgbm_tpu_torch``) in
    subprocesses, started after (d)'s timed fit (the rest of (d) and (e)
    run beside them) and collected here: ``task=train`` on (a)'s CSV to
    the Python API's text on the same file and arguments, ``task=predict``
    equal to ``Booster.predict``, ``task=convert_model`` a non-empty C++
    file, and exit code 1 with ``CUDA_VISIBLE_DEVICES=""``.  Returns the
    launches per part."""
    import scipy.sparse as sp
    from lightgbm_tpu_torch.application import parse_argv
    from lightgbm_tpu_torch.boosting import gbdt as G
    from lightgbm_tpu_torch.config import Config, normalize_params
    from lightgbm_tpu_torch.ops import forest_kernels as FK
    from lightgbm_tpu_torch.ops import linear_kernels as LK
    t_phase = time.perf_counter()
    part_launches = {}

    def mark(what):
        print(f"phase 15 {what}: {time.perf_counter() - t_phase:.1f} s",
              flush=True)

    def counted(part):
        c = {k: v for k, v in launch_counts(HK, RF, TB, prng).items() if v}
        if FK.launches:
            c["forest_values"] = FK.launches
        part_launches[part] = c
        zero_counts(HK, RF, TB, prng)
        FK.launches = 0

    tmp = tempfile.mkdtemp(prefix="chip_smoke_p15_")
    procs = []
    try:
        ds_full, X, y, Xv, yv, _ = slice_data(lgbt, N, 0, 255)
        zero_counts(HK, RF, TB, prng)
        FK.launches = 0

        # (a) file input
        rng = np.random.default_rng(15)
        Xf, yf = X[:N_FILE], y[:N_FILE]
        wf = rng.uniform(0.5, 1.5, size=N_FILE)
        csv = os.path.join(tmp, "higgs.csv")
        t0 = time.perf_counter()
        write_csv(csv, yf, Xf, ["label"] + [f"f{j}" for j in range(F)])
        np.savetxt(csv + ".weight", wf, fmt="%.17g")
        svm = os.path.join(tmp, "higgs.svm")
        write_libsvm(svm, y[:N_LIBSVM], X[:N_LIBSVM])
        t_write = time.perf_counter() - t0
        mb = os.path.getsize(csv) / 2**20
        fp = {"max_bin": 255, "verbosity": -1, "header": True}
        t0 = time.perf_counter()
        dsf = lgbt.Dataset(csv, params=fp).construct()
        t_parse = time.perf_counter() - t0
        dsm = lgbt.Dataset(Xf, yf, weight=wf, params={
            "max_bin": 255, "verbosity": -1}).construct()
        fi, mi = dsf._inner, dsm._inner
        if not (np.array_equal(fi.bins, mi.bins)
                and np.array_equal(fi.metadata.label, mi.metadata.label)
                and np.array_equal(fi.metadata.weight, mi.metadata.weight)):
            fail("phase 15 (a): the CSV's Dataset differs from the "
                 "matrix's (bins, label or weights)")
        t0 = time.perf_counter()
        dss = lgbt.Dataset(svm, params={"max_bin": 255,
                                        "verbosity": -1}).construct()
        t_svm = time.perf_counter() - t0
        dsd = lgbt.Dataset(np.column_stack([np.zeros(N_LIBSVM),
                                            X[:N_LIBSVM]]), y[:N_LIBSVM],
                           params={"max_bin": 255,
                                   "verbosity": -1}).construct()
        if not np.array_equal(dss._inner.bins, dsd._inner.bins):
            fail("phase 15 (a): the LibSVM file's bins differ from the "
                 "matrix's (1-based indices: column 0 empty)")
        b_file = lgbt.train(dict(FILE_RECIPE), dsf, 5)
        b_mat = lgbt.train(dict(FILE_RECIPE), dsm, 5)
        per_file = fused_s_round(b_file)
        if b_file.model_to_string() != b_mat.model_to_string():
            fail("phase 15 (a): 5 fused rounds from the CSV gave another "
                 "model text than from the matrix")
        # the Python API's model on the CLI's arguments; the CLI's
        # subprocesses start after (d)'s timed fit and are collected in (f)
        api_model = os.path.join(tmp, "api_model.txt")
        argv = cli_argv(csv, os.path.join(tmp, "cli_model.txt"))
        cli_params = Config(normalize_params(parse_argv(argv))).to_dict()
        b_api = lgbt.train(cli_params, dsf, 5)
        b_api.save_model(api_model)
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=root)
        cli = [sys.executable, "-m", "lightgbm_tpu_torch"]
        runs = {
            "train": (argv, env),
            "predict": ([f"task=predict", f"data={csv}", "header=true",
                         f"input_model={api_model}",
                         f"output_result={os.path.join(tmp, 'pred.txt')}"],
                        env),
            "convert_model": ([f"task=convert_model",
                               f"input_model={api_model}",
                               f"convert_model="
                               f"{os.path.join(tmp, 'model.cpp')}"], env),
            "no card": ([f"data={csv}", "num_iterations=1",
                         f"output_model={os.path.join(tmp, 'x.txt')}"],
                        dict(env, CUDA_VISIBLE_DEVICES="")),
        }
        counted("(a)")
        print(f"phase 15 (a) file input: CSV {N_FILE:,} x {F + 1} with a "
              f"header and a .weight file, {mb:.1f} MiB, written in "
              f"{t_write:.2f} s (with {N_LIBSVM:,} LibSVM rows), parsed "
              f"and binned in {t_parse:.2f} s ({mb / t_parse:.1f} MiB/s); "
              f"LibSVM {N_LIBSVM:,} rows {t_svm:.2f} s; bins, label and "
              f"weights equal to the matrix's; 5 fused rounds from the file "
              f"(s/round {per_file:.5f}) gave the matrix's text", flush=True)
        del dsm, dss, dsd, b_mat
        mark("(a)")

        # (b) binary datasets: (a)'s Dataset and a bundled one
        rng = np.random.default_rng(7)
        Xb, yb, _ = synth_bundled(N_FILE, rng)
        dsb = lgbt.Dataset(Xb, yb, params={"max_bin": 255,
                                           "verbosity": -1}).construct()
        if dsb._inner.bundle_plan is None:
            fail("phase 15 (b): the phase-7-shaped set was not bundled")
        sizes = {}
        for name, d in (("file", dsf), ("bundled", dsb)):
            path = os.path.join(tmp, f"{name}.bin")
            t0 = time.perf_counter()
            d.save_binary(path)
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = lgbt.Dataset(path).construct()
            t_load = time.perf_counter() - t0
            sizes[name] = (os.path.getsize(path) / 2**20, t_save, t_load)
            if not np.array_equal(loaded._inner.bins, d._inner.bins):
                fail(f"phase 15 (b) {name}: loaded bins differ")
            # (a)'s training of the file's Dataset is the first baseline
            b0 = b_file if d is dsf else lgbt.train(dict(FILE_RECIPE), d, 5)
            b1 = lgbt.train(dict(FILE_RECIPE), loaded, 5)
            fused_s_round(b1)
            if b0.model_to_string() != b1.model_to_string():
                fail(f"phase 15 (b) {name}: 5 fused rounds from the loaded "
                     f"binary gave another text")
            del loaded, b0, b1
        del b_file
        counted("(b)")
        print("phase 15 (b) binary datasets (MiB, save s, load s): "
              + json.dumps({k: [round(a, 2), round(b, 3), round(c, 3)]
                            for k, (a, b, c) in sizes.items()})
              + f"; bundled {Xb.shape[1]} features into "
              f"{dsb._inner.bins.shape[1]} columns; 5 fused rounds from "
              f"each loaded file gave the original's text", flush=True)
        del dsb, Xb
        mark("(b)")

        # (c) wide sparse input, the Allstate shape
        rng = np.random.default_rng(11)
        t0 = time.perf_counter()
        Xw, yw = synth_wide_sparse(N_WIDE, rng)
        t_make = time.perf_counter() - t0
        with RssPeak() as rss:
            t0 = time.perf_counter()
            dsw = lgbt.Dataset(Xw, yw, params=dict(WIDE_PARAMS)).construct()
            t_con = time.perf_counter() - t0
        wi = dsw._inner
        if rss.grew >= 4 << 30 or wi.bins.shape[1] > 64 \
                or wi.bins.dtype != np.uint8 or wi.bundle_plan is None:
            fail(f"phase 15 (c): construction grew the resident set by "
                 f"{rss.grew / 2**30:.2f} GiB, bins {wi.bins.shape} "
                 f"{wi.bins.dtype}")
        zero_counts(HK, RF, TB, prng)
        bw = lgbt.train(dict(WIDE_PARAMS), dsw, 5)
        gw = bw._gbdt
        per_w = fused_s_round(bw)
        kc = {k: v for k, v in launch_counts(HK, RF, TB, prng).items() if v}
        pred = bw.predict(Xw[:50_000])
        train_p = 1.0 / (1.0 + np.exp(-gw.scores[:50_000, 0].double()
                                      .cpu().numpy()))
        off = np.abs(train_p - pred) > 1e-4
        if off.mean() >= 1e-3 or not np.allclose(
                train_p[~off], pred[~off], rtol=1e-5, atol=1e-6):
            fail(f"phase 15 (c): trainer scores vs predict of the CSR: "
                 f"{int(off.sum())} of 50,000 rows off by more than 1e-4")
        FK.launches = 0
        orig = G.GBDT.DEVICE_PREDICT_MIN_WORK
        G.GBDT.DEVICE_PREDICT_MIN_WORK = 0
        try:
            t0 = time.perf_counter()
            pred_dev = bw.predict(Xw[:N_WIDE_FOREST])
            t_pdev = time.perf_counter() - t0
        finally:
            G.GBDT.DEVICE_PREDICT_MIN_WORK = orig
        n_fk = FK.launches
        if n_fk < 1 or not np.allclose(pred_dev, pred[:N_WIDE_FOREST],
                                       rtol=2e-5, atol=2e-6):
            fail(f"phase 15 (c): {n_fk} forest launches for the sparse "
                 f"predict, max abs diff vs the host walk "
                 f"{np.abs(pred_dev - pred[:N_WIDE_FOREST]).max()}")
        a_w = auc(yw[:50_000], pred)
        print(f"phase 15 (c) wide sparse ({N_WIDE:,} x "
              f"{Xw.shape[1]:,} CSR, {Xw.nnz:,} nonzeros, made in "
              f"{t_make:.2f} s): construction {t_con:.2f} s, resident set "
              f"peak {rss.peak / 2**30:.2f} GiB, +{rss.grew / 2**20:.0f} MiB "
              f"over its start (dense float64 would be "
              f"{N_WIDE * Xw.shape[1] * 8 / 2**30:.1f} GiB); "
              f"{len(wi.used_feature_idx):,} features bundled into "
              f"{wi.bins.shape[1]} columns, bins on the card "
              f"{gw.bins.numel() / 2**20:.1f} MiB, device_n_bins "
              f"{wi.device_n_bins()}, hist_kernel {gw.hp.hist_kernel} at "
              f"{gw.hp.n_bins} bins, {gw.hp.hist_dtype}; 5 fused rounds "
              f"s/round {per_w:.5f}, the kernels the batched grower "
              f"launched {json.dumps(kc)}; "
              f"trainer scores vs predict of 50,000 CSR rows: {int(off.sum())}"
              f" off by more than 1e-4 (EFB's sampled conflicts), AUC "
              f"{a_w:.6f}; the forest kernel on the first {N_WIDE_FOREST:,} "
              f"rows ({n_fk} launch(es), threshold lowered) {t_pdev:.2f} s, "
              f"within rtol 2e-5 of the host walk",
              flush=True)
        if t_con > 20:
            print(f"phase 15 (c): construction took {t_con:.1f} s, over "
                  f"20 s on this host", flush=True)
        counted("(c)")
        # card against CPU, 100k x 1: the same text
        xp = dict(WIDE_PARAMS, objective="regression", metric="l2",
                  tpu_hist_dtype="int8", use_quantized_grad=True,
                  quant_train_renew_leaf=False, stochastic_rounding=False)
        # the first rows of the 1M-row binning: its 256-bin bundles
        dsx = dsw.subset(np.arange(N_WIDE_CROSS), params=dict(xp))
        t0 = time.perf_counter()
        b_g = lgbt.train(dict(xp), dsx, 1)
        b_c = lgbt.train(dict(xp, device_type="cpu"), dsx, 1)
        t_x = time.perf_counter() - t0
        if trees_text(b_g) != trees_text(b_c):
            fail("phase 15 (c): wide sparse x 1 round, card text differs from "
                 "the CPU's")
        print(f"phase 15 (c) cross-check ({N_WIDE_CROSS:,} x 1, regression, "
              f"int8, leaf "
              f"renewal off): card text equal to the CPU's "
              f"({b_g._gbdt.models[0].num_leaves} leaves, "
              f"{dsx._inner.bins.shape[1]} columns), {t_x:.2f} s",
              flush=True)
        counted("(c) cross-check")
        del Xw, yw, dsw, bw, gw, dsx, b_g, b_c, pred, pred_dev, train_p
        mark("(c)")

        # (d) the sklearn estimators
        clf = lgbt.LGBMClassifier(n_estimators=20, verbosity=-1)
        t0 = time.perf_counter()
        clf.fit(X, y, eval_set=[(Xv, yv)], early_stopping_rounds=5)
        t_clf = time.perf_counter() - t0
        per_clf = fused_s_round(clf.booster_)
        # the CLI's subprocesses run beside the rest of (d) and (e), whose
        # printed times are taken under their load
        t_cli0 = time.perf_counter()
        for name, (args, e) in runs.items():
            procs.append((name, subprocess.Popen(
                cli + args, cwd=root, env=e, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
        p = clf._train_params()
        b_t = lgbt.train(p, clf.booster_.train_set, 20,
                         valid_sets=[clf.booster_.train_set.create_valid(
                             Xv, label=yv)],
                         callbacks=[lgbt.early_stopping(5),
                                    lgbt.record_evaluation({})])
        if clf.booster_.model_to_string() != b_t.model_to_string():
            fail("phase 15 (d): LGBMClassifier's text differs from "
                 "train()'s")
        proba = clf.predict_proba(Xv)
        if not np.array_equal(proba[:, 1], clf.booster_.predict(Xv)):
            fail("phase 15 (d): predict_proba[:, 1] differs from "
                 "booster_.predict")
        a_clf = auc(yv, proba[:, 1])
        n_r = min(100_000, len(y))
        reg = lgbt.LGBMRegressor(n_estimators=5, verbosity=-1)
        yr = X[:n_r] @ np.linspace(-1, 1, F) + y[:n_r]
        reg.fit(X[:n_r], yr)
        # train() on the estimators' own (binned) Datasets
        b_r = lgbt.train(reg._train_params(), reg.booster_.train_set, 5)
        rk = lgbt.LGBMRanker(n_estimators=5, verbosity=-1)
        yk = np.digitize(yr, np.quantile(yr, [0.5, 0.75, 0.9, 0.97]))
        grp = np.full(n_r // 100, 100)
        grp[-1] += n_r % 100
        rk.fit(X[:n_r], yk, group=grp)
        b_k = lgbt.train(rk._train_params(), rk.booster_.train_set, 5)
        for name, e, b in (("LGBMRegressor", reg, b_r),
                           ("LGBMRanker", rk, b_k)):
            if e.booster_.model_to_string() != b.model_to_string():
                fail(f"phase 15 (d): {name}'s text differs from train()'s")
        counted("(d)")
        print(f"phase 15 (d) sklearn: LGBMClassifier(n_estimators=20) on "
              f"1M x {F} with a 200,000-row eval_set and early stopping "
              f"(patience 5): fit {t_clf:.2f} s, {clf.n_estimators_} trees "
              f"(best iteration {clf.best_iteration_}), s/round "
              f"{per_clf:.5f} (phase 5's default {FUSED_S_ROUND.get('default', float('nan')):.5f}), "
              f"held-out AUC {a_clf:.6f}; its text equal to train()'s, "
              f"predict_proba[:, 1] equal to booster_.predict; "
              f"LGBMRegressor and LGBMRanker (100k x 5) equal to train()'s "
              f"texts; fused: classifier {bool(clf.booster_._gbdt._fused_cache)}, "
              f"regressor {bool(reg.booster_._gbdt._fused_cache)}, ranker "
              f"{bool(rk.booster_._gbdt._fused_cache)}", flush=True)
        del clf, b_t, reg, rk, b_r, b_k, proba
        mark("(d)")

        # (e) inspection and model edits on a card booster
        pe = dict(RECIPE, metric="binary_logloss")
        b = lgbt.train(pe, ds_full, 5)
        text = b.model_to_string()
        nfeat = b.num_feature()
        cnt, gain = np.zeros(nfeat), np.zeros(nfeat)
        leaf_text = []
        for line in text.splitlines():
            if line.startswith("split_feature="):
                feats = np.array(line.split("=")[1].split(), int)
                np.add.at(cnt, feats, 1)
            elif line.startswith("split_gain="):
                np.add.at(gain, feats, np.maximum(
                    np.array(line.split("=")[1].split(), float), 0.0))
            elif line.startswith("leaf_value="):
                leaf_text.extend(float(v) for v in line.split("=")[1].split())
        leaf_dump = []

        def leaves(node):
            if "leaf_value" in node:
                leaf_dump.append((node["leaf_index"], node["leaf_value"]))
            else:
                leaves(node["left_child"])
                leaves(node["right_child"])
        for info in b.dump_model()["tree_info"]:
            start = len(leaf_dump)
            leaves(info["tree_structure"])
            leaf_dump[start:] = sorted(leaf_dump[start:])
        if not np.array_equal(b.feature_importance("split"), cnt) or \
                not np.allclose(b.feature_importance("gain"), gain,
                                rtol=1e-5, atol=0):
            fail("phase 15 (e): feature_importance differs from the model "
                 "text's split counts or gains")
        if [v for _, v in leaf_dump] != leaf_text:
            fail("phase 15 (e): dump_model's leaf values differ from the "
                 "text's")

        def eval_vs_predict(bst, Xe, ye):
            """eval_train's logloss and the host's of predict(raw_score)
            over ``Xe`` (the forest kernel: the threshold lowered)."""
            (_, _, val, _), = bst.eval_train()
            keep = G.GBDT.DEVICE_PREDICT_MIN_WORK
            G.GBDT.DEVICE_PREDICT_MIN_WORK = 0
            try:
                raw = bst.predict(Xe, raw_score=True)
            finally:
                G.GBDT.DEVICE_PREDICT_MIN_WORK = keep
            p_ = np.clip(1.0 / (1.0 + np.exp(-raw)), 1e-15, 1 - 1e-15)
            want = float(-np.mean(ye * np.log(p_)
                                  + (1 - ye) * np.log(1 - p_)))
            return val, want

        second = lgbt.train(dict(pe, boost_from_average=False), ds_full, 3)
        # a linear model's leaf edit: its scores are rebuilt through the
        # linear scores kernel, one launch a linear tree
        dl = lgbt.Dataset(X[:N_LIN], y[:N_LIN], params={
            "max_bin": 255, "verbosity": -1, "linear_tree": True}).construct()
        bl = lgbt.train(dict(pe, linear_tree=True), dl, 3)
        n_lin = sum(t.is_linear for t in bl._gbdt.models)
        edits, lin_rebuild = {}, None
        for name, bst, (Xe, ye), edit in (
                ("set_leaf_output", b, (X, y),
                 lambda: b.set_leaf_output(2, 3, b.get_leaf_output(2, 3)
                                           + 0.5)),
                ("merge_models", b, (X, y), lambda: b.merge_models(second)),
                # a model read from text has no bin thresholds: the rebuild
                # bins its thresholds with the training set's mappers
                ("merge_models (loaded)", b, (X, y),
                 lambda: b.merge_models(lgbt.Booster(
                     model_str=second.model_to_string()))),
                ("shuffle_models", b, (X, y), lambda: b.shuffle_models()),
                ("linear set_leaf_output", bl, (X[:N_LIN], y[:N_LIN]),
                 lambda: bl.set_leaf_output(1, 0, bl.get_leaf_output(1, 0)
                                            + 0.5))):
            LK.score_launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            edit()
            torch.cuda.synchronize()
            t_e = time.perf_counter() - t0
            if bst is bl:
                lin_rebuild = LK.score_launches
            val, want = eval_vs_predict(bst, Xe, ye)
            edits[name] = [round(t_e, 3), val, want]
            if abs(val - want) > 1e-5 * abs(want):
                fail(f"phase 15 (e) {name}: eval_train {val} vs the metric "
                     f"of predict {want}")
        if b.num_trees() != 11:
            fail(f"phase 15 (e): {b.num_trees()} trees after the merge")
        if n_lin < 2 or lin_rebuild != n_lin:
            fail(f"phase 15 (e): the linear model's score rebuild launched "
                 f"the linear scores kernel {lin_rebuild} times for {n_lin} "
                 f"linear trees")
        del b, second, bl, dl
        # reset_training_data to a 500,000-row subset, 5 more fused rounds,
        # against the classic loop; its live device memory against a fresh
        # booster's of 5 fused rounds on the subset
        sub = ds_full.subset(np.arange(0, N, 2))
        texts, mem, alloc = [], {}, []

        def live_mib():
            """The bytes the live tensors asked for (a block the allocator
            hands out whole may hold up to 1 MiB more than was asked)."""
            gc.collect()
            torch.cuda.synchronize()
            st = torch.cuda.memory_stats()
            alloc.append(round(st["allocated_bytes.all.current"] / 2**20, 1))
            return st["requested_bytes.all.current"] / 2**20
        for loop in ("fused", "fresh", "classic"):
            bb = lgbt.train(dict(RECIPE), sub if loop == "fresh" else ds_full,
                            5)
            if loop == "fresh":
                mem["fresh"] = live_mib()
                del bb
                continue
            if loop == "fused":
                mem["before"] = live_mib()
            bb.reset_training_data(sub)
            if loop == "fused":
                bb._gbdt.train_fused(5)
                mem["after"] = live_mib()
                fused_s_round(bb)
            else:
                for _ in range(5):
                    bb.update()
            texts.append(trees_text(bb))
            del bb
        if texts[0] != texts[1]:
            fail("phase 15 (e): after reset_training_data, the fused loop's "
                 "text differs from the classic loop's")
        if mem["after"] > mem["fresh"] + MEM_SLACK_MIB:
            fail(f"phase 15 (e): after reset_training_data the booster "
                 f"holds more live device memory than a fresh one on the "
                 f"subset (MiB): {mem}")
        counted("(e)")
        print(f"phase 15 (e) inspection on a card booster (1M x 5): "
              f"feature_importance equal to the text's split counts and "
              f"summed gains, dump_model's leaf values the text's; edits "
              f"(s beside the CLI's subprocesses, eval_train, the metric of "
              f"predict) {json.dumps(edits)}; the linear model's rebuild "
              f"({N_LIN:,} x 3) {lin_rebuild} linear-scores launches for "
              f"{n_lin} linear trees; reset_training_data to 500,000 rows "
              f"+ 5 fused rounds equal to the classic loop's text; live "
              f"device MiB (requested) with the 1M-row booster "
              f"{mem['before']:.1f}, "
              f"after the reset and 5 rounds {mem['after']:.1f}, a fresh "
              f"booster's of 5 fused rounds on the subset "
              f"{mem['fresh']:.1f} (at most {MEM_SLACK_MIB} MiB more "
              f"allowed; allocated blocks {alloc})", flush=True)
        del sub
        mark("(e)")

        # (f) the CLI's subprocesses
        out = {}
        for name, pr in procs:
            try:
                so, se = pr.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                pr.kill()
                so, se = pr.communicate()
            out[name] = (pr.returncode, se)
        t_cli = time.perf_counter() - t_cli0
        bad = {k: (rc, se[-800:]) for k, (rc, se) in out.items()
               if (rc != 0) != (k == "no card")}
        if bad or "device_type=cpu" not in out["no card"][1]:
            fail(f"phase 15 (f): CLI exit codes {json.dumps(bad)}")
        with open(os.path.join(tmp, "cli_model.txt")) as f:
            cli_text = f.read()
        if cli_text != b_api.model_to_string():
            fail("phase 15 (f): the CLI's model file differs from the "
                 "Python API's text on the same file")
        cli_pred = np.loadtxt(os.path.join(tmp, "pred.txt"))
        want = lgbt.Booster(model_file=api_model).predict(
            np.asarray(Xf, np.float64))
        if not np.array_equal(cli_pred, want):
            fail("phase 15 (f): task=predict differs from Booster.predict")
        cpp = os.path.getsize(os.path.join(tmp, "model.cpp"))
        if cpp == 0:
            fail("phase 15 (f): task=convert_model wrote an empty file")
        print(f"phase 15 (f) CLI (python3 -m lightgbm_tpu_torch, 4 "
              f"subprocesses started after (d)'s timed fit, {t_cli:.1f} s "
              f"to the last): "
              f"task=train on the CSV equal to the Python API's text "
              f"(fused: {bool(b_api._gbdt._fused_cache)}), task=predict of "
              f"{N_FILE:,} rows equal to Booster.predict, convert_model "
              f"{cpp / 2**20:.2f} MiB of C++, exit code "
              f"{out['no card'][0]} with CUDA_VISIBLE_DEVICES=\"\"",
              flush=True)
        del b_api, dsf
    finally:
        for _, pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    print("phase 15 kernels (launches per part): "
          + json.dumps(part_launches), flush=True)
    t = time.perf_counter() - t_phase
    print(f"phase 15: {t:.1f} s", flush=True)
    return part_launches


# ---- phase 16: the C API on the card

#: phase 16's C consumer: reads the rows the script wrote, trains through
#: the C ABI on the card (booster A on this thread, booster B on a pthread,
#: from the same dataset handle), predicts, and checks that B equals A
C_CONSUMER = r"""
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <stdint.h>
#include <time.h>
#include "capi.h"

#define CHECK(call) do { if ((call) != 0) { \
  fprintf(stderr, "FAIL %s: %s\n", #call, LGBMTPU_GetLastError()); \
  return 1; } } while (0)

static double now(void) {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return t.tv_sec + 1e-9 * t.tv_nsec;
}

static void* slurp(const char* dir, const char* name, size_t bytes) {
  char path[4096];
  snprintf(path, sizeof path, "%s/%s", dir, name);
  FILE* f = fopen(path, "rb");
  void* p = malloc(bytes);
  if (!f || !p || fread(p, 1, bytes, f) != bytes) {
    fprintf(stderr, "cannot read %s\n", path);
    exit(2);
  }
  fclose(f);
  return p;
}

static void spill(const char* dir, const char* name, const void* p,
                  size_t bytes) {
  char path[4096];
  snprintf(path, sizeof path, "%s/%s", dir, name);
  FILE* f = fopen(path, "wb");
  fwrite(p, 1, bytes, f);
  fclose(f);
}

static char* model_text(int64_t bst) {
  int64_t need = 0;
  if (LGBMTPU_BoosterSaveModelToString(bst, NULL, &need)) return NULL;
  char* text = malloc(need);
  if (LGBMTPU_BoosterSaveModelToString(bst, text, &need)) return NULL;
  return text;
}

struct job {
  int64_t bst, np, f;
  const double* xp;
  double* out;
  int rounds;
  char err[1024];
};

/* the second host thread: rounds and a predict on handles made by main */
static void* second_thread(void* arg) {
  struct job* j = (struct job*)arg;
  int fin = 0;
  j->err[0] = 0;
  for (int r = 0; r < j->rounds; ++r)
    if (LGBMTPU_BoosterUpdateOneIter(j->bst, &fin) != 0) {
      snprintf(j->err, sizeof j->err, "update: %s", LGBMTPU_GetLastError());
      return NULL;
    }
  int64_t len = j->np;
  if (LGBMTPU_BoosterPredictForMat(j->bst, j->xp, j->np, j->f, 1, j->out,
                                   &len) != 0 || len != j->np)
    snprintf(j->err, sizeof j->err, "predict: %s", LGBMTPU_GetLastError());
  return NULL;
}

int main(int argc, char** argv) {
  if (argc != 7) return 2;
  const char* dir = argv[1];
  const int64_t n = atoll(argv[2]), f = atoll(argv[3]), np = atoll(argv[4]);
  const int rounds = atoi(argv[5]);
  const char* params = argv[6];
  double* X = slurp(dir, "X.bin", sizeof(double) * n * f);
  double* y = slurp(dir, "y.bin", sizeof(double) * n);
  double* xp = slurp(dir, "Xp.bin", sizeof(double) * np * f);
  double t0 = now();
  int64_t ds, a, b;
  CHECK(LGBMTPU_DatasetCreateFromMat(X, n, f, y, params, &ds));
  double t_ds = now() - t0;
  CHECK(LGBMTPU_BoosterCreate(ds, params, &a));
  CHECK(LGBMTPU_BoosterCreate(ds, params, &b));
  printf("c rounds:");
  int fin = 0;
  for (int r = 0; r < rounds; ++r) {
    double t = now();
    CHECK(LGBMTPU_BoosterUpdateOneIter(a, &fin));
    printf(" %.6f", now() - t);
  }
  printf("\n");
  double* pred = malloc(sizeof(double) * np);
  double* raw = malloc(sizeof(double) * np);
  int64_t len = np;
  t0 = now();
  CHECK(LGBMTPU_BoosterPredictForMat(a, xp, np, f, 0, pred, &len));
  double t_pred = now() - t0;
  len = np;
  CHECK(LGBMTPU_BoosterPredictForMat(a, xp, np, f, 1, raw, &len));
  spill(dir, "pred.bin", pred, sizeof(double) * np);
  spill(dir, "raw.bin", raw, sizeof(double) * np);
  char* text_a = model_text(a);
  if (!text_a) return 3;
  spill(dir, "model.txt", text_a, strlen(text_a));
  struct job j = {b, np, f, xp, malloc(sizeof(double) * np), rounds, {0}};
  pthread_t th;
  t0 = now();
  if (pthread_create(&th, NULL, second_thread, &j) != 0) return 4;
  pthread_join(th, NULL);
  double t_thread = now() - t0;
  if (j.err[0]) { fprintf(stderr, "second thread: %s\n", j.err); return 5; }
  char* text_b = model_text(b);
  if (!text_b || strcmp(text_a, text_b) != 0) {
    fprintf(stderr, "the second thread's model text differs\n");
    return 6;
  }
  if (memcmp(raw, j.out, sizeof(double) * np) != 0) {
    fprintf(stderr, "the second thread's raw predictions differ\n");
    return 7;
  }
  /* booster a and the dataset are freed; b stays alive at exit */
  CHECK(LGBMTPU_BoosterFree(a));
  CHECK(LGBMTPU_DatasetFree(ds));
  printf("c consumer: dataset %.3f s, predict %lld rows %.3f s, second "
         "thread %.3f s (%d rounds and a predict)\n", t_ds, (long long)np,
         t_pred, t_thread, rounds);
  return 0;
}
"""

#: phase 16's sizes: (a)'s training rows are phase 3's N, its predicted
#: rows, the fast path's single rows, (c)'s requests
N_CAPI_PRED = 100_000
N_FAST_ROWS = 1_000
N_REQUESTS = 120
CAPI_ROUNDS = 5
N_SHIM_CALLS = 2_000


def check_c_api(torch, lgbt, capi_build):
    """Phase 16: the C API on the card, no new kernel.  In this process,
    through the built library (ctypes; ``capi_build`` the future of
    ``lightgbm_tpu_torch.native.build_capi()``, started in phase 1): a
    Dataset made with ``DatasetCreateFromMat`` from phase 3's 1M x 28 rows
    and a Booster with ``BoosterCreate`` and the recipe (no
    ``device_type``: the card).  (a) a Python ``Booster`` on that same
    Dataset object, the two taking turns (ABI, Python, then Python, ABI,
    ...) for ``CAPI_ROUNDS`` rounds each, every round synchronized and
    timed, the texts equal; a C round against a Python round (each side's
    first round left out), and what the shim alone costs a call
    (``N_SHIM_CALLS`` of ``BoosterGetCurrentIteration`` through ctypes
    against the same ``capi_impl`` function called from Python).  (b)
    ``FastInit`` and ``N_FAST_ROWS`` ``PredictForMatSingleRowFast`` calls,
    each equal bitwise to ``Booster.predict`` of the row, one forest-kernel
    launch (leaves mode) a row, the microseconds a row.  (c)
    ``CompiledPredictor`` from the Python booster and from its model text
    over the default ladder: ``N_REQUESTS`` requests of mixed sizes (1 to
    6,000 rows), exact mode bitwise against
    ``Booster.predict(raw_score=True)``, fast mode bitwise against the
    booster's device ``_device_predict_raw``, one launch a chunk, live
    device memory equal at every request after warm-up.  (f) the model
    text loaded through ``BoosterLoadModelFromString`` (no params: the
    card) and ``PredictForMat`` of ``N_CAPI_PRED`` held-out rows, normal
    and raw, with ``DEVICE_PREDICT_MIN_WORK`` lowered for the calls:
    ``Booster.predict``'s loaded-model path, one leaves launch a call,
    bitwise the host walk.  (e) after ``FreeHandle`` of every handle and
    the Python objects, live device memory (requested bytes) within 1 MiB
    of its value at the phase's start.  Then a pure C program compiled
    with gcc against the library and run as a subprocess: (a) the same
    dataset, booster and rounds (each timed), ``PredictForMat`` of
    ``N_CAPI_PRED`` held-out rows (normal and raw), ``SaveModelToString``;
    its text equal to the Python booster's, its predictions equal bitwise
    to that booster's ``predict`` and ``predict(raw_score=True)``.  (d) in
    the same program a pthread runs the rounds and a raw predict on a
    second booster made by the main thread: its text and predictions must
    equal the first's; the program frees one booster and the dataset and
    exits with the other alive.  Returns the forest kernel's launches of
    (b), (c) and (f) (counts zeroed just before each, read just after)."""
    import ctypes
    from lightgbm_tpu_torch import capi_impl as TC
    from lightgbm_tpu_torch.boosting import gbdt as G
    from lightgbm_tpu_torch.ops import forest_kernels as FK
    from lightgbm_tpu_torch.serving import BucketLadder, CompiledPredictor
    t_phase = time.perf_counter()

    def mark(what):
        print(f"phase 16 {what}: {time.perf_counter() - t_phase:.1f} s",
              flush=True)

    def requested(collect=True):
        """Requested device bytes of the live tensors; ``collect`` runs a
        collection pass first (about 0.2 s in this process by phase 16:
        (c) reads without one, a request's tensors die with their last
        reference)."""
        if collect:
            gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_stats()["requested_bytes.all.current"]

    _, X, y, Xv, yv, _ = slice_data(lgbt, N, 0, 255)
    X64 = np.ascontiguousarray(X, np.float64)
    y64 = np.ascontiguousarray(y, np.float64)
    Xp = np.ascontiguousarray(Xv[:N_CAPI_PRED], np.float64)
    params = json.dumps(RECIPE)
    root = os.path.dirname(os.path.abspath(__file__))
    mem0 = requested()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p16_")
    try:
        lib_path = capi_build.result()
        lib = ctypes.CDLL(lib_path)
        lib.LGBMTPU_GetLastError.restype = ctypes.c_char_p
        I64, P = ctypes.c_int64, ctypes.c_void_p

        def ok(rc, what):
            if rc != 0:
                fail(f"phase 16: {what}: "
                     f"{lib.LGBMTPU_GetLastError().decode()}")
        dsh, bh, fh_, lh = I64(), I64(), I64(), I64()
        fin = ctypes.c_int()
        ok(lib.LGBMTPU_DatasetCreateFromMat(
            P(X64.ctypes.data), I64(N), I64(F), P(y64.ctypes.data),
            params.encode(), ctypes.byref(dsh)), "DatasetCreateFromMat")
        ok(lib.LGBMTPU_BoosterCreate(dsh, params.encode(), ctypes.byref(bh)),
           "BoosterCreate")
        bc = TC._handles[bh.value]
        if bc._gbdt.device.type != "cuda":
            fail("phase 16 (a): the C API booster is not on the card")
        # (a) in this process: the ABI booster and a Python booster on the
        # one Dataset, taking turns
        bp = lgbt.Booster(dict(RECIPE), TC._handles[dsh.value])

        def abi_round():
            ok(lib.LGBMTPU_BoosterUpdateOneIter(bh, ctypes.byref(fin)),
               "UpdateOneIter")
        abi_rounds, py_rounds = [], []
        sides = ((abi_round, abi_rounds), (bp.update, py_rounds))
        for i in range(CAPI_ROUNDS):
            for step, times in (sides if i % 2 == 0 else sides[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        del sides, step, times
        text_lib = bc.model_to_string()
        text_py = bp.model_to_string()
        if text_lib != text_py:
            fail("phase 16 (a): the C API booster's text (through the "
                 "library in this process) differs from the Python "
                 "booster's on the same Dataset")
        # the shim alone: a call that does no device work, through ctypes
        # and the C shim, against the function it reaches
        it = ctypes.c_int()
        t0 = time.perf_counter()
        for _ in range(N_SHIM_CALLS):
            ok(lib.LGBMTPU_BoosterGetCurrentIteration(bh, ctypes.byref(it)),
               "GetCurrentIteration")
        t_abi_call = (time.perf_counter() - t0) / N_SHIM_CALLS
        t0 = time.perf_counter()
        for _ in range(N_SHIM_CALLS):
            TC.booster_current_iteration(bh.value)
        t_py_call = (time.perf_counter() - t0) / N_SHIM_CALLS
        if it.value != CAPI_ROUNDS:
            fail(f"phase 16 (a): GetCurrentIteration gave {it.value}")
        mark("(a) in this process")

        # (b) the fast path
        ok(lib.LGBMTPU_BoosterPredictForMatSingleRowFastInit(
            bh, I64(F), 0, ctypes.byref(fh_)), "FastInit")
        rows = Xp[:N_FAST_ROWS]
        out, got = np.zeros(4), np.zeros(N_FAST_ROWS)
        olen = I64()
        FK.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(N_FAST_ROWS):
            ok(lib.LGBMTPU_BoosterPredictForMatSingleRowFast(
                fh_, P(rows[i].ctypes.data), P(out.ctypes.data), I64(4),
                ctypes.byref(olen)), "SingleRowFast")
            got[i] = out[0]
        t_fast = time.perf_counter() - t0
        fast_launches = FK.launches
        if fast_launches != N_FAST_ROWS:
            fail(f"phase 16 (b): {N_FAST_ROWS} fast rows launched the forest "
                 f"kernel {fast_launches} times")
        want = np.array([np.float64(bc.predict(rows[i:i + 1])[0])
                         for i in range(N_FAST_ROWS)])
        if olen.value != 1 or not np.array_equal(got, want):
            fail("phase 16 (b): a fast row differs from Booster.predict of "
                 "the row")
        print(f"phase 16 (b) fast path: {N_FAST_ROWS:,} "
              f"PredictForMatSingleRowFast calls through the library, each "
              f"equal bitwise to Booster.predict of the row, "
              f"{fast_launches} forest-kernel launches (leaves mode, bucket "
              f"1), {t_fast / N_FAST_ROWS * 1e6:.1f} us a row", flush=True)
        raw_py = bp.predict(Xp, raw_score=True)
        pred_py = np.asarray(bp.predict(Xp), np.float64)
        mark("(b)")

        # (c) CompiledPredictor over the default ladder
        g = bp._gbdt
        preds = {"trained": CompiledPredictor.from_booster(bp),
                 "model text": CompiledPredictor.from_model_text(text_py)}
        fast = CompiledPredictor.from_booster(bp, exact=False)
        ladder = BucketLadder()
        for p in (*preds.values(), fast):
            p.warmup()
        rng = np.random.default_rng(16)
        sizes = np.unique(np.concatenate([
            ladder.sizes, [s + 1 for s in ladder.sizes[:-1]],
            np.exp(rng.uniform(0, np.log(6000), N_REQUESTS)).astype(int)]))
        sizes = rng.permutation(np.concatenate([sizes, sizes]))[:max(
            N_REQUESTS, 100)]
        m_first = None
        mems, lat = [], collections.defaultdict(list)
        chunks = serve_launches = 0
        for n_req in sizes:
            lo = int(rng.integers(0, len(Xv) - n_req))
            Xr = Xv[lo:lo + n_req]
            outs = {}
            # the served calls' launches only (counts zeroed just before,
            # read just after); the references below launch too
            FK.launches = 0
            for name, p in preds.items():
                t0 = time.perf_counter()
                outs[name], st = p.predict_ex(Xr)
                lat[name].append((time.perf_counter() - t0) * 1e3)
                chunks += len(st.chunks)
            fo, st = fast.predict_ex(Xr)
            chunks += len(st.chunks)
            serve_launches += FK.launches
            m = requested(collect=False)
            m_first = m if m_first is None else m_first
            mems.append(m)
            want = bp.predict(Xr, raw_score=True)
            for name, o in outs.items():
                if not np.array_equal(o, want):
                    fail(f"phase 16 (c): exact serving ({name}) differs "
                         f"from Booster.predict at {n_req} rows")
            dv = g._device_predict_raw(np.asarray(Xr, np.float64), 0,
                                       CAPI_ROUNDS)
            if not np.array_equal(fo, dv):
                fail(f"phase 16 (c): fast serving differs from the device "
                     f"predict at {n_req} rows")
        if max(mems) != min(mems):
            fail(f"phase 16 (c): live device memory moved across the "
                 f"requests: {min(mems)} to {max(mems)} bytes")
        if serve_launches != chunks:
            fail(f"phase 16 (c): {serve_launches} forest-kernel launches "
                 f"for {chunks} chunks")
        print(f"phase 16 (c) CompiledPredictor (default ladder "
              f"{ladder.sizes}): {len(sizes)} requests of 1..{max(sizes):,} "
              f"rows, trained and model-text exact mode bitwise against "
              f"Booster.predict(raw_score=True), fast mode bitwise against "
              f"the device predict, {chunks} chunks, {serve_launches} "
              f"forest-kernel launches (one a chunk), requested device memory "
              f"{m_first} bytes at every request; median ms a request "
              + json.dumps({k: round(float(np.median(v)), 3)
                            for k, v in lat.items()}), flush=True)
        del preds, fast, g, p
        mark("(c)")

        # (f) a model loaded through the ABI: Booster.predict's loaded
        # path, the threshold lowered for the calls
        ok(lib.LGBMTPU_BoosterLoadModelFromString(text_py.encode(),
                                                  ctypes.byref(lh)),
           "LoadModelFromString")
        lb = TC._handles[lh.value]
        loaded, t_dev = {}, {}
        keep = G.GBDT.DEVICE_PREDICT_MIN_WORK
        G.GBDT.DEVICE_PREDICT_MIN_WORK = 0
        FK.launches = 0
        try:
            for raw in (1, 0):
                buf = np.zeros(N_CAPI_PRED)
                olen = I64(N_CAPI_PRED)     # in: capacity, out: length
                t0 = time.perf_counter()
                ok(lib.LGBMTPU_BoosterPredictForMat(
                    lh, P(Xp.ctypes.data), I64(N_CAPI_PRED), I64(F), raw,
                    P(buf.ctypes.data), ctypes.byref(olen)),
                   "PredictForMat (loaded)")
                t_dev[raw] = time.perf_counter() - t0
                if olen.value != N_CAPI_PRED:
                    fail(f"phase 16 (f): PredictForMat wrote {olen.value} "
                         f"values for {N_CAPI_PRED} rows")
                loaded[raw] = buf
        finally:
            G.GBDT.DEVICE_PREDICT_MIN_WORK = keep
        loaded_launches = FK.launches
        if loaded_launches != 2 or lb._loaded_forest[1].type != "cuda":
            fail(f"phase 16 (f): the loaded model's two predicts launched "
                 f"the forest kernel {loaded_launches} times")
        t0 = time.perf_counter()
        host = {raw: np.asarray(lb.predict(Xp, raw_score=bool(raw)),
                                np.float64) for raw in (1, 0)}
        t_host = time.perf_counter() - t0
        if not all(np.array_equal(loaded[r], host[r]) for r in (0, 1)) or \
                not np.array_equal(loaded[1], raw_py):
            fail("phase 16 (f): the loaded model's device predict differs "
                 "from its host walk or from the trained booster's raw "
                 "scores")
        print(f"phase 16 (f) loaded model (LoadModelFromString, no params): "
              f"PredictForMat of {N_CAPI_PRED:,} rows x {CAPI_ROUNDS} trees, "
              f"normal and raw, through the forest kernel's leaves "
              f"({loaded_launches} launches, DEVICE_PREDICT_MIN_WORK lowered "
              f"for the calls), bitwise the host walk and the trained "
              f"booster's raw scores; s a call raw {t_dev[1]:.4f}, normal "
              f"{t_dev[0]:.4f} (the first builds the tables) vs the host "
              f"walk's two {t_host:.4f} in all", flush=True)

        # (e) freeing
        for h in (fh_, lh, bh, dsh):
            ok(lib.LGBMTPU_FreeHandle(h), "FreeHandle")
        del bc, bp, lb
        mem_e = requested()
        if abs(mem_e - mem0) > 2**20:
            fail(f"phase 16 (e): live device memory {mem_e / 2**20:.3f} MiB "
                 f"after FreeHandle, {mem0 / 2**20:.3f} MiB before (a)")
        print(f"phase 16 (e) freeing: requested device memory "
              f"{mem0 / 2**20:.3f} MiB before (a), {mem_e / 2**20:.3f} MiB "
              f"after FreeHandle of the fast config, the loaded model, the "
              f"booster and the dataset and the Python booster's release",
              flush=True)
        mark("(f)/(e)")

        # (a) + (d): the C consumer in a subprocess
        src = os.path.join(tmp, "consumer.c")
        with open(src, "w") as fh:
            fh.write(C_CONSUMER)
        exe = os.path.join(tmp, "consumer")
        import sysconfig
        pylib = sysconfig.get_config_var("LIBDIR")
        libdir = os.path.dirname(lib_path)
        cc = subprocess.run(
            ["gcc", "-O1", src,
             f"-I{os.path.join(root, 'lightgbm_tpu_torch', 'native')}",
             f"-L{libdir}", "-llgbtpu_capi", f"-Wl,-rpath,{libdir}",
             f"-Wl,-rpath,{pylib}", "-lpthread", "-o", exe],
            capture_output=True, text=True, timeout=120)
        if cc.returncode:
            fail(f"phase 16 (a): gcc failed: {cc.stderr[-2000:]}")
        X64.tofile(os.path.join(tmp, "X.bin"))
        y64.tofile(os.path.join(tmp, "y.bin"))
        Xp.tofile(os.path.join(tmp, "Xp.bin"))
        env = dict(os.environ, PYTHONPATH=root)
        t0 = time.perf_counter()
        r = subprocess.run([exe, tmp, str(N), str(F), str(N_CAPI_PRED),
                            str(CAPI_ROUNDS), params], env=env,
                           capture_output=True, text=True, timeout=600)
        t_c = time.perf_counter() - t0
        if r.returncode:
            fail(f"phase 16 (a)/(d): the C consumer exited "
                 f"{r.returncode}: {r.stderr[-3000:]} {r.stdout[-1000:]}")
        c_rounds = [float(v) for ln in r.stdout.splitlines()
                    if ln.startswith("c rounds:") for v in ln.split()[2:]]
        with open(os.path.join(tmp, "model.txt")) as fh:
            text_c = fh.read()
        if text_c != text_py:
            fail("phase 16 (a): the C consumer's model text differs from "
                 "the Python booster's")
        raw_c = np.fromfile(os.path.join(tmp, "raw.bin"))
        pred_c = np.fromfile(os.path.join(tmp, "pred.bin"))
        if not np.array_equal(raw_c, raw_py) or \
                not np.array_equal(pred_c, pred_py):
            fail("phase 16 (a): the C consumer's predictions differ from "
                 "the Python booster's")

        def med(v):
            return round(float(np.median(v[1:])), 5)

        def rounded(v):
            return json.dumps([round(x, 5) for x in v])
        # rounds 2..: each pair's ABI - Python difference
        diffs = np.subtract(abi_rounds[1:], py_rounds[1:])
        d_se = float(diffs.std(ddof=1) / np.sqrt(len(diffs)))
        print(f"phase 16 (a) C consumer (gcc, embedded CPython, {N:,} x {F}, "
              f"{CAPI_ROUNDS} UpdateOneIter on the card): text equal to the "
              f"Python booster's, {N_CAPI_PRED:,} predictions (raw, normal) "
              f"bitwise; median s a round (2..), synchronized, in this "
              f"process on one Dataset, the sides taking turns: through the "
              f"C ABI {med(abi_rounds)} {rounded(abi_rounds)} vs Python "
              f"{med(py_rounds)} {rounded(py_rounds)}, a pair's ABI - "
              f"Python {float(diffs.mean()):+.5f} +- {d_se:.5f} s (mean, "
              f"standard error); the shim alone "
              f"(ctypes and capi.cpp, {N_SHIM_CALLS} GetCurrentIteration) "
              f"{t_abi_call * 1e6:.2f} us a call vs {t_py_call * 1e6:.2f} us "
              f"for the capi_impl function called from Python; in the C "
              f"program (its own process, the host clock around each call) "
              f"{med(c_rounds)} {rounded(c_rounds)}; the subprocess "
              f"{t_c:.1f} s in all; "
              + " ".join(ln for ln in r.stdout.splitlines()
                         if ln.startswith("c consumer")), flush=True)
        print("phase 16 (d) threads: a pthread's 5 rounds and raw predict "
              "on handles made by the main thread equal the main thread's "
              "(text, bits); the program exited 0 with one booster alive",
              flush=True)
        mark("(a)/(d)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t = time.perf_counter() - t_phase
    print(f"phase 16: {t:.1f} s", flush=True)
    return fast_launches + serve_launches + loaded_launches


def load_other(root):
    """The port package of another checkout (``root``/lightgbm_tpu_torch),
    imported as ``lgbt_other`` beside this one; its kernels build into its
    own ``_build/``."""
    import importlib
    import importlib.util
    pkg = os.path.join(root, "lightgbm_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "lgbt_other", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["lgbt_other"] = mod
    spec.loader.exec_module(mod)
    ops = {m: importlib.import_module(f"lgbt_other.ops.{m}")
           for m in ("cuda_lib", "hist_kernels", "table")}
    return mod, ops


def ab_trainings(torch, old_pkg, new_pkg, pairs=10):
    """The max_bin=63 (1M x 5), default and pooled (1M x 10) trainings and
    the strict default (90k x 10), the two packages alternating (old/new,
    then new/old, ...) on one Dataset each, so that the host's drift falls
    on both.  Returns the runs whose model text differs from the first's;
    prints per package the median round (each run's first excluded), the
    pairs' new - old medians, their mean with its standard error, and the
    pairs the new package won."""
    bad = []
    for tag, n, rounds, extra in (
            ("max_bin=63 1M x 5", N, 5, dict(max_bin=63)),
            ("default 1M x 10", N, 10, {}),
            ("pooled 1M x 10", N, 10, dict(histogram_pool_size=8)),
            ("strict default 90k x 10", N_STRICT, 10, {})):
        params = dict(RECIPE, **extra)
        X, y, _ = synth_higgs(n, F, np.random.default_rng(0))
        pkgs = {"old": old_pkg, "new": new_pkg}
        dss = {who: pkg.Dataset(X, y, params={"max_bin": params["max_bin"],
                                                "verbosity": -1})
               for who, pkg in pkgs.items()}
        for ds in dss.values():
            ds.construct()
        texts, diffs, rounds_s = set(), [], {"old": [], "new": []}
        for i in range(pairs):
            med = {}
            for who in (("old", "new") if i % 2 == 0 else ("new", "old")):
                stamps = []

                def clock(env):
                    torch.cuda.synchronize()
                    stamps.append(time.perf_counter())
                t0 = time.perf_counter()
                bst = pkgs[who].train(params, dss[who],
                                      num_boost_round=rounds,
                                      callbacks=[clock])
                texts.add(text_sha256(bst))
                t = list(np.diff([t0] + stamps)[1:])
                rounds_s[who] += t
                med[who] = float(np.median(t))
            diffs.append(med["new"] - med["old"])
        if len(texts) != 1:
            bad.append(f"{tag}: model text differs")
        print("ab train: " + json.dumps(dict(
            run=tag, same_text=len(texts) == 1, sha256=sorted(texts),
            pairs=pairs, old_median_s=float(np.median(rounds_s["old"])),
            new_median_s=float(np.median(rounds_s["new"])),
            new_minus_old_s=float(np.mean(diffs)),
            stderr_s=float(np.std(diffs, ddof=1) / np.sqrt(pairs)),
            new_won=sum(d < 0 for d in diffs), pair_diffs_s=diffs)),
            flush=True)
        del dss
    return bad


def ab_main(other_root):
    """Phase A/B: this checkout's kernels against another checkout's, in one
    process, old/new/new/old: take_small_table at n = 1M, T = 255,
    histogram_payload at the four compaction buckets of 1M rows (cnt =
    0.8 S, K = 42; int8, and float32 on real values; and this checkout's
    gated call with S on the device against the other's plain call), and
    histogram_radix_single's 1M root pass (5% of rows excluded) and
    histogram_radix_joint (G = 4 and 1) at n = 1M, int8 on uniform bins and
    on bins where 3 of the 28 features take 3 values, float32 on uniform
    bins, each with identical bits required, one-call ms (20 calls, L2
    flushed) and the profiler's device ms and launches per call; then the
    trainings of ab_trainings, whose model text must be identical."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lightgbm_tpu_torch as new_pkg
    from lightgbm_tpu_torch.ops import cuda_lib
    from lightgbm_tpu_torch.ops import hist_kernels as HK
    from lightgbm_tpu_torch.ops import table as TB
    old_pkg, old = load_other(os.path.abspath(other_root))
    OK, OTB = old["hist_kernels"], old["table"]
    dev = torch.device("cuda")
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    cuda_lib.build_all()
    old["cuda_lib"].build_all()
    print(f"ab: build {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(23)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    bad = []
    table = torch.as_tensor(rng.normal(size=T).astype(np.float32),
                            device=dev)
    idx = torch.as_tensor(rng.integers(0, T, size=N, dtype=np.int32),
                          device=dev)
    shapes = [(f"take_small_table n = {N}, T = {T}",
               lambda m: m.take_small_table(table, idx), TB, OTB)]
    lv = rng.permutation(64)[:K].astype(np.int32)
    lv[-2:] = lv[0]
    leaves = torch.as_tensor(lv, device=dev)
    for S in BUCKETS:
        cnt = torch.tensor([int(0.8 * S)], dtype=torch.int32, device=dev)
        for mode in ("int8", "float32"):
            p = payload_bucket(torch, dev, rng, S, mode == "float32")
            shapes.append((f"histogram_payload S = {S}, {mode}",
                           lambda m, p=p, cnt=cnt, mode=mode:
                           m.histogram_payload(p, leaves, cnt, num_f=F,
                                               n_bins=B, hist_dtype=mode),
                           HK, OK))
            # the batched grower's call: gated on, S on the device (the
            # other checkout's ungated pass computes the same function)
            s_dev = torch.tensor([S], dtype=torch.int32, device=dev)
            one = torch.ones(1, dtype=torch.int32, device=dev)
            o = torch.zeros(K, F, B, 4, device=dev)
            shapes.append((f"histogram_payload S = {S}, {mode}, gated (new)",
                           lambda m, p=p, cnt=cnt, mode=mode, s_dev=s_dev,
                           o=o: m.histogram_payload(
                               p, leaves, cnt, num_f=F, n_bins=B,
                               hist_dtype=mode,
                               **(dict(out=o, gate=one, rows=s_dev)
                                  if m is HK else {})), HK, OK))
    bins = torch.as_tensor(rng.integers(0, B - 1, size=(F, N),
                                        dtype=np.uint8), device=dev)
    sets = {"uniform": bins, "skewed": skewed_bins(torch, bins, rng)}
    vals = {"int8": [torch.as_tensor(a.astype(np.float32), device=dev)
                     for a in (rng.integers(-2, 3, size=N),
                               rng.integers(0, 5, size=N))],
            "float32": [torch.as_tensor(a.astype(np.float32), device=dev)
                        for a in (rng.normal(size=N), rng.random(N))]}
    lor = torch.as_tensor(rng.integers(0, 64, size=N, dtype=np.int32),
                          device=dev)
    lor_root = torch.as_tensor(np.where(rng.random(N) < 0.05, -1, 0).astype(
        np.int32), device=dev)
    lv4 = torch.as_tensor(rng.permutation(64)[:4].astype(np.int32),
                          device=dev)
    for bk, mode in (("uniform", "int8"), ("skewed", "int8"),
                     ("uniform", "float32")):
        bb, (g, h) = sets[bk], vals[mode]
        shapes.append((f"histogram_radix_single n = {N} root, {bk}, {mode}",
                       lambda m, bb=bb, g=g, h=h, mode=mode:
                       m.histogram_radix_single(bb, g, h, lor_root, n_bins=B,
                                                hist_dtype=mode), HK, OK))
        for G in ((4, 1) if mode == "int8" else (4,)):
            shapes.append((f"histogram_radix_joint n = {N} G = {G}, {bk}, "
                           f"{mode}",
                           lambda m, bb=bb, g=g, h=h, mode=mode, G=G:
                           m.histogram_radix_joint(bb, g, h, lor, lv4[:G],
                                                   n_bins=B, hist_dtype=mode),
                           HK, OK))
    res = []
    for tag, fn, mnew, mold in shapes:
        a, b_ = fn(mnew), fn(mold)
        a = a if isinstance(a, tuple) else (a,)
        b_ = b_ if isinstance(b_, tuple) else (b_,)
        if not all(u.shape == v.shape and torch.equal(u.view(torch.int32),
                                                      v.view(torch.int32))
                   for u, v in zip(a, b_)):
            bad.append(f"{tag}: bits differ")
        r = dict(shape=tag, old_ms=[], new_ms=[], old_device_ms=[],
                 new_device_ms=[])
        for who, m in (("old", mold), ("new", mnew), ("new", mnew),
                       ("old", mold)):
            call = (lambda m=m: fn(m))
            r[f"{who}_ms"].append(time_ms(torch, call, flush, reps=20))
            nl, dms = device_per_call(torch, call)
            r[f"{who}_device_ms"].append(dms)
            r[f"{who}_launches"] = nl
            r[f"{who}_device_by_kernel"] = {
                k_[:50]: round(us / 10e3, 5) for k_, _, us in last_work}
        r["new_over_old"] = float(np.mean(r["new_ms"]) / np.mean(r["old_ms"]))
        res.append(r)
        print("ab: " + json.dumps(r), flush=True)
    del shapes, bins, sets, vals, lor, lor_root
    torch.cuda.empty_cache()

    bad += ab_trainings(torch, old_pkg, new_pkg)
    print("ab: " + json.dumps(dict(failures=bad)), flush=True)
    if bad:
        fail(f"A/B: {bad}")
    print(json.dumps({"ok": True, "ab": len(res)}), flush=True)


def main():
    t_script = time.perf_counter()
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
    # phase 16's C ABI library (g++ against this interpreter), built beside
    # the kernels and the phases before it
    import concurrent.futures
    from lightgbm_tpu_torch import native
    capi_pool = concurrent.futures.ThreadPoolExecutor(1)
    capi_build = capi_pool.submit(native.build_capi)
    capi_pool.shutdown(wait=False)
    build_s = cuda_lib.build_all()
    print(f"kernel build: {build_s:.1f} s", flush=True)
    sass = sass_atomics(cuda_lib)
    print("sass atomics (cuobjdump): " + ("not measured" if sass is None
                                          else json.dumps(sass)), flush=True)
    if sass is not None:
        masked = {k: v for k, v in sass.items()
                  if k.startswith("masked_cluster")}
        wrong = {k: [o for o in v if o.startswith(("ATOMS.CAST", "ATOMG"))
                     or re.match(r"REDG?\.", o)]
                 for k, v in masked.items()}
        if (set(masked) != MASKED_KERNELS or any(wrong.values())
                or not all("ATOMS.ADD" in v for v in masked.values())):
            fail(f"masked_cluster atomics: {json.dumps(masked)}")
        print("sass atomics (masked_cluster, the kernel of histogram_leaves, "
              "histogram_leaves_radix2 and histogram_radix_joint (bytes), "
              "histogram_radix_single above 131,072 rows (bytes any), "
              "histogram_leaves_packed (words), histogram_payload (payload) "
              "and histogram_leaves_rows (rows)): native ATOMS.ADD, no "
              "ATOMS.CAST.SPIN, no global RED/ATOM: " + json.dumps(masked),
              flush=True)
    for name, text in sorted(cuda_lib.build_log.items()):
        for ln in text.splitlines():
            if "registers" in ln or "error" in ln.lower():
                print(f"  ptxas {name}: {ln.strip()}", flush=True)

    # ---- 2. kernel checks
    rows = check_kernels(torch, torch.device("cuda"))
    print("library device ms (one index_add_ into precomputed cells, "
          "profiler, warm L2): " + json.dumps(library_device), flush=True)
    check_path_shapes(torch, torch.device("cuda"))
    check_masked_shapes(torch, torch.device("cuda"))
    check_packed_partition_shapes(torch, torch.device("cuda"))
    check_radix_shapes(torch, torch.device("cuda"))
    check_leaves_rows(torch, torch.device("cuda"))
    check_take_payload_shapes(torch, torch.device("cuda"))
    check_determinism(torch, torch.device("cuda"))
    print(f"profiler: {len(lost_windows)} window(s) measured again after "
          f"a lost record {json.dumps(lost_windows)}", flush=True)
    print(f"phases 1-2: {time.perf_counter() - t_script:.1f} s", flush=True)

    # ---- 3. the default recipe on the card, through the classic loop (the
    # per-round clock callback is not fused_safe); counts zeroed just
    # before, read just after
    classic_sha = {}
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
    text_main = trees_text(bst)
    classic_sha["default"] = text_sha256(bst)
    print(f"model text sha256 (default recipe, 1M x 10): {text_sha256(bst)}",
          flush=True)
    profile_round(torch, bst)
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
    classic_sha["max_bin=63"] = text_sha256(bst)
    print(f"model text sha256 (max_bin=63, 1M x 5): {text_sha256(bst)}",
          flush=True)
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
    classic_sha["onehot"] = text_sha256(bst)
    print(f"model text sha256 (onehot, 100k x 3): {text_sha256(bst)}",
          flush=True)
    launches["histogram_leaves"] = c1h["histogram_leaves"]
    del bst

    # (c) the strict default: 90k rows, nothing set but the recipe
    zero_counts(HK, RF, TB, prng)
    torch.cuda.reset_peak_memory_stats()
    bst, auc_s, _, t_s, steps_s = train_slice(torch, lgbt, N_STRICT, 10)
    cs = launch_counts(HK, RF, TB, prng)
    peak_s = torch.cuda.max_memory_allocated()
    g = bst._gbdt
    splits = sum(t.num_leaves - 1 for t in g.models)
    print(f"slice (strict default, {N_STRICT} x 10): train {t_s:.2f} s, "
          f"first iter {steps_s[0]:.3f} s, s/iter (2-10) "
          f"{float(np.mean(steps_s[1:])):.4f}, held-out AUC {auc_s:.6f}, "
          f"peak device memory {peak_s / 2**20:.1f} MiB, {splits} splits "
          f"in 10 trees; kernels {json.dumps(cs)}", flush=True)
    if (int(g.config.tpu_split_batch) != 1 or g.hp.hist_dtype != "float32"
            or g._use_batched_grower() or g.supports_fused()):
        fail(f"the strict default resolved tpu_split_batch="
             f"{g.config.tpu_split_batch}, hist_dtype={g.hp.hist_dtype}, "
             f"batched={g._use_batched_grower()}, fused loop admitted="
             f"{g.supports_fused()}")
    if cs["histogram_radix_single"] < splits + 10:
        fail(f"the strict default launched histogram_radix_single "
             f"{cs['histogram_radix_single']} times for {splits} splits")
    if cs["take_small_table"] < 10:
        fail("the strict default did not launch take_small_table each round")
    if not auc_s > 0.7:
        fail(f"strict default held-out AUC {auc_s} is not that of a trained "
             f"model")
    print(f"model text sha256 (strict default, {N_STRICT} x 10): "
          f"{text_sha256(bst)}", flush=True)
    _, where = syncing(torch, bst.update)
    sp = g.models[-1].num_leaves - 1
    in_grower = sum(1 for w in where if w.startswith("grower.py"))
    print(f"strict default: host reads in one round of {sp} splits: "
          f"{len(where)} ({in_grower} in grower.py, "
          f"{in_grower / max(sp, 1):.3f} per split); by source "
          f"{json.dumps(dict(collections.Counter(where)))}", flush=True)
    n_launch = profile_round(torch, bst)
    if n_launch is not None:
        sp = g.models[-1].num_leaves - 1
        print(f"strict default: {n_launch} launches in a round of {sp} "
              f"splits ({n_launch / max(sp, 1):.1f} per split)", flush=True)
    launches["histogram_radix_single"] = cs["histogram_radix_single"]
    del bst

    # (d) the strict default with the bucketed leaf pass: the rows kernel
    zero_counts(HK, RF, TB, prng)
    bst, auc_b, _, t_b, steps_b = train_slice(
        torch, lgbt, N_STRICT, 5, tpu_leaf_hist="bucketed")
    cb = launch_counts(HK, RF, TB, prng)
    print(f"slice (strict, tpu_leaf_hist=bucketed, {N_STRICT} x 5): train "
          f"{t_b:.2f} s, s/iter (2-5) {float(np.mean(steps_b[1:])):.4f}, "
          f"held-out AUC {auc_b:.6f}; kernels {json.dumps(cb)}", flush=True)
    print(f"model text sha256 (strict bucketed, {N_STRICT} x 5): "
          f"{text_sha256(bst)}", flush=True)
    print("strict bucketed: histogram_rows_t launches by S "
          + json.dumps(dict(sorted(HK.rows_launches_by_size.items()))),
          flush=True)
    if cb["histogram_rows_t"] <= 0:
        fail("the bucketed strict run never launched histogram_rows_t")
    launches["histogram_rows_t"] = cb["histogram_rows_t"]
    del bst

    # (e) the pooled default: 1M rows, histogram_pool_size=8 (128 slots)
    zero_counts(HK, RF, TB, prng)
    torch.cuda.reset_peak_memory_stats()
    bst, auc_p, _, t_p, steps_p = train_slice(torch, lgbt, N, 10,
                                              histogram_pool_size=8)
    cp = launch_counts(HK, RF, TB, prng)
    peak_p = torch.cuda.max_memory_allocated()
    print(f"slice (pooled default, histogram_pool_size=8, 1M x 10): train "
          f"{t_p:.2f} s, s/iter (2-10) {float(np.mean(steps_p[1:])):.4f}, "
          f"held-out AUC {auc_p:.6f} (unpooled {auc_main:.6f}), peak device "
          f"memory {peak_p / 2**20:.1f} MiB (unpooled {peak / 2**20:.1f}), "
          f"model text equal to the unpooled run's: "
          f"{trees_text(bst) == text_main}; kernels {json.dumps(cp)}",
          flush=True)
    if bst._gbdt.hp.hist_pool_slots != 128:
        fail(f"histogram_pool_size=8 gave {bst._gbdt.hp.hist_pool_slots} "
             f"slots, not 128")
    if cp["partition_select"] <= 0 or cp["partition_payload"] != 0:
        fail("the pooled run must launch partition_select and never "
             "partition_payload")
    if abs(auc_p - auc_main) > 1e-3:
        fail(f"pooled AUC {auc_p} vs unpooled {auc_main}: more than 1e-3")
    if cp["histogram_leaves"] <= 0:
        fail("the pooled run never launched histogram_leaves (the extended "
             "pass)")
    classic_sha["pooled"] = text_sha256(bst)
    print(f"model text sha256 (pooled default, 1M x 10): {text_sha256(bst)}",
          flush=True)
    launches["partition_select"] = cp["partition_select"]
    del bst

    # (f) deterministic=true at 1M rows: the batched grower in float32,
    # every payload pass in float32; a second run must give the same text
    zero_counts(HK, RF, TB, prng)
    bst, auc_d, _, t_d, steps_d = train_slice(torch, lgbt, N, 5,
                                              deterministic=True)
    cd = launch_counts(HK, RF, TB, prng)
    g = bst._gbdt
    print(f"slice (deterministic=true, 1M x 5): train {t_d:.2f} s, s/iter "
          f"(2-5) {float(np.mean(steps_d[1:])):.4f}, held-out AUC "
          f"{auc_d:.6f}; kernels {json.dumps(cd)}", flush=True)
    if g.hp.hist_dtype != "float32" or not g._use_batched_grower():
        fail(f"deterministic=true at 1M rows resolved hist_dtype="
             f"{g.hp.hist_dtype}, batched={g._use_batched_grower()}")
    if cd["histogram_payload"] <= 0:
        fail("the deterministic run never launched histogram_payload")
    if not auc_d > 0.7:
        fail(f"deterministic held-out AUC {auc_d} is not that of a trained "
             f"model")
    d_again, *_ = train_slice(torch, lgbt, N, 5, deterministic=True,
                              fresh=True)
    if d_again.model_to_string() != bst.model_to_string():
        fail("two card trainings with deterministic=true gave different "
             "model text")
    classic_sha["deterministic"] = text_sha256(bst)
    print(f"model text sha256 (deterministic=true, 1M x 5): "
          f"{text_sha256(bst)}; a second card run gave the same text",
          flush=True)
    del bst, d_again

    print(f"phases 1-3: {time.perf_counter() - t_script:.1f} s", flush=True)

    # ---- 4. cross-check: card vs CPU plain versions, and card vs card
    b_gpu, auc_gpu, *_ = train_slice(torch, lgbt, 100_000, 1, seed=1,
                                     valid=True, fresh=True)
    b_cpu, auc_cpu, *_ = train_slice(torch, lgbt, 100_000, 1, "cpu", seed=1,
                                     valid=True, fresh=True)
    t_g, t_c = b_gpu._gbdt.models[0], b_cpu._gbdt.models[0]
    if not (t_g.num_leaves == t_c.num_leaves
            and np.array_equal(t_g.split_feature, t_c.split_feature)
            and np.array_equal(t_g.threshold_bin, t_c.threshold_bin)):
        fail("tree 0 differs between the card and the CPU")
    print(f"cross-check (100k x 1): tree 0 identical ({t_g.num_leaves} "
          f"leaves), AUC card {auc_gpu:.6f} cpu {auc_cpu:.6f}", flush=True)
    if abs(auc_gpu - auc_cpu) > 1e-3:
        fail(f"AUC card {auc_gpu} vs cpu {auc_cpu} differ by more than 1e-3")
    b_again, *_ = train_slice(torch, lgbt, 100_000, 1, seed=1, valid=True,
                              fresh=True)
    if b_again.model_to_string() != b_gpu.model_to_string():
        fail("two card trainings gave different model text")
    print("cross-check: two card trainings gave byte-identical model text",
          flush=True)
    del b_gpu, b_cpu, b_again

    # the strict default, card vs CPU and card vs card (float32 sums)
    s_gpu, a_gpu, *_ = train_slice(torch, lgbt, 50_000, 1, seed=1)
    s_cpu, a_cpu, *_ = train_slice(torch, lgbt, 50_000, 1, "cpu", seed=1)
    t_g, t_c = s_gpu._gbdt.models[0], s_cpu._gbdt.models[0]
    print(f"cross-check (strict, 50k x 1): AUC card {a_gpu:.6f} cpu "
          f"{a_cpu:.6f}; tree 0: {leading_agreement(t_g, t_c)} of "
          f"{t_g.num_leaves - 1} card splits agree in order with the CPU's "
          f"{t_c.num_leaves - 1}", flush=True)
    if abs(a_gpu - a_cpu) > 1e-3:
        fail(f"strict AUC card {a_gpu} vs cpu {a_cpu}: more than 1e-3")
    s_again, *_ = train_slice(torch, lgbt, 50_000, 1, seed=1, fresh=True)
    if s_again.model_to_string() != s_gpu.model_to_string():
        fail("two card trainings of the strict default (float32) gave "
             "different model text")
    print("cross-check (strict): two card trainings gave byte-identical "
          "model text", flush=True)
    del s_gpu, s_cpu, s_again

    # the pooled recipe, card vs CPU (int8: exact); tree 0 is compared, so
    # the CPU grows that one
    p_gpu, *_ = train_slice(torch, lgbt, 100_000, 3, histogram_pool_size=8)
    p_cpu, *_ = train_slice(torch, lgbt, 100_000, 1, "cpu",
                            histogram_pool_size=8)
    t_g, t_c = p_gpu._gbdt.models[0], p_cpu._gbdt.models[0]
    if not (p_gpu._gbdt.hp.hist_pool_slots > 0
            and t_g.num_leaves == t_c.num_leaves
            and np.array_equal(t_g.split_feature, t_c.split_feature)
            and np.array_equal(t_g.threshold_bin, t_c.threshold_bin)):
        fail("pooled tree 0 differs between the card and the CPU")
    print(f"cross-check (pooled, 100k; card 3 rounds, CPU 1): tree 0 "
          f"identical ({t_g.num_leaves} leaves)", flush=True)
    del p_gpu, p_cpu

    print(f"phases 1-4: {time.perf_counter() - t_script:.1f} s", flush=True)

    # ---- 5. the fused round loop: a plain train() with no per-round
    # callback, each boosting round one CUDA graph replay
    launches.update(check_fused(torch, lgbt, classic_sha, HK, RF, TB, prng))
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(f"phases 1-5: {time.perf_counter() - t_script:.1f} s", flush=True)

    # ---- 6. prediction: the device forest predictor and TreeSHAP
    rows += check_predict(torch, lgbt)

    # ---- 7. EFB-bundled training
    rows += check_bundled(torch, lgbt, HK, RF, TB, prng)

    # ---- 8. categorical features: the table kernels' launches are the
    # bundled and the categorical fused runs' together
    cat_launches = check_categorical(torch, lgbt, HK, RF, TB, prng)
    for r in rows:
        r["launches"] += cat_launches.get(r["name"], 0)

    # ---- 9. row sampling and the boosting modes: the bagged default's
    # launches (zeroed just before, read just after) are checked there
    bag_launches = check_sampling(torch, lgbt, HK, RF, TB, prng)
    print("phase 9 kernels (the bagged default, 1M x 10, fused): "
          + json.dumps(bag_launches), flush=True)

    # ---- 10. the other objectives: multiclass's launches (zeroed just
    # before its first fused run, read just after) are checked there
    mc_launches = check_objectives(torch, lgbt, HK, RF, TB, prng)
    print("phase 10 kernels (multiclass, Covertype shape, 70 trees, "
          "fused): " + json.dumps(mc_launches), flush=True)

    # ---- 11. learning to rank: the rank kernel's launches are the fused
    # lambdarank run's (zeroed just before, read just after); the other
    # kernels' rows keep their earlier phases' counts
    rank_row, rank_launches = check_ranking(torch, lgbt, HK, RF, TB, prng)
    rows.append(rank_row)
    print("phase 11 kernels (lambdarank, MSLR shape, 10 trees, fused): "
          + json.dumps(rank_launches), flush=True)
    # ---- 12. split constraints: the threefry kernel's launches are those
    # of (a)-(c) (zeroed just before, read just after)
    rows.append(check_constraints(torch, lgbt, HK, RF, TB, prng))
    # ---- 13. forced splits, CEGB and linear trees: the linear kernels'
    # launches are the 1M-row linear run's and its prediction's (zeroed just
    # before, read just after)
    rows += check_learner_options(torch, lgbt, HK, RF, TB, prng)
    # ---- 14. the training surface: the forest kernel's launches for the
    # continued training's init scores (zeroed just before, read just
    # after) join its row
    init_fk = check_training_surface(torch, lgbt, HK, RF, TB, prng, card)
    for r in rows:
        if r["name"] == "forest_values":
            r["launches"] += init_fk
    print(f"phases 1-14: {time.perf_counter() - t_script:.1f} s",
          flush=True)
    # ---- 15. the user surfaces: no new kernel; the launches per part are
    # printed there, and the rows keep their earlier phases' counts
    check_user_surfaces(torch, lgbt, HK, RF, TB, prng, card)
    print(f"phases 1-15: {time.perf_counter() - t_script:.1f} s",
          flush=True)
    # ---- 16. the C API: the forest kernel's launches of the fast path,
    # the serving predictor and the loaded model's predict (zeroed just
    # before each, read just after) join its row
    capi_fk = check_c_api(torch, lgbt, capi_build)
    for r in rows:
        if r["name"] == "forest_values":
            r["launches"] += capi_fk
    print(f"phases 1-16: {time.perf_counter() - t_script:.1f} s",
          flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_script:.1f} s in all, the "
          f"kernel build {build_s:.1f} s of it", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--ab":
        ab_main(sys.argv[2])
    else:
        main()
