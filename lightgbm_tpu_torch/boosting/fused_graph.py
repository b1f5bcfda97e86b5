"""The fused round loop's boosting round, captured as CUDA graphs.

Counterpart of the scan body of ``GBDT.train_fused`` in
``lightgbm_tpu/boosting/gbdt.py`` (``round_real``): gradients -> the row
sampling's draw (bagging or GOSS, where configured) -> integer levels ->
the batched tree (the warm-up ladder, then a fixed budget of
K-wide rounds, learner/batch_grower.py ``BatchedTree`` with no host read)
-> leaf renewal -> shrinkage -> the score update (``take_small_table``) ->
valid-set scores (path aggregation, models/predict.py) -> device metrics ->
the early-stopping state.  Where the JAX package compiles a chunk of rounds
into one scan, this module runs one round over static buffers:

* on the card, :meth:`FusedRound.run` replays one captured
  ``torch.cuda.CUDAGraph`` per boosting round (``main``), then reads ONE
  flag word back.  Its bit 0 says the tree is still growing (a tree whose
  rounds split fewer leaves than they could, e.g. a chain): then a
  one-round graph (``extra``) is replayed until the bit clears, and the
  round's tail (``tail``: renewal to the stop flag) again.  ``main``
  commits the round's scores, stop state and outputs only when the tree
  is complete, so the tail's replay after the extra rounds redoes it;
* on the CPU the same bodies run eagerly (the tests' path).

Forced splits (``forcedsplits_filename``) ride the same graph: ``main``
first runs one K = 1 forced round per schedule entry (the schedule's
length is a host number known at set-up, so the captured graph holds that
many), then the K-wide rounds without the warm-up ladder; a failed entry
sets a device flag that turns the remaining forced rounds into no-ops.

A k-class objective (multiclass) grows k trees a round.  One class body is
captured and replayed k times: a fourth graph (``grads``) evaluates the
[n, k] gradients and draws the round's rows once, then ``main`` grows the
tree of class ``c``, a device scalar that ``tail`` moves on when the tree
is complete (its column of the gradients, its stochastic rounding key
``fold_in(key, c)``, its column of the train and valid scores and its
part of the chunk row), so a round reads one flag a class.  The metrics
and the stop state are kept after the last class.  (Unrolling k class
bodies into one graph would multiply the graph's nodes, its capture time
and the trees' state in the pool by k.)

Round inputs that change every round sit in device buffers staged once
per chunk, never in the captured kernels' arguments: the stochastic
rounding keys (the two threefry keys of ``split(fold_in(key(seed * 7919 +
iter), 0))``, their words derived on the host as in ``ops/prng.py``), the
per-tree feature masks, the row sampling's key words and warm-up flag
(boosting/sample_strategy.py ``round_words``: bagging's
``fold_in(key(bagging_seed), iter // freq)``, GOSS's ``fold_in(key(
bagging_seed), iter)`` and ``iter >= warm-up``), the node-key words of
each round and class where trees draw per node (extra trees, by-node
sampling: ``key(extra_seed * 1000003 + iter * k + cls)``, the classic
loop's, derived on the host and read inside the round as a device
tensor, so every replay draws its own round's thresholds and subsets),
the round's index in the chunk and its iteration.  The sampled row mask goes to the tree and to
leaf renewal, as in the classic loop.
Every round writes its trees and metric values into row ``t`` of one
[T, k P + M] float32 buffer; the host takes it in one transfer per chunk.
On categorical data the row also carries ``split_cat`` and ``cat_bitset``
(one byte a bin, four to a float32 word).
The flag's bit 1 is the in-round early stop, bit 2 a stump: either makes
the host stop replaying.

Capture failure raises ``LightGBMError``; there is no fallback to the
classic loop.
"""

from __future__ import annotations

import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from ..learner.batch_grower import BatchedTree, full_width_rounds
from ..learner.grower import TreeArrays
from ..ops import hist_kernels, prng, rank, round_fuse, table
from ..ops.quantize import discretize_gradients_levels, renew_leaf_values
from ..ops.table import take_small_table
from ..utils import log

#: the TreeArrays fields a chunk row carries, in order (split_cat and
#: cat_bitset follow them on categorical data only: all False otherwise)
_PACKED = ("split_feature", "split_bin", "default_left", "left_child",
           "right_child", "split_gain", "internal_value", "internal_count",
           "leaf_value", "leaf_count", "leaf_weight", "leaf_depth",
           "leaf_path", "num_leaves")
_FLOAT = ("split_gain", "internal_value", "internal_count", "leaf_value",
          "leaf_count", "leaf_weight")

#: flag word bits
GROWING, STOPPED, STUMP = 1, 2, 4

#: graph replays and host flag reads of this process's fused rounds (read
#: by chip_smoke.py): ``replays`` counts every graph launched, ``reads``
#: every flag word read back, ``extra`` the one-round graphs
counts = {"replays": 0, "reads": 0, "extra": 0, "rounds": 0}

#: the one side stream per device that every warm-up and capture runs on.
#: PyTorch keeps a cuBLAS workspace (32 MiB on Hopper) for each stream
#: that ran a matmul (the valid sets' path aggregation), for the life of
#: the process: a new stream a capture added 32 MiB a ``train()`` with a
#: valid set until the stream pool wrapped round.
_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def side_stream(dev: torch.device) -> "torch.cuda.Stream":
    """The side stream of device ``dev`` (made on first use)."""
    s = _SIDE_STREAMS.get(dev)
    if s is None:
        s = _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
    return s

#: the kernel wrappers' launch counters (module, attribute).  A wrapper
#: counts when its Python code launches; inside a capture it records
#: instead, so a capture's counts move to its graph, which adds them on
#: every replay (the launches the replay makes)
_COUNTERS = ((table, "launches"), (round_fuse, "launches"),
             (round_fuse, "select_launches"),
             (round_fuse, "table_launches"),
             (round_fuse, "select_table_launches"), (prng, "launches"),
             (prng, "draw_launches"),
             (rank, "launches"),
             *((hist_kernels, a) for a in (
                 "leaves_launches", "leaves_rows_launches",
                 "payload_launches", "radix_single_launches",
                 "radix_joint_launches", "radix2_launches",
                 "packed_launches", "rows_launches")))


def _read_counters() -> List[int]:
    return [getattr(m, a) for m, a in _COUNTERS]


def _add_counters(delta: List[int], sign: int = 1) -> None:
    for (m, a), d in zip(_COUNTERS, delta):
        setattr(m, a, getattr(m, a) + sign * d)


def _field_shapes(L: int, num_f: int):
    ni = L - 1
    shapes = {f: (ni,) for f in _PACKED[:8]}
    shapes.update({f: (L,) for f in _PACKED[8:12]})
    shapes["leaf_path"] = (L, num_f)
    shapes["num_leaves"] = ()
    return shapes


def _cat_words(L: int, n_bins: int) -> int:
    """float32 words of a row's categorical fields: split_cat as int32,
    then cat_bitset's bytes, padded to whole words."""
    return (L - 1) + -(-(L - 1) * n_bins // 4)


def pack_tree(arrays: TreeArrays, cat: bool = False) -> torch.Tensor:
    """The tree's fields as one float32 row (integers and flags by their
    int32 bit patterns; ``cat``: then split_cat and cat_bitset)."""
    parts = []
    for f in _PACKED:
        a = getattr(arrays, f).reshape(-1)
        if f not in _FLOAT:
            a = a.to(torch.int32).view(torch.float32)
        parts.append(a)
    if cat:
        parts.append(arrays.split_cat.to(torch.int32).view(torch.float32))
        bits = arrays.cat_bitset.reshape(-1).to(torch.uint8)
        bits = torch.nn.functional.pad(bits, (0, (-bits.numel()) % 4))
        parts.append(bits.view(torch.float32))
    return torch.cat(parts)


def unpack_tree(row: np.ndarray, L: int, num_f: int, n_bins: int,
                cat: bool = False) -> TreeArrays:
    """:func:`pack_tree`'s inverse on the host (numpy arrays)."""
    shapes = _field_shapes(L, num_f)
    ints = row.view(np.int32)
    out, o = {}, 0
    for f in _PACKED:
        size = int(np.prod(shapes[f], dtype=np.int64))
        src = row if f in _FLOAT else ints
        a = src[o:o + size].reshape(shapes[f])
        if f in ("default_left", "leaf_path"):
            a = a != 0
        out[f] = a
        o += size
    ni = L - 1
    if cat:
        out["split_cat"] = ints[o:o + ni] != 0
        nb = ni * n_bins
        out["cat_bitset"] = (row[o + ni:o + _cat_words(L, n_bins)]
                             .view(np.uint8)[:nb].reshape(ni, n_bins) != 0)
    else:
        out["split_cat"] = np.zeros(ni, bool)
        out["cat_bitset"] = np.zeros((ni, n_bins), bool)
    return TreeArrays(**out)


def packed_width(L: int, num_f: int, n_bins: int = 0,
                 cat: bool = False) -> int:
    return sum(int(np.prod(s, dtype=np.int64))
               for s in _field_shapes(L, num_f).values()) \
        + (_cat_words(L, n_bins) if cat else 0)


def round_keys(seed_q: int, first_iter: int, T: int, k: int = 1
               ) -> np.ndarray:
    """int64 [T, k, 2, 2]: each round's and class's (grad, hess) threefry
    key words, the classic loop's ``split(fold_in(key(seed_q + iter),
    cls))``, derived on the host (Python ints, no device work)."""
    out = np.zeros((T, k, 2, 2), np.int64)
    for t in range(T):
        qkey = prng.key(seed_q + first_iter + t)
        for c in range(k):
            out[t, c] = prng.split(prng.fold_in(qkey, c))
    return out


class FusedRound:
    """One boosting round of ``gbdt`` over static buffers, for chunks of up
    to ``chunk`` rounds; ``es``: None, or (stopping_rounds,
    first_metric_only) of the in-round stop flag."""

    def __init__(self, gbdt, chunk: int, es=None):
        # a proxy: the booster holds this round in its cache, and a cycle
        # would keep the graphs' memory until the next garbage collection
        self.g = g = weakref.proxy(gbdt)
        dev = g.device
        self.dev = dev
        c = g.config
        self.quant = bool(c.use_quantized_grad)
        self.renew = self.quant and bool(c.quant_train_renew_leaf)
        self.stoch = bool(c.stochastic_rounding)
        self.n_levels = int(c.num_grad_quant_bins)
        self.batch = int(c.tpu_split_batch)
        self.has_fm = float(c.feature_fraction) < 1.0
        # the row sampling's captured draw (its per-round words: the key
        # words of the bag or of GOSS's draw, the warm-up flag)
        self.sample_fn = None if g._sampling_is_noop() \
            else g._device_sample_fn()
        hp = g.hp
        self.L = hp.num_leaves
        self.num_f = g.num_features
        self.mrows = g._fused_metric_layout()
        M = len(self.mrows)
        self.cat = hp.has_categorical
        self.P = packed_width(self.L, self.num_f, hp.n_bins, self.cat)
        #: trees a round; the class body works on class ``c`` and moves it
        #: on when its tree is complete (after the last, to the next round)
        self.k = k = g.num_tree_per_iteration
        i64 = torch.int64
        self.keys = torch.zeros(chunk, k, 2, 2, dtype=i64, device=dev)
        self.fmasks = torch.zeros(chunk, self.num_f, dtype=torch.bool,
                                  device=dev) if self.has_fm else None
        self.swords = torch.zeros(chunk, 3, dtype=i64, device=dev) \
            if self.sample_fn is not None else None
        self.nkeys = torch.zeros(chunk, k, 2, dtype=i64, device=dev) \
            if g._needs_node_rng else None
        self.row_mask: Optional[torch.Tensor] = None
        self.t = torch.zeros((), dtype=i64, device=dev)
        self.c = torch.zeros((), dtype=i64, device=dev)
        self.it = torch.zeros((), dtype=i64, device=dev)
        #: a round's row: its k trees, P words each, then the M metrics
        self.W = k * self.P + M
        self.out = torch.zeros(chunk, self.W, dtype=torch.float32,
                               device=dev)
        self._cols_tree = torch.arange(self.P, dtype=i64, device=dev)
        self._cols_metric = torch.arange(k * self.P, self.W, dtype=i64,
                                         device=dev)
        self.flag = torch.zeros((), dtype=torch.int32, device=dev)
        self.es = es
        if es is not None:
            bigger = torch.as_tensor([r[2] for r in self.mrows], device=dev)
            if es[1]:
                fam0 = self.mrows[0][1].split("@")[0]
                consider = [r[1].split("@")[0] == fam0 for r in self.mrows]
            else:
                consider = [True] * M
            self.bigger = bigger
            self.consider = torch.as_tensor(consider, device=dev)
            self.best = torch.zeros(M, dtype=torch.float32, device=dev)
            self.best_it = torch.zeros(M, dtype=i64, device=dev)
            self.seen = torch.zeros(M, dtype=torch.bool, device=dev)
            self.stopped = torch.zeros((), dtype=torch.bool, device=dev)
            self.reset_es()
        self.tree: Optional[BatchedTree] = None
        #: the K-wide rounds a tree gets before the flag read (the budget)
        self.R = 0
        self.graphs = None
        #: each graph's kernel launches a replay (wrapper counts)
        self.graph_launches: Dict[str, List[int]] = {}
        #: seconds the warm-up round and the three captures took
        self.capture_s = 0.0
        #: (seconds, rounds) of each chunk of GBDT.train_fused: host wall
        #: from before its inputs are staged to after its trees are built
        #: and its callbacks ran, the capture excluded (read by
        #: chip_smoke.py)
        self.walls: List[tuple] = []

    # -------------------------------------------------------- the bodies
    def reset_es(self) -> None:
        """A new training run's stop state (it persists across chunks)."""
        if self.es is None:
            return
        self.best.copy_(torch.where(self.bigger,
                                    torch.full_like(self.best, -np.inf),
                                    torch.full_like(self.best, np.inf)))
        self.best_it.zero_()
        self.seen.zero_()
        self.stopped.zero_()

    def grads(self) -> None:
        """The round's gradients [n, k] (one objective evaluation for all
        classes) and the row sampling's draw, shared by the k trees.  With
        k = 1 it runs inside ``main``; with k > 1 it is a graph of its own,
        replayed before the first class."""
        g = self.g
        # index_select, not [t]: indexing by a 0-d tensor reads it back
        t = self.t.reshape(1)
        if self.k == 1:
            grad, hess = g.objective.get_gradients(g.scores[:, 0])
            grad, hess = grad[:, None], hess[:, None]
        else:
            grad, hess = g.objective.get_gradients(g.scores)
        self.row_mask = None
        if self.sample_fn is not None:
            # the bag or GOSS's rows, drawn after the gradients and before
            # the levels, as the classic loop draws them
            w = self.swords.index_select(0, t)[0]
            self.row_mask, grad, hess = self.sample_fn(
                w[0], w[1], w[2] != 0, grad, hess)
        self.grad_all, self.hess_all = grad, hess

    def _column(self, x: torch.Tensor) -> torch.Tensor:
        """Column ``c`` of an [n, k] tensor, as [n]."""
        if self.k == 1:
            return x[:, 0]
        return x.index_select(1, self.c.reshape(1))[:, 0]

    def _update_column(self, x: torch.Tensor, add: torch.Tensor,
                       commit: torch.Tensor) -> None:
        """Column ``c`` of ``x`` [n, k] += ``add`` [n] where ``commit``."""
        col = self._column(x)
        new = torch.where(commit, col + add, col)
        if self.k == 1:
            col.copy_(new)
        else:
            x.index_copy_(1, self.c.reshape(1), new[:, None])

    def main(self) -> None:
        """Class ``c``'s tree: grow with the fixed budget, then the tail."""
        g = self.g
        t = self.t.reshape(1)
        if self.k == 1:
            self.grads()
        grad = self._column(self.grad_all)
        hess = self._column(self.hess_all)
        self.g_true, self.h_true = grad, hess
        hist_scale = None
        if self.quant:
            kw = self.keys.index_select(0, t)[0]
            kw = kw[0] if self.k == 1 else \
                kw.index_select(0, self.c.reshape(1))[0]
            grad, hess, gs, hs = discretize_gradients_levels(
                grad, hess, n_levels=self.n_levels, stochastic=self.stoch,
                constant_hessian=g.objective.is_constant_hessian,
                split_keys=((kw[0, 0], kw[0, 1]), (kw[1, 0], kw[1, 1])))
            hist_scale = torch.stack([gs, hs])
        fm = self.fmasks.index_select(0, t)[0] if self.has_fm else None
        nkey = None
        if self.nkeys is not None:
            nkey = self.nkeys.index_select(0, t)[0]
            nkey = nkey[0] if self.k == 1 else \
                nkey.index_select(0, self.c.reshape(1))[0]
        tree = BatchedTree(
            g.bins, grad.contiguous(), hess.contiguous(), self.row_mask,
            g.num_bins_arr, g.nan_bin_arr, fm, g.hp, batch=self.batch,
            hist_scale=hist_scale, bins_t=g.bins_t, bins_words=g.bins_words,
            bins_words_t=g.bins_words_t,
            stop=self.stopped if self.es is not None else None,
            bundle=g.bundle, is_cat=g.is_cat_arr, monotone=g.monotone_arr,
            rng_key=nkey, interaction_sets=g.interaction_sets,
            forced=g.forced)
        # forced splits: one K = 1 round a schedule entry (a failed entry
        # makes the rest no-ops on the device), then no ladder; the budget
        # counts from one leaf, an upper bound for any number of forced
        # splits that held
        tree.forced_phase()
        ladder = tree.ladder()
        self.R = full_width_rounds(self.L, self.batch, ladder)
        for width in ladder:
            tree.round(width)
        for _ in range(self.R):
            tree.round(tree.K)
        self.tree = tree
        self.tail()

    def extra(self) -> None:
        """One more K-wide round of a tree that is still growing."""
        self.tree.round(self.tree.K)
        self.flag.copy_(self.tree.growing().to(torch.int32))

    def tail(self) -> None:
        """Renewal, shrinkage, the score updates of column ``c``, the tree's
        part of the chunk row; after the last class the metrics and the
        stop state; committed only when the tree is complete."""
        g, tree = self.g, self.tree
        growing = tree.growing()
        commit = ~growing
        last = commit if self.k == 1 else commit & (self.c == self.k - 1)
        arrays = tree.arrays()
        if self.renew:
            hp = g.hp
            renewed = renew_leaf_values(
                tree.lor, self.g_true, self.h_true, self.row_mask,
                num_leaves=hp.num_leaves, lambda_l1=hp.lambda_l1,
                lambda_l2=hp.lambda_l2)
            # stump (no split found): keep the original leaf value
            arrays = arrays._replace(leaf_value=torch.where(
                arrays.num_leaves > 1, renewed, arrays.leaf_value))
        # shrink BEFORE the gather, the classic loop's order
        shrunk = arrays.leaf_value * g.shrinkage_rate
        self._update_column(g.scores, take_small_table(shrunk, tree.lor),
                            commit)
        arrays_s = arrays._replace(leaf_value=shrunk)
        parts = []
        for vi, ms in enumerate(g.valid_metrics):
            v = g.valid_scores[vi]
            self._update_column(v, g._valid_tree_scores(arrays_s, vi),
                                commit)
            # a k-class booster's metrics take the [n, k] matrix; they are
            # evaluated after every class and kept after the last
            v = v[:, 0] if self.k == 1 else v
            for m in ms:
                parts.append(m.eval_device_traced(v, g.objective)
                             .to(torch.float32))
        flag = growing.to(torch.int32) \
            | ((arrays.num_leaves <= 1).to(torch.int32) * STUMP)
        base = self.t * self.W
        flat = self.out.view(-1)
        flat.index_copy_(0, base + self.P * self.c + self._cols_tree,
                         pack_tree(arrays, self.cat))
        if parts:
            mvals = torch.cat(parts)
            flat.index_copy_(0, base + self._cols_metric, mvals)
            if self.es is not None:
                self._es_update(mvals, last)
                flag = flag | (self.stopped.to(torch.int32) * STOPPED)
        self.flag.copy_(flag)
        if self.k > 1:
            self.c.copy_(torch.where(last, torch.zeros_like(self.c),
                                     self.c + commit.to(torch.int64)))
        step = last.to(torch.int64)
        self.t.add_(step)
        self.it.add_(step)

    def _es_update(self, mvals: torch.Tensor, commit: torch.Tensor) -> None:
        """The early-stopping callback's state machine at min_delta 0 (a
        first evaluation always improves, as the callback's ``best is
        None`` start does, NaN included)."""
        it = self.it
        improved = (torch.where(self.bigger, mvals > self.best,
                                mvals < self.best) | ~self.seen) \
            & self.consider
        best = torch.where(improved, mvals, self.best)
        best_it = torch.where(improved, it, self.best_it)
        seen = self.seen | self.consider
        trip = self.consider & seen & ~improved & \
            (it - best_it >= int(self.es[0]))
        stopped = self.stopped | trip.any()
        for dst, src in ((self.best, best), (self.best_it, best_it),
                         (self.seen, seen), (self.stopped, stopped)):
            dst.copy_(torch.where(commit, src, dst))

    # ------------------------------------------------------ the chunk loop
    def _capture(self) -> None:
        """Warm up once eagerly (kernel builds, launch plans, cached device
        operands), restore the state it advanced, then capture ``main``,
        ``extra`` and ``tail`` into one memory pool."""
        g = self.g
        t0 = time.perf_counter()
        state = [g.scores, *g.valid_scores, self.t, self.c, self.it,
                 self.out, self.flag]
        if self.es is not None:
            state += [self.best, self.best_it, self.seen, self.stopped]
        saved = [s.clone() for s in state]
        torch.cuda.synchronize(self.dev)
        side = side_stream(self.dev)
        side.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(side):
            if self.k > 1:
                self.grads()
            self.main()
        torch.cuda.current_stream(self.dev).wait_stream(side)
        for s, v in zip(state, saved):
            s.copy_(v)
        torch.cuda.synchronize(self.dev)
        pool = torch.cuda.graph_pool_handle()
        graphs = {}
        try:
            for name in self._bodies():
                gr = torch.cuda.CUDAGraph()
                before = _read_counters()
                with torch.cuda.graph(gr, pool=pool, stream=side):
                    getattr(self, name)()
                graphs[name] = gr
                delta = [a - b for a, b in zip(_read_counters(), before)]
                _add_counters(delta, -1)   # recorded, not launched
                self.graph_launches[name] = delta
        except Exception as e:  # no fallback: the classic loop is not taken
            log.fatal(f"capturing the fused boosting round as a CUDA graph "
                      f"failed: {type(e).__name__}: {e}")
        torch.cuda.synchronize(self.dev)
        self.graphs = graphs
        self.capture_s = time.perf_counter() - t0

    def _bodies(self):
        return ("grads", "main", "extra", "tail") if self.k > 1 else \
            ("main", "extra", "tail")

    def _replay(self, name: str) -> None:
        """Run one body: replay its graph on the card."""
        if self.graphs is not None:
            self.graphs[name].replay()
            _add_counters(self.graph_launches[name])
            counts["replays"] += 1
        else:
            getattr(self, name)()

    def _step(self, name: str) -> int:
        """Run one body and read the flag word back: a class's one host
        read."""
        self._replay(name)
        counts["reads"] += 1
        return int(self.flag.item())

    def run(self, first_iter: int, T: int) -> np.ndarray:
        """Run up to ``T`` rounds from iteration ``first_iter``; stops
        after a round that stopped early or grew a stump.  Returns the
        rounds' rows, float32 [done, P + M], in one transfer."""
        g = self.g
        seed_q = (g.config.seed or 0) * 7919
        if self.quant and self.stoch:
            self.keys[:T].copy_(torch.from_numpy(
                round_keys(seed_q, first_iter, T, self.k)))
        if self.has_fm:
            self.fmasks[:T].copy_(torch.from_numpy(np.stack([
                g._feature_mask_array(first_iter + t) for t in range(T)])))
        if self.nkeys is not None:
            self.nkeys[:T].copy_(torch.tensor(
                [[g.node_key(first_iter + t, c) for c in range(self.k)]
                 for t in range(T)], dtype=torch.int64))
        if self.sample_fn is not None:
            self.swords[:T].copy_(torch.tensor(
                [g.sample_strategy.round_words(first_iter + t)
                 for t in range(T)],
                dtype=torch.int64))
        self.t.zero_()
        self.c.zero_()
        self.it.fill_(first_iter)
        if self.dev.type == "cuda" and self.graphs is None:
            self._capture()
        done = 0
        while done < T:
            if self.k > 1:
                self._replay("grads")
            stumps = 0
            for _ in range(self.k):
                f = self._step("main")
                if f & GROWING:
                    while f & GROWING:
                        counts["extra"] += 1
                        f = self._step("extra")
                    f = self._step("tail")
                stumps += bool(f & STUMP)
            done += 1
            counts["rounds"] += 1
            if f & STOPPED or stumps == self.k:
                break
        return self.out[:done].cpu().numpy()


def chunk_rows(rows: np.ndarray, fr: FusedRound) -> List:
    """Each row's (its k TreeArrays on the host, metric values)."""
    n_bins = fr.g.hp.n_bins
    P = fr.P
    return [([unpack_tree(r[c * P:(c + 1) * P], fr.L, fr.num_f, n_bins,
                          fr.cat) for c in range(fr.k)], r[fr.k * P:])
            for r in rows]
