"""GBDT boosting driver.

Counterpart of ``lightgbm_tpu/boosting/gbdt.py`` (reference
src/boosting/gbdt.cpp ``TrainOneIter`` :344-452).  One iteration runs, on
the booster's torch device: objective gradients -> integer gradient levels
(ops/quantize.py; stochastic rounding draws the JAX package's threefry
bits) -> ``grow_tree`` (the strict leaf-wise learner) or
``grow_tree_batched`` (``_use_batched_grower``) -> leaf renewal from the
true gradients ->
shrinkage -> the score update through ``take_small_table``
(shrink BEFORE the gather, the JAX package's order) -> valid-set score
updates.  Trees are then finalized on the host (models/tree.py).
Boost-from-average folds the initial score into the first iteration's
trees exactly like the JAX package.

``_resolve_auto_params`` is the JAX package's policy verbatim: at >= 100k
rows an unset ``tpu_split_batch`` becomes min(42, num_leaves - 1) and an
unset ``tpu_hist_dtype`` / ``use_quantized_grad`` becomes exact int8
levels with leaf renewal; below it a plain ``train()`` keeps
``tpu_split_batch=1`` and float32 histograms, the strict learner.
``histogram_pool_size`` (or the 4 GB guard) becomes batched-grower pool
slots exactly as in the JAX package, and an engaged pool routes even
``tpu_split_batch=1`` through the batched grower.

EFB-bundled data (``enable_bundle``, on by default) trains in both growers
and both loops: the bins hold the bundle columns, ``self.bundle``
(learner/grower.py ``DeviceBundle``) maps them back to per-feature bins,
and a valid set's bins are turned into logical bins once, at ``add_valid``.

Categorical data (``categorical_feature``) trains in both growers and both
loops too: ``hp.has_categorical`` switches on split finding's categorical
candidates, ``self.is_cat_arr`` marks the features, the batched rounds
partition through the decision-table kernel, and the valid sets' path
aggregation reads each categorical node's bitset.

``train_fused`` is the JAX package's fused round loop (``supports_fused``
admits the batched grower's configurations): each boosting round runs as
one replay of a captured CUDA graph on the card (boosting/fused_graph.py),
valid sets scored and their metrics evaluated on the device, the
early-stopping state kept inside the round, and the trees and metric
values of a chunk of rounds come back in one transfer.  Valid sets are
scored by path aggregation in both loops (models/predict.py
``predict_bins_tree_matmul``).

``predict_raw`` is the JAX package's: below ``DEVICE_PREDICT_MIN_WORK``
row-trees (and always with prediction early stopping) it walks the trees
on the host in float64; at or above it ``_device_predict_raw`` bins the
rows once and runs the forest predictor: on the card one launch of the
hand-written forest kernel per row block (ops/forest_kernels.py), under
``device_type=cpu`` the plain path-count version, blocked and padded as
the JAX package pads.

Row sampling (boosting/sample_strategy.py: bagging, pos/neg and by-query
bagging, GOSS) draws after the gradients and before quantization in both
loops (in the fused round, inside the captured graph); its bool row mask
goes to the grower and to leaf renewal.  ``RF`` (boosting/rf.py) and
``DART`` (boosting/dart.py) subclass this class and keep the classic
loop.

A k-class objective (``multiclass``, ``multiclassova``) grows k trees a
round from one [n, k] gradient evaluation, in both loops; l1 / quantile /
MAPE renew their leaves on the host after each tree (``_renew_leaves``) and
keep the classic loop.

Split constraints (monotone constraints, interaction sets, and the node
keys of extra trees and by-node sampling, ``key(extra_seed * 1000003 +
iter * k + cls)``) are set up as in the JAX package
(``_split_constraints``) and reach both growers in both loops; the
fused round stages each round's node keys on the device.

The learner options (``_learner_options``, the JAX package's
boosting/gbdt.py:562-592): forced splits (``forcedsplits_filename``,
:func:`parse_forced_splits`) reach both growers in both loops; CEGB
penalties (the acquisition state kept on the booster across its trees),
linear trees (each tree's leaves fitted on the raw columns after growth,
learner/linear.py, its scores through the linear kernels) and
``tpu_debug_checks`` (:meth:`GBDT._debug_check_tree`) take the classic
loop in both growers, as in the JAX package.

Not ported yet: custom objectives, ``nan_policy`` and the distributed
modes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io.dataset import Dataset
from ..learner import batch_grower, grower
from ..callback import EarlyStopException
from ..learner.grower import CegbState, DeviceBundle, ForcedSplits, TreeArrays
from ..learner.linear import fit_linear_leaves, linear_leaf_scores
from ..metrics import Metric, create_metrics
from ..models.predict import (ForestArrays, forest_from_numpy,
                              predict_bins_leaf_matmul, predict_bins_tree,
                              predict_bins_tree_matmul)
from ..models.tree import Tree
from ..objectives import ObjectiveFunction, create_objective
from ..ops import forest_kernels, prng
from ..ops.histogram import resolve_hist_kernel, wants_packed_mirror
from ..ops.quantize import discretize_gradients_levels, renew_leaf_values
from ..ops.split import SplitHyper
from ..ops.table import take_small_table
from ..utils import log
from ..utils.device import resolve_device
from .sample_strategy import create_sample_strategy


def _resolve_hist_dtype(cfg: Config) -> str:
    """Histogram arithmetic with validity gating (the JAX package's rule):
    ``deterministic=true`` pins float32; int8 needs integer levels."""
    if cfg.deterministic:
        return "float32"
    dt = str(cfg.tpu_hist_dtype)
    if dt == "int8":
        if not bool(cfg.use_quantized_grad):
            log.warning("tpu_hist_dtype=int8 requires use_quantized_grad="
                        "true (integer gradient levels); using bfloat16")
            return "bfloat16"
        if int(cfg.num_grad_quant_bins) > 127:
            log.warning("tpu_hist_dtype=int8 needs num_grad_quant_bins "
                        "<= 127; using bfloat16")
            return "bfloat16"
    return dt


def _hp_from_config(cfg: Config, n_bins: int) -> SplitHyper:
    return SplitHyper(
        num_leaves=max(2, int(cfg.num_leaves)),
        max_depth=int(cfg.max_depth),
        lambda_l1=float(cfg.lambda_l1),
        lambda_l2=float(cfg.lambda_l2),
        min_data_in_leaf=int(cfg.min_data_in_leaf),
        min_sum_hessian_in_leaf=float(cfg.min_sum_hessian_in_leaf),
        min_gain_to_split=float(cfg.min_gain_to_split),
        max_delta_step=float(cfg.max_delta_step),
        cat_l2=float(cfg.cat_l2),
        cat_smooth=float(cfg.cat_smooth),
        max_cat_threshold=int(cfg.max_cat_threshold),
        max_cat_to_onehot=int(cfg.max_cat_to_onehot),
        min_data_per_group=int(cfg.min_data_per_group),
        n_bins=n_bins,
        rows_per_block=int(cfg.tpu_rows_per_block),
        path_smooth=float(cfg.path_smooth),
        hist_dtype=_resolve_hist_dtype(cfg),
        hist_kernel=resolve_hist_kernel(cfg.hist_kernel),
        leaf_hist=str(cfg.tpu_leaf_hist),
        extra_trees=bool(cfg.extra_trees),
        feature_fraction_bynode=float(cfg.feature_fraction_bynode),
    )


def _check_slice(config: Config, train_set: Dataset) -> None:
    """Reject configurations whose code paths are not ported yet."""
    unported = [
        (config.boosting not in ("gbdt", "rf", "dart"),
         f"boosting={config.boosting}"),
        (str(config.tree_learner) not in ("serial",),
         f"tree_learner={config.tree_learner}"),
        (config.nan_policy != "none", f"nan_policy={config.nan_policy}"),
    ]
    for bad, what in unported:
        if bad:
            log.fatal(f"{what} is not supported by lightgbm_tpu_torch yet")


def parse_forced_splits(filename: str, dataset: Dataset, num_leaves: int,
                        device) -> Optional[ForcedSplits]:
    """``forcedsplits_filename``'s JSON (nodes ``{"feature": original
    index, "threshold": value, "left": ..., "right": ...}``) as the
    schedule of the growers, in BFS order (reference
    serial_tree_learner.cpp:620 ForceSplits; the JAX package's
    ``_parse_forced_splits``): at entry i the left child keeps its parent's
    leaf id and the right child becomes leaf i + 1, as the growers number
    them; the threshold goes through the feature's mapper
    (``values_to_bins``).  An entry on an unused feature ends the schedule
    there.  None for an empty file or schedule."""
    import json
    with open(filename) as fh:
        root = json.load(fh)
    if not root:
        return None
    orig_to_packed = {int(o): p
                      for p, o in enumerate(dataset.used_feature_idx)}
    K = num_leaves - 1
    leaf, feat, thr = [], [], []
    queue = [(root, 0)]
    i = 0
    while queue and i < K:
        node, lf = queue.pop(0)
        p = orig_to_packed.get(int(node["feature"]))
        if p is None:
            log.warning("forced split on unused feature %s ignored; "
                        "aborting remaining forced splits" % node["feature"])
            break
        mapper = dataset.mappers[int(node["feature"])]
        t = int(mapper.values_to_bins(
            np.array([float(node["threshold"])], np.float64))[0])
        leaf.append(lf)
        feat.append(p)
        thr.append(t)
        if node.get("left"):
            queue.append((node["left"], lf))
        if node.get("right"):
            queue.append((node["right"], i + 1))
        i += 1
    if i == 0:
        return None
    a = [np.asarray(v, np.int32) for v in (leaf, feat, thr)]
    return ForcedSplits(*a, table=torch.as_tensor(np.stack(a), device=device)
                        .to(torch.int64))


def _parse_interaction_sets(spec, used_feature_idx) -> Optional[np.ndarray]:
    """``interaction_constraints`` ("[0,1,2],[2,3]" or a list of lists of
    original feature indices) -> bool [S, F_packed] (the JAX package's
    ``_parse_interaction_sets``; reference config
    interaction_constraints_vector, col_sampler.hpp)."""
    if not spec:
        return None
    if isinstance(spec, str):
        import json
        sets = json.loads("[" + spec + "]")
    else:
        sets = [list(s) for s in spec]
    if not sets:
        return None
    orig_to_packed = {int(o): p for p, o in enumerate(used_feature_idx)}
    out = np.zeros((len(sets), len(used_feature_idx)), bool)
    for si, st in enumerate(sets):
        for f in st:
            p = orig_to_packed.get(int(f))
            if p is not None:
                out[si, p] = True
    return out


class GBDT:
    """Training driver (reference gbdt.h/gbdt.cpp ``GBDT``)."""

    def __init__(self, config: Config, train_set: Dataset,
                 objective: Optional[ObjectiveFunction] = None,
                 metrics: Optional[List[Metric]] = None):
        self.config = config
        self.train_set = train_set
        self.device = resolve_device(config.device_type)
        _check_slice(config, train_set)
        self.objective = objective if objective is not None else \
            create_objective(config)
        if self.objective is None:
            log.fatal("objective=none (custom gradients) is not supported by "
                      "lightgbm_tpu_torch yet")
        self.objective.init(train_set.metadata, train_set.num_data,
                            self.device)
        self.train_metrics = metrics if metrics is not None else \
            create_metrics(config)
        for m in self.train_metrics:
            m.init(train_set.metadata, train_set.num_data)
        self.num_class = max(1, int(config.num_class))
        self.num_tree_per_iteration = self.objective.num_model_per_iteration
        self.shrinkage_rate = float(config.learning_rate)
        self.models: List[Tree] = []          # iter-major, one per class
        self.iter_ = 0

        # device operands: the row-major bins, their transposed copy (the
        # histogram and partition kernels' layout) and the packed word
        # mirror the compaction payload carries — all tree-invariant
        dev = self.device
        self.bins = torch.as_tensor(train_set.bins, device=dev)
        self.bins_t = self.bins.t().contiguous()
        self.bins_words = torch.as_tensor(train_set.packed_mirror(),
                                          device=dev)
        self.num_bins_arr = torch.as_tensor(train_set.num_bins_array(),
                                            device=dev)
        self.nan_bin_arr = torch.as_tensor(train_set.nan_bin_array(),
                                           device=dev)
        self.num_features = train_set.num_features
        self.is_cat_arr = torch.as_tensor(train_set.categorical_array(),
                                          device=dev)
        # EFB: the bins hold bundle columns; these tables map them back
        ba = train_set.device_bundle_arrays()
        self.bundle = None if ba is None else \
            DeviceBundle(*(torch.as_tensor(a, device=dev) for a in ba))

        self._resolve_auto_params(config)
        self.hp = _hp_from_config(config, train_set.device_n_bins())
        if bool(train_set.categorical_array().any()):
            self.hp = dataclasses.replace(self.hp, has_categorical=True)
        # the transposed packed mirror [W, n], resident when the masked
        # passes may take the packed kernel (the JAX booster's bins_words)
        self.bins_words_t = None
        if wants_packed_mirror(self.hp.hist_kernel, self.hp.n_bins):
            self.bins_words_t = self.bins_words.t().contiguous()
        self._check_pool(config)
        self._split_constraints(config)
        self._learner_options(config)
        if self._use_batched_grower():
            batch_grower.check_supported(self.hp,
                                         int(config.tpu_split_batch))

        n = train_set.num_data
        k = self.num_tree_per_iteration
        self.scores = torch.zeros(n, k, dtype=torch.float32, device=dev)
        self.init_scores = np.zeros(k)
        self._init_base_score()
        self.sample_strategy = create_sample_strategy(config, n)

        self.valid_sets: List[Dataset] = []
        self.valid_names: List[str] = []
        self.valid_scores: List[torch.Tensor] = []
        self.valid_metrics: List[List[Metric]] = []
        self._valid_bins: List[torch.Tensor] = []
        self._valid_bins_t: List[torch.Tensor] = []
        self._valid_raw: List[Optional[torch.Tensor]] = []
        self._fused_cache = {}
        self._last_fused_evals: List = []

    def _split_constraints(self, config: Config) -> None:
        """The JAX package's set-up of the split constraints
        (boosting/gbdt.py:530-562): monotone directions per original
        feature mapped to the packed features (categorical ones 0) and
        the method and penalty in ``hp``; the interaction sets; whether
        trees need node keys (extra trees, by-node sampling)."""
        ts = self.train_set
        self.monotone_arr = None
        mono_cfg = list(config.monotone_constraints or [])
        if any(int(m) != 0 for m in mono_cfg):
            full = np.zeros(ts.num_total_features, np.int32)
            full[:len(mono_cfg)] = np.asarray(mono_cfg, np.int32)[
                :ts.num_total_features]
            packed = full[np.asarray(ts.used_feature_idx)]
            packed[np.asarray(ts.categorical_array())] = 0
            self.monotone_arr = torch.as_tensor(packed, device=self.device)
            method = str(config.monotone_constraints_method)
            if method not in ("basic", "intermediate", "advanced"):
                log.fatal("unknown monotone_constraints_method=%r (expected "
                          "basic/intermediate/advanced)" % method)
            self.hp = dataclasses.replace(
                self.hp, use_monotone=True, monotone_method=method,
                monotone_penalty=float(config.monotone_penalty))
        isets = _parse_interaction_sets(config.interaction_constraints,
                                        ts.used_feature_idx)
        self.interaction_sets = None if isets is None else \
            torch.as_tensor(isets, device=self.device)
        self._needs_node_rng = (self.hp.extra_trees
                                or self.hp.feature_fraction_bynode < 1.0)

    def _learner_options(self, config: Config) -> None:
        """The JAX package's set-up of forced splits, CEGB and linear
        trees (boosting/gbdt.py:327-331, 562-592): the forced schedule on
        the device; CEGB's penalties premultiplied by ``cegb_tradeoff``
        (per original feature, mapped to the packed ones) and its
        acquisition state (``used_rows`` bool [n, F] only with lazy
        penalties), kept across every tree; under ``linear_tree`` the
        training set's raw columns on the device."""
        ts, dev = self.train_set, self.device
        self.forced = None
        if config.forcedsplits_filename:
            self.forced = parse_forced_splits(
                config.forcedsplits_filename, ts, self.hp.num_leaves, dev)
        self.cegb: Optional[CegbState] = None
        if (float(config.cegb_penalty_split) > 0.0
                or list(config.cegb_penalty_feature_lazy or [])
                or list(config.cegb_penalty_feature_coupled or [])):
            tr = float(config.cegb_tradeoff)

            def vec(lst):
                full = np.zeros(ts.num_total_features, np.float64)
                a = np.asarray(list(lst or []), np.float64)
                full[:len(a)] = a[:ts.num_total_features]
                return full[np.asarray(ts.used_feature_idx)] * tr

            lazy = vec(config.cegb_penalty_feature_lazy)
            F = self.num_features

            def f32(a):
                return torch.as_tensor(np.asarray(a, np.float32), device=dev)

            self.cegb = CegbState(
                split_pen=f32(np.float32(tr * float(
                    config.cegb_penalty_split))),
                coupled_pen=f32(vec(config.cegb_penalty_feature_coupled)),
                lazy_pen=f32(lazy),
                feature_used=torch.zeros(F, dtype=torch.bool, device=dev),
                used_rows=(torch.zeros(ts.num_data, F, dtype=torch.bool,
                                       device=dev)
                           if (lazy != 0).any() else None))
        self.linear = bool(config.linear_tree) and ts.raw is not None
        self.raw_dev = torch.as_tensor(ts.raw, device=dev) \
            if self.linear else None

    def node_key(self, iter_: int, cls: int) -> prng.Key:
        """The key words of a tree's node draws: ``key(extra_seed *
        1000003 + iter * k + cls)``, the JAX package's."""
        return prng.key(int(self.config.extra_seed) * 1000003
                        + iter_ * self.num_tree_per_iteration + cls)

    def _resolve_auto_params(self, config: Config) -> None:
        """Fast-by-default policy, the JAX package's verbatim: at scale, a
        plain ``train()`` gets the batched grower and exact quantized-grad
        int8 levels with leaf renewal; explicit user settings and
        ``deterministic=true`` win."""
        at_scale = self.train_set.num_data >= 100_000
        batchable = True   # serial training: the only mode ported
        if not config.is_explicit("tpu_split_batch"):
            if at_scale and batchable and int(config.num_leaves) >= 8:
                config.tpu_split_batch = min(42, int(config.num_leaves) - 1)
        if (at_scale and not config.deterministic
                and not bool(config.linear_tree)
                and not config.is_explicit("tpu_hist_dtype")
                and not config.is_explicit("use_quantized_grad")):
            config.tpu_hist_dtype = "int8"
            config.use_quantized_grad = True
            if not config.is_explicit("quant_train_renew_leaf"):
                config.quant_train_renew_leaf = True
            log.info("auto speed mode: tpu_split_batch=%d, exact "
                     "quantized-grad int8 kernels (set "
                     "tpu_hist_dtype=float32 or deterministic=true to "
                     "opt out)" % int(config.tpu_split_batch))

    def _check_pool(self, config: Config) -> None:
        """The JAX package's histogram-pool translation (reference
        histogram_pool_size MB, serial_tree_learner.cpp:36-47): the MB
        budget becomes batched-grower pool slots, at least 3 * batch + 2;
        unset, the pool still engages at 1 GB when the [L, F, B, 4] state
        would pass 4 GB."""
        pool_mb = float(config.histogram_pool_size)
        bytes_per_leaf = self.bins.shape[1] * self.hp.n_bins * 4 * 4
        full_state = bytes_per_leaf * self.hp.num_leaves
        if pool_mb <= 0 and not config.is_explicit("histogram_pool_size") \
                and full_state > (4 << 30):
            pool_mb = 1024.0
            log.info("histogram state would be %.1f GB; engaging the "
                     "bounded pool at 1 GB (set histogram_pool_size=-1 "
                     "to keep all leaves resident)"
                     % (full_state / (1 << 30)))
        if pool_mb > 0:
            slots = int(pool_mb * (1 << 20) // max(bytes_per_leaf, 1))
            slots = max(slots, 3 * max(1, int(config.tpu_split_batch)) + 2)
            if slots < self.hp.num_leaves:
                self.hp = dataclasses.replace(self.hp, hist_pool_slots=slots)

    def _use_batched_grower(self) -> bool:
        """The JAX package's decision, reduced to serial training: batched
        rounds when ``tpu_split_batch`` > 1 or the bounded pool is engaged
        (batch=1 pooled rounds grow the strict learner's trees)."""
        return (int(self.config.tpu_split_batch) > 1
                or batch_grower.pooled(self.hp))

    def _grow(self, g: torch.Tensor, h: torch.Tensor, row_mask,
              feature_mask, hist_scale=None, node_key=None):
        """One tree through the strict or the batched learner; ``row_mask``
        bool [n] (the bag) or None; ``node_key`` the tree's node key words
        (:meth:`node_key`) when trees need them."""
        args = (self.bins, g, h, row_mask, self.num_bins_arr,
                self.nan_bin_arr, feature_mask, self.hp)
        kw = dict(hist_scale=hist_scale, bins_t=self.bins_t,
                  bins_words=self.bins_words, bins_words_t=self.bins_words_t,
                  bundle=self.bundle, is_cat=self.is_cat_arr,
                  monotone=self.monotone_arr,
                  interaction_sets=self.interaction_sets,
                  forced=self.forced, cegb=self.cegb)
        if self._use_batched_grower():
            key = None if node_key is None else torch.tensor(
                node_key, dtype=torch.int64, device=self.device)
            return batch_grower.grow_tree_batched(
                *args, batch=int(self.config.tpu_split_batch), rng_key=key,
                **kw)
        return grower.grow_tree(*args, rng_key=node_key, **kw)

    def _init_base_score(self) -> None:
        md = self.train_set.metadata
        if md.init_score is not None:
            init = np.zeros(self.num_tree_per_iteration)
        elif self.config.boost_from_average:
            init = np.array([self.objective.boost_from_score(k)
                             for k in range(self.num_tree_per_iteration)])
        else:
            init = np.zeros(self.num_tree_per_iteration)
        self.init_scores = init
        if np.any(init != 0):
            self.scores = self.scores + torch.as_tensor(
                init, dtype=torch.float32, device=self.device)[None, :]
        if md.init_score is not None:
            isc = md.init_score.reshape(-1, self.num_tree_per_iteration,
                                        order="F") \
                if md.init_score.size != md.num_data else \
                md.init_score.reshape(-1, 1)
            self.scores = self.scores + torch.as_tensor(
                isc, dtype=torch.float32, device=self.device)

    def add_valid(self, valid_set: Dataset, name: str) -> None:
        """reference GBDT::AddValidDataset (gbdt.cpp:184)."""
        self.valid_sets.append(valid_set)
        self.valid_names.append(name)
        ms = create_metrics(self.config)
        for m in ms:
            m.init(valid_set.metadata, valid_set.num_data)
        self.valid_metrics.append(ms)
        vsc = np.zeros((valid_set.num_data, self.num_tree_per_iteration),
                       np.float32) + self.init_scores[None, :]
        isc = valid_set.metadata.init_score
        if isc is not None:
            vsc += isc.reshape(vsc.shape, order="F") \
                if isc.size == vsc.size else isc.reshape(-1, 1)
        self.valid_scores.append(torch.as_tensor(vsc, dtype=torch.float32,
                                                 device=self.device))
        self._valid_bins.append(torch.as_tensor(valid_set.bins,
                                                device=self.device))
        # the transposed valid bins the path aggregation reads, made once:
        # logical (per-feature) bins when the data is bundled
        self._valid_bins_t.append(self._logical_bins_t(self._valid_bins[-1],
                                                       name))
        # linear trees score the valid rows on their raw columns
        self._valid_raw.append(
            torch.as_tensor(valid_set.raw, device=self.device)
            if self.linear and valid_set.raw is not None else None)

    def _logical_bins_t(self, bins: torch.Tensor, name: str) -> torch.Tensor:
        """u8 [F, n]: the transposed bins of ``bins`` [n, Fb], turned into
        each feature's logical bin (``inv_table[f, bins[:, feat_col[f]]]``)
        when the data is bundled (F / Fb times the bundled bins' bytes,
        logged)."""
        bins_t = bins.t().contiguous()
        bd = self.bundle
        if bd is None:
            return bins_t
        n = bins.shape[0]
        out = torch.empty(bd.feat_col.shape[0], n, dtype=torch.uint8,
                          device=bins.device)
        cols = bd.feat_col.long()
        step = 1 << 16   # bounds the i64 gather index [Fv, step]
        for r0 in range(0, n, step):
            phys = bins_t[cols, r0:r0 + step].long()
            out[:, r0:r0 + step] = bd.inv_table.gather(1, phys)
        log.info(f"valid set {name}: logical bins {out.shape[0]} x {n} "
                 f"({out.numel() / 2**20:.1f} MiB, "
                 f"{out.shape[0] / bins.shape[1]:.2f}x the bundled bins)")
        return out

    def _valid_tree_scores(self, arrays: TreeArrays, vi: int
                           ) -> torch.Tensor:
        """One tree's contribution to valid set ``vi`` (leaf values already
        shrunk), with no host read: the walk's values bit for bit.  The
        path aggregation serves every tree the port grows (constant
        leaves); bundled data is scored on its logical bins, made
        once at ``add_valid``, and a categorical node's decision is its
        bitset at the row's bin, where the JAX package walks such trees
        (``_matmul_valid_ok``): each row reaches the same leaf."""
        return predict_bins_tree_matmul(
            arrays, self._valid_bins_t[vi], self.nan_bin_arr,
            has_categorical=self.hp.has_categorical)

    # ------------------------------------------------------------ training
    def boosting_gradients(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """reference GBDT::Boosting (gbdt.cpp:220): grad and hess [n, k];
        a k-class objective takes the whole [n, k] score matrix."""
        if self.num_tree_per_iteration == 1:
            g, h = self.objective.get_gradients(self.scores[:, 0])
            return g[:, None], h[:, None]
        return self.objective.get_gradients(self.scores)

    def _feature_mask_array(self, iter_: int) -> np.ndarray:
        """The tree's feature subset (bool [F]) of iteration ``iter_``."""
        f = self.num_features
        kf = max(1, int(np.ceil(float(self.config.feature_fraction) * f)))
        rng = np.random.default_rng(self.config.feature_fraction_seed
                                    + iter_)
        chosen = rng.choice(f, size=kf, replace=False)
        mask = np.zeros(f, bool)
        mask[chosen] = True
        return mask

    def _feature_mask_for_tree(self) -> Optional[torch.Tensor]:
        if float(self.config.feature_fraction) >= 1.0:
            return None
        return torch.as_tensor(self._feature_mask_array(self.iter_),
                               device=self.device)

    def train_one_iter(self) -> bool:
        """One boosting iteration (reference gbdt.cpp:344 TrainOneIter).
        Returns True when no tree could be grown (early finish)."""
        k = self.num_tree_per_iteration
        g, h = self.boosting_gradients()
        row_mask, g, h = self.sample_strategy.sample(
            self.iter_, g, h, self.train_set.metadata)
        feature_mask = self._feature_mask_for_tree()
        g_true, h_true = g, h
        hist_scales = [None] * k
        quant = bool(self.config.use_quantized_grad)
        if quant:
            # the JAX package's per-round key: seed * 7919 + iter, folded
            # with the class
            qkey = prng.key((self.config.seed or 0) * 7919 + self.iter_)
            gq, hq = [], []
            for c in range(k):
                gc, hc, gs, hs = discretize_gradients_levels(
                    g[:, c], h[:, c], prng.fold_in(qkey, c),
                    n_levels=int(self.config.num_grad_quant_bins),
                    stochastic=bool(self.config.stochastic_rounding),
                    constant_hessian=self.objective.is_constant_hessian)
                gq.append(gc)
                hq.append(hc)
                hist_scales[c] = torch.stack([gs, hs])
            g = torch.stack(gq, dim=1)
            h = torch.stack(hq, dim=1)

        finished = True
        for cls_idx in range(k):
            arrays, leaf_of_row = self._grow(
                g[:, cls_idx].contiguous(), h[:, cls_idx].contiguous(),
                row_mask, feature_mask, hist_scale=hist_scales[cls_idx],
                node_key=(self.node_key(self.iter_, cls_idx)
                          if self._needs_node_rng else None))
            if bool(self.config.tpu_debug_checks):
                self._debug_check_tree(arrays, leaf_of_row, row_mask)
            if quant and bool(self.config.quant_train_renew_leaf):
                renewed = renew_leaf_values(
                    leaf_of_row, g_true[:, cls_idx], h_true[:, cls_idx],
                    row_mask, num_leaves=self.hp.num_leaves,
                    lambda_l1=self.hp.lambda_l1, lambda_l2=self.hp.lambda_l2)
                # stump (no split found): keep the original leaf value
                arrays = arrays._replace(leaf_value=torch.where(
                    arrays.num_leaves > 1, renewed, arrays.leaf_value))
            arrays = self._renew_leaves(arrays, leaf_of_row, cls_idx)
            lin = None
            if self.linear and int(arrays.num_leaves) > 1:
                # each leaf's ridge fit on its numeric path features, from
                # the TRUE gradients (the solution is not scale-invariant)
                lin = fit_linear_leaves(
                    self.raw_dev, leaf_of_row, arrays.leaf_path,
                    ~self.is_cat_arr, g_true[:, cls_idx],
                    h_true[:, cls_idx], row_mask, arrays.leaf_value,
                    float(self.config.linear_lambda))
                self._linear_scores(arrays, leaf_of_row, lin, cls_idx)
            else:
                # shrink BEFORE the gather, exactly like the JAX package:
                # the other order differs by an ulp and cascades through
                # the quantization grid
                shrunk = arrays.leaf_value * self.shrinkage_rate
                self.scores[:, cls_idx] += take_small_table(shrunk,
                                                            leaf_of_row)
                arrays_shrunk = arrays._replace(leaf_value=shrunk)
                for vi in range(len(self.valid_sets)):
                    self.valid_scores[vi][:, cls_idx] += \
                        self._valid_tree_scores(arrays_shrunk, vi)
            tree = Tree.from_arrays(arrays, self.train_set)
            if tree.num_leaves > 1:
                finished = False
            if lin is not None:
                tree.set_linear(lin[0].cpu().numpy().astype(np.float64),
                                lin[1].cpu().numpy().astype(np.float64),
                                self.train_set.used_feature_idx)
            tree.apply_shrinkage(self.shrinkage_rate)
            if self.iter_ == 0 and abs(self.init_scores[cls_idx]) > 1e-10:
                tree.add_bias(self.init_scores[cls_idx])
            self.models.append(tree)
        self.iter_ += 1
        return finished

    def _linear_scores(self, arrays: TreeArrays, leaf_of_row: torch.Tensor,
                       lin, cls_idx: int) -> None:
        """The score updates of a linear tree (the JAX package's
        boosting/gbdt.py:1034-1049): each training row's linear leaf
        output, and each valid row's from its leaf (path aggregation over
        the valid bins) and the valid set's raw columns, scaled by the
        shrinkage; the kernels of ops/linear_kernels.py on the card."""
        const, coeff = lin
        rate = self.shrinkage_rate
        contrib = linear_leaf_scores(self.raw_dev, leaf_of_row, const, coeff,
                                     arrays.leaf_value)
        self.scores[:, cls_idx] += rate * contrib
        for vi in range(len(self.valid_sets)):
            leaf_v = predict_bins_leaf_matmul(
                arrays, self._valid_bins_t[vi], self.nan_bin_arr,
                has_categorical=self.hp.has_categorical)
            vraw = self._valid_raw[vi]
            vc = linear_leaf_scores(vraw, leaf_v, const, coeff,
                                    arrays.leaf_value) \
                if vraw is not None else arrays.leaf_value[leaf_v]
            self.valid_scores[vi][:, cls_idx] += rate * vc

    def _debug_check_tree(self, arrays: TreeArrays, leaf_of_row: torch.Tensor,
                          row_mask) -> None:
        """``tpu_debug_checks``: the per-tree invariant checks of the JAX
        package's ``_debug_check_tree`` (reference
        cuda_single_gpu_tree_learner DEBUG CheckSplitValid :571), on the
        host: leaf ids in range, the stored leaf counts against the rows of
        the partition, the child links in range.  One host read a tree."""
        nl = int(arrays.num_leaves)
        lor = leaf_of_row.cpu().numpy()
        if lor.min() < 0 or lor.max() >= nl:
            log.fatal("debug check: leaf_of_row out of range [0, %d): "
                      "min=%d max=%d" % (nl, lor.min(), lor.max()))
        mask = np.ones(lor.shape[0], bool) if row_mask is None \
            else row_mask.cpu().numpy()
        counts = np.bincount(lor[mask], minlength=self.hp.num_leaves)
        stored = arrays.leaf_count.cpu().numpy()
        # rtol: float32 counts of leaves past 2^24 rows
        if not np.allclose(counts[:nl], stored[:nl], rtol=1e-6, atol=0.5):
            bad = np.nonzero(~np.isclose(counts[:nl], stored[:nl],
                                         rtol=1e-6, atol=0.5))[0]
            log.fatal("debug check: leaf_count mismatch at leaves %s "
                      "(partition %s vs stored %s)"
                      % (bad[:5], counts[bad[:5]], stored[bad[:5]]))
        lc = arrays.left_child.cpu().numpy()[:nl - 1]
        rc = arrays.right_child.cpu().numpy()[:nl - 1]
        for side, arr in (("left", lc), ("right", rc)):
            # children: >= 0 a node, -(leaf + 1) a leaf
            if (arr >= nl - 1).any():
                log.fatal("debug check: %s child node index out of range"
                          % side)
            if (-arr - 1 >= nl).any():
                log.fatal("debug check: %s child leaf index out of range"
                          % side)

    def _renew_leaves(self, arrays: TreeArrays, leaf_of_row: torch.Tensor,
                      cls_idx: int) -> TreeArrays:
        """Leaf-output renewal of l1 / quantile / MAPE (reference
        RenewTreeOutput): the objective's float64 host percentiles of the
        residuals at the scores before the tree, one host read of
        ``leaf_of_row`` a tree (the JAX package's ``_renew_leaves``).
        Returns the arrays with their unshrunk leaf values."""
        if not self.objective.need_renew_tree_output:
            return arrays
        lor = leaf_of_row.cpu().numpy()
        score_host = self.scores[:, cls_idx].cpu().numpy().astype(np.float64)
        renewed = self.objective.renew_tree_output(
            score_host, None, lor, int(arrays.num_leaves))
        if renewed is None:
            return arrays
        lv = arrays.leaf_value.cpu().numpy().copy()
        lv[:len(renewed)] = renewed
        return arrays._replace(leaf_value=torch.as_tensor(
            lv.astype(np.float32), device=arrays.leaf_value.device))

    # ------------------------------------------------- fused iterations
    def supports_fused(self) -> bool:
        """True when whole boosting rounds can run as the fused loop
        (``train_fused``): the JAX package's gate reduced to what the port
        trains.  Plain and pos/neg bagging and GOSS draw inside the round
        (``device_sample_fn``); by-query bagging, RF, DART and the strict
        learner keep the classic loop, as in the JAX package; so do the
        objectives whose calls change their state (``jit_safe``:
        rank_xendcg, position-debiased lambdarank), linear trees, CEGB and
        ``tpu_debug_checks``; forced splits take the fused loop."""
        return (type(self) is GBDT
                and self.objective is not None
                and not self.objective.need_renew_tree_output
                and self.objective.jit_safe
                and not self.linear
                and self.cegb is None
                and not bool(self.config.tpu_debug_checks)
                and (not self.valid_sets or self.fused_valid_ok())
                and (self._sampling_is_noop()
                     or self._device_sample_fn() is not None)
                and self._use_batched_grower())

    def _device_sample_fn(self):
        """The sampling strategy's captured draw, or None
        (sample_strategy.py ``device_sample_fn``)."""
        return self.sample_strategy.device_sample_fn(
            self.train_set.metadata, self.device)

    def fused_valid_ok(self) -> bool:
        """Valid sets ride the fused round when every valid metric has a
        device evaluation (metrics.py ``eval_device_traced``) and device
        evaluation is on; with k > 1 trees a round every metric must take
        the [n, k] score matrix (``_DEV_MULTI``)."""
        if not self._device_eval_ok():
            return False
        multi = self.num_tree_per_iteration != 1
        return all(ms and all(m.has_device_eval()
                              and (m._DEV_MULTI or not multi) for m in ms)
                   for ms in self.valid_metrics)

    def _sampling_is_noop(self) -> bool:
        """No per-iteration row sampling (bagging.hpp's is_use_subset)."""
        c = self.config
        if str(c.data_sample_strategy) == "goss":
            return False
        return (float(c.bagging_fraction) >= 1.0
                and float(c.pos_bagging_fraction) >= 1.0
                and float(c.neg_bagging_fraction) >= 1.0) \
            or int(c.bagging_freq) <= 0

    @staticmethod
    def fused_chunk_for(num_rounds: int) -> int:
        """Chunk length of ``train_fused``: the largest c <= 40 that
        divides ``num_rounds`` (>= 8), 32 and a ragged tail otherwise."""
        for c in range(40, 7, -1):
            if num_rounds % c == 0:
                return c
        return 32

    @classmethod
    def fused_chunks(cls, num_rounds: int) -> List[int]:
        """The chunk lengths ``train_fused`` runs, in order."""
        c = cls.fused_chunk_for(num_rounds)
        out, done = [], 0
        while done < num_rounds:
            t = min(c, num_rounds - done)
            out.append(t)
            done += t
        return out

    def _fused_metric_layout(self):
        """(set name, display name, bigger) of each in-round metric value,
        in the order the round evaluates them."""
        rows = []
        for vi, ms in enumerate(self.valid_metrics):
            for m in ms:
                for disp in m.display_names():
                    rows.append((self.valid_names[vi], disp,
                                 bool(m.bigger_is_better)))
        return rows

    def train_fused(self, num_rounds: int, chunk: int = 0,
                    cb_driver=None, es_params=None) -> bool:
        """Run ``num_rounds`` boosting iterations as the fused round loop:
        each round's gradients, tree, score update, valid scoring, metric
        evaluation and stop flag are one captured CUDA graph on the card
        (boosting/fused_graph.py), with one host read a round; the trees
        and metric values of a chunk come to the host in one transfer.
        Returns True if growth finished early (a stump round).

        ``cb_driver(iteration, evals)``: run once per round with the
        device-evaluated metrics (engine.py feeds the real callbacks
        through it); an ``EarlyStopException`` from it truncates the model
        to that round (score caches rebuilt) and is re-raised.
        ``es_params``: the early_stopping callback's (stopping_rounds,
        first_metric_only, min_delta); at min_delta 0 the round keeps the
        stop flag itself (strict float32 comparisons of the values the
        callback compares) and the host stops replaying once it trips."""
        from .fused_graph import FusedRound, chunk_rows

        if not self.supports_fused():
            log.fatal("train_fused: this configuration runs the classic "
                      "loop (GBDT.supports_fused is false)")
        if chunk <= 0:
            chunk = self.fused_chunk_for(num_rounds)
        nvalid = len(self.valid_sets)
        mrows = self._fused_metric_layout() if nvalid else []
        use_es = (es_params is not None and cb_driver is not None
                  and nvalid > 0 and float(es_params[2]) == 0.0)
        es = (int(es_params[0]), bool(es_params[1])) if use_es else None
        key = (chunk, nvalid, es, float(self.config.feature_fraction) < 1.0)
        if self.forced is not None:
            # the forced schedule's bytes key the captured rounds, as the
            # JAX package keys its compiled runner
            key += (self.forced.table.cpu().numpy().tobytes(),)
        fr = self._fused_cache.get(key)
        if fr is None:
            fr = self._fused_cache[key] = FusedRound(self, chunk, es)
        fr.reset_es()
        k = self.num_tree_per_iteration
        begin_iter = self.iter_
        finished = False
        done = 0
        self._last_fused_evals = []
        while done < num_rounds and not finished:
            T = min(chunk, num_rounds - done)
            t0, cap0, done0 = time.perf_counter(), fr.capture_s, done
            rows = chunk_rows(fr.run(self.iter_, T), fr)
            for t, (class_arrays, mvals) in enumerate(rows):
                stumps = 0
                for cls_idx, arrays in enumerate(class_arrays):
                    tree = Tree.from_arrays(arrays, self.train_set)
                    tree.apply_shrinkage(self.shrinkage_rate)
                    if (self.iter_ == 0
                            and abs(self.init_scores[cls_idx]) > 1e-10):
                        tree.add_bias(self.init_scores[cls_idx])
                    self.models.append(tree)
                    stumps += tree.num_leaves <= 1
                self.iter_ += 1
                done += 1
                if nvalid:
                    self._last_fused_evals = [
                        (mrows[j][0], mrows[j][1], float(mvals[j]),
                         mrows[j][2]) for j in range(len(mrows))]
                if cb_driver is not None:
                    try:
                        cb_driver(self.iter_ - 1 - begin_iter,
                                  self._last_fused_evals)
                    except EarlyStopException:
                        # the device ran the chunk's later rounds: rebuild
                        # the score caches from the kept trees
                        if t + 1 < len(rows):
                            self.invalidate_score_cache()
                        raise
                if stumps == k:
                    # the classic loop stops after a round of k stumps
                    finished = True
                    if t + 1 < len(rows):
                        self.invalidate_score_cache()
                    break
            fr.walls.append((time.perf_counter() - t0
                             - (fr.capture_s - cap0), done - done0))
        return finished

    def invalidate_score_cache(self) -> None:
        """Rebuild the train and valid scores from the model list (after a
        fused chunk ran rounds past the kept ones), in place."""
        k = self.num_tree_per_iteration

        def rebuild(n, bins_d, init_score):
            sc = np.zeros((n, k), np.float32) + self.init_scores[None, :]
            if init_score is not None:
                sc += init_score.reshape(sc.shape, order="F") \
                    if init_score.size == sc.size else \
                    init_score.reshape(-1, 1)
            sc = torch.as_tensor(sc, device=self.device)
            for i, t in enumerate(self.models):
                arrs = _tree_to_arrays_stub(t, self.train_set, self.device)
                sc[:, i % k] += predict_bins_tree(arrs, bins_d,
                                                  self.nan_bin_arr,
                                                  self.bundle)
            return sc

        self.scores.copy_(rebuild(self.train_set.num_data, self.bins,
                                  self.train_set.metadata.init_score))
        for vi, vs in enumerate(self.valid_sets):
            self.valid_scores[vi].copy_(rebuild(
                vs.num_data, self._valid_bins[vi], vs.metadata.init_score))

    # ------------------------------------------------------------- evaluate
    def eval_train(self) -> List[Tuple[str, str, float, bool]]:
        return self._eval_metric_list("training", self.train_metrics,
                                      self.scores)

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        out = []
        for vi, ms in enumerate(self.valid_metrics):
            out.extend(self._eval_metric_list(
                self.valid_names[vi], ms, self.valid_scores[vi]))
        return out

    def _device_eval_ok(self) -> bool:
        """Metrics evaluate on the device unless ``tpu_device_eval=false`` or
        ``deterministic=true`` (host float64), as in the JAX package."""
        return (bool(self.config.tpu_device_eval)
                and not bool(self.config.deterministic))

    def _eval_metric_list(self, set_name, metrics, scores_dev):
        """Device float32 evaluation where the metric has one (only the M
        values cross to the host; with k > 1 only the metrics that take the
        [n, k] matrix), host float64 otherwise."""
        multi = scores_dev.shape[1] != 1
        out = []
        score_host = None
        for m in metrics:
            res = None
            if self._device_eval_ok() and (
                    not multi or (m._DEV_MULTI and self._DEVICE_EVAL_MULTI)):
                res = m.eval_device(scores_dev if multi else scores_dev[:, 0],
                                    self.objective)
            if res is None:
                if score_host is None:
                    score_host = self._host_scores(scores_dev)
                res = m.eval(score_host, self.objective)
            for name, val in res:
                out.append((set_name, name, val, m.bigger_is_better))
        return out

    #: k > 1 scores go to the metrics that take [n, k] on the device (the
    #: fused round evaluates them there, so the classic loop's values are
    #: the same); the JAX package's classic loop evaluates them on the host
    _DEVICE_EVAL_MULTI = True

    def _host_scores(self, scores: torch.Tensor) -> np.ndarray:
        s = scores.cpu().numpy().astype(np.float64)
        return s[:, 0] if s.shape[1] == 1 else s

    # ------------------------------------------------------------- predict
    #: rows x trees at and above which predict_raw runs the forest
    #: predictor on the booster's device; below it the host float64 walk
    #: (no binning pass) keeps full-double sums for small inputs, as in
    #: the JAX package
    DEVICE_PREDICT_MIN_WORK = 20_000_000

    #: _device_predict_raw's row blocks (class attributes so tests can
    #: shrink them): BLOCK bounds the plain version's [ni, rows] decision
    #: bits and [L, rows] counts; QUANTUM is the tail padding grain of the
    #: plain version (the JAX package's geometry; the kernel needs none)
    PREDICT_BLOCK_ROWS = 1_048_576
    PREDICT_TAIL_QUANTUM = 131_072

    def predict_raw(self, X: np.ndarray, start_iteration: int = 0,
                    num_iteration: int = -1, early=None) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        k = self.num_tree_per_iteration
        total_iters = len(self.models) // k
        end = total_iters if num_iteration <= 0 else \
            min(total_iters, start_iteration + num_iteration)
        n_trees = max(0, (end - start_iteration) * k)
        if (early is None and X.shape[0] * n_trees
                >= self.DEVICE_PREDICT_MIN_WORK):
            dev = self._device_predict_raw(X, start_iteration, end)
            if dev is not None:
                return dev
        from ..basic import _host_raw
        out = _host_raw(self.models, X, k, start_iteration, end, early)
        return out[:, 0] if k == 1 else out

    def _device_predict_raw(self, X: np.ndarray, start_it: int,
                            end_it: int) -> Optional[np.ndarray]:
        """Raw scores of trees [start_it, end_it) on the booster's device:
        X binned once with the training mappers (a raw split
        ``value <= threshold`` is exactly ``bin <= threshold_bin`` under
        them), then the stacked forest over the bins.  Numeric models use
        ``bin_external`` (u8) and :class:`ForestArrays`; categorical,
        bundled and linear models ``bin_external_pred`` (i32 logical bins
        with the unseen / NaN sentinels) and :class:`BitsetForest`.

        On the card the bins [F, n] are copied once and the forest kernel
        runs once per row block, with no padding; a linear model also
        copies the raw values of the columns its leaves read, feature-major,
        and the kernel runs in its linear mode.  On the CPU the plain
        version runs per block, the ragged tail padded up as the JAX
        package pads it (``predict_bucketing=on``: the geometric ladder of
        quantum multiples up to the block, ``off``: the next multiple of
        the quantum); padded rows are cut off and every row's result is
        exact per row, so the output is the same either way.  The JAX
        package's ``predict_bucketed_calls`` / ``predict_bucket_pad_rows``
        counters belong to its ``obs/`` layer and are not kept here."""
        k = self.num_tree_per_iteration
        models = self.models[start_it * k:end_it * k]
        if not models:
            return None
        dev = self.device
        ds = self.train_set
        linear = any(t.is_linear for t in models)
        general = (linear or bool(ds.categorical_array().any())
                   or ds.bundle_plan is not None)
        lin = None
        cat_feats = ()
        if general:
            fb, lin_np, cat_feats = forest_bitset_arrays(models, k, ds)
            forest = forest_from_numpy(fb, dev)
            cols = np.zeros(0, np.int64) if lin_np is None else \
                np.nonzero(lin_np["featmask"].any((0, 1)))[0]
            if cols.size:
                # only the raw columns the linear leaves read (a leaf with
                # none outputs its plain value)
                lin = forest_from_numpy(dict(
                    const=lin_np["const"], coeff=lin_np["coeff"][..., cols],
                    featmask=lin_np["featmask"][..., cols]), dev)
                raw_np = np.asarray(X[:, cols], np.float32)
            bins_np = ds.bin_external_pred(X)
        else:
            forest = self._forest_arrays(models, k)
            bins_np = ds.bin_external(X)
        blk = int(self.PREDICT_BLOCK_ROWS)
        n_all = bins_np.shape[0]
        if dev.type == "cuda":
            bins_t = torch.as_tensor(np.ascontiguousarray(bins_np.T),
                                     device=dev)
            raw_t = None if lin is None else torch.as_tensor(
                np.ascontiguousarray(raw_np.T), device=dev)
            outs = [forest_kernels.forest_values(
                forest, bins_t[:, r0:r0 + blk], k, cat_feats, lin=lin,
                raw_t=None if raw_t is None else raw_t[:, r0:r0 + blk])
                for r0 in range(0, n_all, blk)]
            out = torch.cat(outs).double().cpu().numpy()
            return out[:, 0] if k == 1 else out
        tail_q = min(int(self.PREDICT_TAIL_QUANTUM), blk)
        bucketing = self.config.predict_bucketing == "on"
        outs = []
        for r0 in range(0, n_all, blk):
            chunk = bins_np[r0:r0 + blk]
            rows = chunk.shape[0]
            if bucketing:
                target = tail_q
                while target < rows:
                    target *= 2
                pad = min(target, blk) - rows
            else:
                pad = (-rows) % tail_q
            bins_t = torch.as_tensor(np.ascontiguousarray(
                np.pad(chunk, ((0, pad), (0, 0))).T), device=dev)
            raw_t = None if lin is None else torch.as_tensor(
                np.ascontiguousarray(np.pad(raw_np[r0:r0 + blk],
                                            ((0, pad), (0, 0))).T),
                device=dev)
            res = forest_kernels.forest_values(forest, bins_t, k, cat_feats,
                                               lin=lin, raw_t=raw_t)
            outs.append(res[:rows].double().numpy())
        out = np.concatenate(outs, axis=0)
        return out[:, 0] if k == 1 else out

    def _forest_arrays(self, models, k: int) -> ForestArrays:
        """The numeric forest of ``models`` on the booster's device
        (:func:`forest_arrays`)."""
        return forest_from_numpy(forest_arrays(models, k, self.train_set),
                                 self.device)

    def predict(self, X: np.ndarray, raw_score: bool = False,
                start_iteration: int = 0, num_iteration: int = -1,
                pred_leaf: bool = False, early=None) -> np.ndarray:
        if pred_leaf:
            X = np.asarray(X, dtype=np.float64)
            if X.ndim == 1:
                X = X.reshape(1, -1)
            k = self.num_tree_per_iteration
            total_iters = len(self.models) // k
            end = total_iters if num_iteration <= 0 else \
                min(total_iters, start_iteration + num_iteration)
            from ..basic import _host_leaves
            return _host_leaves(self.models, X, k, start_iteration, end)
        raw = self.predict_raw(X, start_iteration, num_iteration,
                               early=early)
        if raw_score or not self.objective.need_convert_output:
            return raw
        # f32 conversion, as the JAX package converts raw scores on its
        # device (x64 off)
        return self.objective.convert_output(
            torch.as_tensor(raw, dtype=torch.float32)).numpy()

    # -------------------------------------------------------------- export
    def num_trees(self) -> int:
        return len(self.models)

    def current_iteration(self) -> int:
        return self.iter_


def _tree_to_arrays_stub(tree: Tree, dataset: Dataset,
                         device) -> TreeArrays:
    """A host Tree as device TreeArrays (packed feature indices, bin
    thresholds, categorical nodes' bitsets over the training bins) for the
    walk: its own contribution, the folded boost-from-average bias taken
    out (the JAX package's stub)."""
    L = max(tree.num_leaves, 2)
    ni = L - 1
    orig_to_packed = {o: p for p, o in enumerate(dataset.used_feature_idx)}
    sf = np.array([orig_to_packed.get(int(f), 0)
                   for f in tree.split_feature], np.int32)

    def pad(a, fill, dtype):
        out = np.full(ni, fill, dtype)
        out[:len(a)] = np.asarray(a)[:ni]
        return torch.as_tensor(out, device=device)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    n_bins = dataset.device_n_bins()
    bitset = np.zeros((ni, n_bins), bool)
    for i in range(min(len(tree.split_feature), ni)):
        if not tree.decision_type[i] & 1:
            continue
        csi = int(tree.cat_split_index[i])
        if csi < 0 or csi >= len(tree.cat_threshold):
            continue
        table = dataset.mappers[int(tree.split_feature[i])]._cat_2_bin or {}
        for c in tree.cat_threshold[csi]:
            b = table.get(int(c))
            if b is not None and b < n_bins:
                bitset[i, b] = True

    leaf = np.zeros(L, np.float32)
    leaf[:tree.num_leaves] = (tree.leaf_value - tree.bias).astype(np.float32)
    return TreeArrays(
        split_feature=pad(sf, 0, np.int32),
        split_bin=pad(tree.threshold_bin, 0, np.int32),
        default_left=pad((tree.decision_type & 2) > 0, False, bool),
        split_cat=pad((tree.decision_type & 1) > 0, False, bool),
        left_child=pad(tree.left_child, -1, np.int32),
        right_child=pad(tree.right_child, -1, np.int32),
        split_gain=zeros(ni, torch.float32),
        cat_bitset=torch.as_tensor(bitset, device=device),
        internal_value=zeros(ni, torch.float32),
        internal_count=zeros(ni, torch.float32),
        leaf_value=torch.as_tensor(leaf, device=device),
        leaf_count=zeros(L, torch.float32),
        leaf_weight=zeros(L, torch.float32),
        leaf_depth=zeros(L, torch.int32),
        leaf_path=zeros((L, dataset.num_features), torch.bool),
        num_leaves=torch.tensor(tree.num_leaves, dtype=torch.int32,
                                device=device))


def _leaf_path_masks(t: Tree, mpos: np.ndarray, mneg: np.ndarray,
                     depth: np.ndarray) -> None:
    """Fill one tree's leaf path masks in place (the JAX package's
    ``_leaf_path_masks``): a depth-first walk from the root records each
    leaf's (node, direction) path; children encode leaves as
    ``-(leaf + 1)``.  mpos / mneg [L, ni], depth [L] (-1 stays for dead
    slots)."""
    if t.num_leaves <= 1:
        depth[0] = 0
        return
    stack = [(0, [])]
    while stack:
        node, path = stack.pop()
        for child, left in ((t.left_child[node], True),
                            (t.right_child[node], False)):
            p2 = path + [(node, left)]
            if child < 0:
                leaf = -int(child) - 1
                depth[leaf] = len(p2)
                for nd, lft in p2:
                    (mpos if lft else mneg)[leaf, nd] = 1.0
            else:
                stack.append((int(child), p2))


def forest_arrays(models, k: int, ds: Dataset) -> dict:
    """The JAX package's ``_forest_arrays`` as numpy: every field of
    :class:`ForestArrays` (masks in float32, 0/1) for the trees ``models``
    of a booster trained on ``ds``, each padded to the widest tree's
    ni = L - 1 nodes, and the children (-1 on padded nodes)."""
    L = max(max(t.num_leaves for t in models), 2)
    T, ni = len(models), L - 1
    orig_to_packed = {o: p for p, o in enumerate(ds.used_feature_idx)}
    nan_bin = ds.nan_bin_array()
    d = dict(feat=np.zeros((T, ni), np.int32),
             thr=np.zeros((T, ni), np.int32),
             dl=np.zeros((T, ni), bool),
             nanb=np.full((T, ni), -2, np.int32),
             mpos=np.zeros((T, L, ni), np.float32),
             mneg=np.zeros((T, L, ni), np.float32),
             depth=np.full((T, L), -1, np.int32),
             value=np.zeros((T, L), np.float32),
             cls=np.arange(T, dtype=np.int32) % k,
             left=np.full((T, ni), -1, np.int32),
             right=np.full((T, ni), -1, np.int32))
    for ti, t in enumerate(models):
        nn = max(t.num_leaves - 1, 0)
        d["value"][ti, :t.num_leaves] = t.leaf_value[:t.num_leaves]
        _leaf_path_masks(t, d["mpos"][ti], d["mneg"][ti], d["depth"][ti])
        if nn:
            pf = np.array([orig_to_packed.get(int(f), 0)
                           for f in t.split_feature[:nn]], np.int32)
            d["feat"][ti, :nn] = pf
            d["thr"][ti, :nn] = t.threshold_bin[:nn]
            d["dl"][ti, :nn] = (np.asarray(t.decision_type[:nn]) & 2) > 0
            d["nanb"][ti, :nn] = nan_bin[pf]
            d["left"][ti, :nn] = t.left_child[:nn]
            d["right"][ti, :nn] = t.right_child[:nn]
    return d


def forest_bitset_arrays(models, k: int, ds: Dataset):
    """The JAX package's ``_forest_bitset_arrays`` as numpy: (the fields
    of :class:`BitsetForest`, those of :class:`LinearLeaves` or None,
    cat_feats).  Numeric nodes (bundled or not) stay threshold compares in
    LOGICAL bin space; true categorical nodes get bitsets over the widest
    categorical feature's bins plus the sentinel bins of
    ``bin_external_pred`` (unseen ``num_bin``: right; NaN ``num_bin + 1``:
    ``cat_nan_left``)."""
    d = forest_arrays(models, k, ds)
    T, ni = d["feat"].shape
    L = ni + 1
    is_cat = ds.categorical_array()
    cat_feats = tuple(int(p) for p in np.nonzero(is_cat)[0])
    Bc = max((ds.mappers[ds.used_feature_idx[p]].num_bin
              for p in cat_feats), default=1) + 2
    cat_nodes = [[nd for nd in range(max(t.num_leaves - 1, 0))
                  if int(t.decision_type[nd]) & 1] for t in models]
    C = max([1] + [len(c) for c in cat_nodes])
    catn = np.full((T, C), ni, np.int32)        # ni = dead pad slot
    catf = np.zeros((T, C), np.int32)
    catb = np.zeros((T, C, Bc), np.float32)
    for ti, t in enumerate(models):
        for ci, nd in enumerate(cat_nodes[ti]):
            p = int(d["feat"][ti, nd])
            catn[ti, ci] = nd
            catf[ti, ci] = p
            csi = int(t.cat_split_index[nd])
            sets = set(t.cat_threshold[csi])
            mapper = ds.mappers[ds.used_feature_idx[p]]
            for b, c in enumerate(mapper.bin_2_categorical):
                if c in sets:
                    catb[ti, ci, b] = 1.0
            if csi < len(t.cat_nan_left) and t.cat_nan_left[csi]:
                catb[ti, ci, mapper.num_bin + 1] = 1.0
    d.update(catn=catn, catf=catf, catb=catb)
    lin = None
    if any(t.is_linear for t in models):
        Fr = ds.num_total_features
        lin = dict(const=np.zeros((T, L), np.float32),
                   coeff=np.zeros((T, L, Fr), np.float32),
                   featmask=np.zeros((T, L, Fr), np.float32))
        for ti, t in enumerate(models):
            if not t.is_linear:
                continue
            for leaf in range(t.num_leaves):
                lin["const"][ti, leaf] = t.leaf_const[leaf]
                for fi, f in enumerate(t.leaf_features[leaf]):
                    lin["coeff"][ti, leaf, f] = t.leaf_coeff[leaf][fi]
                    lin["featmask"][ti, leaf, f] = 1.0
    return d, lin, cat_feats
