"""GBDT boosting driver.

Counterpart of ``lightgbm_tpu/boosting/gbdt.py`` (reference
src/boosting/gbdt.cpp ``TrainOneIter`` :344-452).  One iteration runs, on
the booster's torch device: objective gradients -> integer gradient levels
(ops/quantize.py; stochastic rounding draws the JAX package's threefry
bits) -> ``grow_tree_batched`` -> leaf renewal from the true gradients ->
shrinkage -> the score update through ``take_small_table``
(shrink BEFORE the gather, the JAX package's order) -> valid-set score
updates.  Trees are then finalized on the host (models/tree.py).
Boost-from-average folds the initial score into the first iteration's
trees exactly like the JAX package.

``_resolve_auto_params`` is the JAX package's policy verbatim: at >= 100k
rows an unset ``tpu_split_batch`` becomes min(42, num_leaves - 1) and an
unset ``tpu_hist_dtype`` / ``use_quantized_grad`` becomes exact int8
levels with leaf renewal.

Not ported yet: the strict leaf-wise grower, the fused multi-round scan,
bagging/GOSS, DART/RF, multiclass, custom objectives, the distributed
modes and the device forest predictor (``predict`` walks trees on the
host, as the JAX package does below ``DEVICE_PREDICT_MIN_WORK``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io.dataset import Dataset
from ..learner.batch_grower import check_supported, grow_tree_batched
from ..metrics import Metric, create_metrics
from ..models.predict import predict_bins_tree
from ..models.tree import Tree
from ..objectives import ObjectiveFunction, create_objective
from ..ops import prng
from ..ops.histogram import resolve_hist_kernel, wants_packed_mirror
from ..ops.quantize import discretize_gradients_levels, renew_leaf_values
from ..ops.split import SplitHyper
from ..ops.table import take_small_table
from ..utils import log
from ..utils.device import resolve_device


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
        (config.boosting != "gbdt", f"boosting={config.boosting}"),
        (str(config.data_sample_strategy) == "goss", "GOSS sampling"),
        (int(config.bagging_freq) > 0 and (
            float(config.bagging_fraction) < 1.0
            or float(config.pos_bagging_fraction) < 1.0
            or float(config.neg_bagging_fraction) < 1.0), "bagging"),
        (str(config.tree_learner) not in ("serial",),
         f"tree_learner={config.tree_learner}"),
        (bool(config.linear_tree), "linear_tree"),
        (any(int(m) != 0 for m in (config.monotone_constraints or [])),
         "monotone_constraints"),
        (bool(config.interaction_constraints), "interaction_constraints"),
        (bool(config.forcedsplits_filename), "forcedsplits_filename"),
        (float(config.cegb_penalty_split) > 0.0
         or bool(list(config.cegb_penalty_feature_lazy or []))
         or bool(list(config.cegb_penalty_feature_coupled or [])),
         "cegb penalties"),
        (config.nan_policy != "none", f"nan_policy={config.nan_policy}"),
        (bool(config.tpu_debug_checks), "tpu_debug_checks"),
        (bool(train_set.categorical_array().any()), "categorical features"),
        (train_set.bundle_plan is not None,
         "EFB feature bundles (set enable_bundle=false)"),
    ]
    for bad, what in unported:
        if bad:
            log.fatal(f"{what} is not supported by lightgbm_tpu_torch yet")


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

        self._resolve_auto_params(config)
        self.hp = _hp_from_config(config, train_set.device_n_bins())
        # the transposed packed mirror [W, n], resident when the masked
        # passes may take the packed kernel (the JAX booster's bins_words)
        self.bins_words_t = None
        if wants_packed_mirror(self.hp.hist_kernel, self.hp.n_bins):
            self.bins_words_t = self.bins_words.t().contiguous()
        self._check_pool(config)
        check_supported(self.hp, int(config.tpu_split_batch))

        n = train_set.num_data
        k = self.num_tree_per_iteration
        self.scores = torch.zeros(n, k, dtype=torch.float32, device=dev)
        self.init_scores = np.zeros(k)
        self._init_base_score()

        self.valid_sets: List[Dataset] = []
        self.valid_names: List[str] = []
        self.valid_scores: List[torch.Tensor] = []
        self.valid_metrics: List[List[Metric]] = []
        self._valid_bins: List[torch.Tensor] = []

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
        """The JAX package's histogram-pool translation, reduced to its
        verdict: an engaged pool is not ported yet."""
        pool_mb = float(config.histogram_pool_size)
        bytes_per_leaf = self.bins.shape[1] * self.hp.n_bins * 4 * 4
        if pool_mb <= 0 and not config.is_explicit("histogram_pool_size") \
                and bytes_per_leaf * self.hp.num_leaves > (4 << 30):
            pool_mb = 1024.0
        if pool_mb > 0:
            slots = int(pool_mb * (1 << 20) // max(bytes_per_leaf, 1))
            slots = max(slots, 3 * max(1, int(config.tpu_split_batch)) + 2)
            if slots < self.hp.num_leaves:
                self.hp = dataclasses.replace(self.hp, hist_pool_slots=slots)

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

    # ------------------------------------------------------------ training
    def boosting_gradients(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """reference GBDT::Boosting (gbdt.cpp:220)."""
        g, h = self.objective.get_gradients(self.scores[:, 0])
        return g[:, None], h[:, None]

    def _feature_mask_for_tree(self) -> Optional[torch.Tensor]:
        frac = float(self.config.feature_fraction)
        if frac >= 1.0:
            return None
        f = self.num_features
        kf = max(1, int(np.ceil(frac * f)))
        rng = np.random.default_rng(self.config.feature_fraction_seed
                                    + self.iter_)
        chosen = rng.choice(f, size=kf, replace=False)
        mask = np.zeros(f, bool)
        mask[chosen] = True
        return torch.as_tensor(mask, device=self.device)

    def train_one_iter(self) -> bool:
        """One boosting iteration (reference gbdt.cpp:344 TrainOneIter).
        Returns True when no tree could be grown (early finish)."""
        k = self.num_tree_per_iteration
        g, h = self.boosting_gradients()
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
            arrays, leaf_of_row = grow_tree_batched(
                self.bins, g[:, cls_idx].contiguous(),
                h[:, cls_idx].contiguous(), None, self.num_bins_arr,
                self.nan_bin_arr, feature_mask, self.hp,
                batch=int(self.config.tpu_split_batch),
                hist_scale=hist_scales[cls_idx], bins_t=self.bins_t,
                bins_words=self.bins_words, bins_words_t=self.bins_words_t)
            if quant and bool(self.config.quant_train_renew_leaf):
                renewed = renew_leaf_values(
                    leaf_of_row, g_true[:, cls_idx], h_true[:, cls_idx],
                    None, num_leaves=self.hp.num_leaves,
                    lambda_l1=self.hp.lambda_l1, lambda_l2=self.hp.lambda_l2)
                # stump (no split found): keep the original leaf value
                arrays = arrays._replace(leaf_value=torch.where(
                    arrays.num_leaves > 1, renewed, arrays.leaf_value))
            # shrink BEFORE the gather, exactly like the JAX package: the
            # other order differs by an ulp and cascades through the
            # quantization grid
            shrunk = arrays.leaf_value * self.shrinkage_rate
            self.scores[:, cls_idx] += take_small_table(shrunk, leaf_of_row)
            arrays_shrunk = arrays._replace(leaf_value=shrunk)
            for vi in range(len(self.valid_sets)):
                self.valid_scores[vi][:, cls_idx] += predict_bins_tree(
                    arrays_shrunk, self._valid_bins[vi], self.nan_bin_arr)
            tree = Tree.from_arrays(arrays, self.train_set)
            if tree.num_leaves > 1:
                finished = False
            tree.apply_shrinkage(self.shrinkage_rate)
            if self.iter_ == 0 and abs(self.init_scores[cls_idx]) > 1e-10:
                tree.add_bias(self.init_scores[cls_idx])
            self.models.append(tree)
        self.iter_ += 1
        return finished

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

    def _eval_metric_list(self, set_name, metrics, scores_dev):
        """Host float64 evaluation (the JAX package's non-device eval)."""
        out = []
        if not metrics:
            return out
        score_host = self._host_scores(scores_dev)
        for m in metrics:
            for name, val in m.eval(score_host, self.objective):
                out.append((set_name, name, val, m.bigger_is_better))
        return out

    def _host_scores(self, scores: torch.Tensor) -> np.ndarray:
        s = scores.cpu().numpy().astype(np.float64)
        return s[:, 0] if s.shape[1] == 1 else s

    # ------------------------------------------------------------- predict
    def predict_raw(self, X: np.ndarray, start_iteration: int = 0,
                    num_iteration: int = -1) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        k = self.num_tree_per_iteration
        total_iters = len(self.models) // k
        end = total_iters if num_iteration <= 0 else \
            min(total_iters, start_iteration + num_iteration)
        out = np.zeros((X.shape[0], k))
        for it in range(start_iteration, end):
            for c in range(k):
                out[:, c] += self.models[it * k + c].predict(X)
        return out[:, 0] if k == 1 else out

    def predict(self, X: np.ndarray, raw_score: bool = False,
                start_iteration: int = 0,
                num_iteration: int = -1) -> np.ndarray:
        raw = self.predict_raw(X, start_iteration, num_iteration)
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
