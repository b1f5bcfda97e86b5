"""Parameter/config system.

Counterpart of ``lightgbm_tpu/config.py``: the same ``_PARAMS`` registry,
aliases, coercion and checks, so the same keys parse to the same values.
Port-specific: ``device_type`` selects the torch device (utils/device.py;
default ``cuda``), and keys whose features are not ported yet are rejected
at the boundary that would read them.

Design of the reference's config layer (reference:
include/LightGBM/config.h:39 ``struct Config`` with 837 defaulted fields,
src/io/config.cpp ``Config::Set`` and the generated alias table in
src/io/config_auto.cpp).  The reference generates its alias table and setters
from structured comments; here a single declarative ``_PARAMS`` registry plays
that role (single source of truth for names, aliases, defaults and checks).

Semantics preserved:
  * alias resolution is first-wins per canonical name
    (reference application.cpp:79 ``KeepFirstValues``),
  * ``Config.set(params)`` accepts strings or typed values,
  * ``check`` constraints mirror the reference's ``// check = ...`` comments,
  * ``check_param_conflict`` fixes illegal combos (reference config.cpp).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

from .utils import log


def _parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return bool(v)
    s = str(v).strip().lower()
    if s in ("true", "1", "yes", "+"):
        return True
    if s in ("false", "0", "no", "-"):
        return False
    raise ValueError(f"cannot parse bool from {v!r}")


def _parse_int_list(v: Any) -> List[int]:
    if v is None or v == "":
        return []
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return [int(x) for x in str(v).split(",") if x != ""]


def _parse_float_list(v: Any) -> List[float]:
    if v is None or v == "":
        return []
    if isinstance(v, (list, tuple)):
        return [float(x) for x in v]
    return [float(x) for x in str(v).split(",") if x != ""]


def _parse_str_list(v: Any) -> List[str]:
    if v is None or v == "":
        return []
    if isinstance(v, (list, tuple)):
        return [str(x) for x in v]
    return [s for s in str(v).split(",") if s != ""]


# (name, default, aliases, check) — check is (op, bound) pairs like the
# reference's `// check = >0` annotations (config.h:202-253).
# Parameters that BIND a constructed Dataset's binning and cannot change
# afterwards (reference LGBM_DatasetUpdateParamChecking c_api.h:573 and the
# python package's _compare_params_for_warning list).
DATASET_BINDING_PARAMS = (
    "max_bin", "max_bin_by_feature", "min_data_in_bin",
    "bin_construct_sample_cnt", "enable_bundle", "linear_tree",
    "data_random_seed", "is_enable_sparse", "feature_pre_filter",
    "use_missing", "zero_as_missing", "categorical_feature",
    "forcedbins_filename", "precise_float_parser",
)

_PARAMS: List[Tuple[str, Any, Tuple[str, ...], Tuple[Tuple[str, float], ...]]] = [
    # --- core (config.h "Core Parameters") ---
    ("task", "train", ("task_type",), ()),
    ("output_model", "LightGBM_model.txt", ("model_output", "model_out"), ()),
    ("input_model", "", ("model_input", "model_in"), ()),
    ("output_result", "LightGBM_predict_result.txt",
     ("predict_result", "prediction_result", "predict_name", "pred_name",
      "name_pred", "prediction_name"), ()),
    ("saved_feature_importance_type", 0, (), ()),
    ("config", "", ("config_file",), ()),
    ("objective", "regression", ("objective_type", "app", "application", "loss"), ()),
    ("boosting", "gbdt", ("boosting_type", "boost"), ()),
    ("data_sample_strategy", "bagging", (), ()),
    ("data", "", ("train", "train_data", "train_data_file", "data_filename"), ()),
    ("valid", [], ("test", "valid_data", "valid_data_file", "test_data",
                   "test_data_file", "valid_filenames"), ()),
    ("num_iterations", 100, ("num_iteration", "n_iter", "num_tree", "num_trees",
                             "num_round", "num_rounds", "nrounds", "num_boost_round",
                             "n_estimators", "max_iter"), ((">=", 0),)),
    ("learning_rate", 0.1, ("shrinkage_rate", "eta"), ((">", 0.0),)),
    ("num_leaves", 31, ("num_leaf", "max_leaves", "max_leaf", "max_leaf_nodes"),
     ((">", 1),)),
    ("tree_learner", "serial", ("tree", "tree_type", "tree_learner_type"), ()),
    ("num_threads", 0, ("num_thread", "nthread", "nthreads", "n_jobs"), ()),
    ("device_type", "cuda", ("device",), ()),      # torch device: cuda|gpu -> the card, cpu -> CPU (utils/device.py)
    ("seed", None, ("random_seed", "random_state"), ()),
    ("deterministic", False, (), ()),
    # --- learning control ---
    ("force_col_wise", False, (), ()),
    ("force_row_wise", False, (), ()),
    ("histogram_pool_size", -1.0, ("hist_pool_size",), ()),
    ("max_depth", -1, (), ()),
    ("min_data_in_leaf", 20, ("min_data_per_leaf", "min_data", "min_child_samples",
                              "min_samples_leaf"), ((">=", 0),)),
    ("min_sum_hessian_in_leaf", 1e-3, ("min_sum_hessian_per_leaf", "min_sum_hessian",
                                       "min_hessian", "min_child_weight"), ((">=", 0.0),)),
    ("bagging_fraction", 1.0, ("sub_row", "subsample", "bagging"),
     ((">", 0.0), ("<=", 1.0))),
    ("pos_bagging_fraction", 1.0, ("pos_sub_row", "pos_subsample", "pos_bagging"),
     ((">", 0.0), ("<=", 1.0))),
    ("neg_bagging_fraction", 1.0, ("neg_sub_row", "neg_subsample", "neg_bagging"),
     ((">", 0.0), ("<=", 1.0))),
    ("bagging_freq", 0, ("subsample_freq",), ()),
    ("bagging_seed", 3, ("bagging_fraction_seed",), ()),
    ("bagging_by_query", False, (), ()),
    ("feature_fraction", 1.0, ("sub_feature", "colsample_bytree"),
     ((">", 0.0), ("<=", 1.0))),
    ("feature_fraction_bynode", 1.0, ("sub_feature_bynode", "colsample_bynode"),
     ((">", 0.0), ("<=", 1.0))),
    ("feature_fraction_seed", 2, (), ()),
    ("extra_trees", False, ("extra_tree",), ()),
    ("extra_seed", 6, (), ()),
    ("early_stopping_round", 0, ("early_stopping_rounds", "early_stopping",
                                 "n_iter_no_change"), ()),
    ("early_stopping_min_delta", 0.0, (), ((">=", 0.0),)),
    ("first_metric_only", False, (), ()),
    ("max_delta_step", 0.0, ("max_tree_output", "max_leaf_output"), ()),
    ("lambda_l1", 0.0, ("reg_alpha", "l1_regularization"), ((">=", 0.0),)),
    ("lambda_l2", 0.0, ("reg_lambda", "lambda", "l2_regularization"), ((">=", 0.0),)),
    ("linear_lambda", 0.0, (), ((">=", 0.0),)),
    ("min_gain_to_split", 0.0, ("min_split_gain",), ((">=", 0.0),)),
    ("drop_rate", 0.1, ("rate_drop",), ((">=", 0.0), ("<=", 1.0))),
    ("max_drop", 50, (), ()),
    ("skip_drop", 0.5, (), ((">=", 0.0), ("<=", 1.0))),
    ("xgboost_dart_mode", False, (), ()),
    ("uniform_drop", False, (), ()),
    ("drop_seed", 4, (), ()),
    ("top_rate", 0.2, (), ((">=", 0.0), ("<=", 1.0))),
    ("other_rate", 0.1, (), ((">=", 0.0), ("<=", 1.0))),
    ("min_data_per_group", 100, (), ((">", 0),)),
    ("max_cat_threshold", 32, (), ((">", 0),)),
    ("cat_l2", 10.0, (), ((">=", 0.0),)),
    ("cat_smooth", 10.0, (), ((">=", 0.0),)),
    ("max_cat_to_onehot", 4, (), ((">", 0),)),
    ("top_k", 20, ("topk",), ((">", 0),)),
    ("monotone_constraints", [], ("mc", "monotone_constraint", "monotonic_cst"), ()),
    ("monotone_constraints_method", "basic", ("monotone_constraining_method", "mc_method"), ()),
    ("monotone_penalty", 0.0, ("monotone_splits_penalty", "ms_penalty", "mc_penalty"),
     ((">=", 0.0),)),
    ("feature_contri", [], ("feature_contrib", "fc", "fp", "feature_penalty"), ()),
    ("forcedsplits_filename", "", ("fs", "forced_splits_filename", "forced_splits_file",
                                   "forced_splits"), ()),
    ("refit_decay_rate", 0.9, (), ((">=", 0.0), ("<=", 1.0))),
    ("cegb_tradeoff", 1.0, (), ((">=", 0.0),)),
    ("cegb_penalty_split", 0.0, (), ((">=", 0.0),)),
    ("cegb_penalty_feature_lazy", [], (), ()),
    ("cegb_penalty_feature_coupled", [], (), ()),
    ("path_smooth", 0.0, (), ((">=", 0.0),)),
    ("interaction_constraints", "", (), ()),
    ("verbosity", 1, ("verbose",), ()),
    ("snapshot_freq", -1, ("save_period",), ()),
    # --- observability (obs/; docs/OBSERVABILITY.md) ---
    ("trace_output", "", ("trace_file", "trace_out"), ()),        # Chrome trace-event JSON path (Perfetto-loadable)
    ("telemetry_output", "", ("telemetry_file",), ()),            # per-iteration telemetry JSONL path
    ("event_output", "", ("event_file", "event_journal"), ()),    # structured event-journal JSONL path (obs/events.py declared schema; lifecycle events: heartbeat/eviction/reshape/resume, checkpoint write/resume/corrupt-skip, nan_policy trips, serving hot-swap/overload)
    ("profile_dir", "", ("profiler_dir",), ()),                   # jax.profiler trace directory (device timeline)
    ("slo_config", "", ("slos",), ()),                            # declarative SLO watching (obs/slo.py SLOS table): ""/off = disabled; "on" = every declared SLO at default budget; or "name[:budget],name2" to pick/override (e.g. "serving_p99_ms:25,compile_miss_storm"); breaches emit slo_breach/slo_recovered journal events with multi-window burn-rate logic
    ("rollup_window_s", 60.0, ("rollup_window",), ((">", 0.0),)), # time-series rollup window length in seconds (obs/timeseries.py ring; feeds SLO evaluation and tools/obs_top.py)
    ("anomaly_detection", "off", (), ()),                         # baseline-relative training-loop anomaly detection: on|off (obs/anomaly.py; robust z on round time, eval divergence/plateau, compile-miss burst, host-RSS slope — journal events + counters, never hard failures)
    ("request_trace", "off", (), ()),                             # request-scoped distributed tracing across the serving tier (obs/reqtrace.py): off (default; zero per-request work) | errors (tail-based: keep failed/failed-over/deadline-breached/slowest-k traces only) | sample:<p> (errors + keep fraction p of healthy requests) | all; kept traces carry a per-request span tree (router dispatch, retry attempts, replica queue wait, admission, bucket pad, device run, value gather) merged onto the router's clock, plus exemplar trace ids on latency quantiles and a per-process crash flight recorder
    # --- robustness (robustness/; docs/ROBUSTNESS.md) ---
    ("checkpoint_dir", "", ("checkpoint_directory",), ()),        # periodic atomic training checkpoints under this directory; empty = off
    ("checkpoint_interval", 10, (), ((">", 0),)),                 # boosting rounds between checkpoints
    ("checkpoint_keep", 3, (), ((">", 0),)),                      # newest checkpoints retained (older ones pruned)
    ("nan_policy", "none", (), ()),                               # per-round finite guard on grad/hess/scores: none|raise|skip_round|halt_and_keep_best
    ("cluster_timeout_s", 3600.0, ("cluster_timeout",), ((">", 0.0),)),  # parallel.cluster.launch worker deadline
    ("heartbeat_interval_s", 5.0, (), ((">", 0.0),)),             # elastic liveness: seconds between per-round worker heartbeat markers (robustness/elastic.py; same file substrate as the startup-barrier ready markers)
    ("heartbeat_timeout_s", 30.0, (), ((">", 0.0),)),             # elastic liveness: a worker silent past this is DEAD (evicted); staleness between heartbeat_interval_s and this marks it SLOW (bounded wait + warn + elastic_slow_worker_rounds counter)
    ("elastic", "off", (), ()),                                   # worker-loss policy: on|off. off (default) = a post-barrier worker death fail-fasts the whole job (pre-PR-9 behavior); on = evict the silent worker, rebuild the mesh over the survivor set, re-shard rows, resume from the newest checkpoint (robustness/elastic.py, docs/ROBUSTNESS.md "Elastic recovery")
    ("publish_interval", 10, (), ((">", 0),)),                    # continuous-learning pipeline (pipeline/; docs/ROBUSTNESS.md "Continuous learning"): boosting rounds per train->publish cycle — every cycle boosts this many more rounds on the data seen so far, then exports and publishes the snapshot
    ("pipeline_workdir", "", (), ()),                             # continuous-learning pipeline: durable directory for the atomic cycle manifest, per-cycle checkpoints, model-text exports and the publish-provenance ledger; a SIGKILLed trainer resumes from it with ContinuousTrainer(..., resume="auto"); empty = pipeline unavailable (ContinuousTrainer requires it)
    ("publish_retry_budget", 2, (), ((">=", 0),)),                # continuous-learning pipeline: publishes retried per cycle after a mid-rollout abort (fleet RollingSwapAborted) before the failure propagates; each retry reuses the cycle's export-assigned version, never skipping forward
    ("use_quantized_grad", False, (), ()),
    ("num_grad_quant_bins", 4, (), ()),
    ("quant_train_renew_leaf", False, (), ()),
    ("stochastic_rounding", True, (), ()),
    # --- dataset (config.h "Dataset Parameters") ---
    ("max_bin", 255, ("max_bins",), ((">", 1),)),
    ("max_bin_by_feature", [], (), ()),
    ("min_data_in_bin", 3, (), ((">", 0),)),
    ("bin_construct_sample_cnt", 200000, ("subsample_for_bin",), ((">", 0),)),
    ("data_random_seed", 1, ("data_seed",), ()),
    ("is_enable_sparse", True, ("is_sparse", "enable_sparse", "sparse"), ()),
    ("enable_bundle", True, ("is_enable_bundle", "bundle"), ()),
    ("use_missing", True, (), ()),
    ("zero_as_missing", False, (), ()),
    ("feature_pre_filter", True, (), ()),
    ("pre_partition", False, ("is_pre_partition",), ()),
    ("two_round", False, ("two_round_loading", "use_two_round_loading"), ()),
    ("header", False, ("has_header",), ()),
    ("label_column", "", ("label",), ()),
    ("weight_column", "", ("weight",), ()),
    ("group_column", "", ("group", "group_id", "query_column", "query", "query_id"), ()),
    ("ignore_column", "", ("ignore_feature", "blacklist"), ()),
    ("categorical_feature", "", ("cat_feature", "categorical_column", "cat_column",
                                 "categorical_features"), ()),
    ("forcedbins_filename", "", (), ()),
    ("ingest_chunk_rows", 100000, (), ((">", 0),)),               # out-of-core streaming construction (io/streaming.py): rows per chunk in both the sketch pass and the bin+pack pass; peak host memory scales with this, not with the row count
    ("ingest_memory_budget_mb", 0.0, (), ((">=", 0.0),)),         # out-of-core streaming construction: soft ceiling on the chunk working set in MB (0 = off); ingest_chunk_rows is clamped down so one raw+binned chunk fits the budget
    ("ingest_sketch_accuracy", 0.001, (), ((">", 0.0), ("<", 0.5))),  # out-of-core streaming construction: relative accuracy alpha of the mergeable log-bucket quantile sketch used when a feature overflows the exact distinct tally; bin boundaries then sit within alpha relative error of the in-memory ones
    ("ingest_workers", 0, (), ((">=", 0),)),                      # elastic sharded ingest (io/sharded.py; docs/SCALING.md "Sharded ingestion"): worker hosts sharding pass 1/pass 2 over a stripe-ownership ledger; 0 (default) = single-host io/streaming.py path, no ledger, no extra files; 1 = delegate to the single-host path (byte-identical artifacts); >=2 = multi-process workers with heartbeat death detection and work-stealing — output stays bit-identical to the single-host build regardless of worker deaths (reuses heartbeat_interval_s / heartbeat_timeout_s for liveness)
    ("ingest_stripe_batch", 1, (), ((">", 0),)),                  # elastic sharded ingest: contiguous stripes a worker claims per ledger sweep; larger batches amortize claim-file round-trips, smaller ones spread reassignable work more evenly after a host death
    ("save_binary", False, ("is_save_binary", "is_save_binary_file"), ()),
    ("precise_float_parser", False, (), ()),
    ("parser_config_file", "", (), ()),
    ("linear_tree", False, ("linear_trees",), ()),
    # --- predict ---
    ("start_iteration_predict", 0, (), ()),
    ("num_iteration_predict", -1, (), ()),
    ("predict_raw_score", False, ("is_predict_raw_score", "predict_rawscore",
                                  "raw_score"), ()),
    ("predict_leaf_index", False, ("is_predict_leaf_index", "leaf_index"), ()),
    ("predict_contrib", False, ("is_predict_contrib", "contrib"), ()),
    ("predict_disable_shape_check", False, (), ()),
    ("pred_early_stop", False, (), ()),
    ("pred_early_stop_freq", 10, (), ()),
    ("pred_early_stop_margin", 10.0, (), ()),
    # --- convert ---
    ("convert_model_language", "", (), ()),
    ("convert_model", "gbdt_prediction.cpp", ("convert_model_file",), ()),
    # --- objective (config.h "Objective Parameters") ---
    ("objective_seed", 5, (), ()),
    ("num_class", 1, ("num_classes",), ((">", 0),)),
    ("is_unbalance", False, ("unbalance", "unbalanced_sets"), ()),
    ("scale_pos_weight", 1.0, (), ((">", 0.0),)),
    ("sigmoid", 1.0, (), ((">", 0.0),)),
    ("boost_from_average", True, (), ()),
    ("reg_sqrt", False, (), ()),
    ("alpha", 0.9, (), ((">", 0.0),)),
    ("fair_c", 1.0, (), ((">", 0.0),)),
    ("poisson_max_delta_step", 0.7, (), ((">", 0.0),)),
    ("tweedie_variance_power", 1.5, (), ((">=", 1.0), ("<", 2.0))),
    ("lambdarank_truncation_level", 30, (), ((">", 0),)),
    ("lambdarank_norm", True, (), ()),
    ("label_gain", [], (), ()),
    ("lambdarank_position_bias_regularization", 0.0, (), ((">=", 0.0),)),
    ("rank_query_buckets", "auto", (), ()),  # query-length bucket ladder for the device lambdarank/xendcg kernels (objectives.py): "auto" derives power-of-two buckets from the training query-length distribution; an explicit list (e.g. "16,64,256") pins the ladder (extended to cover the longest query); each bucket geometry lowers ONE pairwise program through ops/compile_cache.py (rank_compile_hits/misses), so padded-pair compute is sum_b nq_b*T*Q_b instead of nq*T*Qmax; LGBMTPU_NO_RANK_BUCKETS=1 is the pad-to-max A/B hatch
    # --- metric ---
    ("metric", [], ("metrics", "metric_types"), ()),
    ("metric_freq", 1, ("output_freq",), ((">", 0),)),
    ("is_provide_training_metric", False, ("training_metric", "is_training_metric",
                                           "train_metric"), ()),
    ("eval_at", [1, 2, 3, 4, 5], ("ndcg_eval_at", "ndcg_at", "map_eval_at", "map_at"), ()),
    ("multi_error_top_k", 1, (), ((">", 0),)),
    ("auc_mu_weights", [], (), ()),
    # --- network (config.h:1086-1110); on TPU these describe the JAX mesh ---
    ("num_machines", 1, ("num_machine",), ((">", 0),)),
    ("local_listen_port", 12400, ("local_port", "port"), ()),
    ("time_out", 120, (), ((">", 0),)),
    ("machine_list_filename", "", ("machine_list_file", "machine_list", "mlist"), ()),
    ("machines", "", ("workers", "nodes"), ()),
    # --- device / TPU (replaces reference GPU params config.h:1113-1150) ---
    ("gpu_platform_id", -1, (), ()),
    ("gpu_device_id", -1, (), ()),
    ("gpu_use_dp", False, (), ()),
    ("num_gpu", 1, (), ((">", 0),)),
    ("tpu_hist_dtype", "float32", (), ()),       # hist product dtype; float32 = exact CPU/reference parity, bfloat16 = ~3x faster kernels, int8 = int8-MXU path (requires use_quantized_grad, ~1.6x bfloat16 kernel rate); AUTO POLICY: at >=100k rows and deterministic=false, an unset value engages int8 with exact quantized-grad levels (decision-identical; boosting/gbdt.py _resolve_auto_params); deterministic=true always forces float32
    ("tpu_debug_checks", False, (), ()),         # per-tree invariant checks (reference DEBUG CheckSplitValid)
    ("tpu_device_eval", True, (), ()),           # jitted device metric eval (l2/l1/rmse/logloss/error/auc/ndcg); host f64 when false or deterministic=true
    ("tpu_rows_per_block", 16384, (), ()),        # histogram kernel row tile
    ("tpu_leaf_hist", "masked", (), ()),          # per-leaf hist: masked|bucketed
    ("tpu_split_batch", 1, (), ((">", 0),)),      # splits per histogram pass; AUTO POLICY: unset at >=100k rows resolves to min(42, num_leaves-1)
    ("hist_kernel", "auto", (), ()),              # histogram build formulation: auto|onehot|packed|radix2 (ops/histogram.py HIST_KERNELS; all modes bit-identical — onehot = flat reference, packed = 4 bins per i32 lane SWAR compares, radix2 = shared hi/lo nibble planes reused across split-batch leaf channels)
    ("collective_overlap", "auto", (), ()),       # distributed histogram-reduction schedule: auto|on|off (ops/histogram.py reduce_hist; "on"/auto-under-data/voting splits each psum into two independent half-collectives — bit-identical sums — so XLA's latency-hiding scheduler can overlap wire time with local compute; LGBMTPU_NO_OVERLAP is the trace-time A/B hatch; data_gspmd ignores it, the partitioner owns its schedule)
    ("serving_buckets", [1, 8, 64, 512, 4096], (), ()),  # serving-tier row-count bucket ladder (lightgbm_tpu/serving/): requests are padded up to the smallest bucket >= n (oversize requests chunk by the largest), so every request re-enters an already-compiled program and XLA never lowers at steady state; sorted/deduped, all entries > 0
    ("predict_bucketing", "on", (), ()),          # batch Booster.predict shape-thrash fix: on|off (boosting/gbdt.py _device_predict_raw pads block tails up to a geometric ladder of tail-quantum multiples instead of the next exact multiple, bounding compiled program count at log2(block/quantum)+1 across ANY mix of row counts; bit-identical — padded rows are sliced off and the path-count matmuls are per-row exact; counters predict_bucketed_calls/predict_bucket_pad_rows)
    ("serving_telemetry_output", "", (), ()),     # serving per-request JSONL path (serving/server.py PredictionServer: one record per predict() with model/version, rows, buckets hit, pad rows, latency_s; "" disables)
    ("serving_max_inflight", 64, (), ((">", 0),)),  # serving-tier admission control: bound on concurrently served predict() requests (serving/server.py); a request arriving with the bound already in flight is rejected FAST (ServerOverloaded + serve_rejected_requests counter) instead of queueing unboundedly
    ("serving_replicas", 0, (), ((">=", 0),)),      # replicated serving fleet size (serving/fleet.py FleetServer): 0 (default) = OFF, single-process PredictionServer semantics with no extra processes or files; N >= 1 spawns N replica worker processes (each a full PredictionServer + warmed bucket ladder) behind a failover router
    ("serving_retry_budget", 2, (), ((">=", 0),)),  # fleet router failover bound: a request whose replica dies or misses its sub-deadline is transparently re-dispatched to a surviving replica at most this many times (request_failover journal events + fleet_request_failovers counter); 0 = no failover, first error surfaces
    ("fleet_heartbeat_interval_s", 0.5, (), ((">", 0.0),)),  # serving-replica liveness: seconds between a replica's heartbeat markers (same file substrate as training heartbeats, robustness/elastic.py; faster default than heartbeat_interval_s because serving replicas beat on wall time, not boosting rounds)
    ("fleet_heartbeat_timeout_s", 3.0, (), ((">", 0.0),)),   # serving-replica liveness: a replica silent past this is DEAD — evicted from the routing table, killed, respawned and re-warmed from the fleet manifest before it rejoins; staleness between ~2x fleet_heartbeat_interval_s and this marks it SUSPECT (deprioritized, not evicted)
    ("aot_store", "", (), ()),                      # disk-backed ahead-of-time executable store directory (ops/aot_store.py): serving predictors DESERIALIZE previously compiled bucket programs from it (zero XLA lowerings on warm) and persist fresh ones for later processes; "" = off for a standalone PredictionServer, while a FleetServer defaults its store to <workdir>/models/aot_store next to the fleet manifest and a ContinuousTrainer to <pipeline_workdir>/aot_store ("off" disables even those defaults); artifacts carry a backend/jax-version/device-topology fingerprint — stale or corrupt entries are evicted and rebuilt live, never loaded, and an unwritable path degrades to a warning (utils/paths.py probe)
    ("serving_autoscale", "off", (), ()),           # SLO-driven fleet elasticity: off|on (serving/fleet.py monitor): "on" lets watchtower breach/recover transitions on the serving SLOs (obs/slo.py serving_p99_ms / serving_error_rate over rollup windows) spawn replica slots up to serving_replicas_max under load and retire them back to serving_replicas_min after recovery — retirement drains the replica out of rotation first, so clients never see a failed request from a scale-down; enabling this without slo_config activates the serving SLOs at their default budgets
    ("serving_replicas_min", 0, (), ((">=", 0),)),  # autoscale floor on live replica slots (serving/fleet.py); 0 (default) = follow serving_replicas
    ("serving_replicas_max", 0, (), ((">=", 0),)),  # autoscale ceiling on live replica slots (serving/fleet.py); 0 (default) = follow serving_replicas; must be >= serving_replicas_min when both are explicit
]

# Reference-LightGBM parameters the package ACCEPTS but never reads: they
# exist so reference configs/sklearn kwargs parse cleanly, and their values
# change nothing on the execution path (the same list as lightgbm_tpu's,
# minus ``device_type``, which selects the torch device here).
_COMPAT_ONLY: Tuple[str, ...] = (
    "num_threads",
    "saved_feature_importance_type",
    "force_col_wise", "force_row_wise",
    "feature_contri",
    "is_enable_sparse", "feature_pre_filter", "two_round", "ignore_column",
    "precise_float_parser", "parser_config_file",
    "predict_disable_shape_check",
    "time_out",
    "gpu_platform_id", "gpu_device_id", "gpu_use_dp", "num_gpu",
)

_CANONICAL: Dict[str, Any] = {name: default for name, default, _, _ in _PARAMS}
_ALIASES: Dict[str, str] = {}
for _name, _default, _aliases, _checks in _PARAMS:
    _ALIASES[_name] = _name
    for _a in _aliases:
        _ALIASES[_a] = _name
_CHECKS: Dict[str, Tuple[Tuple[str, float], ...]] = {
    name: checks for name, _, _, checks in _PARAMS if checks
}

# objective aliases resolved inside the objective string itself
# (reference config.cpp ParseObjectiveAlias)
_OBJECTIVE_ALIASES = {
    "regression": "regression", "regression_l2": "regression", "l2": "regression",
    "mean_squared_error": "regression", "mse": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1",
    "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson", "quantile": "quantile",
    "mape": "mape", "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary", "binary_logloss": "binary",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda", "xentlambda": "cross_entropy_lambda",
    "lambdarank": "lambdarank", "rank_xendcg": "rank_xendcg",
    "xendcg": "rank_xendcg", "xe_ndcg": "rank_xendcg", "xe_ndcg_mart": "rank_xendcg",
    "xendcg_mart": "rank_xendcg",
    "none": "none", "null": "none", "custom": "none", "na": "none",
}

_METRIC_ALIASES = {
    "l1": "l1", "mean_absolute_error": "l1", "mae": "l1", "regression_l1": "l1",
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2", "regression": "l2",
    "regression_l2": "l2",
    "rmse": "rmse", "root_mean_squared_error": "rmse", "l2_root": "rmse",
    "quantile": "quantile", "huber": "huber", "fair": "fair", "poisson": "poisson",
    "mape": "mape", "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "gamma_deviance": "gamma_deviance", "tweedie": "tweedie",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "binary_error": "binary_error",
    "auc": "auc", "average_precision": "average_precision",
    "auc_mu": "auc_mu",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "softmax": "multi_logloss", "multiclassova": "multi_logloss",
    "multiclass_ova": "multi_logloss", "ova": "multi_logloss", "ovr": "multi_logloss",
    "multi_error": "multi_error",
    "ndcg": "ndcg", "lambdarank": "ndcg", "rank_xendcg": "ndcg", "xendcg": "ndcg",
    "xe_ndcg": "ndcg", "xe_ndcg_mart": "ndcg", "xendcg_mart": "ndcg",
    "map": "map", "mean_average_precision": "map",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda", "xentlambda": "cross_entropy_lambda",
    "kullback_leibler": "kullback_leibler", "kldiv": "kullback_leibler",
    "none": "none", "null": "none", "custom": "none", "na": "none",
}


def resolve_objective_alias(name: str) -> str:
    return _OBJECTIVE_ALIASES.get(str(name).strip().lower(), str(name))


def resolve_metric_alias(name: str) -> str:
    return _METRIC_ALIASES.get(str(name).strip().lower(), str(name))


def normalize_params(params: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Resolve aliases first-wins into canonical names (application.cpp:79)."""
    out: Dict[str, Any] = {}
    if not params:
        return out
    for k, v in params.items():
        canon = _ALIASES.get(str(k).strip().lower())
        if canon is None:
            log.warning(f"Unknown parameter: {k}")
            continue
        if canon in out:
            log.warning(f"{k} is set={v}, {canon}={out[canon]} will be used. "
                        f"Current value: {canon}={out[canon]}")
            continue
        out[canon] = v
    return out


def raw_param(params: Optional[Dict[str, Any]], name: str) -> Any:
    """The value of canonical ``name`` in ``params`` under any of its
    aliases, uncoerced (a list stays a list), first wins as in
    :func:`normalize_params`; None where it is not set."""
    for k, v in (params or {}).items():
        if _ALIASES.get(str(k).strip().lower()) == name:
            return v
    return None


class Config:
    """Flat runtime config; attribute access for every canonical parameter."""

    def __init__(self, params: Optional[Dict[str, Any]] = None, **kwargs: Any):
        self._explicit: Dict[str, Any] = {}
        for name, default in _CANONICAL.items():
            object.__setattr__(self, name, default() if callable(default) else
                               (list(default) if isinstance(default, list) else default))
        merged = dict(params or {})
        merged.update(kwargs)
        self.set(merged)

    def set(self, params: Dict[str, Any]) -> "Config":
        canon = normalize_params(params)
        for name, value in canon.items():
            setattr(self, name, self._coerce(name, value))
            self._explicit[name] = getattr(self, name)
        self._post_process()
        return self

    def is_explicit(self, name: str) -> bool:
        return name in self._explicit

    @staticmethod
    def _coerce(name: str, value: Any) -> Any:
        default = _CANONICAL[name]
        try:
            if name == "seed":
                return None if value is None else int(value)
            if name == "rank_query_buckets":
                # str default ("auto") but list values are legal — keep
                # them as int lists instead of stringifying
                if isinstance(value, str) and \
                        value.strip().lower() in ("", "auto"):
                    return "auto"
                return _parse_int_list(value)
            if isinstance(default, bool):
                v: Any = _parse_bool(value)
            elif isinstance(default, int):
                v = int(float(value)) if not isinstance(value, int) else value
            elif isinstance(default, float):
                v = float(value)
            elif isinstance(default, list):
                if default and isinstance(default[0], int) or name in (
                        "eval_at", "max_bin_by_feature", "monotone_constraints"):
                    v = _parse_int_list(value)
                elif name in ("label_gain", "feature_contri", "auc_mu_weights",
                              "cegb_penalty_feature_lazy", "cegb_penalty_feature_coupled"):
                    v = _parse_float_list(value)
                else:
                    v = _parse_str_list(value)
            else:
                v = str(value)
        except (TypeError, ValueError) as e:
            log.fatal(f"Failed to parse parameter {name}={value!r}: {e}")
        for op, bound in _CHECKS.get(name, ()):
            ok = {"<": v < bound, "<=": v <= bound, ">": v > bound, ">=": v >= bound}[op]
            if not ok:
                log.fatal(f"Check failed: {name} {op} {bound}, got {v}")
        return v

    def _post_process(self) -> None:
        # resolve objective-style aliases
        self.objective = resolve_objective_alias(self.objective)
        self.boosting ={"gbdt": "gbdt", "gbrt": "gbdt", "dart": "dart",
                         "rf": "rf", "random_forest": "rf",
                         "goss": "gbdt"}.get(str(self.boosting).lower(), self.boosting)
        # reference: `boosting=goss` is sugar for data_sample_strategy=goss
        if str(self._explicit.get("boosting", "")).lower() == "goss":
            self.data_sample_strategy = "goss"
        if isinstance(self.metric, str):
            self.metric = _parse_str_list(self.metric)
        self.metric = [resolve_metric_alias(m) for m in self.metric]
        self.check_param_conflict()
        log.set_verbosity(self.verbosity)

    def check_param_conflict(self) -> None:
        """Mirror of reference Config::CheckParamConflict (config.cpp)."""
        if self.is_explicit("bagging_freq") and self.bagging_freq > 0 and \
                self.bagging_fraction >= 1.0 and not self.is_explicit("bagging_fraction") \
                and self.data_sample_strategy != "goss":
            pass  # bagging_freq without fraction is a no-op; keep silently like ref
        if self.boosting == "rf":
            if self.bagging_freq <= 0 or self.bagging_fraction >= 1.0 or \
                    self.bagging_fraction <= 0.0:
                log.warning("RF requires bagging; setting bagging_fraction=0.9, "
                            "bagging_freq=1")
                if self.bagging_freq <= 0:
                    self.bagging_freq = 1
                if not (0.0 < self.bagging_fraction < 1.0):
                    self.bagging_fraction = 0.9
        if self.objective in ("multiclass", "multiclassova") and self.num_class <= 1:
            log.fatal("Number of classes should be specified and greater than 1 "
                      "for multiclass training")
        if self.objective not in ("multiclass", "multiclassova", "none") and \
                self.num_class != 1:
            log.fatal("Number of classes must be 1 for non-multiclass training")
        if self.objective in ("lambdarank", "rank_xendcg") and \
                self.lambdarank_truncation_level <= 0:
            log.fatal("lambdarank_truncation_level must be positive")
        self.nan_policy = str(self.nan_policy or "none").strip().lower()
        if self.nan_policy not in ("none", "raise", "skip_round",
                                   "halt_and_keep_best"):
            log.fatal(f"unknown nan_policy={self.nan_policy!r} (expected "
                      "none/raise/skip_round/halt_and_keep_best)")
        self.predict_bucketing = str(self.predict_bucketing or "on") \
            .strip().lower()
        if self.predict_bucketing not in ("on", "off"):
            log.fatal(f"unknown predict_bucketing={self.predict_bucketing!r} "
                      "(expected on/off)")
        self.elastic = str(self.elastic or "off").strip().lower()
        if self.elastic not in ("on", "off"):
            log.fatal(f"unknown elastic={self.elastic!r} (expected on/off)")
        self.anomaly_detection = \
            str(self.anomaly_detection or "off").strip().lower()
        if self.anomaly_detection not in ("on", "off"):
            log.fatal(f"unknown anomaly_detection="
                      f"{self.anomaly_detection!r} (expected on/off)")
        # the observability tier (obs/) is not ported: its keys parse, and a
        # request to turn it on fails loudly instead of doing nothing
        if str(self.slo_config or "").strip():
            log.fatal("slo_config is not supported by lightgbm_tpu_torch "
                      "yet (the obs/ tier is not ported)")
        self.request_trace = \
            str(self.request_trace or "off").strip().lower()
        if self.request_trace != "off":
            log.fatal("request_trace is not supported by lightgbm_tpu_torch "
                      "yet (the serving tier is not ported)")
        if float(self.heartbeat_timeout_s) < float(self.heartbeat_interval_s):
            log.fatal(
                f"heartbeat_timeout_s={self.heartbeat_timeout_s} must be >= "
                f"heartbeat_interval_s={self.heartbeat_interval_s} (a worker "
                "cannot be declared dead faster than it is expected to "
                "publish)")
        if float(self.fleet_heartbeat_timeout_s) < \
                float(self.fleet_heartbeat_interval_s):
            log.fatal(
                f"fleet_heartbeat_timeout_s={self.fleet_heartbeat_timeout_s} "
                f"must be >= fleet_heartbeat_interval_s="
                f"{self.fleet_heartbeat_interval_s} (a replica cannot be "
                "declared dead faster than it is expected to beat)")
        self.serving_autoscale = \
            str(self.serving_autoscale or "off").strip().lower()
        if self.serving_autoscale not in ("on", "off"):
            log.fatal(f"unknown serving_autoscale="
                      f"{self.serving_autoscale!r} (expected on/off)")
        if int(self.serving_replicas_min) > 0 and \
                int(self.serving_replicas_max) > 0 and \
                int(self.serving_replicas_min) > \
                int(self.serving_replicas_max):
            log.fatal(
                f"serving_replicas_min={self.serving_replicas_min} must "
                f"be <= serving_replicas_max="
                f"{self.serving_replicas_max} (the autoscale floor "
                "cannot exceed the ceiling)")
        if not self.serving_buckets or \
                any(int(b) <= 0 for b in self.serving_buckets):
            log.fatal(f"serving_buckets must be a non-empty list of positive "
                      f"row counts, got {self.serving_buckets!r}")
        self.serving_buckets = sorted({int(b) for b in self.serving_buckets})
        rqb = self.rank_query_buckets
        if isinstance(rqb, str):
            rqb = rqb.strip().lower() or "auto"
            if rqb != "auto":
                try:
                    rqb = _parse_int_list(rqb)
                except (TypeError, ValueError):
                    log.fatal(f"unknown rank_query_buckets="
                              f"{self.rank_query_buckets!r} (expected "
                              "\"auto\" or a list of positive doc counts)")
        if isinstance(rqb, (list, tuple)):
            if not rqb or any(int(b) <= 0 for b in rqb):
                log.fatal(f"rank_query_buckets must be \"auto\" or a "
                          f"non-empty list of positive doc counts, got "
                          f"{self.rank_query_buckets!r}")
            rqb = sorted({int(b) for b in rqb})
        self.rank_query_buckets = rqb
        # max_depth implies a num_leaves cap when num_leaves not explicit
        if self.max_depth > 0 and not self.is_explicit("num_leaves"):
            full = 1 << min(self.max_depth, 30)
            self.num_leaves = min(self.num_leaves, full)

    def to_dict(self) -> Dict[str, Any]:
        return {name: getattr(self, name) for name in _CANONICAL}

    def __repr__(self) -> str:
        keys = sorted(self._explicit)
        inner = ", ".join(f"{k}={getattr(self, k)!r}" for k in keys)
        return f"Config({inner})"


ParamsLike = Union[Dict[str, Any], Config, None]


def as_config(params: ParamsLike) -> Config:
    if isinstance(params, Config):
        return params
    return Config(params or {})
