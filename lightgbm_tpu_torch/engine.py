"""Training entry points: ``train()`` and ``cv()``.

Counterpart of ``lightgbm_tpu/engine.py`` ``train`` / ``_run_training`` /
``cv`` / ``CVBooster`` (reference python-package/lightgbm/engine.py:109,
354, 611): construct the datasets, build the booster (continuing from
``init_model`` when given), then run the boosting rounds.  Where every
callback is ``fused_safe`` (none at all, or only ``log_evaluation`` /
``record_evaluation`` / ``early_stopping``, which read the evaluation list),
no custom objective or metric is given and ``GBDT.supports_fused`` admits
the configuration, the rounds run as the fused loop (``GBDT.train_fused``:
one CUDA graph replay a round on the card, the callbacks driven once a
round with the metrics evaluated on the device); otherwise the classic loop
runs the ``before_iteration`` callbacks (``reset_parameter``), updates
(with ``fobj``'s gradients), evaluates (with ``feval``'s metrics) and calls
back once a round.  Both set ``best_iteration`` and ``best_score`` as the
JAX package does; ``nan_policy=halt_and_keep_best`` ends the classic loop
with every completed round kept.

``cv`` trains one booster a fold on subsets of one binned Dataset
(``Dataset.subset``: the mappers shared, nothing binned again) and returns
the mean and standard deviation of each evaluation a round.  Each fold's
captured rounds are released when its training ends, and its booster too
unless ``return_cvbooster`` keeps it, so device memory does not grow with
the folds.

Not ported yet: checkpoints (``resume=``, ``final_checkpoint=``,
``checkpoint_dir``), the telemetry file and the observability session of
the JAX package's ``obs/``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from .basic import Booster, Dataset
from .callback import CallbackEnv, EarlyStopException, record_evaluation
from .config import normalize_params
from .robustness.guards import NumericHalt
from .utils import log


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[Sequence[Dataset]] = None,
          valid_names: Optional[Sequence[str]] = None,
          feval: Optional[Union[Callable, List[Callable]]] = None,
          init_model: Optional[Union[str, Booster]] = None,
          keep_training_booster: bool = False,
          callbacks: Optional[List[Callable]] = None,
          fobj: Optional[Callable] = None,
          resume: Optional[str] = None,
          final_checkpoint: bool = False) -> Booster:
    """Train a booster (reference engine.py:109).  Runs on the CUDA device
    unless ``device_type=cpu`` is given; without a card that raises.

    ``fobj(preds, train_set) -> (grad, hess)`` trains custom gradients
    (``objective=none``); ``feval(preds, data) -> (name, value,
    bigger_is_better)`` (or a list of them) adds metrics to every round's
    evaluation.  ``init_model`` (a Booster or a model file) continues
    training: its raw predictions become the datasets' init scores and its
    trees lead the new booster's.  ``keep_training_booster`` is accepted
    for the reference's signature; the returned booster always keeps its
    training state, as in the JAX package.  ``resume`` and
    ``final_checkpoint`` belong to checkpointing, not ported yet."""
    if resume is not None or final_checkpoint:
        log.fatal("resume= and final_checkpoint= (checkpoints) are not "
                  "supported by lightgbm_tpu_torch yet")
    params = normalize_params(params)
    if params.get("checkpoint_dir"):
        log.fatal("checkpoint_dir (checkpoints) is not supported by "
                  "lightgbm_tpu_torch yet")
    if "num_iterations" in params:
        num_boost_round = params["num_iterations"]
    params["num_iterations"] = num_boost_round
    if fobj is not None:
        params["objective"] = "none"
    if init_model is not None:
        # continued training (reference engine.py:233-244)
        predictor = init_model if isinstance(init_model, Booster) \
            else Booster(model_file=str(init_model))
        train_set._apply_predictor(predictor)
    booster = Booster(params=params, train_set=train_set)

    names = list(valid_names or [])
    train_in_valid = False
    valid_pairs = []   # (name, Dataset) of the valid sets other than train
    for i, vs in enumerate(valid_sets or []):
        name = names[i] if i < len(names) else f"valid_{i}"
        if vs is train_set:
            train_in_valid = True
            continue
        booster.add_valid(vs, name)
        valid_pairs.append((name, vs))

    callbacks = sorted(callbacks or [], key=lambda cb: getattr(cb, "order",
                                                               0))
    return _run_training(booster, params, train_set, num_boost_round,
                         valid_pairs, train_in_valid, feval, fobj, callbacks)


def _run_training(booster: Booster, params, train_set: Dataset,
                  num_boost_round: int, valid_pairs, train_in_valid: bool,
                  feval, fobj, callbacks: List[Callable]) -> Booster:
    """The boosting rounds of ``train()``: the fused loop where it may run
    (the JAX package's gate), the classic loop otherwise."""
    gbdt = booster._gbdt
    cbs_before = [cb for cb in callbacks
                  if getattr(cb, "before_iteration", False)]
    cbs_after = [cb for cb in callbacks
                 if not getattr(cb, "before_iteration", False)]
    fused_safe = all(getattr(cb, "fused_safe", False) for cb in callbacks) \
        and not cbs_before
    if (fused_safe and not train_in_valid and num_boost_round > 0
            and feval is None and fobj is None
            and not gbdt.config.is_provide_training_metric
            and (not valid_pairs or callbacks)
            and gbdt.supports_fused()):
        es_params = next((cb.es_params for cb in callbacks
                          if getattr(cb, "es_params", None)), None)

        def cb_driver(it, evals):
            for cb in cbs_after:
                cb(CallbackEnv(booster, params, it, 0, num_boost_round,
                               evals))
        try:
            finished = gbdt.train_fused(
                num_boost_round, cb_driver=cb_driver if callbacks else None,
                es_params=es_params)
        except EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            _set_best_score(booster, e.best_score)
            return booster
        if finished:
            log.warning("Stopped training because there are no more "
                        "leaves that meet the split requirements")
        if booster.best_iteration <= 0:
            _set_best_score(booster, gbdt._last_fused_evals)
        return booster

    evals: List = []
    for it in range(num_boost_round):
        for cb in cbs_before:
            cb(CallbackEnv(booster, params, it, 0, num_boost_round, None))
        try:
            finished = booster.update(fobj=fobj)
        except NumericHalt:
            # nan_policy=halt_and_keep_best: keep every completed round
            # (guards.py warned with the round)
            booster.best_iteration = it
            _set_best_score(booster, evals)
            break
        evals = []
        if train_in_valid or gbdt.config.is_provide_training_metric:
            evals.extend(booster.eval_train())
        evals.extend(booster.eval_valid())
        if feval is not None:
            evals.extend(_eval_custom(feval, booster, train_set, valid_pairs,
                                      train_in_valid))
        try:
            for cb in cbs_after:
                cb(CallbackEnv(booster, params, it, 0, num_boost_round,
                               evals))
        except EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            _set_best_score(booster, e.best_score)
            break
        if finished:
            log.warning("Stopped training because there are no more "
                        "leaves that meet the split requirements")
            break
    if booster.best_iteration <= 0:
        # unset without early stopping: predict() and save_model() then
        # use every tree
        _set_best_score(booster, evals)
    return booster


def _eval_custom(feval, booster: Booster, train_set: Dataset, valid_pairs,
                 train_in_valid: bool) -> List[tuple]:
    """Each ``feval``'s (set, name, value, bigger) on the training set (when
    it is a valid set) and every valid set, from the raw scores on the
    host (the JAX package's ``_eval_custom``)."""
    out = []
    gb = booster._gbdt
    for f in feval if isinstance(feval, (list, tuple)) else [feval]:
        if train_in_valid:
            out.append(("training",) + tuple(
                f(gb._host_scores(gb.scores), train_set)))
        for vi, (name, vs) in enumerate(valid_pairs):
            out.append((name,) + tuple(
                f(gb._host_scores(gb.valid_scores[vi]), vs)))
    return out


def _set_best_score(booster: Booster, evals) -> None:
    booster.best_score = {}
    for item in evals or []:
        booster.best_score.setdefault(item[0], {})[item[1]] = item[2]


class CVBooster:
    """The boosters of ``cv``'s folds (reference engine.py:354): a method
    call runs on every booster and returns the list of their results."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name: str):
        def handler(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler


def _make_folds(inner, params, nfold: int, stratified: bool, shuffle: bool,
                seed: int):
    """(folds, fold_groups) of the JAX package's ``cv``: whole queries for
    ranking data (and each fold's query sizes), class-stratified folds for
    binary and multiclass objectives, plain folds otherwise; shuffled with
    ``np.random.default_rng(seed)``, so the folds are the JAX package's."""
    n = inner.num_data
    label = np.asarray(inner.metadata.label)
    rng = np.random.default_rng(seed)
    qb = inner.metadata.query_boundaries
    idx = np.arange(n)
    if qb is not None:
        nq = len(qb) - 1
        qidx = np.arange(nq)
        if shuffle:
            rng.shuffle(qidx)
        folds, fold_groups = [], []
        for part in np.array_split(qidx, nfold):
            test_q = np.sort(part)
            train_q = np.setdiff1d(qidx, part)

            def rows(qs):
                return np.concatenate([np.arange(qb[q], qb[q + 1])
                                       for q in qs]) \
                    if len(qs) else np.array([], int)
            folds.append((rows(train_q), rows(test_q)))
            fold_groups.append((np.diff(qb)[train_q], np.diff(qb)[test_q]))
        return folds, fold_groups
    if stratified and params.get("objective") in (
            "binary", "multiclass", "multiclassova"):
        folds_idx = [[] for _ in range(nfold)]
        for cls in np.unique(label):
            cls_idx = idx[label == cls]
            if shuffle:
                rng.shuffle(cls_idx)
            for i, part in enumerate(np.array_split(cls_idx, nfold)):
                folds_idx[i].extend(part)
        return [(np.setdiff1d(idx, np.asarray(f)), np.asarray(sorted(f)))
                for f in folds_idx], None
    if shuffle:
        rng.shuffle(idx)
    return [(np.setdiff1d(np.arange(n), p), np.sort(p))
            for p in np.array_split(idx, nfold)], None


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, feval=None, seed: int = 0,
       callbacks: Optional[List[Callable]] = None,
       eval_train_metric: bool = False,
       return_cvbooster: bool = False) -> Dict[str, Any]:
    """K-fold cross-validation (reference engine.py:611; the JAX package's
    ``cv``): ``{"valid <metric>-mean": [...], "valid <metric>-stdv": [...]}``
    a round (``train ...`` too with ``eval_train_metric``), cut at the best
    mean round when any fold stopped early; ``"cvbooster"`` with
    ``return_cvbooster``.  ``folds``: (train_idx, test_idx) pairs, or made
    as the JAX package makes them (:func:`_make_folds`)."""
    params = normalize_params(params)
    if params.get("checkpoint_dir"):
        # a checkpointed run is one training, not one a fold
        log.warning("checkpoint_dir is not supported inside cv(); "
                    "checkpointing disabled for the fold trainings")
        params = {k: v for k, v in params.items() if k != "checkpoint_dir"}
    if metrics is not None:
        params["metric"] = metrics
    # parameters of the binning must reach the shared binning pass
    if train_set._inner is None:
        train_set.params = {**train_set.params, **params}
    else:
        stale = [k for k in ("max_bin", "linear_tree", "enable_bundle",
                             "max_bin_by_feature", "min_data_in_bin")
                 if k in params
                 and params[k] != train_set.params.get(k, params[k])]
        if stale:
            log.warning(f"cv params {stale} ignored: the Dataset is "
                        "already constructed with its own binning")
    train_set.construct()
    inner = train_set.inner
    fold_groups = None
    if folds is None:
        folds, fold_groups = _make_folds(inner, params, nfold, stratified,
                                         shuffle, seed)

    cvb = CVBooster()
    histories = []
    higher_better = None
    for fi, (train_idx, test_idx) in enumerate(folds):
        dtrain = Dataset.from_inner(inner.subset(train_idx),
                                    dict(train_set.params))
        dtest = Dataset.from_inner(inner.subset(test_idx),
                                   dict(train_set.params))
        if fold_groups is not None:
            gtr, gte = fold_groups[fi]
            dtrain.inner.metadata.set_group(gtr)
            dtest.inner.metadata.set_group(gte)
        rec: Dict[str, Dict[str, List[float]]] = {}
        vs, vn = [dtest], ["valid"]
        if eval_train_metric:
            vs.append(dtrain)
            vn.append("train")
        bst = train(params, dtrain, num_boost_round, valid_sets=vs,
                    valid_names=vn, feval=feval,
                    callbacks=list(callbacks or []) + [record_evaluation(rec)])
        histories.append(rec)
        if higher_better is None:
            ev0 = bst.eval_valid()
            higher_better = bool(ev0[0][3]) if ev0 else False
        # the fold's captured rounds (their graph pool) go now; the booster
        # too unless the caller keeps the fold boosters
        bst._gbdt._fused_cache.clear()
        if return_cvbooster:
            cvb.append(bst)
        del bst, dtrain, dtest

    # each round's mean and standard deviation over the folds (reference
    # engine.py _agg_cv_result); folds stopped early cut every curve to
    # the shortest history
    out: Dict[str, Any] = {}
    first_valid_key = None
    for set_name in histories[0]:
        # train() names the training set "training"; cv's keys say "train"
        public = "train" if set_name == "training" else set_name
        for metric in histories[0][set_name]:
            rows = [h[set_name][metric] for h in histories]
            it = min(len(r) for r in rows)
            arr = np.asarray([r[:it] for r in rows])
            out[f"{public} {metric}-mean"] = [float(v)
                                             for v in arr.mean(axis=0)]
            out[f"{public} {metric}-stdv"] = [float(v)
                                             for v in arr.std(axis=0)]
            if public == "valid" and first_valid_key is None:
                first_valid_key = f"valid {metric}-mean"
    # a fold stopped early: cut to the best round of the mean curve (the
    # effective round count, params may set it)
    nbr_eff = int(params.get("num_iterations", num_boost_round))
    stopped = any(
        min((len(r) for r in h.get("valid", {}).values()),
            default=nbr_eff) < nbr_eff
        for h in histories)
    if first_valid_key and stopped:
        curve = np.asarray(out[first_valid_key])
        best_idx = int(np.argmax(curve) if higher_better
                       else np.argmin(curve))
        for key in list(out):
            out[key] = out[key][:best_idx + 1]
        cvb.best_iteration = best_idx + 1
    if return_cvbooster:
        out["cvbooster"] = cvb
    return out
