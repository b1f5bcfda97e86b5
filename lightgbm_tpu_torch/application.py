"""Command-line application.

Counterpart of ``lightgbm_tpu/application.py`` (reference:
src/application/application.cpp:31 ``Application``, src/main.cpp), run as

    python -m lightgbm_tpu_torch config=train.conf [key=value ...]

Tasks (application.cpp:209-287 dispatch): ``train`` (the default, with
``valid``, ``is_provide_training_metric``, ``early_stopping_round``,
``snapshot_freq`` and ``input_model``), ``predict``, ``convert_model`` and
``refit``.  Config files are ``key = value`` lines with ``#`` comments;
command-line pairs override file pairs.  As in the JAX package, every
parameter reaches ``train()`` explicitly (``Config.to_dict()``), so the
auto speed policy, which yields to explicit settings, does not apply.

The device is resolved first, whatever the task: without a card every
task raises ``LightGBMError`` (``python -m`` exits 1) unless
``device_type=cpu``.  ``checkpoint_dir`` raises, as in ``train()``; with
``verbosity >= 2`` a training run logs the booster's telemetry counters
(the JAX package's phase timers and memory sampler are not ported).
"""

from __future__ import annotations

import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from . import callback as cb
from .basic import Booster, Dataset
from .config import Config, normalize_params
from .engine import train as train_api
from .io.parser import load_text_file
from .utils import log
from .utils.device import resolve_device


def parse_config_file(path: str) -> Dict[str, str]:
    """Read a reference-style .conf file into a key->value dict."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def parse_argv(argv: List[str]) -> Dict[str, Any]:
    """argv ``key=value`` pairs (+ optional config=file) → raw params.

    Command-line pairs take precedence over config-file pairs
    (application.cpp: cmdline first, then config file keys not yet seen).
    """
    cmdline: Dict[str, str] = {}
    for tok in argv:
        if "=" not in tok:
            log.warning(f"Unknown argument (ignored): {tok}")
            continue
        k, v = tok.split("=", 1)
        cmdline[k.strip()] = v.strip()
    params: Dict[str, Any] = dict(cmdline)
    conf = cmdline.get("config", cmdline.get("config_file"))
    if conf:
        for k, v in parse_config_file(conf).items():
            params.setdefault(k, v)
    params.pop("config", None)
    params.pop("config_file", None)
    return params


def _load_dataset(cfg: Config, params: Dict[str, Any]) -> Dataset:
    """The training file as a Dataset, constructed here unless an
    ``input_model`` continues training: then ``train()`` sets its predictor
    first, so the init scores come from the parsed rows (the JAX package's
    CLI constructs first and its continuation then finds no raw data)."""
    if not cfg.data:
        log.fatal("No training data specified (data=...)")
    ds = Dataset(cfg.data, params=params)
    if not cfg.input_model:
        ds.construct()
    return ds


def _run_train(cfg: Config, params: Dict[str, Any]) -> None:
    train_set = _load_dataset(cfg, params)
    valid_sets = []
    valid_names = []
    valids = cfg.valid if isinstance(cfg.valid, list) else [cfg.valid]
    for i, vf in enumerate(valids):
        if not vf:
            continue
        valid_sets.append(train_set.create_valid(vf))
        valid_names.append(os.path.basename(str(vf)) or f"valid_{i}")
    if bool(cfg.is_provide_training_metric):
        valid_sets.insert(0, train_set)
        valid_names.insert(0, "training")

    callbacks = [cb.log_evaluation(period=int(cfg.metric_freq))]
    if int(cfg.early_stopping_round) > 0:
        callbacks.append(cb.early_stopping(
            int(cfg.early_stopping_round),
            min_delta=float(cfg.early_stopping_min_delta)))
    snapshot = int(cfg.snapshot_freq)
    if snapshot > 0:
        out = cfg.output_model

        def _snapshot(env):
            it = env.iteration + 1
            if it % snapshot == 0:
                env.model.save_model(f"{out}.snapshot_iter_{it}")
        callbacks.append(_snapshot)

    init_model = cfg.input_model or None
    booster = train_api(params, train_set,
                        num_boost_round=int(cfg.num_iterations),
                        valid_sets=valid_sets, valid_names=valid_names,
                        init_model=init_model, callbacks=callbacks)
    booster.save_model(cfg.output_model)
    log.info(f"Finished training; model saved to {cfg.output_model}")
    if int(cfg.verbosity) >= 2:
        tel = booster.telemetry()
        if tel.get("counters"):
            log.info("telemetry counters: " + ", ".join(
                f"{k}={v:g}" for k, v in sorted(tel["counters"].items())))


def _run_predict(cfg: Config, params: Dict[str, Any]) -> None:
    if not cfg.input_model:
        log.fatal("task=predict requires input_model=...")
    if not cfg.data:
        log.fatal("task=predict requires data=...")
    booster = Booster(model_file=cfg.input_model)
    arr, _, _ = load_text_file(str(cfg.data), cfg)
    preds = booster.predict(
        arr,
        start_iteration=int(cfg.start_iteration_predict),
        num_iteration=(None if int(cfg.num_iteration_predict) < 0
                       else int(cfg.num_iteration_predict)),
        raw_score=bool(cfg.predict_raw_score),
        pred_leaf=bool(cfg.predict_leaf_index),
        pred_contrib=bool(cfg.predict_contrib),
    )
    preds = np.asarray(preds)
    with open(cfg.output_result, "w") as f:
        if preds.ndim == 1:
            for v in preds:
                f.write(f"{v:.18g}\n")
        else:
            for row in preds:
                f.write("\t".join(f"{v:.18g}" for v in row) + "\n")
    log.info(f"Finished prediction; results saved to {cfg.output_result}")


def _run_convert_model(cfg: Config, params: Dict[str, Any]) -> None:
    if not cfg.input_model:
        log.fatal("task=convert_model requires input_model=...")
    lang = cfg.convert_model_language or "cpp"
    if lang not in ("cpp", "c++"):
        log.fatal(f"convert_model_language={lang} is not supported (cpp only)")
    from .models.model_io import model_to_cpp
    booster = Booster(model_file=cfg.input_model)
    code = model_to_cpp(booster._get_trees(),
                        num_tree_per_iteration=booster.num_model_per_iteration())
    with open(cfg.convert_model, "w") as f:
        f.write(code)
    log.info(f"Finished converting model; code saved to {cfg.convert_model}")


def _run_refit(cfg: Config, params: Dict[str, Any]) -> None:
    if not cfg.input_model:
        log.fatal("task=refit requires input_model=...")
    if not cfg.data:
        log.fatal("task=refit requires data=...")
    booster = Booster(model_file=cfg.input_model, params=params)
    arr, label, _ = load_text_file(str(cfg.data), cfg)
    if label is None:
        log.fatal("refit data has no label column")
    refit_booster = booster.refit(arr, label,
                                  decay_rate=float(cfg.refit_decay_rate))
    refit_booster.save_model(cfg.output_model)
    log.info(f"Finished refit; model saved to {cfg.output_model}")


def main(argv: Optional[List[str]] = None) -> None:
    if argv is None:
        argv = sys.argv[1:]
    raw = parse_argv(argv)
    cfg = Config(normalize_params(raw))
    # typed canonical params (CLI values arrive as strings; Config coerces)
    params = cfg.to_dict()
    resolve_device(cfg.device_type)
    task = str(cfg.task)
    if task == "train":
        _run_train(cfg, params)
    elif task in ("predict", "prediction", "test"):
        _run_predict(cfg, params)
    elif task == "convert_model":
        _run_convert_model(cfg, params)
    elif task == "refit":
        _run_refit(cfg, params)
    else:
        log.fatal(f"Unknown task: {task}")


if __name__ == "__main__":  # pragma: no cover
    main()
