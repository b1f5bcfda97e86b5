"""The port's CLI (``python -m lightgbm_tpu_torch``, application.py)
against lightgbm_tpu.application.main on the same ``.conf`` and CSV files
written to ``tmp_path``: train (with a valid set, the training metric,
early stopping, snapshots and ``input_model``), predict, convert_model and
refit give equal files.  The configuration is the batched int8 learner on
a regression target (its text equals the JAX package's byte for byte);
both CLIs pass every parameter explicitly."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from lightgbm_tpu import application as JA

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch import application as TA

from test_torch_fused import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

CONF = """\
# the batched int8 learner
task = train
objective = regression
num_leaves = 15
max_bin = 63
min_data_in_leaf = 5
tpu_split_batch = 4
use_quantized_grad = true
tpu_hist_dtype = int8
quant_train_renew_leaf = true
stochastic_rounding = false
hist_kernel = onehot
metric = l2
verbosity = -1
device_type = cpu
"""


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    X = rng.normal(size=(1500, 5))
    X[rng.random((1500, 5)) < 0.05] = np.nan
    y = np.nan_to_num(X[:, 0]) - 0.5 * np.nan_to_num(X[:, 2]) + \
        0.1 * rng.normal(size=1500)
    for name, rows in (("train.csv", slice(0, 1200)),
                       ("test.csv", slice(1200, None))):
        M = np.column_stack([y[rows], X[rows]])
        np.savetxt(d / name, M, fmt="%.17g", delimiter=",")
    (d / "train.conf").write_text(CONF)
    return d


def _run_both(d, args):
    """Run both CLIs with ``args``, ``{out}`` the same output prefix for
    both (the model text's parameters name it), each side's files then
    renamed to its own prefix; return the two prefixes."""
    outs = []
    for side, main in (("jax", JA.main), ("torch", TA.main)):
        main([a.replace("{out}", str(d / "out")) for a in args])
        for f in d.glob("out.*"):
            f.rename(d / (side + f.name[len("out"):]))
        outs.append(d / side)
    return outs


def _same_file(a, b):
    assert Path(a).read_text() == Path(b).read_text()


def test_parse_config_file_and_argv(files, tmp_path):
    conf = TA.parse_config_file(str(files / "train.conf"))
    assert conf == JA.parse_config_file(str(files / "train.conf"))
    assert conf["objective"] == "regression" and conf["task"] == "train"
    p = tmp_path / "a.conf"
    p.write_text("num_leaves = 63\nlearning_rate = 0.3  # comment\n")
    argv = [f"config={p}", "num_leaves=7", "stray"]
    params = TA.parse_argv(argv)
    assert params == JA.parse_argv(argv)
    assert params["num_leaves"] == "7" and params["learning_rate"] == "0.3"


def test_train_predict_convert_refit_match_jax(files):
    d = files
    conf = f"config={d / 'train.conf'}"
    mj, mt = _run_both(d, [conf, f"data={d / 'train.csv'}",
                           f"valid={d / 'test.csv'}", "num_trees=6",
                           "output_model={out}.model.txt"])
    _same_file(f"{mj}.model.txt", f"{mt}.model.txt")
    text = Path(f"{mt}.model.txt").read_text()
    # the Python API on the same file and the same (all explicit) params
    cfg = lgb.Config(lgb.config.normalize_params(TA.parse_argv(
        [conf, f"data={d / 'train.csv'}", "num_trees=6"])))
    ds = lgb.Dataset(str(d / "train.csv"), params=cfg.to_dict())
    api = lgb.train(cfg.to_dict(), ds, 6)
    assert api.model_to_string().split("parameters:")[0] == \
        text.split("parameters:")[0]
    # predict (raw and converted), convert_model, refit
    for extra in ([], ["predict_raw_score=true"], ["predict_leaf_index=true"]):
        pj, pt = _run_both(d, ["task=predict", f"data={d / 'test.csv'}",
                               f"input_model={mt}.model.txt",
                               "output_result={out}.pred.txt",
                               "device_type=cpu"] + extra)
        _same_file(f"{pj}.pred.txt", f"{pt}.pred.txt")
    preds = np.loadtxt(f"{mt}.pred.txt")
    te = np.loadtxt(d / "test.csv", delimiter=",")
    assert preds.shape[0] == te.shape[0]
    np.testing.assert_array_equal(
        preds, lgb.Booster(model_file=f"{mt}.model.txt").predict(
            te[:, 1:], pred_leaf=True))
    cj, ct = _run_both(d, ["task=convert_model",
                           f"input_model={mt}.model.txt",
                           "convert_model={out}.cpp", "device_type=cpu"])
    _same_file(f"{cj}.cpp", f"{ct}.cpp")
    code = Path(f"{ct}.cpp").read_text()
    assert "PredictTree0" in code and "void Predict(" in code
    rj, rt = _run_both(d, [conf, "task=refit", f"input_model={mt}.model.txt",
                           f"data={d / 'train.csv'}",
                           "output_model={out}.refit.txt"])
    _same_file(f"{rj}.refit.txt", f"{rt}.refit.txt")
    assert lgb.Booster(model_file=f"{rt}.refit.txt").num_trees() == 6


def test_train_options_match_jax(files):
    """is_provide_training_metric, early_stopping_round, snapshot_freq and
    input_model (continued training)."""
    d = files
    conf = f"config={d / 'train.conf'}"
    base = [conf, f"data={d / 'train.csv'}", f"valid={d / 'test.csv'}"]
    mj, mt = _run_both(d, base + ["num_trees=4", "snapshot_freq=2",
                                  "is_provide_training_metric=true",
                                  "output_model={out}.snap.txt"])
    _same_file(f"{mj}.snap.txt", f"{mt}.snap.txt")
    for it in (2, 4):
        _same_file(f"{mj}.snap.txt.snapshot_iter_{it}",
                   f"{mt}.snap.txt.snapshot_iter_{it}")
    ej, et = _run_both(d, base + ["num_trees=40", "learning_rate=0.9",
                                  "early_stopping_round=2",
                                  "output_model={out}.es.txt"])
    _same_file(f"{ej}.es.txt", f"{et}.es.txt")
    assert lgb.Booster(model_file=f"{et}.es.txt").num_trees() < 40
    # input_model: the JAX package's CLI constructs the training file
    # before the continuation and then finds no raw rows; the port's sets
    # the predictor first, and equals the Python API's continued training
    cont = base + ["num_trees=2", f"input_model={mt}.snap.txt",
                   f"output_model={d / 'cont.txt'}"]
    with pytest.raises(Exception, match="raw data"):
        JA.main(cont)
    TA.main(cont)
    text = (d / "cont.txt").read_text()
    assert lgb.Booster(model_str=text).num_trees() == 6
    cfg = lgb.Config(lgb.config.normalize_params(TA.parse_argv(cont)))
    ds = lgb.Dataset(str(d / "train.csv"), params=cfg.to_dict())
    api = lgb.train(cfg.to_dict(), ds, 2, init_model=f"{mt}.snap.txt",
                    valid_sets=[ds.create_valid(str(d / "test.csv"))])
    assert api.model_to_string().split("parameters:")[0] == \
        text.split("parameters:")[0]


def test_cli_refusals(files, monkeypatch, tmp_path):
    d = files
    with pytest.raises(lgb.LightGBMError):
        TA.main(["task=predict", f"data={d / 'test.csv'}",
                 "device_type=cpu"])
    with pytest.raises(lgb.LightGBMError):
        TA.main(["task=nonsense", "device_type=cpu"])
    with pytest.raises(lgb.LightGBMError, match="checkpoint"):
        TA.main([f"config={d / 'train.conf'}", f"data={d / 'train.csv'}",
                 f"checkpoint_dir={tmp_path}", "num_trees=1",
                 f"output_model={tmp_path / 'm.txt'}"])
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for task in ("train", "predict", "convert_model", "refit"):
        with pytest.raises(lgb.LightGBMError, match="CUDA"):
            TA.main([f"task={task}", f"data={d / 'train.csv'}",
                     f"input_model={tmp_path / 'none.txt'}"])


def test_python_dash_m_with_jax_unimportable(files, tmp_path):
    """``python -m lightgbm_tpu_torch`` trains with jax and lightgbm_tpu
    poisoned; without a card (and no device_type=cpu) it exits 1 before
    reading data."""
    d = files
    model = tmp_path / "m.txt"
    code = textwrap.dedent(f"""
        import runpy, sys
        for name in ("jax", "jaxlib", "lightgbm_tpu"):
            sys.modules[name] = None
        sys.argv = ["lightgbm_tpu_torch", "config={d / 'train.conf'}",
                    "data={d / 'train.csv'}", "num_trees=2",
                    "output_model={model}"]
        runpy.run_module("lightgbm_tpu_torch", run_name="__main__")
        assert not any(m.split(".")[0] in ("jax", "jaxlib")
                       for m, mod in sys.modules.items() if mod is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok") and model.exists()
    assert lgb.Booster(model_file=str(model)).num_trees() == 2
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch",
                          f"data={d / 'missing.csv'}"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 1
    assert "device_type=cpu" in out.stderr
