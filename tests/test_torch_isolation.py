"""The port stands alone: no module of ``lightgbm_tpu_torch`` (nor
``chip_smoke.py``) imports jax or lightgbm_tpu, it trains with jax
unimportable, and its entry points refuse to run on the CPU unless asked."""

import ast
import re
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgb_torch
from lightgbm_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "lightgbm_tpu")


def _port_sources():
    files = sorted((REPO / "lightgbm_tpu_torch").rglob("*.py"))
    return [p for p in files if "_build" not in p.parts] + \
        [REPO / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_module_imports_no_jax(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {sorted(bad)}"


def test_trains_with_jax_unimportable(tmp_path):
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "lightgbm_tpu"):
            sys.modules[name] = None   # poison: importing it now fails
        import numpy as np
        import lightgbm_tpu_torch as lgb
        rng = np.random.default_rng(0)
        X = rng.normal(size=(3000, 5))
        y = (X[:, 0] + 0.3 * rng.normal(size=3000) > 0).astype(float)
        params = dict(objective="binary", num_leaves=7, max_bin=31,
                      tpu_split_batch=2, use_quantized_grad=True,
                      tpu_hist_dtype="int8", stochastic_rounding=False,
                      hist_kernel="onehot", device_type="cpu",
                      verbosity=-1)
        bst = lgb.train(params, lgb.Dataset(X, y), num_boost_round=3)
        p = bst.predict(X[:100])
        assert p.shape == (100,) and np.isfinite(p).all()
        assert not any(m.split(".")[0] in ("jax", "jaxlib")
                       for m, mod in sys.modules.items() if mod is not None)
        print("ok", bst.num_trees())
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok 3")


def test_scan_covers_the_learner_option_modules():
    names = {str(p.relative_to(REPO)) for p in _port_sources()}
    for mod in ("learner/linear.py", "ops/linear_kernels.py",
                "learner/grower.py", "learner/batch_grower.py"):
        assert f"lightgbm_tpu_torch/{mod}" in names


def test_learner_options_train_with_jax_unimportable(tmp_path):
    """Forced splits, CEGB and linear trees train and predict with jax
    and lightgbm_tpu unimportable."""
    (tmp_path / "forced.json").write_text(
        '{"feature": 0, "threshold": 0.0, '
        '"left": {"feature": 1, "threshold": 0.2}}')
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "lightgbm_tpu"):
            sys.modules[name] = None   # poison: importing it now fails
        import numpy as np
        import lightgbm_tpu_torch as lgb
        rng = np.random.default_rng(0)
        X = rng.normal(size=(2000, 4))
        y = X[:, 0] + np.where(X[:, 1] > 0, X[:, 2], -X[:, 2])
        base = dict(objective="regression", num_leaves=7, device_type="cpu",
                    verbosity=-1)
        for extra in (dict(forcedsplits_filename="forced.json",
                           tpu_split_batch=2),
                      dict(cegb_penalty_split=1e-4,
                           cegb_penalty_feature_lazy=[1e-3] * 4),
                      dict(linear_tree=True, tpu_debug_checks=True)):
            bst = lgb.train(dict(base, **extra), lgb.Dataset(X, y),
                            num_boost_round=3)
            assert np.isfinite(bst.predict(X[:50])).all()
        assert not any(m.split(".")[0] in ("jax", "jaxlib")
                       for m, mod in sys.modules.items() if mod is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("device_type", [None, "", "cuda", "gpu"])
def test_default_device_without_a_card_raises(monkeypatch, device_type):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(lgb_torch.LightGBMError):
        resolve_device(device_type)
    params = dict(objective="regression", tpu_split_batch=2,
                  hist_kernel="onehot", verbosity=-1)
    if device_type is not None:
        params["device_type"] = device_type
    X = np.random.default_rng(0).normal(size=(200, 3))
    with pytest.raises(lgb_torch.LightGBMError):
        lgb_torch.train(params, lgb_torch.Dataset(X, X[:, 0]),
                        num_boost_round=1)


def test_cpu_only_on_request():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(lgb_torch.LightGBMError):
        resolve_device("tpu")


def test_scan_covers_the_training_surface_modules():
    names = {str(p.relative_to(REPO)) for p in _port_sources()}
    for mod in ("obs/__init__.py", "obs/metrics.py",
                "robustness/__init__.py", "robustness/guards.py",
                "engine.py", "basic.py", "callback.py"):
        assert f"lightgbm_tpu_torch/{mod}" in names


def test_training_surface_runs_with_jax_unimportable(tmp_path):
    """Custom objectives and metrics, nan_policy, continued training,
    rollback, refit, reset_parameter, cv and the telemetry counters run
    with jax and lightgbm_tpu unimportable."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "lightgbm_tpu"):
            sys.modules[name] = None   # poison: importing it now fails
        import numpy as np
        import lightgbm_tpu_torch as lgb
        rng = np.random.default_rng(0)
        X = rng.normal(size=(2000, 4))
        y = (X[:, 0] + 0.3 * rng.normal(size=2000) > 0).astype(float)

        def fobj(p, ds):
            q = 1.0 / (1.0 + np.exp(-p))
            g = q - ds.get_label()
            if len(calls) == 2:
                g = g * np.nan
            calls.append(1)
            return g, q * (1.0 - q)

        def feval(p, ds):
            return "err", float(np.mean((p > 0) != ds.get_label())), False
        base = dict(num_leaves=7, device_type="cpu", verbosity=-1)
        calls = []
        ds = lgb.Dataset(X, y, free_raw_data=False)
        b = lgb.train(dict(base, nan_policy="skip_round"), ds, 4,
                      valid_sets=[ds], fobj=fobj, feval=feval)
        assert b.num_trees() == 3
        assert b.telemetry()["counters"]["nan_rounds_skipped"] == 1
        b2 = lgb.train(dict(base, objective="binary"), ds, 3, init_model=b,
                       callbacks=[lgb.reset_parameter(
                           learning_rate=[0.1, 0.2, 0.3])])
        assert b2.num_trees() == 6
        b2.rollback_one_iter()
        assert b2.num_trees() == 5
        r = b2.refit(X, y, decay_rate=0.5)
        assert np.isfinite(r.predict(X[:50])).all()
        res = lgb.cv(dict(base, objective="binary"), lgb.Dataset(X, y), 3,
                     nfold=3, return_cvbooster=True)
        assert len(res["valid binary_logloss-mean"]) == 3
        assert not any(m.split(".")[0] in ("jax", "jaxlib")
                       for m, mod in sys.modules.items() if mod is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_training_surface_without_a_card_raises(monkeypatch):
    """cv and a loaded model's refit run on the card by default: without
    one they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 3))
    y = (X[:, 0] > 0).astype(float)
    params = dict(objective="binary", num_leaves=7, verbosity=-1)
    with pytest.raises(lgb_torch.LightGBMError):
        lgb_torch.cv(params, lgb_torch.Dataset(X, y), 2, nfold=2)
    bst = lgb_torch.train(dict(params, device_type="cpu"),
                          lgb_torch.Dataset(X, y), 2)
    loaded = lgb_torch.Booster(model_str=bst.model_to_string())
    with pytest.raises(lgb_torch.LightGBMError):
        loaded.refit(X, y)


def test_scan_covers_the_user_surface_modules():
    names = {str(p.relative_to(REPO)) for p in _port_sources()}
    for mod in ("io/parser.py", "io/dataset.py", "sklearn.py",
                "plotting.py", "application.py", "__main__.py",
                "models/model_io.py"):
        assert f"lightgbm_tpu_torch/{mod}" in names


def test_user_surfaces_run_with_jax_unimportable(tmp_path):
    """File input, sparse input, a binary dataset, an estimator, the
    inspection methods and the CLI run with jax and lightgbm_tpu
    unimportable."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "lightgbm_tpu"):
            sys.modules[name] = None   # poison: importing it now fails
        import numpy as np
        import scipy.sparse as sp
        import lightgbm_tpu_torch as lgb
        from lightgbm_tpu_torch.application import main
        rng = np.random.default_rng(0)
        X = rng.normal(size=(1500, 4))
        y = X[:, 0] + 0.1 * rng.normal(size=1500)
        np.savetxt("train.csv", np.column_stack([y, X]), fmt="%.17g",
                   delimiter=",")
        base = dict(objective="regression", num_leaves=7, device_type="cpu",
                    verbosity=-1)
        b = lgb.train(base, lgb.Dataset("train.csv"), 3)
        assert b.num_trees() == 3 and b.dump_model()["tree_info"]
        assert b.feature_importance("gain").shape == (4,)
        S = sp.random(1500, 30, density=0.1, random_state=0, format="csr")
        bs = lgb.train(base, lgb.Dataset(S, y), 2)
        assert np.isfinite(bs.predict(S)).all()
        lgb.Dataset(X, y).save_binary("d.bin")
        assert lgb.Dataset("d.bin").construct().num_data() == 1500
        reg = lgb.LGBMRegressor(n_estimators=2, verbosity=-1,
                                device_type="cpu").fit(X, y)
        assert np.isfinite(reg.predict(X)).all()
        main(["data=train.csv", "num_trees=2", "device_type=cpu",
              "output_model=m.txt", "verbosity=-1"])
        assert lgb.Booster(model_file="m.txt").num_trees() == 2
        assert not any(m.split(".")[0] in ("jax", "jaxlib")
                       for m, mod in sys.modules.items() if mod is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_scan_covers_the_c_api_and_serving_modules():
    names = {str(p.relative_to(REPO)) for p in _port_sources()}
    for mod in ("capi_impl.py", "native/__init__.py", "serving/__init__.py",
                "serving/buckets.py", "serving/standalone.py",
                "serving/predictor.py"):
        assert f"lightgbm_tpu_torch/{mod}" in names


def test_c_shim_dispatches_to_the_port_only():
    """native/capi.cpp imports lightgbm_tpu_torch.capi_impl and no other
    module, and includes nothing of lightgbm_tpu."""
    src = (REPO / "lightgbm_tpu_torch" / "native" / "capi.cpp").read_text()
    assert re.findall(r'PyImport_ImportModule\("([^"]+)"\)', src) == \
        ["lightgbm_tpu_torch.capi_impl"]
    includes = re.findall(r'#include\s+[<"]([^>"]+)[>"]', src)
    assert includes and not any("lightgbm_tpu" in i for i in includes)
    assert not re.search(r'"lightgbm_tpu\.', src)


def test_c_api_and_serving_run_with_jax_unimportable(tmp_path):
    """The C API's Python side and the serving predictor train and
    predict with jax and lightgbm_tpu unimportable."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "lightgbm_tpu"):
            sys.modules[name] = None   # poison: importing it now fails
        import json
        import numpy as np
        from lightgbm_tpu_torch import capi_impl as C
        from lightgbm_tpu_torch.serving import CompiledPredictor
        rng = np.random.default_rng(0)
        X = rng.normal(size=(800, 4))
        y = (X[:, 0] > 0).astype(float)
        p = json.dumps(dict(objective="binary", num_leaves=7,
                            device_type="cpu", verbose=-1))
        ds = C.dataset_from_mat(X.ctypes.data, 800, 4, y.ctypes.data, p)
        b = C.booster_create(ds, p)
        for _ in range(3):
            C.booster_update_one_iter(b)
        out = np.zeros(1)
        f = C.fastpredict_init(b, 4, 1)
        row = np.ascontiguousarray(X[0])
        C.fastpredict_row(f, row.ctypes.data, out.ctypes.data, 1)
        bst = C._handles[b]
        assert out[0] == bst.predict(X[:1], raw_score=True)[0]
        pred = CompiledPredictor.from_model_text(
            bst.model_to_string(), params={"device_type": "cpu"})
        assert np.array_equal(pred.predict(X[:100]),
                              bst.predict(X[:100], raw_score=True))
        assert not any(m.split(".")[0] in ("jax", "jaxlib")
                       for m, mod in sys.modules.items() if mod is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
