"""The port stands alone: no module of ``lightgbm_tpu_torch`` (nor
``chip_smoke.py``) imports jax or lightgbm_tpu, it trains with jax
unimportable, and its entry points refuse to run on the CPU unless asked."""

import ast
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
