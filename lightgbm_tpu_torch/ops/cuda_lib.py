"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with ``ctypes``.
The build happens at first use (or all at once through :func:`build_all`,
one ``nvcc`` process per source, all started together) into
``lightgbm_tpu_torch/_build/``; a library's file name carries a hash of its
source and flags, so an edited source is rebuilt and never confused with an
old build (the hash covers the shared ``csrc/*.cuh`` headers too).
Nothing here runs at import time.

Every wrapper checks its tensors in Python, launches on PyTorch's current
stream and raises ``LightGBMError`` when the C function returns a non-zero
``cudaGetLastError()`` code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

from ..utils import log

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("take", "hist", "radix", "packed", "rows", "partition", "forest",
           "shap", "rank", "prng", "linear")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_F, _LL = ctypes.c_float, ctypes.c_longlong
_DESC = (_P,) * 8  # the partition kernels' eight [K] slot descriptors
#: C signatures of the exported functions (all return the launch's
#: cudaGetLastError() code)
_SIGNATURES = {
    "take": {"lgbt_take": (_P, _L, _P, _I, _P, _P)},
    "hist": {
        "lgbt_hist_leaves": (_P, _L, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                             _P),
        "lgbt_hist_leaves_rows": (_P, _L, _I, _P, _P, _P, _P, _I, _I, _I, _P,
                                  _P),
        "lgbt_hist_payload": (_P, _L, _I, _I, _P, _I, _P, _I, _I, _P, _P,
                              _P),
    },
    "radix": {
        "lgbt_hist_radix_single": (_P, _L, _I, _P, _P, _P, _I, _I, _P, _P,
                                   _P),
        "lgbt_pass_scale": (_P, _P, _L, _P, _P),
        "lgbt_hist_radix2": (_P, _L, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                             _P),
    },
    "packed": {
        "lgbt_hist_packed": (_P, _I, _L, _I, _P, _P, _P, _P, _I, _I, _I, _P,
                             _P, _P),
    },
    "rows": {
        "lgbt_hist_rows": (_P, _L, _I, _P, _I, _I, _I, _P, _P),
    },
    "forest": {
        "lgbt_forest": (_P, _I, _L, _L, _I, _P, _P, _I, _I, _P, _I, _I, _P,
                        _I, _P, _I, _P, _L, _P, _P, _P, _I, _P, _P, _P),
    },
    "shap": {
        "lgbt_shap": (_P, _L, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P,
                      _P, _P, _I, _I, _P, _P, _P, _P),
    },
    "rank": {
        "lgbt_lambdarank": (_P, _P, _P, _P, _P, _P, _I, _L, _F, _I, _I, _P,
                            _P, _P, _P),
    },
    "linear": {
        "lgbt_linear_normal": (_P, _L, _I, _L, _P, _P, _P, _P, _I, _P, _I,
                               _P, _P, _P, _P, _L, _P, _P, _P, _P, _P),
        "lgbt_linear_scores": (_P, _L, _P, _L, _P, _P, _I, _P, _P, _P, _P),
    },
    "prng": {
        "lgbt_threefry_draw": (_P, _L, _I) + (_P, _LL, _LL) * 3
        + (_L, _I, _P, _P),
    },
    "partition": {
        "lgbt_partition_payload": (_L, _I, _P, _I, _P, _P, _P, _P) + _DESC
        + (_I, _P, _I, _P, _P, _P, _P),
        "lgbt_partition_select": (_P, _L, _I, _P, _P) + _DESC
        + (_I, _P, _I, _P, _P, _P),
    },
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: ``nvcc -Xptxas -v`` output of the builds this process ran, by source
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    log.fatal("nvcc not found (set CUDA_HOME or put nvcc on PATH); the "
              "CUDA kernels of lightgbm_tpu_torch are built from csrc/ on "
              "first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    text, _ = proc.communicate()
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    build_log[name] = text
    if proc.returncode != 0:
        log.fatal(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):"
                  f"\n{text}")
    os.replace(tmp, out)


def build_all() -> float:
    """Compile every kernel source not built yet, one ``nvcc`` per source,
    all running at once.  Returns the wall seconds it took."""
    t0 = time.perf_counter()
    with _LOCK:
        procs = {name: _start(name) for name in SOURCES}
        for name, proc in procs.items():
            _finish(name, proc)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    A library already loaded is returned without taking the lock (a dict
    read is atomic): every launch of every wrapper comes through here."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, args in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(args)
            f.restype = ctypes.c_int
        _LIBS[name] = lib
        return lib


def stream_handle(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a pointer (the
    raw handle: building a ``torch.cuda.Stream`` costs microseconds a
    launch)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check(code: int, what: str) -> None:
    """Raise when a launch reported a CUDA error."""
    if code != 0:
        log.fatal(f"{what}: CUDA error {code} at launch")
