"""The C ABI library of the port, built with the system g++ at first use.

``capi.cpp`` embeds CPython and dispatches every ``LGBMTPU_*`` function of
``capi.h`` to :mod:`lightgbm_tpu_torch.capi_impl`.  :func:`build_capi`
compiles it into ``lightgbm_tpu_torch/_build/liblgbtpu_capi.so`` (the same
file name as lightgbm_tpu's library, in another directory), so a consumer
that links ``-L$(lib_dir()) -llgbtpu_capi`` (SWIG builds,
``R-package/src/Makevars`` through ``LGBTPU_LIB``) gets the port.  Nothing
here runs at import time.
"""

from __future__ import annotations

import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_CAPI_SRC = os.path.join(_DIR, "capi.cpp")
_CAPI_LIB = os.path.join(_BUILD, "liblgbtpu_capi.so")
_lock = threading.Lock()


def _compile_if_stale(src: str, lib_path: str, extra_flags, timeout: int
                      ) -> None:
    """Serialized stale check, compile to a temporary file, atomic
    replace.  The temporary name carries the pid, so concurrent builds
    (pytest-xdist workers) cannot corrupt each other."""
    with _lock:
        if os.path.exists(lib_path) and \
                os.path.getmtime(lib_path) >= os.path.getmtime(src):
            return
        os.makedirs(os.path.dirname(lib_path), exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", src,
               *extra_flags, "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True, timeout=timeout)
        os.replace(tmp, lib_path)


def build_capi() -> str:
    """Build the embedded-CPython C ABI library (capi.cpp) against this
    interpreter's headers and ``libpython``, and return its path.
    Consumers link it like the reference's lib_lightgbm."""
    import sysconfig
    inc = sysconfig.get_path("include")
    libdir = sysconfig.get_config_var("LIBDIR")
    pyver = sysconfig.get_config_var("LDVERSION")
    _compile_if_stale(
        _CAPI_SRC, _CAPI_LIB,
        [f"-I{inc}", f"-L{libdir}", f"-Wl,-rpath,{libdir}",
         f"-lpython{pyver}"], 180)
    return _CAPI_LIB


def lib_dir() -> str:
    """Directory holding the built C ABI library: the link target for
    non-Python consumers (``-L``, ``LGBTPU_LIB``)."""
    return os.path.dirname(build_capi())
