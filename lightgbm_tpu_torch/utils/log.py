"""Logging facade for lightgbm_tpu_torch.

Counterpart of ``lightgbm_tpu/utils/log.py`` (reference:
include/LightGBM/utils/log.h:78 ``Log`` with levels Fatal/Warning/Info/Debug
and a redirectable callback, ``Log::ResetCallBack`` log.h:97).  Same user
surface: four levels, a process-global verbosity, and a pluggable callback.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional


class LightGBMError(Exception):
    """Raised where the reference calls ``Log::Fatal`` (utils/log.h:117)."""


_verbosity = 1  # matches reference config.h `verbosity` default (1 = Info)
_callback: Optional[Callable[[str], None]] = None


def set_verbosity(level: int) -> None:
    global _verbosity
    _verbosity = int(level)


def register_logger(func: Optional[Callable[[str], None]]) -> None:
    """Redirect log output through ``func`` (reference c_api.h:73)."""
    global _callback
    _callback = func


def _emit(msg: str) -> None:
    if _callback is not None:
        _callback(msg)
    else:
        print(msg, file=sys.stderr, flush=True)


def info(msg: str) -> None:
    if _verbosity >= 1:
        _emit(f"[LightGBM-Torch] [Info] {msg}")


def warning(msg: str) -> None:
    if _verbosity >= 0:
        _emit(f"[LightGBM-Torch] [Warning] {msg}")


def fatal(msg: str) -> "None":
    raise LightGBMError(msg)
