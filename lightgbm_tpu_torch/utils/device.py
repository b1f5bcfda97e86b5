"""Device selection for the torch package.

``device_type`` (alias ``device``) picks where training runs:

* unset, ``cuda`` or ``gpu``: the CUDA card (``torch.device("cuda")``);
* ``cpu``: the CPU, on the kernels' plain PyTorch versions.

There is no silent fallback: asking for the card on a machine without one
raises ``LightGBMError``, so a run that was meant for the card never
continues on the CPU unnoticed.
"""

from __future__ import annotations

import torch

from . import log

_CUDA_NAMES = ("", "cuda", "gpu")


def resolve_device(device_type) -> torch.device:
    """Map a ``device_type`` value to a torch device (see module doc)."""
    name = str(device_type or "").strip().lower()
    if name == "cpu":
        return torch.device("cpu")
    if name in _CUDA_NAMES:
        if not torch.cuda.is_available():
            log.fatal("device_type=%s needs a CUDA device, and torch sees "
                      "none; pass device_type=cpu to run on the CPU"
                      % (name or "cuda"))
        return torch.device("cuda")
    log.fatal("device_type=%r is not supported by lightgbm_tpu_torch "
              "(expected cuda, gpu or cpu)" % device_type)
