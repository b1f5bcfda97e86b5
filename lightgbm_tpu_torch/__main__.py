"""``python -m lightgbm_tpu_torch``: the CLI (reference src/main.cpp).  A
``LightGBMError`` is printed and exits with code 1."""

import sys

from .application import main
from .utils.log import LightGBMError

try:
    main()
except LightGBMError as e:
    print(f"[LightGBM] [Fatal] {e}", file=sys.stderr, flush=True)
    sys.exit(1)
