"""Numeric guards (``nan_policy``).

Counterpart of the ``guards`` pillar of ``lightgbm_tpu/robustness``;
checkpoints, resume and fault injection are not ported yet.
"""
