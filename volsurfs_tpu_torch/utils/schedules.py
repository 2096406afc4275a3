"""Schedules: map_range_val, the logistic beta of a variance and the
learning-rate schedule (counterpart of volsurfs_tpu/utils/schedules.py).

The scalar schedules round as JAX's traced float32 scalars do (numpy
float32 arithmetic in the same order, returned as numpy float32), but for
the exp of the logistic beta.
"""

from __future__ import annotations

import numpy as np


def map_range_val(x, in_start, in_end, out_start, out_end):
    """x clamped to [in_start, in_end] and mapped linearly onto [out_start,
    out_end]; a degenerate range gives out_end."""
    x = min(max(x, in_start), in_end)
    if in_start >= in_end:
        return np.float32(out_end)
    return (np.float32(out_end - out_start) * np.float32(x - in_start)
            / np.float32(in_end - in_start) + np.float32(out_start))


def get_logistic_beta_from_variance(variance):
    """clip(exp(10 variance), 1e-6, 1e6), the exp rounded once from float64
    (XLA's float32 exp is not correctly rounded: the two differ by an ulp
    at ~1 in 10 arguments)."""
    x = np.float64(np.float32(variance) * np.float32(10.0))
    return np.float32(np.clip(np.float32(np.exp(x)), np.float32(1e-6), np.float32(1e6)))


def logistic_distribution_stdev(beta):
    return (np.pi / np.sqrt(3.0)) / beta


def make_lr_schedule(
    base_lr: float,
    milestones,
    gamma: float = 0.3,
    warmup_start_iter: int = 0,
    warmup_iters: int = 0,
):
    """lr(step): linear warmup from warmup_start_iter over warmup_iters, then
    multiplied by gamma at each milestone passed. Steps before
    warmup_start_iter run at base_lr."""
    milestones = sorted(int(m) for m in milestones)

    def schedule(step: int) -> float:
        decay = gamma ** sum(step >= m for m in milestones)
        warm = 1.0
        if warmup_iters > 0 and warmup_start_iter <= step < warmup_start_iter + warmup_iters:
            warm = (step - warmup_start_iter) / warmup_iters
        return base_lr * warm * decay

    return schedule
