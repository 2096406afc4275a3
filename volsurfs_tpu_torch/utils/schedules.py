"""Learning-rate schedule (counterpart of volsurfs_tpu/utils/schedules.py)."""

from __future__ import annotations


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
