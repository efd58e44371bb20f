"""Learning-rate schedules: functions of the update count, as the JAX
package's optax schedules are (``panogrf_tpu/train/lr.py``)."""

from __future__ import annotations


def exp_decay(lr_init: float = 4e-4, decay_step: int = 20000,
              decay_rate: float = 0.5, lr_min: float = 1e-5):
    """lr_init * rate^(step // decay_step), floored at lr_min."""
    def schedule(step: int) -> float:
        return max(lr_init * decay_rate ** (step // decay_step), lr_min)
    return schedule


def warmup_exp_decay(lr_init: float = 4e-4, warmup_step: int = 1000,
                     decay_step: int = 20000, decay_rate: float = 0.5,
                     lr_min: float = 1e-5):
    """Linear warmup into exponential decay."""
    base = exp_decay(lr_init, decay_step, decay_rate, lr_min)

    def schedule(step: int) -> float:
        if step < warmup_step:
            return lr_init * min(step / max(warmup_step, 1), 1.0)
        return base(step)
    return schedule


NAME2LR = {"exp_decay": exp_decay, "warm_up_exp_decay": warmup_exp_decay}
