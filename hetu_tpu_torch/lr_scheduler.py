"""Learning-rate schedulers (counterpart of ``hetu_tpu/lr_scheduler.py``;
reference: python/hetu/lr_scheduler.py). The fixed schedule so far; the
step, multi-step, exponential and plateau schedules are to port."""
from __future__ import annotations

__all__ = ["FixedScheduler"]


class FixedScheduler:
    def __init__(self, learning_rate):
        if learning_rate < 0:
            raise ValueError(f"learning rate must be >= 0, got "
                             f"{learning_rate}")
        self.learning_rate = learning_rate

    def get(self):
        return self.learning_rate

    def step(self, metric=None):
        return self.learning_rate
