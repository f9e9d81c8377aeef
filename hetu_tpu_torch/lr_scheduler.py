"""Learning-rate schedulers (counterpart of ``hetu_tpu/lr_scheduler.py``;
reference: python/hetu/lr_scheduler.py): fixed, step, multi-step,
exponential and reduce-on-plateau. The executor reads ``get()`` for a
training step and calls ``step()`` after it; a plateau schedule moves
only when ``step(metric)`` is given a metric."""
from __future__ import annotations

__all__ = ["FixedScheduler", "StepScheduler", "MultiStepScheduler",
           "ExponentialScheduler", "ReduceOnPlateauScheduler"]


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


class StepScheduler(FixedScheduler):
    """The rate times ``gamma`` once every ``step_size`` updates."""

    def __init__(self, learning_rate, step_size, gamma=0.1):
        super().__init__(learning_rate)
        if step_size <= 0:
            raise ValueError(f"step_size must be > 0, got {step_size}")
        self.step_size = step_size
        self.gamma = gamma
        self.cnt = 0

    def get(self):
        return self.learning_rate * (self.gamma
                                     ** (self.cnt // self.step_size))

    def step(self, metric=None):
        self.cnt += 1
        return self.get()


class MultiStepScheduler(FixedScheduler):
    """The rate times ``gamma`` at each milestone passed."""

    def __init__(self, learning_rate, milestones, gamma=0.1):
        super().__init__(learning_rate)
        self.milestones = sorted(milestones)
        self.gamma = gamma
        self.cnt = 0

    def get(self):
        passed = sum(1 for m in self.milestones if m <= self.cnt)
        return self.learning_rate * (self.gamma ** passed)

    def step(self, metric=None):
        self.cnt += 1
        return self.get()


class ExponentialScheduler(FixedScheduler):
    """The rate times ``gamma`` every update."""

    def __init__(self, learning_rate, gamma=0.99):
        super().__init__(learning_rate)
        self.gamma = gamma
        self.cnt = 0

    def get(self):
        return self.learning_rate * (self.gamma ** self.cnt)

    def step(self, metric=None):
        self.cnt += 1
        return self.get()


class ReduceOnPlateauScheduler(FixedScheduler):
    """The rate times ``factor`` after more than ``patience`` metrics in
    a row that do not beat the best by ``threshold`` (relative to it, or
    absolute)."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel"):
        super().__init__(learning_rate)
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        if threshold_mode not in ("rel", "abs"):
            raise ValueError(f"threshold_mode must be 'rel' or 'abs', got "
                             f"{threshold_mode!r}")
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cur_lr = learning_rate
        self.best = None
        self.num_bad = 0

    def get(self):
        return self.cur_lr

    def _is_better(self, metric):
        if self.best is None:
            return True
        if self.threshold_mode == "rel":
            delta = abs(self.best) * self.threshold
        else:
            delta = self.threshold
        if self.mode == "min":
            return metric < self.best - delta
        return metric > self.best + delta

    def step(self, metric=None):
        if metric is None:
            return self.cur_lr
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.cur_lr *= self.factor
                self.num_bad = 0
        return self.cur_lr
