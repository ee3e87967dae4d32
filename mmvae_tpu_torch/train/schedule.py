"""Host-side training schedules (mmvae_tpu/train/schedule.py).

- ReduceLROnPlateau with torch defaults (reference main.py:117: factor 0.1,
  patience 10, rel threshold 1e-4, cooldown 0).
- beta_kl decay: multiplied by decrease_beta_kl every epoch past warmup
  (jmvae_nf.py:189-193).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ReduceLROnPlateau:
    lr: float
    factor: float = 0.1
    patience: int = 10
    threshold: float = 1e-4
    min_lr: float = 0.0
    cooldown: int = 0

    best: float = float("inf")
    num_bad: int = 0
    cooldown_counter: int = 0

    def step(self, metric: float) -> float:
        """Feed the epoch val loss; returns the (possibly reduced) lr."""
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        return self.lr

    def reset(self, lr: float):
        self.lr = lr
        self.best = float("inf")
        self.num_bad = 0
        self.cooldown_counter = 0


class BetaKlSchedule:
    """beta_kl *= decrease each epoch with epoch >= warmup."""

    def __init__(self, beta_kl: float, decrease: float, warmup: int):
        self.value = beta_kl
        self.decrease = decrease
        self.warmup = warmup

    def step(self, epoch: int) -> float:
        if epoch >= self.warmup:
            self.value *= self.decrease
        return self.value
