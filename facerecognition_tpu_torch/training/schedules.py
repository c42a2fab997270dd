"""Learning-rate schedules, and the plateau and early-stopping controllers.

Counterpart of ``facerecognition_tpu/training/schedules.py``, whose
schedules are optax's. ``build_schedule`` returns a plain function
``step -> lr`` that computes optax's value in float32, in optax's order of
operations, for:

- ``cosine``: ``cosine_decay_schedule(base_lr, decay_steps, alpha)``;
- ``step``: ``exponential_decay(base_lr, step_size, gamma, staircase=True)``;
- ``constant`` / ``plateau``: ``constant_schedule(base_lr)``;
- a warmup: ``linear_schedule(base_lr * warmup_start_factor, base_lr,
  warmup_steps)`` joined to the main schedule at ``warmup_steps``
  (``join_schedules``: the main one is evaluated at ``step - boundary``).

The step is the optimizer's update count before its increment: the first
update uses ``schedule(0)`` (``training/optim.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np

F32 = np.float32


def _cosine(init_value: float, decay_steps: int, alpha: float) -> Callable[[int], F32]:
    def schedule(count: int) -> F32:
        c = F32(min(count, decay_steps))
        # The float32 argument's cosine rounded once from float64: nearer
        # XLA's float32 cos than numpy's float32 one (within an ulp of it).
        cosine = F32(np.cos(np.float64(F32(math.pi) * c / F32(decay_steps))))
        decayed = F32(1 - alpha) * (F32(0.5) * (F32(1) + cosine)) + F32(alpha)
        return F32(init_value) * decayed

    return schedule


def _exponential_staircase(init_value: float, transition_steps: int, decay_rate: float):
    def schedule(count: int) -> F32:
        if count <= 0:
            return F32(init_value)
        p = np.floor(F32(count) / F32(transition_steps))
        return F32(init_value) * np.power(F32(decay_rate), p)

    return schedule


def _linear(init_value: float, end_value: float, transition_steps: int):
    def schedule(count: int) -> F32:
        c = min(max(count, 0), transition_steps)
        frac = F32(1) - F32(c) / F32(transition_steps)
        return F32(init_value - end_value) * frac + F32(end_value)

    return schedule


def warmup_cosine_decay(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int, end_value: float = 0.0
) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(init_value, peak_value,
    warmup_steps, decay_steps, end_value)``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then cosine to ``end_value`` at
    ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = _linear(init_value, peak_value, warmup_steps)
    main = _cosine(peak_value, decay_steps - warmup_steps, alpha)

    def schedule(count: int) -> float:
        count = int(count)
        return float(warm(count) if count < warmup_steps else main(count - warmup_steps))

    return schedule


def build_schedule(
    base_lr: float,
    schedule: str = "cosine",
    total_steps: int = 10_000,
    warmup_steps: int = 0,
    warmup_start_factor: float = 0.1,
    step_size: int = 3_000,
    gamma: float = 0.1,
    min_lr: float = 0.0,
) -> Callable[[int], float]:
    """A config-described schedule as a function of the update count."""
    # CLI overrides parse through YAML 1.1, where "3e-4" is a string.
    base_lr = float(base_lr)
    gamma = float(gamma)
    min_lr = float(min_lr)
    warmup_start_factor = float(warmup_start_factor)
    if schedule == "cosine":
        main = _cosine(
            base_lr, max(total_steps - warmup_steps, 1), min_lr / base_lr if base_lr else 0.0
        )
    elif schedule == "step":
        main = _exponential_staircase(base_lr, step_size, gamma)
    elif schedule in ("constant", "plateau"):
        # plateau: the host-side ReduceOnPlateau scales this constant base.
        def main(count: int) -> F32:
            return F32(base_lr)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    if warmup_steps > 0:
        warm = _linear(base_lr * warmup_start_factor, base_lr, warmup_steps)

        def joined(count: int) -> float:
            count = int(count)
            return float(warm(count) if count < warmup_steps else main(count - warmup_steps))

        return joined
    return lambda count: float(main(int(count)))


class ReduceOnPlateau:
    """Host-side plateau controller: emits an LR scale factor (torch
    ReduceLROnPlateau's factor and patience, min or max mode)."""

    def __init__(
        self,
        factor: float = 0.1,
        patience: int = 5,
        mode: str = "min",
        min_scale: float = 1e-4,
    ):
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.min_scale = min_scale
        self.best: Optional[float] = None
        self.bad_epochs = 0
        self.scale = 1.0

    def update(self, metric: float) -> float:
        improved = (
            self.best is None
            or (self.mode == "min" and metric < self.best - 1e-12)
            or (self.mode == "max" and metric > self.best + 1e-12)
        )
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.bad_epochs = 0
        return self.scale

    def state_dict(self) -> dict:
        return {"best": self.best, "bad_epochs": self.bad_epochs, "scale": self.scale}

    def load_state_dict(self, state: dict) -> None:
        self.best = state["best"]
        self.bad_epochs = state["bad_epochs"]
        self.scale = state["scale"]


class EarlyStopping:
    """Patience-based early stop."""

    def __init__(self, patience: int = 15, mode: str = "max", min_delta: float = 0.0):
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.counter = 0
        self.should_stop = False

    def __call__(self, metric: float) -> bool:
        improved = (
            self.best is None
            or (self.mode == "max" and metric > self.best + self.min_delta)
            or (self.mode == "min" and metric < self.best - self.min_delta)
        )
        if improved:
            self.best = metric
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.should_stop = True
        return self.should_stop

    def state_dict(self) -> dict:
        return {"best": self.best, "counter": self.counter, "should_stop": self.should_stop}

    def load_state_dict(self, state: dict) -> None:
        self.best = state["best"]
        self.counter = state["counter"]
        self.should_stop = state["should_stop"]
