"""Hyper-parameter sweep hooks (the reference's Optuna path).

The port of ``affganwriting_tpu/train/sweep.py``, on the port's own
config.  GAN_word/main_run.py:292-331 wires an Optuna study over the four
learning rates.  Optuna isn't in this image, so the same surface is a dependency-free
random/grid search: define a space, get deterministic trial configs, feed
back objective values, read the best trial.  The objective convention
matches the reference (minimize summed validation CER).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Callable

import numpy as np

from affganwriting_torch.core.config import WordGanConfig


@dataclasses.dataclass
class LogUniform:
    low: float
    high: float

    def sample(self, rng: np.random.Generator) -> float:
        return float(math.exp(rng.uniform(
            math.log(self.low), math.log(self.high))))


DEFAULT_SPACE = {
    # main_run.py:437-444 searches the four Adam lrs
    "lr_dis": LogUniform(1e-5, 1e-3),
    "lr_gen": LogUniform(1e-5, 1e-3),
    "lr_rec": LogUniform(1e-6, 1e-4),
    "lr_cla": LogUniform(1e-6, 1e-4),
}


class Study:
    def __init__(self, base: WordGanConfig, space: dict | None = None,
                 seed: int = 0):
        self.base = base
        self.space = space or DEFAULT_SPACE
        self.rng = np.random.default_rng(seed)
        self.trials: list[dict] = []

    def suggest(self) -> WordGanConfig:
        params = {k: v.sample(self.rng) for k, v in self.space.items()}
        self.trials.append({"params": params, "value": None})
        return self.base.replace(**params)

    def report(self, value: float) -> None:
        self.trials[-1]["value"] = float(value)

    @property
    def best(self) -> dict:
        done = [t for t in self.trials if t["value"] is not None]
        return min(done, key=lambda t: t["value"])

    def run(self, objective: Callable[[WordGanConfig], float],
            n_trials: int) -> dict:
        for _ in range(n_trials):
            cfg = self.suggest()
            self.report(objective(cfg))
        return self.best

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.trials, f, indent=2)
