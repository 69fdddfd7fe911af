"""ReduceLROnPlateau on the word recognizer (GAN_word/main_run.py:279).

The port of ``affganwriting_tpu/train/schedules.py:PlateauScaler``: a
host-side multiplier that the trainer applies to R's learning rate through
``train/state.py:set_rec_lr``.  The module's schedule family and
name-partitioned optimizer serve the line stack and are ported with it.
"""

from __future__ import annotations

import math


class PlateauScaler:
    """Tracks a monitored metric (lower is better); multiplies the rate by
    ``factor`` once it has failed to improve for more than ``patience``
    evaluations, down to ``min_mul`` (torch ``ReduceLROnPlateau``'s
    defaults: factor 0.1, patience 10)."""

    def __init__(self, factor: float = 0.1, patience: int = 10,
                 min_mul: float = 1e-4):
        self.factor = factor
        self.patience = patience
        self.min_mul = min_mul
        self.best = math.inf
        self.bad = 0
        self.mul = 1.0

    def update(self, metric: float) -> float:
        if metric < self.best:
            self.best = metric
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.mul = max(self.min_mul, self.mul * self.factor)
                self.bad = 0
        return self.mul
