"""LR schedules, the name-partitioned optimizer, and ReduceLROnPlateau.

The port of ``affganwriting_tpu/train/schedules.py`` (the reference's
line_generation/base/base_trainer.py:49-166 and GAN_word/main_run.py:279):

- ``make_schedule``: the LambdaLR family (LR_test, cyclic, cyclic-full,
  1cycle, detector, rampup, custom warmup), step -> multiplier in f32 as
  the JAX package's jnp lambdas compute it.  Its ``pow`` is taken in f64
  and rounded to f32: XLA's f32 ``pow`` is its own approximation, which
  no torch or numpy routine reproduces bit for bit (within 1 ulp).
- ``partition_labels``: main / slow / frozen by substring of each leaf's
  JAX path string (``_path_str``, e.g. ``style_extractor/conv0/kernel``),
  freeze before slow, so that a config's ``slow_param_names`` and
  ``freeze_param_names`` select the same leaves in both packages; the
  port's parameter names reach those paths through ``flax_paths``, the
  converter's name map read backwards.
- ``PartitionedAdam``: optax's ``multi_transform`` of Adam(b1, b2) times
  the schedule times -lr (0.1 lr on the slow group), frozen leaves not
  updated.  Steps are counted as optax counts them: the k-th update (from
  0) takes the schedule at k, and every parameter of a group takes a step
  on every update, a zero gradient where the loss did not reach it (Adam's
  moments decay and the parameter moves, as in optax).
- ``PlateauScaler``: a host-side multiplier that the word trainer applies
  to R's learning rate through ``train/state.py:set_rec_lr``.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch
from torch import nn


def _pow(base: torch.Tensor, exponent: float) -> torch.Tensor:
    """f32 ``base ** exponent`` (the exponent rounded to f32, as jnp takes
    it), taken in f64."""
    e = float(torch.tensor(exponent, dtype=torch.float32))
    return (base.double() ** e).float()


def make_schedule(name: str | bool, iterations: int,
                  **kw) -> Callable[[int], float]:
    """step -> multiplier, as base_trainer.py:113-166's lambdas."""
    if name in (None, False, "none", "constant"):
        return lambda step: 1.0

    def as_fn(f):
        return lambda step: float(f(torch.tensor(int(step),
                                                 dtype=torch.int32)))

    if name == "LR_test":
        start = 1e-6
        slope = (1 - start) / iterations
        return as_fn(lambda s: start + slope * s)
    if name == "cyclic":
        min_mul = kw.get("min_lr_mul", 0.001)
        cycle = kw.get("cycle_size", 500)
        return as_fn(lambda s: 1 - (1 - min_mul) * ((s - 1) % cycle)
                     / (cycle - 1))
    if name == "cyclic-full":
        min_mul = kw.get("min_lr_mul", 0.25)
        cycle = kw.get("cycle_size", 500)

        def full_cycle(s):
            rising = ((1 - min_mul) * (s % cycle) / (cycle - 1)) + min_mul
            falling = 1 - (1 - min_mul) * (s % cycle) / (cycle - 1)
            return torch.where((s // cycle) % 2 == 0, rising, falling)

        return as_fn(full_cycle)
    if name == "1cycle":
        low_mul = kw.get("low_lr_mul", 0.25)
        min_mul = kw.get("min_lr_mul", 0.0001)
        cycle = kw.get("cycle_size", 1000)
        trail = max(1, iterations - 2 * cycle)

        def one_cycle(s):
            rising = ((1 - low_mul) * (s % cycle) / (cycle - 1)) + low_mul
            falling = 1 - (1 - low_mul) * (s % cycle) / (cycle - 1)
            t = s - 2 * cycle
            trail_off = low_mul * (trail - t) / trail + min_mul * t / trail
            return torch.where(s < cycle, rising,
                               torch.where(s < 2 * cycle, falling, trail_off))

        return as_fn(one_cycle)
    if name == "detector":
        warm = kw.get("warmup_steps", 1000)
        return as_fn(lambda s: torch.minimum(
            _pow(s + 1.0, -0.3), (s + 1.0) * warm ** -1.3))
    if name == "rampup":
        warm = kw.get("warmup_steps", 1000)
        return as_fn(lambda s: torch.clamp_max((s + 0.001) / warm, 1.0))
    if name is True or name == "custom":
        warm = kw.get("warmup_steps", 1000)
        return as_fn(lambda s: torch.minimum(
            _pow(torch.clamp_min(s - (warm - 3), 1e-6) / 100, -0.1),
            s * (1.485 / warm) + 0.01))
    raise ValueError(f"unrecognized learning schedule {name!r}")


def partition_labels(paths: dict[str, str],
                     slow_patterns: Iterable[str] = (),
                     freeze_patterns: Iterable[str] = (),
                     default: str = "main") -> dict[str, str]:
    """{name: JAX path string} -> {name: 'frozen' | 'slow' | default}: a
    path containing a freeze pattern is frozen, else one containing a slow
    pattern is slow (base_trainer.py:62-95)."""
    slow, freeze = tuple(slow_patterns), tuple(freeze_patterns)

    def label(path):
        if any(p in path for p in freeze):
            return "frozen"
        if any(p in path for p in slow):
            return "slow"
        return default

    return {name: label(path) for name, path in paths.items()}


def host_step_counts(opt_state: dict) -> dict:
    """A torch optimizer's state dict with its ``step`` tensors on the
    host, where torch keeps Adam's step counts outside its capturable and
    fused modes (a load onto the card moved them); in place, returned."""
    for s in opt_state["state"].values():
        if isinstance(s.get("step"), torch.Tensor):
            s["step"] = s["step"].cpu()
    return opt_state


class PartitionedAdam:
    """Adam over the main and slow groups of ``params`` ({name: parameter})
    with a shared schedule; frozen parameters take no step and have no
    state (optax's ``set_to_zero``)."""

    def __init__(self, params: dict[str, nn.Parameter], paths: dict[str, str],
                 base_lr: float, iterations: int,
                 schedule: str | bool = "none",
                 slow_patterns: Iterable[str] = (),
                 freeze_patterns: Iterable[str] = (),
                 b1: float = 0.5, b2: float = 0.999, slow_mul: float = 0.1,
                 **sched_kw):
        self.base_lr = base_lr
        self.sched = make_schedule(schedule, iterations, **sched_kw)
        self.labels = partition_labels(paths, slow_patterns, freeze_patterns)
        self.names = {g: [n for n in params if self.labels[n] == g]
                      for g in ("main", "slow")}
        self.params = params
        groups = [{"params": [params[n] for n in names], "mul": mul,
                   "group": g, "lr": base_lr * mul}
                  for g, names, mul in (("main", self.names["main"], 1.0),
                                        ("slow", self.names["slow"],
                                         slow_mul)) if names]
        self.opt = torch.optim.Adam(groups, lr=base_lr, betas=(b1, b2),
                                    eps=1e-8)
        self.count = 0

    @property
    def trained(self) -> list[str]:
        return self.names["main"] + self.names["slow"]

    def step(self, grads: dict[str, torch.Tensor | None]) -> None:
        """One update from ``grads`` ({name: gradient or None, None a zero
        gradient}); frozen names are ignored."""
        mul = self.sched(self.count)
        for group in self.opt.param_groups:
            group["lr"] = self.base_lr * group["mul"] * mul
        for name in self.trained:
            p, g = self.params[name], grads.get(name)
            p.grad = torch.zeros_like(p) if g is None else g
        self.opt.step()
        for name in self.trained:
            self.params[name].grad = None
        self.count += 1

    def state_dict(self) -> dict:
        return {"opt": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(host_step_counts(state["opt"]))
        self.count = int(state["count"])


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
