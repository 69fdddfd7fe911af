"""Checkpoints of the word GAN: latest, periodic and best.

The port of ``affganwriting_tpu/core/checkpoint.py:CheckpointManager``.  A
checkpoint is one ``torch.save`` file holding everything a resume needs:
``{"step", and per player "gen", "dis", "cla", "rec": {"model": state dict
(parameters and BatchNorm running statistics), "opt": optimizer state dict
(Adam's moments and step) or None}}``; ``<name>.config.json`` beside it
holds the config.  Names: ``latest``, ``step_%08d`` (the newest
``keep_periodic`` are kept) and ``best`` with ``best.metric.json`` (lower is
better), which survives a restart.

Crash safety: a save writes ``<path>.new`` in full (through a temporary
file renamed into place, so a ``.new`` is always complete) and commits with
two renames, the old file aside and the new one into place.  At every
instant ``<path>`` or a complete ``<path>.new`` exists, and
``_recover_swap`` promotes the latter after a crash between the renames.
"""

from __future__ import annotations

import json
import os
import re

import torch

from affganwriting_torch.core.config import WordGanConfig
from affganwriting_torch.train.state import PLAYERS


def state_payload(state) -> dict:
    """A ``train/state.py:WordGanState`` as the checkpoint's dict."""
    out = {"step": int(state.step)}
    for name in PLAYERS:
        player = getattr(state, name)
        out[name] = {"model": player.model.state_dict(),
                     "opt": None if player.opt is None
                     else player.opt.state_dict()}
    return out


def load_payload(state, payload: dict):
    """Load a checkpoint's dict into ``state`` in place; returns it."""
    state.step = int(payload["step"])
    for name in PLAYERS:
        player, saved = getattr(state, name), payload[name]
        player.model.load_state_dict(saved["model"], strict=True)
        if (player.opt is None) != (saved["opt"] is None):
            raise ValueError(f"{name}: the checkpoint and the state disagree "
                             "on whether it has an optimizer (rec_frozen?)")
        if player.opt is not None:
            # torch keeps Adam's step counts on the host (outside its
            # capturable and fused modes); a load onto the card moved them
            for s in saved["opt"]["state"].values():
                if isinstance(s.get("step"), torch.Tensor):
                    s["step"] = s["step"].cpu()
            player.opt.load_state_dict(saved["opt"])
    return state


class CheckpointManager:
    def __init__(self, directory: str, keep_periodic: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_periodic = keep_periodic
        self._best_metric: float | None = None
        best_path = self._path("best.metric.json")
        if os.path.exists(best_path):
            with open(best_path) as f:
                self._best_metric = float(json.load(f)["metric"])

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _recover_swap(self, path: str) -> None:
        """Finish a swap that stopped between its two renames: ``<path>``
        missing beside a complete ``<path>.new`` -> promote it; drop a
        left-over ``<path>.old``."""
        new, old = f"{path}.new", f"{path}.old"
        if not os.path.exists(path) and os.path.exists(new):
            os.rename(new, path)
        if os.path.exists(old):
            os.remove(old)

    def _save_swap(self, path: str, payload: dict) -> None:
        self._recover_swap(path)
        new, tmp, old = f"{path}.new", f"{path}.new.tmp", f"{path}.old"
        torch.save(payload, tmp)
        os.replace(tmp, new)
        if os.path.exists(path):
            os.rename(path, old)
        os.rename(new, path)
        if os.path.exists(old):
            os.remove(old)

    def save(self, name: str, state, config: WordGanConfig) -> None:
        self._save_swap(self._path(name), state_payload(state))
        with open(self._path(f"{name}.config.json"), "w") as f:
            f.write(config.to_json())

    def save_latest(self, state, config: WordGanConfig) -> None:
        self.save("latest", state, config)

    def save_step(self, state, config: WordGanConfig, step: int) -> None:
        self.save(f"step_{step:08d}", state, config)
        self._prune()

    def maybe_save_best(self, state, config: WordGanConfig,
                        metric: float) -> bool:
        """Save ``best`` if ``metric`` (validation CER) is the lowest so
        far."""
        if self._best_metric is None or metric < self._best_metric:
            self._best_metric = metric
            self.save("best", state, config)
            with open(self._path("best.metric.json"), "w") as f:
                json.dump({"metric": metric}, f)
            return True
        return False

    def _prune(self) -> None:
        steps = sorted(d for d in os.listdir(self.directory)
                       if re.fullmatch(r"step_\d{8}", d))
        for d in steps[: -self.keep_periodic]:
            os.remove(self._path(d))
            cfg = self._path(f"{d}.config.json")
            if os.path.exists(cfg):
                os.remove(cfg)

    def load(self, name: str, map_location=None) -> dict:
        """The checkpoint's dict, its tensors on ``map_location``."""
        path = self._path(name)
        self._recover_swap(path)
        return torch.load(path, map_location=map_location, weights_only=True)

    def restore(self, name: str, state):
        """Load checkpoint ``name`` into ``state`` (a ``WordGanState`` of
        the same config) in place, onto its device; returns it."""
        dev = next(state.gen.model.parameters()).device
        return load_payload(state, self.load(name, dev))

    def load_config(self, name: str) -> WordGanConfig:
        with open(self._path(f"{name}.config.json")) as f:
            return WordGanConfig.from_json(f.read())

    def latest_exists(self) -> bool:
        self._recover_swap(self._path("latest"))
        return os.path.exists(self._path("latest"))
