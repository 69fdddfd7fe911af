"""Checkpoints of the word and line GANs: latest, periodic and best.

The port of ``affganwriting_tpu/core/checkpoint.py``.  A
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
``recover_swap`` promotes the latter after a crash between the renames.

The line GAN (``LineCheckpointManager``, ``restore_line_trainer``): the
payload is ``{"state": {"step", "model", "disc", "ae": state dicts (the
main tree, the frozen HWR and its BatchNorm statistics; D with its
spectral-norm ``u``/``sigma``; the AE), "main_opt", "disc_opt": optimizer
state dicts}, "swa": {"avg": {name: tensor}, "count"}, "iteration"}``, the
explicit iteration being the curriculum clock; the trainer's constructor
config rides beside it as ``<name>.config.json``, from which generation
and the app rebuild the model (the reference's generate.py:88-97).
"""

from __future__ import annotations

import json
import os
import re

import torch

from affganwriting_torch.core.config import WordGanConfig
from affganwriting_torch.train.schedules import host_step_counts
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
            player.opt.load_state_dict(host_step_counts(saved["opt"]))
    return state


def recover_swap(path: str) -> None:
    """Finish a swap that stopped between its two renames: ``<path>``
    missing beside a complete ``<path>.new`` -> promote it; drop a
    left-over ``<path>.old``."""
    new, old = f"{path}.new", f"{path}.old"
    if not os.path.exists(path) and os.path.exists(new):
        os.rename(new, path)
    if os.path.exists(old):
        os.remove(old)


def save_swap(path: str, payload: dict) -> None:
    """``torch.save`` ``payload`` to ``path`` by the swap above: never a
    half-written ``path``."""
    recover_swap(path)
    new, tmp, old = f"{path}.new", f"{path}.new.tmp", f"{path}.old"
    torch.save(payload, tmp)
    os.replace(tmp, new)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(new, path)
    if os.path.exists(old):
        os.remove(old)


def load_swapped(path: str, map_location="cpu") -> dict:
    """The payload ``save_swap`` wrote to ``path``."""
    recover_swap(path)
    return torch.load(path, map_location=map_location, weights_only=True)


class CheckpointManager:
    """``write=False`` (a rank other than 0 on a mesh) keeps the
    bookkeeping (the best metric so far) and reads, but writes, renames
    and prunes nothing: rank 0 writes for all."""

    def __init__(self, directory: str, keep_periodic: int = 5,
                 write: bool = True):
        self.directory = os.path.abspath(directory)
        self.write = write
        if write:
            os.makedirs(self.directory, exist_ok=True)
        self.keep_periodic = keep_periodic
        self._best_metric: float | None = None
        best_path = self._path("best.metric.json")
        if os.path.exists(best_path):
            with open(best_path) as f:
                self._best_metric = float(json.load(f)["metric"])

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def save(self, name: str, state, config: WordGanConfig) -> None:
        if not self.write:
            return
        save_swap(self._path(name), state_payload(state))
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
            if self.write:
                with open(self._path("best.metric.json"), "w") as f:
                    json.dump({"metric": metric}, f)
            return True
        return False

    def _prune(self) -> None:
        if not self.write:
            return
        steps = sorted(d for d in os.listdir(self.directory)
                       if re.fullmatch(r"step_\d{8}", d))
        for d in steps[: -self.keep_periodic]:
            os.remove(self._path(d))
            cfg = self._path(f"{d}.config.json")
            if os.path.exists(cfg):
                os.remove(cfg)

    def load(self, name: str, map_location=None) -> dict:
        """The checkpoint's dict, its tensors on ``map_location``."""
        if not self.write:       # rank 0 finishes an interrupted swap
            return torch.load(self._path(name), map_location=map_location,
                              weights_only=True)
        return load_swapped(self._path(name), map_location)

    def restore(self, name: str, state):
        """Load checkpoint ``name`` into ``state`` (a ``WordGanState`` of
        the same config) in place, onto its device; returns it.  A state
        placed on a mesh is loaded whole and sharded again (every rank of
        its model groups must call this)."""
        from affganwriting_torch.parallel.mesh import unsharded

        dev = next(state.gen.model.parameters()).device
        payload = self.load(name, dev)
        with unsharded(state):
            return load_payload(state, payload)

    def load_config(self, name: str) -> WordGanConfig:
        with open(self._path(f"{name}.config.json")) as f:
            return WordGanConfig.from_json(f.read())

    def latest_exists(self) -> bool:
        if self.write:
            recover_swap(self._path("latest"))
        return os.path.exists(self._path("latest"))


def line_payload(payload: dict) -> dict:
    """A line-trainer payload (``{"state": LineState, "swa", "iteration"}``)
    as the checkpoint's dict."""
    st = payload["state"]
    return {"state": {"step": int(st.step),
                      "model": st.model.state_dict(),
                      "disc": st.disc.state_dict(),
                      "ae": st.ae.state_dict(),
                      "main_opt": st.main_opt.state_dict(),
                      "disc_opt": st.disc_opt.state_dict()},
            "swa": {"avg": dict(payload["swa"]["avg"]),
                    "count": int(payload["swa"]["count"])},
            "iteration": int(payload["iteration"])}


def load_line_state(state, saved: dict):
    """Load a checkpoint's ``"state"`` dict into a ``LineState`` in place;
    returns it."""
    state.step = int(saved["step"])
    state.model.load_state_dict(saved["model"], strict=True)
    state.disc.load_state_dict(saved["disc"], strict=True)
    state.ae.load_state_dict(saved["ae"], strict=True)
    state.main_opt.load_state_dict(saved["main_opt"])
    state.disc_opt.load_state_dict(host_step_counts(saved["disc_opt"]))
    return state


class LineCheckpointManager(CheckpointManager):
    """The line stack's latest/periodic/best trio (the reference's
    base_trainer.py:340-399): ``line_payload`` of the trainer's payload,
    and the trainer's constructor config as JSON beside it."""

    def save(self, name: str, payload: dict, config: dict) -> None:
        if not self.write:
            return
        save_swap(self._path(name), line_payload(payload))
        with open(self._path(f"{name}.config.json"), "w") as f:
            json.dump(config, f, indent=2, sort_keys=True)

    def load_config(self, name: str) -> dict:
        with open(self._path(f"{name}.config.json")) as f:
            return json.load(f)


def restore_line_trainer(ckpt_dir: str, sample_batch: dict | None = None,
                         name: str = "latest", curriculum=None,
                         device=None, mesh=None):
    """Checkpoint directory -> (trainer, payload): the trainer rebuilt from
    the embedded config on ``device`` (``None``: the card) or on ``mesh``
    (every rank calls this and restores; rank 0 alone finishes a swap a
    crash left half done), a fresh state with the checkpoint loaded into
    it, the SWA slot and the iteration (the reference's
    base_trainer.py:410-479, generate.py:88-97)."""
    from affganwriting_torch.parallel.mesh import unsharded
    from affganwriting_torch.train.line_trainer import LineGanTrainer

    writer = True
    if mesh is not None:
        import torch.distributed as dist

        writer = dist.get_rank() == 0
        if writer:
            recover_swap(os.path.join(os.path.abspath(ckpt_dir), name))
        dist.barrier()
    mgr = LineCheckpointManager(ckpt_dir, write=writer)
    trainer = LineGanTrainer.from_config(mgr.load_config(name),
                                         curriculum=curriculum,
                                         device=device, mesh=mesh)
    state = trainer.init_state(sample_batch)
    saved = mgr.load(name, trainer.device)
    with unsharded(state):
        load_line_state(state, saved["state"])
    return trainer, {"state": state, "swa": saved["swa"],
                     "iteration": int(saved["iteration"])}
