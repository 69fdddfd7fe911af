"""JSON configs of the line-generation stack.

The port's own copy of ``affganwriting_tpu/core/line_config.py`` (plain
json, no jax): JSON files with nested dicts, ``-a key.path=value`` dotted
overrides, name <-> file name agreement, the resume rule, and registries
that take the place of the reference's ``eval(config['arch'])``.  The
registries here are the port's and start empty: the line trainer
registers its archs and trainers.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Callable

ARCH_REGISTRY: dict[str, Callable] = {}
TRAINER_REGISTRY: dict[str, Callable] = {}


def register_arch(name: str):
    def deco(fn):
        ARCH_REGISTRY[name] = fn
        return fn
    return deco


def register_trainer(name: str):
    def deco(fn):
        TRAINER_REGISTRY[name] = fn
        return fn
    return deco


def load_config(path: str, overrides: list[str] | None = None,
                check_name: bool = True) -> dict:
    """The JSON config at ``path`` with ``overrides`` applied; with
    ``check_name``, ``config["name"]`` must be the file name without its
    ``cf_`` prefix and extension."""
    with open(path) as f:
        config = json.load(f)
    if check_name and "name" in config:
        stem = os.path.splitext(os.path.basename(path))[0]
        expected = stem[3:] if stem.startswith("cf_") else stem
        if config["name"] != expected:
            raise ValueError(
                f"config name {config['name']!r} != filename {expected!r}")
    for ov in overrides or []:
        apply_override(config, ov)
    return config


def apply_override(config: dict, override: str) -> None:
    """``trainer.curriculum.0=...``: a dotted-path assignment whose value
    is parsed as JSON where it parses, else kept as a string."""
    key, _, raw = override.partition("=")
    try:
        value: Any = json.loads(raw)
    except json.JSONDecodeError:
        value = raw
    node = config
    parts = key.split(".")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def merge_resume(config: dict, checkpoint_config: dict) -> dict:
    """The checkpoint's embedded config wins unless the file sets
    ``"override": true``."""
    if config.get("override"):
        return config
    merged = copy.deepcopy(checkpoint_config)
    merged.update({k: v for k, v in config.items() if k == "override"})
    return merged


def build_arch(config: dict):
    name = config["arch"] if "arch" in config else config["model"]["arch"]
    try:
        return ARCH_REGISTRY[name](config)
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; registered: {sorted(ARCH_REGISTRY)}"
        ) from None
