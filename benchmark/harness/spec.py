"""The benchmark's pieces, found by name: a cell is
``workloads/<cell>.json`` (its configuration, traffic mix, chips and why),
a configuration ``configs/<config>.json``, a traffic mix
``traffic/<mix>.json``, a per-layer metric ``metrics/<metric>.py`` (read
in the cells that its entry in ``BENCHMARK.json`` names), and a
configuration's reference parts ``reference/<kind>_<name>.py``: its style
encoder ``reference/style_<style_encoder>.py`` and its recognizer, with
the tap that reads the program's R, ``reference/rec_<recognizer>.py``
(``reference.models.part``; what a part file holds is in that module's
docstring).  Adding any of them is adding a file."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def _json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def names(kind: str) -> list[str]:
    suffix = ".py" if kind == "metrics" else ".json"
    return sorted(p.name[:-len(suffix)]
                  for p in (HERE / kind).glob(f"*{suffix}"))


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def cell(name: str) -> dict:
    """The cell with its configuration and traffic mix read in."""
    c = _json("workloads", name)
    return dict(c, name=name, config_file=config(c["config"]),
                traffic_mix=traffic(c["traffic"]))


def metric(name: str):
    """The reader module of a per-layer metric: ``LAYER``, ``UNIT``,
    ``SOURCE``, ``MOVES`` and ``read(ctx) -> float | None``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench() -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return json.loads((HERE.parent / "BENCHMARK.json").read_text())


def metrics_of(cell: str, e2e: str) -> dict:
    """The reader of every per-layer metric that ``BENCHMARK.json`` gives
    the cell: those that list it under ``workloads`` or, without that key,
    every one that moves the cell's end-to-end metric ``e2e``."""
    return {m["name"]: metric(m["name"]) for m in bench()["per_layer"]
            if m["moves"] == e2e and cell in m.get("workloads", [cell])}
