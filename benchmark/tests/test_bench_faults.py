"""A run with the timed path broken underneath comes out not correct, one
test for each fault a cell can have, on the CPU at a tiny size (the look
for a card skipped); and on the card the control fails each cell's limits
at the cell's own size."""

import copy
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.harness import spec
from benchmark.harness.checks import checks_of, is_correct
from benchmark.harness.serve import serve
from benchmark.harness.train import train
from benchmark.tests import tiny

DEV = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[2]


def verdict(cell, numbers) -> bool:
    return is_correct(checks_of(numbers, cell["check"]["limits"]))


def alter_token(out):
    imgs, ids, *rest = out
    ids = ids.clone()
    ids[0, 0] = (ids[0, 0] + 27) % 55
    return imgs, ids, *rest


def alter_answer(out):
    imgs, ids, *rest = out
    imgs = imgs.clone()
    imgs[0] = -imgs[0]
    return imgs, ids, *rest


@pytest.mark.parametrize("mutate", [alter_token, alter_answer])
@pytest.mark.parametrize("cell", [tiny.synth, tiny.preview])
def test_serving_fault_is_caught(cell, mutate):
    c = cell()
    sound = serve(c, 31, 1.5, None, DEV, 0.0)["numbers"]
    broken = serve(c, 31, 1.5, None, DEV, 0.0, mutate=mutate)["numbers"]
    assert verdict(c, broken) is False, (sound, broken)


def left_unchanged(*players):
    """A step that returns these players' state as it found it, the others
    updated; one player alone is a minority of the leaves, which the
    pooled medians miss."""
    def fault(step):
        def run(state, batch, gen, on_phase=None):
            keep = {n: copy.deepcopy(getattr(state, n).model.state_dict())
                    for n in players}
            out = step(state, batch, gen, on_phase)
            for n, sd in keep.items():
                getattr(state, n).model.load_state_dict(sd)
                getattr(state, n).opt.state.clear()
            return out
        return run
    fault.__name__ = ("unchanged" if len(players) == 4
                      else f"{players[0]}_unchanged")
    return fault


def half_batch(step):
    """Half of the batch left out, the mean taken over the rest."""
    def run(state, batch, gen, on_phase=None):
        return step(state, {k: v[:len(v) // 2] for k, v in batch.items()},
                    gen, on_phase)
    return run


@pytest.mark.parametrize("fault", [
    left_unchanged("gen", "dis", "cla", "rec"), half_batch,
    left_unchanged("dis"), left_unchanged("rec")], ids=lambda f: f.__name__)
def test_train_fault_is_caught(fault):
    c = tiny.train()
    broken = train(c, 41, 1.0, None, DEV, 0.0, fault=fault)["numbers"]
    assert verdict(c, broken) is False, broken


@pytest.mark.card
@pytest.mark.parametrize("name,control", [
    ("word-resnet50.synth-bulk", "w8a8"), ("word-resnet50.synth-bulk", "fp8"),
    ("word-resnet50.train-b8", "fp8"), ("word-dinov2l.preview", "fp8")])
def test_control_fails_on_the_card(card, name, control):
    """The control (``control.py``) at the cell's own size reads over a
    limit on three seeds."""
    import json

    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "control.py"),
         "--workload", name, "--seeds", "101,102,103", "--seconds", "3",
         "--control", control], capture_output=True, text=True,
        check=True).stdout
    cell = spec.cell(name)
    for line in out.strip().splitlines():
        assert verdict(cell, json.loads(line)["numbers"]) is False, line
