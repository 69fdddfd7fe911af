"""The port stands alone: no jax, flax or JAX-package import, and no silent
CPU run."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)   # tier-1 runs six xdist workers

ROOT = Path(__file__).resolve().parents[1]

_CHECK = """
import importlib, pkgutil, sys
import affganwriting_torch
names = [m.name for m in pkgutil.walk_packages(
    affganwriting_torch.__path__, "affganwriting_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "affganwriting_tpu"))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 20, names
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_need_a_card_or_an_explicit_cpu():
    from affganwriting_torch.gen.inference import (
        build_generator,
        build_models,
        build_recognizer,
        make_generate_and_read_fn,
        make_generate_fn,
    )
    from affganwriting_torch.train.eval_step import make_eval_step
    from affganwriting_torch.train.state import init_state
    from affganwriting_torch.train.step import (
        make_phased_train_step,
        make_train_step,
    )
    from test_torch_support import small_torch_config

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    for fn in (build_models, build_generator, build_recognizer,
               make_generate_fn, make_generate_and_read_fn, init_state,
               make_phased_train_step, make_train_step, make_eval_step):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(small_torch_config())
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(small_torch_config(), device="cuda")


def test_trainer_and_clis_need_a_card_or_an_explicit_cpu(tmp_path,
                                                         monkeypatch):
    """The trainer, ``train_word``'s builder and the other CLIs raise
    before they build or write anything."""
    from affganwriting_torch.cli import (
        generate_word,
        inspect_ckpt,
        train_word,
    )
    from affganwriting_torch.train.loop import WordGanTrainer
    from test_torch_support import small_torch_config

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            WordGanTrainer(small_torch_config(), [], logdir=str(tmp_path),
                           **kw)
    assert not (tmp_path / "ckpt").exists()
    monkeypatch.setattr(train_word, "default_config", small_torch_config)
    for extra in ([], ["--device", "cuda"]):
        for run in (
                lambda: train_word.build_trainer(
                    ["--logdir", str(tmp_path / "run")] + extra),
                lambda: generate_word.main(["--out", str(tmp_path / "gen")]
                                           + extra),
                lambda: inspect_ckpt.main([str(tmp_path / "ck")] + extra)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                run()
    assert not any((tmp_path / d).exists() for d in ("run", "gen", "ck"))


def test_fid_and_evaluation_clis_need_a_card_or_an_explicit_cpu(tmp_path):
    """``FIDScorer``, ``cli/evaluate`` with a real folder and
    ``cli/quality_report`` raise before they score or write anything."""
    from affganwriting_torch.cli import evaluate, quality_report
    from affganwriting_torch.eval.fid import FIDScorer

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    (tmp_path / "gen").mkdir()
    for extra in ([], ["--device", "cuda"]):
        for run in (
                lambda: FIDScorer(**({"device": "cuda"} if extra else {})),
                lambda: evaluate.main([str(tmp_path / "gen"), "--real",
                                       str(tmp_path / "gen")] + extra),
                lambda: quality_report.main(
                    ["--ckpt", str(tmp_path / "ck"), "--out",
                     str(tmp_path / "q")] + extra)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                run()
    assert not (tmp_path / "q").exists()
    assert FIDScorer(device="cpu").device.type == "cpu"


def test_kernel_wrappers_refuse_an_input_that_requires_grad():
    """The kernels are forward-only: with grad mode on, a CUDA input that
    requires grad raises instead of returning an output without a
    ``grad_fn``.  The wrappers take their plain versions on the CPU before
    reaching the guard, so the guard they call is tested here."""
    from affganwriting_torch.ops.cuda_build import refuse_autograd

    x = torch.zeros(2, 8, requires_grad=True)
    for what in ("in_relu", "phase_head"):
        with pytest.raises(RuntimeError, match=f"{what}: the kernel is "
                           "forward-only"):
            refuse_autograd(what, torch.zeros(3), x)
    with torch.no_grad():
        refuse_autograd("in_relu", x)
    with torch.inference_mode():
        refuse_autograd("phase_head", x)
    refuse_autograd("in_relu", x.detach())
