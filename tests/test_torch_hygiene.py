"""The port stands alone: no jax, flax or JAX-package import, no data file
read from the JAX package, and no silent CPU run."""

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
        make_generate_and_read_quant_fn,
        make_generate_fn,
    )
    from affganwriting_torch.train.eval_step import make_eval_step
    from affganwriting_torch.train.state import init_state
    from affganwriting_torch.train.step import (
        make_phased_train_step,
        make_train_step,
    )
    from test_torch_support import small_torch_config

    from affganwriting_torch.cli import bench, bench_kernels
    from affganwriting_torch.entry import entry
    from affganwriting_torch.train.htr_trainer import HTRTrainer
    from affganwriting_torch.train.teacher import DeviceTrOCRTeacher

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    trocr = small_torch_config(recognizer="trocr", rec_frozen=True)
    for fn, cfg in [(fn, small_torch_config()) for fn in (
            build_models, build_generator, build_recognizer,
            make_generate_fn, make_generate_and_read_fn,
            make_generate_and_read_quant_fn, init_state,
            make_phased_train_step, make_train_step, make_eval_step,
            HTRTrainer, DeviceTrOCRTeacher)] + [
            (build_recognizer, trocr), (init_state, trocr)]:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(cfg)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(cfg, device="cuda")
    from types import SimpleNamespace

    from affganwriting_torch.gen.inference import make_sharded_pipeline
    from affganwriting_torch.parallel.mesh import make_mesh
    from affganwriting_torch.parallel.multihost import init_distributed

    on_card = SimpleNamespace(device=torch.device("cuda"), data=1, model=1,
                              data_rank=0)
    for run in (lambda: make_sharded_pipeline(small_torch_config(), on_card),
                init_distributed, lambda: init_distributed(device="cuda"),
                make_mesh, lambda: make_mesh(device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()
    for run in (entry, lambda: entry(device="cuda"),
                lambda: bench.main(["--batch", "8", "--quick"]),
                lambda: bench.main(["--batch", "8", "--headline", "int8"]),
                lambda: bench_kernels.main(["--batch", "8"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()


def test_trainer_and_clis_need_a_card_or_an_explicit_cpu(tmp_path,
                                                         monkeypatch):
    """The trainers (the word and the line GAN's, the AE pretrainer),
    ``train_word``'s builder and the other CLIs (the teacher phase's two,
    ``train_htr``, ``train_line``, ``get_styles``, the line pretrainers,
    ``evaluate_line``, ``line_repl`` and the two profilers among them),
    the int8 and subpixel A/B tools, ``restore_line_trainer``, ``extract_styles``,
    ``generate_lines``, ``evaluate_lines`` and the app's backend raise
    before they build or write anything."""
    import json
    from types import SimpleNamespace

    from affganwriting_torch.cli import (
        evaluate_line,
        get_styles,
        line_repl,
        profile_gen,
        profile_pipeline,
        train_auto,
        train_hwr,
        train_line,
    )
    from affganwriting_torch.core.checkpoint import restore_line_trainer
    from affganwriting_torch.eval.line_eval import evaluate_lines
    from affganwriting_torch.train.auto_trainer import AutoTrainer
    from affganwriting_torch.gen.line_inference import (
        extract_styles,
        generate_lines,
    )
    from affganwriting_torch.serve import app
    from affganwriting_torch.train.line_trainer import LineGanTrainer

    from affganwriting_torch.cli import (
        generate_word,
        inspect_ckpt,
        teacher_check,
        teacher_phase,
        train_htr,
        train_word,
    )
    from affganwriting_torch.tools import (
        ab_int8_cer,
        ab_int8_static,
        ab_subpixel_quality,
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
    for cli in (train_word, teacher_check, train_htr, profile_pipeline,
                profile_gen):
        monkeypatch.setattr(cli, "default_config", small_torch_config)
    for extra in ([], ["--device", "cuda"]):
        for run in (
                lambda: train_word.build_trainer(
                    ["--logdir", str(tmp_path / "run")] + extra),
                lambda: generate_word.main(["--out", str(tmp_path / "gen")]
                                           + extra),
                lambda: inspect_ckpt.main([str(tmp_path / "ck")] + extra),
                lambda: teacher_phase.main(
                    ["--ckpt", str(tmp_path / "ck"), "--out",
                     str(tmp_path / "tp")] + extra),
                lambda: teacher_check.main(["--out", str(tmp_path / "tc")]
                                           + extra),
                lambda: train_htr.main(["--logdir", str(tmp_path / "htr")]
                                       + extra),
                lambda: ab_int8_cer.main(["--ckpt", str(tmp_path / "ck")]
                                         + extra),
                lambda: ab_subpixel_quality.main(
                    ["--ckpt", str(tmp_path / "ck")] + extra),
                lambda: ab_int8_static.main(["--batch", "8"])):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                run()
    assert not any((tmp_path / d).exists()
                   for d in ("run", "gen", "ck", "tp", "tc", "htr"))
    line_ck = tmp_path / "line_ck"
    line_ck.mkdir()
    (line_ck / "latest.config.json").write_text(json.dumps(
        LineGanTrainer(device="cpu").config_dict))
    on_card = SimpleNamespace(device=torch.device("cuda"))
    for kw, extra in (({}, []), ({"device": "cuda"}, ["--device", "cuda"])):
        for run in (
                lambda: LineGanTrainer(**kw),
                lambda: restore_line_trainer(str(line_ck), **kw),
                lambda: extract_styles(on_card, None, []),
                lambda: generate_lines(on_card, None, ["a"], None, None),
                lambda: train_line.main(
                    ["--logdir", str(tmp_path / "line")] + extra),
                lambda: get_styles.main(
                    ["--out", str(tmp_path / "s.pkl")] + extra),
                lambda: app._load_backend(**kw),
                lambda: app.main(["--selftest"] + extra),
                lambda: AutoTrainer(**kw),
                lambda: evaluate_lines(on_card, None, [], None),
                lambda: train_auto.main(
                    ["--logdir", str(tmp_path / "auto")] + extra),
                lambda: train_hwr.main(
                    ["--logdir", str(tmp_path / "hwr")] + extra),
                lambda: evaluate_line.main(
                    ["--out", str(tmp_path / "e.json")] + extra),
                lambda: line_repl.main(["--out", str(tmp_path / "repl")]
                                       + extra),
                lambda: profile_pipeline.main(["--batch", "4"] + extra),
                lambda: profile_gen.main(["--batch", "4"] + extra)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                run()
    assert not any((tmp_path / d).exists() for d in (
        "line", "s.pkl", "auto", "hwr", "e.json", "repl"))


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


_ALONE = """
import sys
from affganwriting_torch.data import iam, lines, parse_iam, wiki_text
from affganwriting_torch.data.lines import LineCharset, TextData

cs = LineCharset()
paths = iam.default_reference_paths()
gt = iam.parse_groundtruth(paths["train_gt"])
corpus = iam.load_corpus(paths["corpus"])
text = TextData(cs, max_len=20, seed=0)
assert cs.n_class == 80 and len(gt) > 100 and len(corpus) > 1000, (
    cs.n_class, len(gt), len(corpus))
assert all(p.startswith(sys.argv[1]) for p in paths.values()), paths
assert lines._REF_DATA.startswith(sys.argv[1]), lines._REF_DATA
bad = [m for m in sys.modules if m.split(".")[0] == "affganwriting_tpu"]
assert not bad, bad
print("alone ok")
"""


def test_port_reads_its_own_data_files(tmp_path):
    """``affganwriting_torch/`` copied alone, with no ``affganwriting_tpu/``
    on disk beside it, loads the line charset, the text corpus, the word
    ground truth and the word corpus from its own ``data/assets``."""
    import shutil

    shutil.copytree(ROOT / "affganwriting_torch",
                    tmp_path / "affganwriting_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items()
           if k not in ("AFFGAN_LINE_DATA", "AFFGAN_WORD_DATA")}
    env["PYTHONPATH"] = str(tmp_path)
    proc = subprocess.run([sys.executable, "-c", _ALONE, str(tmp_path)],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "alone ok" in proc.stdout
