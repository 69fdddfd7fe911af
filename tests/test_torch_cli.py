"""The port's CLIs on the CPU: ``--help``, a 1-epoch ``train_word``, a
``generate_word`` chunk from its checkpoint (greedy and beam) and
``inspect_ckpt``; ``quality_report`` and ``evaluate`` on a checkpoint
trained with the ``cnn`` style encoder, with PIL and without; the flags
of the JAX CLIs that wait for later work; and ``train_line``'s IAM and
pretrained flags reaching their readers.

The run uses a small configuration (tests/test_torch_support.py's, with
resnet18 and batch 2 to keep the checkpoint small) in place of
``train_word``'s ``default_config()``, and ``--device cpu``.  TensorBoard is kept out (its import pulls in a large
framework here).
"""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import numpy as np

from affganwriting_torch.cli import (
    evaluate,
    evaluate_line,
    generate_word,
    get_styles,
    inspect_ckpt,
    line_repl,
    profile_gen,
    profile_pipeline,
    quality_report,
    train_auto,
    train_hwr,
    train_line,
    train_word,
)
from affganwriting_torch.serve import app
from affganwriting_torch.core.config import VOCAB
from affganwriting_torch.models.style_encoders import available
from affganwriting_torch.train.state import param_count
from test_torch_support import TRAIN_SMALL, small_torch_config

torch.set_num_threads(2)   # tier-1 runs six xdist workers


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    import affganwriting_torch.utils.logging as logging

    monkeypatch.setattr(logging, "summary_writer", lambda logdir: None)


@pytest.mark.parametrize(
    "cli", [train_word, generate_word, inspect_ckpt, evaluate,
            quality_report, train_line, get_styles, app, train_auto,
            train_hwr, evaluate_line, line_repl, profile_pipeline,
            profile_gen],
    ids=["train_word", "generate_word", "inspect_ckpt", "evaluate",
         "quality_report", "train_line", "get_styles", "app", "train_auto",
         "train_hwr", "evaluate_line", "line_repl", "profile_pipeline",
         "profile_gen"])
def test_help(cli, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0
    assert "--device" in capsys.readouterr().out


@pytest.mark.parametrize("flags,item", [
    pytest.param(["--mesh", "auto"], "torch.distributed.run",
                 id="flags0-item 10"),
    (["--trocr-ckpt", "ckpt"], "requires --recognizer trocr"),
    (["--recognizer", "trocr", "--trocr-preset", "tiny", "--trocr-ckpt",
      "ckpt"], "cannot load into --trocr-preset tiny"),
    (["--recognizer", "trocr", "--trocr-ckpt", "no/such/dir"],
     "not a readable local HF checkpoint directory"),
    (["train_line", "--xml-root", "no/such/xml"], "no/such/xml"),
    pytest.param(["train_line", "--mesh", "2"], "torch.distributed.run",
                 id="flags5-item 10"),
    (["train_line", "--pretrained-hwr", "no/such/hwr_final"],
     "no/such/hwr_final"),
    (["train_line", "--pretrained-ae", "no/such/ae_final"],
     "no/such/ae_final"),
    (["train_line", "--config", "configs/cf_synth_charSpecMulti.json", "-a",
      "trainer.encoder_weights=no/such/ae_final"], "no/such/ae_final"),
    (["line_trainer", "pretrained_hwr"], "no/such/pretrained_hwr"),
    (["line_trainer", "pretrained_ae"], "no/such/pretrained_ae")])
def test_unported_flags_name_their_roadmap_item(flags, item, tmp_path):
    """The refusals: ``--mesh`` outside the launcher names it (in
    ``train_word``, ``generate_word`` and ``train_line``; the cases keep
    their ids from when ``--mesh`` waited for ROADMAP item 10); the TrOCR
    flags are refused by the JAX CLI's own rules.  ``train_line``'s IAM line
    data and pretrained HWR and AE (flags, the config's
    ``trainer.encoder_weights``, or the trainer's own arguments) are
    ported: a path that does not exist reaches the IAM reader or the
    splice, which raise ``FileNotFoundError`` naming it."""
    from pathlib import Path

    from affganwriting_torch.train.line_trainer import LineGanTrainer

    if flags[0] == "train_line":
        root = Path(__file__).resolve().parents[1]
        argv = [str(root / a) if a.startswith("configs/") else a
                for a in flags[1:]]
        exc = SystemExit if "--mesh" in flags else FileNotFoundError
        with pytest.raises(exc, match=item):
            train_line.main(argv + ["--device", "cpu", "--logdir",
                                    str(tmp_path / "line")])
        return
    if flags[0] == "line_trainer":
        trainer = LineGanTrainer(device="cpu",
                                 **{flags[1]: f"no/such/{flags[1]}"})
        with pytest.raises(FileNotFoundError, match=item):
            trainer.init_state()
        return
    with pytest.raises(SystemExit, match=item):
        train_word.main(flags + ["--device", "cpu"])
    if flags[0] == "--mesh":
        with pytest.raises(SystemExit, match=item):
            generate_word.main(flags + ["--device", "cpu"])


@pytest.mark.parametrize("cli", [train_word, generate_word],
                         ids=["train_word", "generate_word"])
def test_style_encoder_takes_the_ten_keys(cli, capsys):
    """Every registry key is a choice (the encoders themselves are held
    against the JAX package in tests/test_torch_style_encoders.py);
    anything else is refused by the parser."""
    assert len(available()) == 10
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    out = " ".join(capsys.readouterr().out.split())
    assert "{" + ",".join(available()) + "}" in out
    with pytest.raises(SystemExit) as e:
        cli.main(["--style-encoder", "resnet101", "--device", "cpu"])
    assert e.value.code == 2


def _until_end(row) -> list:
    row = list(row)
    return row[: row.index(VOCAB.end)] if VOCAB.end in row else row


def test_train_generate_inspect(tmp_path, capsys, monkeypatch):
    cfg = small_torch_config(**TRAIN_SMALL)
    monkeypatch.setattr(train_word, "default_config", lambda: cfg)
    logdir = tmp_path / "run"
    trainer = train_word.main([
        "--style-encoder", "resnet18", "--batch-size", "2",
        "--compute-dtype", "float32", "--epochs", "1", "--max-writers", "4", "--eval-every", "1",
        "--restart-rss-gb", "0", "--logdir", str(logdir), "--device", "cpu"])
    cfg = cfg.replace(style_encoder="resnet18", batch_size=2)
    assert trainer.config == cfg
    assert trainer.state.step == 2
    groups = [json.loads(s)["group"] for s in open(logdir / "metrics.jsonl")]
    assert groups == ["train", "eval"]
    assert (logdir / "ckpt" / "latest").exists()
    assert (logdir / "ckpt" / "best").exists()

    out = {}
    for beam in (0, 1, 3):
        out[beam] = generate_word.main([
            "--ckpt", str(logdir / "ckpt"), "--ckpt-name", "best",
            "--corpus", "ladder", "--max-writers", "1", "--beam", str(beam),
            "--out", str(tmp_path / f"gen{beam}"), "--device", "cpu"])
        files = list((tmp_path / f"gen{beam}").iterdir())
        assert len(files) == len(out[beam]["files"]) == 17
        assert all(f.name.endswith((".png", ".png.npy")) for f in files)
        ids = out[beam]["pred_ids"]
        assert ids.shape == (17, cfg.output_max_len - 1)
        assert ids.min() >= 0 and ids.max() < VOCAB.size
    # a width-1 beam reads as the greedy path, up to the first END
    assert [_until_end(r) for r in out[1]["pred_ids"]] == \
        [_until_end(r) for r in out[0]["pred_ids"]]

    capsys.readouterr()
    shown = inspect_ckpt.main([str(logdir / "ckpt"), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert shown["step"] == 2
    assert shown["param_counts"] == param_count(trainer.state)
    for n, count in shown["param_counts"].items():
        assert count > 0 and f'"{n}": {count}' in printed


def test_quality_report_and_evaluate(tmp_path, capsys, monkeypatch):
    """``train_word`` with ``--style-encoder cnn`` (1 epoch), then
    ``quality_report`` on its ``best`` for 2 writers x 4 real words (the 80
    OOV words generated per writer) and ``evaluate`` on the two folders, with
    and without ``--per-writer``; then again without PIL, where every word
    is written and read as ``.png.npy``.  The report's CER is
    ``cer_of_folder``'s, its FID and WID finite.  To fit a CPU test the
    InceptionV3 front end resizes to 75x75 (the smallest input its stem
    takes) instead of 299x299, and FID keeps the first 64 pool3 features
    (a 2048x2048 sqrtm takes ~28 s here); tests/test_torch_eval.py holds
    both against the JAX package at full size."""
    import sys

    from affganwriting_torch.eval import fid, inception_v3
    from affganwriting_torch.eval.generated import cer_of_folder
    from affganwriting_torch.models.blocks import resize_bilinear

    cfg = small_torch_config(**TRAIN_SMALL)
    monkeypatch.setattr(train_word, "default_config", lambda: cfg)
    monkeypatch.setattr(inception_v3, "resize_bilinear",
                        lambda x, size: resize_bilinear(x, (75, 75)))
    acts = fid.FIDScorer.activations
    monkeypatch.setattr(fid.FIDScorer, "activations",
                        lambda self, x: acts(self, x)[:, :64])
    monkeypatch.delenv("AFFGAN_INCEPTION_PTH", raising=False)
    monkeypatch.setattr(fid, "find_inception_weights", lambda: None)
    logdir = tmp_path / "run"
    train_word.main([
        "--style-encoder", "cnn", "--batch-size", "2", "--compute-dtype",
        "float32", "--epochs", "1", "--max-writers", "4", "--eval-every",
        "1", "--restart-rss-gb", "0", "--logdir", str(logdir),
        "--device", "cpu"])
    for pil in (True, False):
        if not pil:
            monkeypatch.setitem(sys.modules, "PIL", None)
        out = tmp_path / f"q{pil}"
        capsys.readouterr()
        report = quality_report.main([
            "--ckpt", str(logdir / "ckpt"), "--max-writers", "2",
            "--words-per-writer", "4", "--out", str(out), "--device",
            "cpu"])
        assert json.loads(capsys.readouterr().out.splitlines()[-1]) == \
            report == json.load(open(out / "report.json"))
        assert set(report) == {
            "scenario", "ckpt", "cer", "fid_provenance",
            "fid_random_features", "wid_fid_random_features", "seconds"}
        assert set(report["seconds"]) == {"generate", "real_set",
                                          "activations", "frechet"}
        assert report["fid_provenance"] == "random_features:torch:seed=0"
        gen, real = out / "generated", out / "real"
        suffix = ".png" if pil else ".png.npy"
        assert all(f.name.endswith(suffix) for f in gen.iterdir())
        names = [f.name for f in real.iterdir()]
        assert len(names) == 8 and all(re.fullmatch(
            r"[^-]+-[0-3]\.real" + re.escape(suffix), n) for n in names)
        assert report["cer"] == cer_of_folder(str(gen))
        assert report["cer"]["count"] == 160
        for key in ("fid_random_features", "wid_fid_random_features"):
            assert np.isfinite(report[key]), key
        for extra, key in (([], "fid_random_features"),
                           (["--per-writer"], "wid_fid_random_features")):
            res = evaluate.main([str(gen), "--real", str(real), "--device",
                                 "cpu"] + extra)
            assert set(res) == {"cer", "fid_provenance", key}
            assert res["cer"] == report["cer"]
            assert res[key] == pytest.approx(report[key], rel=1e-6)


TESTS = Path(__file__).resolve().parent


def _launch(n: int, cli: str, *argv: str) -> str:
    """``cli`` on ``n`` CPU ranks under ``torch.distributed.run`` (a free
    port of localhost), at the small configuration of
    ``tests/torch_cli_ranks.py``; returns the output."""
    env = {**os.environ, "PYTHONHASHSEED": "0",
           "PYTHONPATH": f"{TESTS.parent}{os.pathsep}{TESTS}"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), str(TESTS / "torch_cli_ranks.py"),
           cli, *argv, "--device", "cpu"]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    return proc.stdout + proc.stderr


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """``train_word --mesh 2`` on two CPU ranks: one epoch of one step
    (batch 2, a word a rank) and its evaluation."""
    logdir = tmp_path_factory.mktemp("mesh") / "run"
    out = _launch(2, "train_word", "--mesh", "2", "--style-encoder",
                  "resnet18", "--batch-size", "2", "--max-writers", "2",
                  "--epochs", "1", "--restart-rss-gb", "0", "--logdir",
                  str(logdir), "--compute-dtype", "float32")
    yield logdir, out
    shutil.rmtree(logdir / "ckpt")      # two files of ~0.55 GB


def test_train_word_on_two_cpu_ranks(mesh_run):
    """One step on the mesh; rank 0 alone writes the metrics and one set
    of checkpoint files, which hold one step."""
    logdir, out = mesh_run
    assert out.count("mesh: {'data': 2, 'model': 1}") == 1
    lines = [json.loads(s) for s in open(logdir / "metrics.jsonl")]
    assert [r["group"] for r in lines] == ["train", "eval"]
    assert all(np.isfinite(r["l_total"]) for r in lines[:1])
    assert sorted(os.listdir(logdir / "ckpt")) == [
        "best", "best.config.json", "best.metric.json", "latest",
        "latest.config.json"]
    payload = torch.load(logdir / "ckpt" / "latest", weights_only=True)
    assert payload["step"] == 1


def test_generate_word_on_two_cpu_ranks(mesh_run, tmp_path):
    """``generate_word --mesh 2`` (chunks of 7 words padded to 8, 4 a rank)
    writes the files ``--mesh none`` writes, with the same pixels."""
    logdir, _ = mesh_run
    args = ["--ckpt", str(logdir / "ckpt"), "--ckpt-name", "latest",
            "--corpus", "ladder", "--max-writers", "1", "--words-per-batch",
            "7"]
    _launch(2, "generate_word", "--mesh", "2", *args, "--out",
            str(tmp_path / "mesh"))
    # one process, under the same string-hash seed (the style stacks are
    # synthetic words seeded from hash(word))
    _launch(1, "generate_word", "--mesh", "none", *args, "--out",
            str(tmp_path / "one"))
    names = sorted(os.listdir(tmp_path / "one"))
    assert len(names) == 17
    assert sorted(os.listdir(tmp_path / "mesh")) == names
    for name in names:
        a, b = (_read_image(tmp_path / d / name) for d in ("one", "mesh"))
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, name


def _read_image(path) -> np.ndarray:
    if str(path).endswith(".npy"):
        return np.load(path)
    from PIL import Image

    return np.asarray(Image.open(path))


def test_train_line_on_two_cpu_ranks(tmp_path):
    """``train_line --mesh 2``: one iteration over 4 lines, 2 a rank; rank
    0 writes the one checkpoint."""
    out = _launch(2, "train_line", "--mesh", "2", "--max-gen-length", "32",
                  "--width", "128", "--iterations", "1", "--val-every", "0",
                  "--logdir", str(tmp_path / "line"))
    ckpt = tmp_path / "line" / "ckpt"
    try:
        assert out.count("mesh: {'data': 2, 'model': 1}") == 1
        assert sorted(os.listdir(ckpt)) == ["latest", "latest.config.json"]
        payload = torch.load(ckpt / "latest", weights_only=True)
        assert payload["iteration"] == 1
    finally:
        shutil.rmtree(ckpt)             # ~0.63 GB


def test_dryrun_multichip_prints_its_ok_line(capsys):
    """``entry.dryrun_multichip(4)``: 4 CPU ranks, data=2 x model=2, two
    steps and a checkpoint round trip."""
    from affganwriting_torch.entry import dryrun_multichip

    line = dryrun_multichip(4, timeout_s=240)
    assert line.startswith("dryrun_multichip ok on 4 ranks: mesh data=2 x "
                           "model=2")
    assert line in capsys.readouterr().out
