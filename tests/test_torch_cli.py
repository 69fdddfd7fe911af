"""The port's CLIs on the CPU: ``--help``, a 1-epoch ``train_word``, a
``generate_word`` chunk from its checkpoint (greedy and beam) and
``inspect_ckpt``; ``quality_report`` and ``evaluate`` on a checkpoint
trained with the ``cnn`` style encoder, with PIL and without; and the
flags of the JAX CLIs that wait for later work.

The run uses a small configuration (tests/test_torch_support.py's, with
resnet18 and batch 2 to keep the checkpoint small) in place of
``train_word``'s ``default_config()``, and ``--device cpu``.  TensorBoard is kept out (its import pulls in a large
framework here).
"""

import json
import re

import pytest
import torch

import numpy as np

from affganwriting_torch.cli import (
    evaluate,
    generate_word,
    inspect_ckpt,
    quality_report,
    train_word,
)
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
            quality_report],
    ids=["train_word", "generate_word", "inspect_ckpt", "evaluate",
         "quality_report"])
def test_help(cli, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0
    assert "--device" in capsys.readouterr().out


@pytest.mark.parametrize("flags,item", [
    (["--mesh", "auto"], "item 10"), (["--recognizer", "trocr"], "item 8"),
    (["--trocr-preset", "tiny"], "item 8"),
    (["--trocr-ckpt", "ckpt"], "item 8")])
def test_unported_flags_name_their_roadmap_item(flags, item):
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
