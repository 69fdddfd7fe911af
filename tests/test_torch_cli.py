"""The port's CLIs on the CPU: ``--help``, a 1-epoch ``train_word``, a
``generate_word`` chunk from its checkpoint (greedy and beam) and
``inspect_ckpt``; and the flags of the JAX CLIs that wait for later work.

The run uses a small configuration (tests/test_torch_support.py's, with
resnet18 and batch 2 to keep the checkpoint small) in place of
``train_word``'s ``default_config()``, and ``--device cpu``.  TensorBoard is kept out (its import pulls in a large
framework here).
"""

import json

import pytest
import torch

from affganwriting_torch.cli import generate_word, inspect_ckpt, train_word
from affganwriting_torch.core.config import VOCAB
from affganwriting_torch.train.state import param_count
from test_torch_support import TRAIN_SMALL, small_torch_config

torch.set_num_threads(2)   # tier-1 runs six xdist workers


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    import affganwriting_torch.utils.logging as logging

    monkeypatch.setattr(logging, "summary_writer", lambda logdir: None)


@pytest.mark.parametrize("cli", [train_word, generate_word, inspect_ckpt],
                         ids=["train_word", "generate_word", "inspect_ckpt"])
def test_help(cli, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0
    assert "--device" in capsys.readouterr().out


@pytest.mark.parametrize("flags,item", [
    (["--mesh", "auto"], "item 10"), (["--recognizer", "trocr"], "item 8"),
    (["--trocr-preset", "tiny"], "item 8"),
    (["--style-encoder", "efficientnet_v2_l"], "item 8")])
def test_unported_flags_name_their_roadmap_item(flags, item):
    with pytest.raises(SystemExit, match=item):
        train_word.main(flags + ["--device", "cpu"])
    if flags[0] in ("--mesh", "--style-encoder"):
        with pytest.raises(SystemExit, match=item):
            generate_word.main(flags + ["--device", "cpu"])


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
