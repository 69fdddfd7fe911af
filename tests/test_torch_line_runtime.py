"""The port's line-GAN runtime on the CPU: ``LineGanTrainer.fit`` (latest,
periodic and best checkpoints, validation, SWA, sheets) and its resume;
``LineCheckpointManager`` (the swap-aside save, ``<name>.config.json``, the
best metric, pruning) and ``restore_line_trainer``; the ``train_line``
and ``get_styles`` CLIs and ``serve/app.py --selftest`` with ``--device
cpu``, without PIL.

``fit`` runs a small trainer (12 classes, style 16, generator 32, D dim 8,
AE dim 8, lines of 64 x 128); the CLIs build the trainer the JAX CLIs
build (80 classes, style 128, generator 256, D dim 64, the default AE) on
short lines (``--max-gen-length 32 --width 128``).  A restored state is
held bit for bit against the saved one (every parameter, statistic,
spectral-norm buffer, Adam moment and count, SWA and the iteration).
The JAX package's ``fit`` and checkpoints (orbax) are not run here: the
lesson steps and the rotation are held against it in
``test_torch_line_steps.py`` and ``test_torch_line_rotation.py``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from affganwriting_torch.core.checkpoint import (
    LineCheckpointManager,
    line_payload,
    load_line_state,
    restore_line_trainer,
)
from affganwriting_torch.train.line_trainer import LineGanTrainer
from test_torch_support import LINE_GAN, line_batch

torch.set_num_threads(2)   # tier-1 runs six xdist workers


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    import affganwriting_torch.utils.logging as logging

    monkeypatch.setattr(logging, "summary_writer", lambda logdir: None)


def _equal(got, want, where=""):
    """Bit-equality of two checkpoint dicts; returns the fields compared."""
    if isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want), \
            where
        return 1
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        return sum(_equal(got[k], want[k], f"{where}.{k}") for k in want)
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        return sum(_equal(g, w, f"{where}[{i}]")
                   for i, (g, w) in enumerate(zip(got, want)))
    assert got == want, (where, got, want)
    return 1


def _small_trainer(**kw):
    from affganwriting_torch.models.line.autoencoder import Autoencoder
    from affganwriting_torch.models.line.container import HWWithStyle
    from affganwriting_torch.models.line.discriminator import (
        DiscriminatorAP,
    )

    tr = LineGanTrainer(**LINE_GAN, device="cpu", **kw)
    torch.manual_seed(0)
    tr.model = HWWithStyle(gen_dim=32, **LINE_GAN)
    tr.disc = DiscriminatorAP(dim=8)
    tr.ae = Autoencoder(dim=8)
    return tr


def test_fit_checkpoints_validates_averages_and_resumes(tmp_path):
    from affganwriting_torch.utils.logging import MetricsLogger

    tr = _small_trainer(seed=1)
    state = tr.init_state()
    batches = [line_batch(seed=30 + i) for i in range(8)]
    ckpt = LineCheckpointManager(str(tmp_path / "ckpt"))
    logger = MetricsLogger(str(tmp_path))
    state = tr.fit(state, iter(batches), 5, log_every=1, logger=logger,
                   ckpt=ckpt, save_every=2, save_latest_every=1,
                   val_batches_fn=lambda: iter(batches[5:]), val_every=2,
                   val_max_batches=2, swa_start=3, sheet_every=2,
                   sheet_dir=str(tmp_path / "sheets"), restart_rss_gb=0)
    names = set(os.listdir(tmp_path / "ckpt"))
    assert {"latest", "latest.config.json", "step_00000002",
            "step_00000004", "best", "best.config.json",
            "best.metric.json"} <= names
    assert not any(n.endswith((".new", ".old", ".tmp")) for n in names)
    assert sorted(os.listdir(tmp_path / "sheets")) == ["iter_2.png",
                                                       "iter_4.png"]
    lines = [json.loads(s) for s in open(tmp_path / "metrics.jsonl")]
    groups = [r["group"] for r in lines]
    assert groups.count("line_train") == 5
    assert groups.count("line_valid") == 2
    valid = [r for r in lines if r["group"] == "line_valid"]
    assert all(np.isfinite(v) for r in lines for k, v in r.items()
               if k not in ("group",))
    assert "swa_val_monitor" in valid[1] and "swa_val_monitor" not in \
        valid[0]
    assert tr.swa_state["count"] == 3          # iterations 3, 4 and 5

    saved = ckpt.load("latest")
    assert saved["iteration"] == 5 and saved["swa"]["count"] == 3
    assert saved["state"]["step"] == state.step
    assert _equal(line_payload({"state": state, "swa": tr.swa_state,
                                "iteration": 5}), saved) > 100
    best = json.load(open(tmp_path / "ckpt" / "best.metric.json"))
    assert best["metric"] == min(r["val_monitor"] for r in valid)

    # resume: a trainer from the saved config, loaded from latest, goes on
    # at iteration 5 with the average still accumulating
    tr2 = LineGanTrainer.from_config(ckpt.load_config("latest"),
                                     device="cpu")
    tr2.model, tr2.disc, tr2.ae = tr.model, tr.disc, tr.ae
    state2 = load_line_state(tr2.init_state(), saved["state"])
    assert _equal(line_payload({"state": state2, "swa": saved["swa"],
                                "iteration": 5}), saved) > 100
    lessons = []
    orig = tr2.train_iteration
    tr2.train_iteration = lambda s, it, b: (lessons.append(it), orig(
        s, it, b))[1]
    tr2.fit(state2, iter(batches), 7, ckpt=ckpt, save_every=100,
            save_latest_every=100, swa_state=saved["swa"],
            start_iteration=5, restart_rss_gb=0)
    assert lessons == [5, 6]
    assert tr2.swa_state["count"] == 5
    assert ckpt.load("latest")["iteration"] == 7


def test_line_checkpoint_manager(tmp_path):
    tr = _small_trainer()
    state = tr.init_state()
    from affganwriting_torch.train.swa import swa_init

    payload = {"state": state, "swa": swa_init(state.main_params()),
               "iteration": 3}
    mgr = LineCheckpointManager(str(tmp_path), keep_periodic=2)
    mgr.save_latest(payload, tr.config_dict)
    assert mgr.load_config("latest") == json.loads(json.dumps(
        tr.config_dict))
    want = mgr.load("latest")
    # a crash between the two renames leaves <path>.new only
    os.rename(tmp_path / "latest", tmp_path / "latest.new")
    assert mgr.latest_exists()
    _equal(mgr.load("latest"), want)
    for step in (1, 2, 3):
        mgr.save_step(payload, tr.config_dict, step)
    assert sorted(n for n in os.listdir(tmp_path) if n.startswith("step_")) \
        == ["step_00000002", "step_00000002.config.json", "step_00000003",
            "step_00000003.config.json"]
    assert mgr.maybe_save_best(payload, tr.config_dict, 2.0)
    assert not mgr.maybe_save_best(payload, tr.config_dict, 3.0)
    assert LineCheckpointManager(str(tmp_path))._best_metric == 2.0


@pytest.fixture(scope="module")
def line_run(tmp_path_factory):
    """``train_line`` with the JAX CLI's model on short lines, 3 iterations
    with SWA from 2, then resumed for 2 more, ``--device cpu``."""
    import affganwriting_torch.utils.logging as logging
    from affganwriting_torch.cli import train_line

    orig = logging.summary_writer
    logging.summary_writer = lambda logdir: None
    root = tmp_path_factory.mktemp("line")
    argv = ["--device", "cpu", "--logdir", str(root / "run"),
            "--max-gen-length", "32", "--width", "128", "--val-every", "3",
            "--val-batches", "1", "--save-every", "3",
            "--save-latest-every", "3", "--sheet-every", "0",
            "--swa-start", "2", "--char-style-dim", "4",
            "--restart-rss-gb", "0"]
    try:
        tr, state = train_line.main(argv + ["--iterations", "3"])
        first = LineCheckpointManager(str(root / "run" / "ckpt")).load(
            "latest")
        tr2, state2 = train_line.main(argv + ["--iterations", "5"])
    finally:
        logging.summary_writer = orig
    return dict(root=root, ckpt=str(root / "run" / "ckpt"), first=first,
                trainer=tr2, state=state2)


def test_train_line_saves_and_resumes(line_run):
    from affganwriting_torch.data.lines import LineCharset, LineDataset

    first = line_run["first"]
    assert first["iteration"] == 3 and first["swa"]["count"] == 2
    cfg = json.load(open(os.path.join(line_run["ckpt"],
                                      "latest.config.json")))
    assert cfg["char_style_dim"] == 4 and cfg["max_gen_length"] == 32
    assert cfg["n_class"] == 80
    tr, payload = restore_line_trainer(line_run["ckpt"], device="cpu")
    saved = LineCheckpointManager(line_run["ckpt"]).load("latest")
    assert saved["iteration"] == 5 and saved["swa"]["count"] == 4
    assert _equal(line_payload(payload), saved) > 1000
    assert tr._saved_grads is None
    ds = LineDataset(LineCharset(), width=128, seed=9)
    val = tr.validate(payload["state"], ds.batches(2), max_batches=1)
    assert set(val) >= {"val_auto", "val_count", "val_monitor"}
    assert all(np.isfinite(v) for v in val.values())


def test_get_styles_and_generate_from_the_checkpoint(line_run, tmp_path,
                                                    capsys):
    from affganwriting_torch.cli import get_styles
    from affganwriting_torch.data.lines import LineCharset
    from affganwriting_torch.gen.line_inference import (
        StyleLibrary,
        generate_lines,
    )

    out = tmp_path / "styles.pkl"
    lib = get_styles.main(["--ckpt", line_run["ckpt"], "--out", str(out),
                           "--n-authors", "4", "--width", "128",
                           "--eval-writer-id", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "wrote 8 styles (4 authors)" in text
    assert set(json.loads(text.strip().splitlines()[-1])) == {
        "top1", "top5", "top20"}
    loaded = StyleLibrary.load(str(out))
    np.testing.assert_array_equal(loaded.styles, lib.styles)
    assert lib.styles.shape == (8, 128 + 4 + 80 * 4)
    tr, payload = restore_line_trainer(line_run["ckpt"], device="cpu")
    imgs = generate_lines(tr, payload["state"], ["Hello world", "ab"],
                          lib.styles[:2], LineCharset())
    again = generate_lines(tr, payload["state"], ["Hello world", "ab"],
                           lib.styles[:2], LineCharset())
    assert imgs.shape == (2, 64, 128, 1) and np.isfinite(imgs).all()
    np.testing.assert_array_equal(imgs, again)     # seeded


def test_app_selftest_on_the_checkpoint(line_run, monkeypatch, capsys):
    """The self-test on the checkpoint, with PIL unimportable: a finite
    (1, 64, 128, 1) line, and PNG bytes that decode (the standard
    library's reader, and PIL afterwards) to the app's page."""
    import io

    from PIL import Image

    from affganwriting_torch.serve import app
    from affganwriting_torch.utils.png import decode_gray_png

    argv = ["--selftest", "--ckpt", line_run["ckpt"], "--device", "cpu"]
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)
        res = app.main(argv)
    assert "selftest ok: image (1, 64, 128, 1)" in capsys.readouterr().out
    assert np.isfinite(res["image"]).all()
    np.testing.assert_array_equal(decode_gray_png(res["png"]), res["page"])
    with Image.open(io.BytesIO(res["png"])) as im:
        np.testing.assert_array_equal(np.asarray(im), res["page"])
    assert res["emuru"].startswith(("absent, raises cleanly", "available"))
