"""The port's teacher phase vs the JAX package's, f32 on the CPU.

Small configuration (tests/test_torch_support.py's ``SMALL``, 32x104, R's
dropout 0 on both sides), random flax leaves converted by
``utils/from_flax``:

- ``SelfTeacher``: texts equal, confidences within 1e-5;
- the on-device TrOCR teacher (tiny) against ``FlaxTrOCRTeacher``: ids and
  texts equal, confidences within 1e-5;
- ``texts_to_labels``: equal;
- ``clip_by_global_norm_`` against optax's ``clip_by_global_norm`` below
  and above the limit: within 1e-6 relative;
- one ``make_teacher_update`` step (the clip active: the summed loss has a
  gradient norm far above 1): the loss within ``LOSS_TOL`` of max(1, |JAX|),
  R's new running statistics within ``STATS_TOL`` and Adam's first moment
  (0.1 times the clipped gradient) within ``DELTA_TOL["rec"]``
  (``train/parity.py``);
- ``run_teacher_phase`` with a stub teacher (fixed texts and confidences per
  batch): the stats' keys and counts equal, ``avg_confidence`` equal and
  ``avg_pseudo_loss`` within ``LOSS_TOL``;
- ``cli/teacher_phase`` and ``cli/teacher_check`` on the CPU;
- the host ``TrOCRTeacher`` on a tiny HF model this file saves: the JAX
  package's texts and confidences exactly (both run ``transformers``).
"""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import affganwriting_tpu.train.teacher as jteacher
from affganwriting_tpu.models.recognizer import trocr as jtrocr
from affganwriting_tpu.models.recognizer.seq2seq import Recognizer as JRec
from affganwriting_torch.core.checkpoint import CheckpointManager
from affganwriting_torch.models.recognizer import trocr
from affganwriting_torch.models.recognizer.seq2seq import Recognizer
from affganwriting_torch.train import teacher
from affganwriting_torch.train.parity import (
    DELTA_TOL,
    LOSS_TOL,
    STATS_TOL,
    delta_errors,
    delta_ok,
    is_stat,
)
from affganwriting_torch.train.state import init_state
from affganwriting_torch.utils.from_flax import (
    convert_module,
    trocr_core_from_flax,
    word_gan_from_flax,
)
from test_torch_support import (
    TRAIN_SMALL,
    jax_word_gan_state,
    random_variables,
    save_tiny_trocr,
    small_jax_config,
    small_torch_config,
    to_numpy_tree,
    word_batch,
)

torch.set_num_threads(2)   # tier-1 runs six xdist workers


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    import affganwriting_torch.utils.logging as logging

    monkeypatch.setattr(logging, "summary_writer", lambda logdir: None)


def _images(b: int, h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.tanh(rng.normal(size=(b, h, w, 1))).astype(np.float32)


@pytest.fixture(scope="module")
def recs():
    """The small config's seq2seq R of each package (dropout 0), from the
    same random leaves."""
    jcfg, tcfg = small_jax_config(), small_torch_config()
    jrec = JRec(jcfg.vocab_size, jcfg.rec_hidden, jcfg.rec_embed,
                jcfg.output_max_len, dropout=0.0, dtype=jnp.float32)
    img = _images(1, 32, 104, 0)
    labels = np.zeros((1, jcfg.output_max_len), np.int32)
    variables = random_variables(jrec, img, labels, seed=3)
    port = Recognizer(tcfg.vocab_size, tcfg.rec_hidden, tcfg.rec_embed,
                      tcfg.output_max_len, tcfg.img_height, torch.float32,
                      dropout=0.0)
    port.load_state_dict(convert_module(to_numpy_tree(variables), port))
    return jcfg, tcfg, jrec, variables, port


def test_self_teacher_matches_jax(recs):
    jcfg, tcfg, _, variables, port = recs
    images = _images(6, 32, 104, 1)
    want_texts, want_conf = jteacher.SelfTeacher(
        jcfg, jax.tree.map(jnp.asarray, variables)).predict(images)
    texts, conf = teacher.SelfTeacher(tcfg, port).predict(images)
    assert texts == want_texts
    np.testing.assert_allclose(conf, want_conf, atol=1e-5, rtol=0)
    # the teacher froze its own copy, not the R it was given
    assert all(p.requires_grad for p in port.parameters())


def test_device_trocr_teacher_matches_jax():
    jcfg, tcfg = small_jax_config(), small_torch_config()
    arch_j, arch = jtrocr.TrOCRArch.tiny(), trocr.TrOCRArch.tiny()
    params = random_variables(
        jtrocr.TrOCRCore(arch_j), np.zeros((1, 384, 384, 3), np.float32),
        np.zeros((1, 2), np.int32), seed=7)["params"]
    want = jteacher.FlaxTrOCRTeacher(jcfg, arch=arch_j, params=jax.tree.map(
        jnp.asarray, params))
    got = teacher.DeviceTrOCRTeacher(
        tcfg, arch=arch, state=trocr_core_from_flax(to_numpy_tree(params),
                                                    arch), device="cpu")
    images = _images(4, 32, 104, 2)
    w_ids, w_conf = (np.asarray(a) for a in want._run(want._params,
                                                      jnp.asarray(images)))
    ids, conf = got.decode(images)
    np.testing.assert_array_equal(ids.numpy(), w_ids)
    np.testing.assert_allclose(conf.numpy(), w_conf, atol=1e-5, rtol=0)
    assert got.predict(images)[0] == want.predict(images)[0]


def test_texts_to_labels_match_jax():
    cfg, jcfg = small_torch_config(), small_jax_config()
    texts = ["hello", "", "a.b,c d", "Überlong wording", "x" * 20, "Zz"]
    np.testing.assert_array_equal(teacher.texts_to_labels(texts, cfg),
                                  jteacher.texts_to_labels(texts, jcfg))


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(4)
    grads = [rng.normal(size=s).astype(np.float32) * scale
             for s in ((3, 4), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], None)
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = teacher.clip_by_global_norm_(params, 1.0)
    assert (float(norm) >= 1.0) == (scale > 1)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                   rtol=1e-6, atol=0)


def test_teacher_update_step_matches_jax(recs, monkeypatch):
    """One step from the same R, images, pseudo labels, mask and weight.
    Adam's first step is lr times the sign of the gradient wherever it is
    above Adam's eps, so the step itself would compare the signs of float
    noise (the conv biases before a train-mode BatchNorm have a gradient of
    exactly 0); Adam's first moment, 0.1 times the clipped gradient, is
    compared instead, leaf by leaf under ``LEAF_FLOOR``."""
    jcfg, tcfg, jrec, variables, port = recs
    monkeypatch.setattr(jteacher, "build_models",
                        lambda cfg: (None, None, None, jrec))
    update_j, opt_j = jteacher.make_teacher_update(jcfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    images = _images(4, 32, 104, 5)
    labels = teacher.texts_to_labels(["abc", "word", "Zed", "qq"], tcfg)
    mask = np.asarray([1, 1, 0, 1], np.float32)
    _, new_s, new_opt, loss_j = update_j(params, stats, opt_j.init(params),
                                         images, labels, mask, 0.8,
                                         jax.random.key(0))
    adam = new_opt[1][0]
    want_mu = convert_module({"params": to_numpy_tree(adam.mu)}, port,
                             params_only=True)
    want_stats = convert_module(to_numpy_tree(
        {"params": params, "batch_stats": new_s}), port)
    before = {k: v.clone() for k, v in port.state_dict().items()}

    update, opt = teacher.make_teacher_update(tcfg, port)
    assert isinstance(opt, torch.optim.Adam)
    assert opt.param_groups[0]["lr"] == 1e-5
    loss = update(torch.from_numpy(images).permute(0, 3, 1, 2),
                  torch.from_numpy(labels).long(), torch.from_numpy(mask),
                  0.8)
    got = {k: v.clone() for k, v in port.state_dict().items()}
    got_mu = {n: opt.state[p]["exp_avg"].clone()
              for n, p in port.named_parameters()}
    port.load_state_dict(before)          # the fixture's R stays as built
    assert abs(float(loss) - float(loss_j)) <= LOSS_TOL * max(
        1.0, abs(float(loss_j))), (float(loss), float(loss_j))
    zeros = {n: torch.zeros_like(v) for n, v in got_mu.items()}
    l2, per_leaf = delta_errors(got_mu, want_mu, zeros)
    worst = max(per_leaf, key=per_leaf.get)
    assert delta_ok("rec", l2, per_leaf), (l2, worst, per_leaf[worst],
                                          DELTA_TOL["rec"])
    # the clip was active: 0.1 x the clipped gradient has norm 0.1
    norm = sum(float(v.double().norm()) ** 2 for v in want_mu.values())
    assert norm ** 0.5 == pytest.approx(0.1, rel=1e-4)
    moved = [k for k in got if not is_stat(k)
             and not torch.equal(got[k], before[k])]
    assert len(moved) > 0.9 * len([k for k in got if not is_stat(k)])
    for k in (k for k in want_stats if is_stat(k)):
        assert not torch.equal(want_stats[k], before[k]), k
        np.testing.assert_allclose(got[k].numpy(), want_stats[k].numpy(),
                                   rtol=STATS_TOL, atol=STATS_TOL,
                                   err_msg=k)


class _StubTeacher:
    """Fixed texts and confidences, one row of ``CONFS`` per call."""

    CONFS = [[0.9, 0.7, 0.5, 0.95], [0.9, 0.1, 0.2, 0.3],
             [0.61, 0.6, 0.8, 0.59]]
    TEXTS = ["abc", "Word", "", "zz"]

    def __init__(self):
        self.calls = 0

    def predict(self, images):
        conf = np.asarray(self.CONFS[self.calls % 3], np.float32)
        self.calls += 1
        assert images.shape[0] == len(conf)
        return list(self.TEXTS), conf


def test_run_teacher_phase_stats_match_jax(monkeypatch):
    jcfg = small_jax_config(**TRAIN_SMALL)
    tcfg = small_torch_config(**TRAIN_SMALL)
    batches = [word_batch(tcfg, 4, seed) for seed in (20, 21, 22, 23)]
    jstate, models = jax_word_gan_state(jcfg, batches[0])
    monkeypatch.setattr(jteacher, "build_models", lambda cfg: models)
    _, want = jteacher.run_teacher_phase(
        jstate, jcfg, _StubTeacher(), iter(batches), jax.random.key(0),
        max_steps=2)
    state = init_state(tcfg, device="cpu", rec_dropout=0.0,
                       weights=word_gan_from_flax(to_numpy_tree(jstate),
                                                  tcfg))
    stub = _StubTeacher()
    state, got = teacher.run_teacher_phase(state, tcfg, stub, iter(batches),
                                           max_steps=2)
    assert got.keys() == want.keys()
    assert stub.calls == 3 == got["used_batches"] + got[
        "skipped_small_batches"]
    for k in ("used_batches", "used_samples", "skipped_small_batches"):
        assert got[k] == want[k], k
    assert got["avg_confidence"] == pytest.approx(want["avg_confidence"],
                                                  rel=1e-6)
    assert abs(got["avg_pseudo_loss"] - want["avg_pseudo_loss"]) <= \
        LOSS_TOL * max(1.0, abs(want["avg_pseudo_loss"])), (got, want)


def test_host_trocr_teacher_matches_jax(tmp_path):
    save_tiny_trocr(str(tmp_path), seed=8)
    images = _images(3, 64, 216, 6)
    want = jteacher.TrOCRTeacher(str(tmp_path), max_new_tokens=6).predict(
        images)
    got = teacher.TrOCRTeacher(str(tmp_path), max_new_tokens=6).predict(
        torch.from_numpy(images))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


@pytest.fixture(scope="module")
def small_checkpoint(tmp_path_factory):
    """(config, directory) of a ``best`` checkpoint of the small config
    with resnet18, random weights."""
    cfg = small_torch_config(**TRAIN_SMALL).replace(
        style_encoder="resnet18", batch_size=2)
    ckpt = tmp_path_factory.mktemp("teacher") / "ckpt"
    CheckpointManager(str(ckpt)).save(
        "best", init_state(cfg, device="cpu", seed=1), cfg)
    return cfg, str(ckpt)


def test_teacher_phase_cli_on_the_cpu(tmp_path, capsys, small_checkpoint):
    from affganwriting_torch.cli import teacher_phase

    _, ckpt = small_checkpoint
    out = tmp_path / "report"
    report = teacher_phase.main([
        "--ckpt", ckpt, "--max-steps", "2",
        "--eval-batches", "1", "--conf-threshold", "0.0", "--out", str(out),
        "--device", "cpu"])
    saved = json.loads((out / "report.json").read_text())
    assert saved == json.loads(json.dumps(report))
    assert saved["teacher"] == "self(beam)"
    assert saved["phase_stats"]["used_batches"] == 2
    for when in ("before", "after"):
        assert all(np.isfinite(v) and v >= 0
                   for v in saved[when].values())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        saved


def test_teacher_check_cli_on_the_cpu(tmp_path, monkeypatch,
                                     small_checkpoint):
    from affganwriting_torch.cli import teacher_check

    cfg, ckpt = small_checkpoint
    monkeypatch.setattr(teacher_check, "default_config", lambda: cfg)
    out = tmp_path / "check"
    rows = teacher_check.main(["--out", str(out), "--max-writers", "1",
                               "--ckpt", ckpt, "--device", "cpu"])
    with open(out / "results.csv") as f:
        table = list(csv.reader(f))
    assert table[0] == ["writer", "word", "prediction", "confidence"]
    assert len(table) == 1 + len(teacher_check.TARGET_WORDS) == 1 + len(rows)
    assert [r[1] for r in table[1:]] == teacher_check.TARGET_WORDS
    assert len([p for p in out.iterdir() if ".png" in p.name]) == \
        len(teacher_check.TARGET_WORDS)
