"""The port's teacher-forced decode, augmentation and standalone HTR
trainer vs the JAX package's, on the CPU.

- teacher-forced decode of the small seq2seq R (tests/test_torch_support.py's
  ``SMALL``, f32, eval mode) from the same random flax leaves, the port
  handed the JAX package's own mask ``jax.random.uniform(key, (steps, B)) <
  rate``: at rate 1 every logit within 1e-4 of max(1, |JAX|); at rates 0
  and 0.5 the greedy ids equal wherever the JAX logits' top-2 margin is
  above twice the packages' logit difference, and the logits within 1e-4
  at every step up to a sample's first id that is not (greedy ids feed the
  next step), at least half the ids clear;
- rate 0 (or an all-False mask) bit-equal to the free-running decode;
- ``teacher_rate_schedule`` and the piecewise learning rate against
  optax's ``piecewise_constant_schedule``: equal (1e-12 relative);
- ``marcal_augment`` and its parts: bit-equal for the same
  ``np.random.Generator``;
- one ``HTRTrainer`` step against the JAX trainer's (dropout 0 on both
  sides as in ``train/parity.py``, teacher rate 1 so that the mask is all
  set whatever the key): the loss within ``LOSS_TOL`` of max(1, |JAX|), R's
  running statistics within ``STATS_TOL``, and Adam's first moment (0.1
  times the gradient: Adam's first step is lr times the sign of the
  gradient, float noise where that is 0) within ``DELTA_TOL["rec"]``;
- ``cli/train_htr`` on the CPU (small widths at 64x216, 2 epochs of 2
  steps).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import affganwriting_tpu.data.augment as jaug
from affganwriting_tpu.models.recognizer.seq2seq import Recognizer as JRec
from affganwriting_tpu.train.htr_trainer import HTRTrainer as JHTRTrainer
from affganwriting_tpu.train.htr_trainer import (
    teacher_rate_schedule as j_rate_schedule,
)
from affganwriting_torch.data import augment
from affganwriting_torch.models.recognizer.seq2seq import Recognizer
from affganwriting_torch.train.htr_trainer import (
    HTRTrainer,
    piecewise_lr,
    teacher_rate_schedule,
)
from affganwriting_torch.train.parity import (
    DELTA_TOL,
    LOSS_TOL,
    STATS_TOL,
    delta_errors,
    delta_ok,
    is_stat,
)
from affganwriting_torch.utils.from_flax import convert_module
from test_torch_support import (
    random_variables,
    small_jax_config,
    small_torch_config,
    to_numpy_tree,
)

torch.set_num_threads(2)   # tier-1 runs six xdist workers

B = 6


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    import affganwriting_torch.utils.logging as logging

    monkeypatch.setattr(logging, "summary_writer", lambda logdir: None)


def _labels(cfg, b: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.vocab_size, size=(b, cfg.output_max_len))
    for i, n in enumerate(rng.integers(1, cfg.max_chars + 1, size=b)):
        ids[i, n + 1] = 1
        ids[i, n + 2:] = 2
    ids[:, 0] = 0
    return ids.astype(np.int32)


@pytest.fixture(scope="module")
def recs():
    jcfg, tcfg = small_jax_config(), small_torch_config()
    jrec = JRec(jcfg.vocab_size, jcfg.rec_hidden, jcfg.rec_embed,
                jcfg.output_max_len, dropout=0.0, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    img = np.tanh(rng.normal(size=(B, 32, 104, 1))).astype(np.float32)
    labels = _labels(tcfg, B, 1)
    variables = random_variables(jrec, img, labels, seed=2)
    port = Recognizer(tcfg.vocab_size, tcfg.rec_hidden, tcfg.rec_embed,
                      tcfg.output_max_len, tcfg.img_height, torch.float32,
                      dropout=0.0)
    port.load_state_dict(convert_module(to_numpy_tree(variables), port))
    return jrec, variables, port.eval(), img, labels


@pytest.mark.parametrize("rate", [0.0, 0.5, 1.0])
def test_teacher_forced_decode_matches_jax_with_its_mask(recs, rate):
    jrec, variables, port, img, labels = recs
    key = jax.random.key(3)
    steps = labels.shape[1] - 1
    mask = np.array(jax.random.uniform(key, (steps, B)) < rate)
    assert mask.all() if rate == 1.0 else not mask.all()
    want = np.asarray(jrec.apply(variables, img, labels, teacher_rate=rate,
                                 rng=key)[0])
    with torch.no_grad():
        got = port(torch.from_numpy(img).permute(0, 3, 1, 2),
                   torch.from_numpy(labels).long(),
                   teacher_mask=torch.from_numpy(mask))[0].numpy()
    diff = np.abs(got - want)
    tol = 1e-4 * np.maximum(1.0, np.abs(want))
    if rate == 1.0:
        assert (diff <= tol).all(), diff.max()
        return
    top2 = np.sort(want, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * diff.max(-1)
    assert clear.mean() >= 0.5, clear.mean()
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])
    # until a sample's first near-tie that the next step reads greedily
    # (mask row t picks step t + 1's input), its inputs are the JAX
    # package's
    for i in range(B):
        for t in range(steps):
            assert (diff[i, t] <= tol[i, t]).all(), (i, t, diff[i, t].max())
            if not clear[i, t] and not mask[t, i]:
                break


def test_rate_zero_is_the_free_running_decode_bit_for_bit(recs):
    _, _, port, img, labels = recs
    x = torch.from_numpy(img).permute(0, 3, 1, 2)
    y = torch.from_numpy(labels).long()
    with torch.no_grad():
        free = port(x, y)[0]
        gen = torch.Generator().manual_seed(0)
        zero = port(x, y, gen, teacher_rate=0.0)[0]
        none = port(x, y, teacher_mask=torch.zeros(labels.shape[1] - 1, B,
                                                   dtype=torch.bool))[0]
    assert torch.equal(free, zero) and torch.equal(free, none)
    assert torch.equal(gen.get_state(),
                       torch.Generator().manual_seed(0).get_state())


def test_rate_schedule_and_piecewise_lr_match_jax():
    for total in (1, 7, 200):
        for epoch in range(0, total + 3):
            assert teacher_rate_schedule(epoch, total) == \
                j_rate_schedule(epoch, total)
    milestones, gamma, lr = (60, 100, 140), 0.5, 2e-4
    sched = optax.piecewise_constant_schedule(
        lr, {m * 1000: gamma for m in milestones})
    for step in (0, 1, 59_999, 60_000, 60_001, 99_999, 100_000, 139_999,
                 140_000, 500_000):
        assert piecewise_lr(step, lr, milestones, gamma) == pytest.approx(
            float(sched(step)), rel=1e-6), step


def test_marcal_augment_is_bit_equal():
    img = (np.random.default_rng(5).uniform(size=(64, 216)) > 0.8).astype(
        np.float32)
    for seed in range(4):
        got = augment.marcal_augment(img, np.random.default_rng(seed))
        want = jaug.marcal_augment(img, np.random.default_rng(seed))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    got = augment.grid_warp(img, np.random.default_rng(9))
    np.testing.assert_array_equal(
        got, jaug.grid_warp(img, np.random.default_rng(9)))


def test_htr_step_matches_jax():
    jcfg, tcfg = small_jax_config(), small_torch_config()
    rng = np.random.default_rng(6)
    img = np.tanh(rng.normal(size=(4, 32, 104, 1))).astype(np.float32)
    labels = _labels(tcfg, 4, 7)
    jt = JHTRTrainer(jcfg)
    jt.rec = jt.rec.clone(dropout=0.0)
    variables = random_variables(jt.rec, img, labels, seed=8)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = {"params": params,
             "stats": jax.tree.map(jnp.asarray, variables["batch_stats"]),
             "opt": jt.opt.init(params), "step": jnp.zeros((), jnp.int32)}
    jt._build()
    new, loss_j, _ = jt._step(state, jnp.asarray(img), jnp.asarray(labels),
                              1.0, jax.random.key(0))

    port = HTRTrainer(tcfg, device="cpu", rec_dropout=0.0,
                      weights=convert_module(to_numpy_tree(variables),
                                             Recognizer(
                                                 tcfg.vocab_size,
                                                 tcfg.rec_hidden,
                                                 tcfg.rec_embed,
                                                 tcfg.output_max_len,
                                                 tcfg.img_height)))
    assert isinstance(port.opt, torch.optim.Adam) and port.lr_now() == 2e-4
    before = {k: v.clone() for k, v in port.rec.state_dict().items()}
    loss, _ = port.train_step(img, labels, teacher_rate=1.0)
    assert port.steps == 1
    assert abs(float(loss) - float(loss_j)) <= LOSS_TOL * max(
        1.0, abs(float(loss_j))), (float(loss), float(loss_j))
    mu = {n: port.opt.state[p]["exp_avg"]
          for n, p in port.rec.named_parameters()}
    want_mu = convert_module({"params": to_numpy_tree(new["opt"][0].mu)},
                             port.rec, params_only=True)
    l2, per_leaf = delta_errors(mu, want_mu, {n: torch.zeros_like(v)
                                              for n, v in mu.items()})
    worst = max(per_leaf, key=per_leaf.get)
    assert delta_ok("rec", l2, per_leaf), (l2, worst, per_leaf[worst],
                                          DELTA_TOL["rec"])
    want = convert_module(to_numpy_tree({"params": new["params"],
                                         "batch_stats": new["stats"]}),
                          port.rec)
    after = port.rec.state_dict()
    for k in (k for k in want if is_stat(k)):
        assert not torch.equal(after[k], before[k]), k
        np.testing.assert_allclose(after[k].numpy(), want[k].numpy(),
                                   rtol=STATS_TOL, atol=STATS_TOL,
                                   err_msg=k)


def test_train_htr_cli_on_the_cpu(tmp_path, monkeypatch, capsys):
    from affganwriting_torch.cli import train_htr

    # the IAM words run to max_chars 10
    cfg = small_torch_config().replace(img_height=64, img_width=216,
                                       max_chars=10)
    monkeypatch.setattr(train_htr, "default_config", lambda: cfg)
    logdir = tmp_path / "htr"
    out = train_htr.main(["--epochs", "2", "--steps-per-epoch", "2",
                          "--batch-size", "4", "--eval-words", "6",
                          "--logdir", str(logdir), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        out
    assert out["epochs"] == 2 and out["eval_words"] == 6 and out["augment"]
    assert np.isfinite(out["htr_floor_cer_te"])
    saved = torch.load(logdir / "htr_final", weights_only=False)
    assert set(saved["model"]) == set(Recognizer(
        cfg.vocab_size, cfg.rec_hidden, cfg.rec_embed, cfg.output_max_len,
        cfg.img_height).state_dict())
    lines = [json.loads(s) for s in open(logdir / "metrics.jsonl")]
    assert [r["step"] for r in lines] == [0, 1]
    assert lines[0]["teacher_rate"] == 0.5 and lines[1]["teacher_rate"] \
        == 0.25
    assert not os.path.exists(str(logdir / "htr_final") + ".new")
