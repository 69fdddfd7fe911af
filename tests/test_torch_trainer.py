"""The port's word trainer runtime on the CPU: checkpoints, the plateau
schedule, early stopping, ``WordGanTrainer.fit`` with resume and one epoch
against the JAX trainer (the Adam state carried over from the JAX package
is tests/test_torch_adam_carry.py's).

Limits:
- checkpoints restore every tensor and optimizer field bit for bit;
- ``PlateauScaler`` and ``EarlyStopping`` give the JAX package's values
  exactly;
- one trainer epoch (two steps) against the JAX trainer: parity.py's
  configuration (SGD, ``w_rec`` 0, R's dropout 0 on both sides) with G held
  still and R at 1e-5 (``EPOCH_CONFIG`` says why); the post-loop pass over
  the JAX trainer's step outputs exactly equal, every step's losses and the
  epoch means within ``LOSS_TOL`` (``l_rec`` only at a step where none of
  R's ids on the fakes is near a tie, ``l_rec_tr`` only at a step where
  R's ids on the real words are equal), R's greedy ids equal wherever they
  are not within twice the packages' logit difference of a tie, and the
  CERs apart by at most one edit per id that is;
- SIGINT inside ``fit``, even in the middle of a step, saves the state
  after a whole step.

TensorBoard is kept out (its import pulls in a large framework here); the
JSONL logging is what these tests read.
"""

import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

import affganwriting_tpu.train.step as jstep
from affganwriting_tpu.train.loop import EarlyStopping as JEarly
from affganwriting_tpu.train.loop import WordGanTrainer as JTrainer
from affganwriting_tpu.train.schedules import PlateauScaler as JPlateau
from affganwriting_torch.core.checkpoint import (
    CheckpointManager,
    state_payload,
)
from affganwriting_torch.data import iam
from affganwriting_torch.data.words import WordStyleDataset
from affganwriting_torch.models.blocks import BatchNorm
from affganwriting_torch.train import parity
from affganwriting_torch.train.loop import EarlyStopping, WordGanTrainer
from affganwriting_torch.train.schedules import PlateauScaler
from affganwriting_torch.train.state import (
    PLAYERS,
    PlayerState,
    WordGanState,
    init_state,
)
from affganwriting_torch.utils.from_flax import word_gan_from_flax
from test_torch_support import (
    TRAIN_SMALL,
    jax_word_gan_state,
    small_jax_config,
    small_torch_config,
    to_numpy_tree,
)

torch.set_num_threads(2)   # tier-1 runs six xdist workers


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    import affganwriting_torch.utils.logging as logging

    monkeypatch.setattr(logging, "summary_writer", lambda logdir: None)


METRICS = [10.0, 9.0, 9.5, 9.5, 9.5, 8.0, 8.0, 8.5, 9.0, 7.0, 7.0, 7.0,
           7.5, 8.0, 8.0, 8.0]


@pytest.mark.parametrize("patience", [0, 2, 3])
def test_plateau_and_early_stopping_match(patience):
    ours, theirs = PlateauScaler(0.1, patience), JPlateau(0.1, patience)
    stop, jstop = EarlyStopping(patience + 1), JEarly(patience + 1)
    for m in METRICS:
        assert ours.update(m) == theirs.update(m)
        stop.update(m)
        jstop.update(m)
        assert (stop.best, stop.count, stop.should_stop) == \
            (jstop.best, jstop.count, jstop.should_stop)
    assert ours.mul < 1.0 and stop.should_stop


def tiny_state(seed: int) -> WordGanState:
    """Four small players (a linear layer and a BatchNorm with running
    statistics each) whose Adams have taken one step."""
    torch.manual_seed(seed)
    players = []
    for _ in PLAYERS:
        model = torch.nn.Sequential(torch.nn.Linear(3, 4), BatchNorm(4))
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        model.train()(torch.randn(5, 3)).square().sum().backward()
        opt.step()
        players.append(PlayerState(model, opt))
    return WordGanState(seed + 3, *players)


def assert_states_equal(a: WordGanState, b: WordGanState):
    pa, pb = state_payload(a), state_payload(b)
    assert pa["step"] == pb["step"]

    def same(x, y, where):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y) and x.dtype == y.dtype, where
        elif isinstance(x, dict):
            assert x.keys() == y.keys(), where
            for k in x:
                same(x[k], y[k], f"{where}.{k}")
        elif isinstance(x, (list, tuple)):
            assert len(x) == len(y), where
            for i, (u, v) in enumerate(zip(x, y)):
                same(u, v, f"{where}[{i}]")
        else:
            assert x == y, where

    for n in PLAYERS:
        same(pa[n], pb[n], n)
        assert pa[n]["opt"]["state"], n


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    saved = tiny_state(0)
    ck = CheckpointManager(str(tmp_path))
    cfg = small_torch_config()
    ck.save_latest(saved, cfg)
    restored = ck.restore("latest", tiny_state(1))
    assert_states_equal(restored, saved)
    assert ck.load_config("latest") == cfg


def test_crash_between_the_renames_is_recovered(tmp_path):
    """A save that stopped after moving the old file aside: ``latest`` is
    gone, a complete ``latest.new`` and ``latest.old`` remain; the next
    manager promotes ``.new`` and drops ``.old``."""
    ck = CheckpointManager(str(tmp_path))
    ck.save_latest(tiny_state(0), small_torch_config())
    newer = tiny_state(2)
    torch.save(state_payload(newer), tmp_path / "latest.new")
    os.rename(tmp_path / "latest", tmp_path / "latest.old")
    again = CheckpointManager(str(tmp_path))
    assert again.latest_exists()
    assert not (tmp_path / "latest.new").exists()
    assert not (tmp_path / "latest.old").exists()
    assert_states_equal(again.restore("latest", tiny_state(1)), newer)


def test_prune_keeps_keep_periodic(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep_periodic=2)
    for step in (1, 2, 3, 4):
        ck.save_step(tiny_state(step), small_torch_config(), step)
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000003", "step_00000003.config.json", "step_00000004",
        "step_00000004.config.json"]


def test_best_survives_a_restart(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    cfg = small_torch_config()
    assert ck.maybe_save_best(tiny_state(0), cfg, 5.0)
    assert not ck.maybe_save_best(tiny_state(1), cfg, 7.0)
    again = CheckpointManager(str(tmp_path))
    assert not again.maybe_save_best(tiny_state(2), cfg, 6.0)
    assert_states_equal(again.restore("best", tiny_state(3)), tiny_state(0))
    assert again.maybe_save_best(tiny_state(4), cfg, 4.0)
    assert json.loads((tmp_path / "best.metric.json").read_text()) == \
        {"metric": 4.0}


def test_sigint_saves_latest(tmp_path):
    """SIGINT inside ``fit`` saves ``latest`` and raises
    ``KeyboardInterrupt`` (a stub epoch, as tests/test_schedules.py
    does)."""
    trainer = WordGanTrainer.__new__(WordGanTrainer)
    trainer.config = small_torch_config()
    trainer.ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    trainer.test_data = None
    trainer.start_epoch = 0
    trainer.save_every = 10**9
    trainer.state = tiny_state(0)
    calls = []

    def epoch_then_interrupt(epoch):
        calls.append(epoch)
        os.kill(os.getpid(), signal.SIGINT)

    trainer.train_epoch = epoch_then_interrupt
    with pytest.raises(KeyboardInterrupt):
        trainer.fit(5)
    assert calls == [0]
    assert trainer.ckpt.latest_exists()
    assert_states_equal(trainer.ckpt.restore("latest", tiny_state(1)),
                        trainer.state)


def test_sigint_inside_a_step_saves_the_whole_step(tmp_path):
    """SIGINT from inside a step, after R's and C's phases and before D's
    and G's: the step runs to its end, and ``latest`` holds the state
    after it, not one with R and C stepped and D and G not."""
    cfg = small_torch_config(**TRAIN_SMALL).replace(
        style_encoder="resnet18", batch_size=2)
    train, _ = _datasets(cfg, 4)
    trainer = WordGanTrainer(cfg, train, logdir=str(tmp_path / "run"),
                             restart_rss_gb=0, device="cpu")
    step, phases = trainer.train_step, []

    def interrupt_after_cla(name):
        phases.append(name)
        if name == "cla":
            os.kill(os.getpid(), signal.SIGINT)

    trainer.train_step = lambda state, batch, generator: step(
        state, batch, generator, interrupt_after_cla)
    with pytest.raises(KeyboardInterrupt):
        trainer.fit(2)
    assert phases == ["rec", "cla", "dis_gen"]
    assert trainer.state.step == 1
    saved = trainer.ckpt.restore("latest", init_state(cfg, "cpu", seed=1))
    assert_states_equal(saved, trainer.state)


def test_plateau_step_rescales_r_lr():
    cfg = small_torch_config()
    trainer = WordGanTrainer.__new__(WordGanTrainer)
    trainer.config = cfg
    trainer.plateau = PlateauScaler(factor=0.1, patience=0)
    trainer.state = tiny_state(0)
    trainer._plateau_step(10.0)
    assert [g["lr"] for g in trainer.state.rec.opt.param_groups] == \
        [cfg.lr_rec]
    trainer._plateau_step(11.0)
    assert trainer.state.rec.opt.param_groups[0]["lr"] == \
        pytest.approx(cfg.lr_rec * 0.1)
    assert trainer.state.gen.opt.param_groups[0]["lr"] == 1e-3


def _datasets(cfg, n: int, seed: int = 0, dataset=WordStyleDataset):
    paths = iam.default_reference_paths()
    corpus = iam.load_corpus(paths["corpus"])[:300]
    out = []
    for split, s in (("train_gt", seed), ("test_gt", seed + 1)):
        gt = dict(list(iam.parse_groundtruth(paths[split]).items())[:n])
        out.append(dataset(gt, iam.writer_label_map(gt), cfg, corpus=corpus,
                           seed=s))
    return out


def test_fit_writes_logs_and_checkpoints_and_resumes_bit_exact(tmp_path):
    """Two epochs of 2 steps at the small config (resnet18 to keep the
    checkpoints small), evaluating and saving every epoch; then a trainer
    on the same logdir starts at epoch 2 with every parameter, statistic
    and optimizer field as saved, and trains one more epoch."""
    cfg = small_torch_config(**TRAIN_SMALL).replace(
        style_encoder="resnet18", batch_size=2)
    train, test = _datasets(cfg, 4)
    logdir = str(tmp_path / "run")
    kw = dict(logdir=logdir, eval_every=1, save_every=1,
              restart_rss_gb=0, device="cpu")
    first = WordGanTrainer(cfg, train, test, rec_plateau=True, **kw)
    first.fit(2)
    lines = [json.loads(s) for s in open(f"{logdir}/metrics.jsonl")]
    assert [(r["group"], r["step"]) for r in lines] == [
        ("train", 0), ("eval", 0), ("train", 1), ("eval", 1)]
    for r in lines:
        assert all(np.isfinite(v) for k, v in r.items() if k != "group")
        assert min(r[k] for k in r if k.startswith("cer")) >= 0
    ckpt = os.listdir(f"{logdir}/ckpt")
    assert {"latest", "step_00000001", "best", "best.metric.json",
            "latest.config.json"} <= set(ckpt)
    assert [f for f in os.listdir(f"{logdir}/sheets")
            if f.startswith("eval_")] != []
    assert first.state.step == 4

    second = WordGanTrainer(cfg, train, test, rec_plateau=True, **kw)
    assert second.start_epoch == 2
    assert_states_equal(second.state, first.state)
    second.fit(3)
    assert second.state.step == 6
    last = json.loads(open(f"{logdir}/metrics.jsonl").readlines()[-2])
    assert last["group"] == "train" and last["step"] == 2
    assert np.isfinite(last["l_total"])


class _Log:
    def log(self, step, scalars, group="train"):
        self.out = dict(scalars)


# parity.py's step with G held still and R at 1e-5.  At lr_gen 1.0 or 1e-3
# the second step's fakes of both packages lie 1.8-1.9 (max abs) from the
# port's f64 run's: they depend on the float rounding there.  G's update is
# tests/test_torch_train_step.py's.  Over two steps at lr_rec 1e-3 R's
# update in the JAX package's f32 lies 56% (relative L2) from the port's
# f64 one (the port's f32 13%), and the second step's ``l_rec_tr`` 7e-3
# (relative) from the f64 run's, past ``LOSS_TOL`` (the port's 5e-5).  At
# 1e-5: 12% and 0.1%, ``l_rec_tr`` within 3e-4.  R's state then barely
# moves, and the second step holds the carry of D's and C's updates.
# ``python tests/torch_epoch_readings.py`` prints these readings.
EPOCH_CONFIG = dict(parity.STEP_CONFIG, lr_gen=0.0, lr_rec=1e-5)
CER_KEYS = {"cer_tr": ("rec_logits_tr", "label_ch0"),
            "cer_te": ("logits_xt", "label_xt"),
            "cer_te2": ("logits_swap", "label_xt_swap")}


def test_one_epoch_matches_the_jax_trainer(tmp_path):
    """One epoch (8 writers, batch 4: two steps, the second from the state
    the first left) of each trainer from the same converted weights on the
    same batch stream (``EPOCH_CONFIG``):

    - the post-loop pass, exactly: the port's reduction of the JAX
      trainer's step outputs gives the JAX trainer's epoch means and CERs;
    - every step's losses and the epoch means within ``LOSS_TOL``, except
      as below;
    - R's greedy ids equal wherever they are not within twice the
      packages' logit difference of a tie, the CERs apart by at most one
      edit per id that is (counted in whole edits).  R free-runs on the
      real words as on the fakes.  On the real words most ids must be
      clear of a tie (measured: 0-13 of 56 a step are not).  On the fakes about
      half are not (55-76 of 112 in three runs): the JAX package's f32
      fakes lie ~1e-2 from the port's f64 ones (the port's ~1e-3), R's
      logits on them (random weights) have top-2 margins of ~0.1, and a
      flip feeds every later step of the free-running decode.  That is why
      parity.py holds ``w_rec`` at 0, and why the two losses that read R's
      greedy ids are compared only where those ids cannot have moved them:
      ``l_rec``, R's loss on the fakes, only at a step with no id on the
      fakes near a tie, and ``l_rec_tr``, R's loss on the real words, only
      at a step where the packages' ids on the real words are equal.  Over
      42 string-hash seeds (the synthetic words, and so the batches, vary
      with it), ``l_rec_tr`` stayed within 2.7e-4 of itself at every step
      with equal ids, and moved by up to 8.1e-3 (``LOSS_TOL`` is 2e-3) at
      steps where 2-5 ids differed: the JAX package's f32 logits on the
      real words, not the port's, lie off the port's f64 ones there.  The
      epoch means follow their steps."""
    jcfg = small_jax_config(**EPOCH_CONFIG)
    tcfg = small_torch_config(**EPOCH_CONFIG)
    from affganwriting_tpu.data.words import WordStyleDataset as JDataset

    jtrain, _ = _datasets(jcfg.replace(batch_size=parity.STEP_BATCH), 8,
                          dataset=JDataset)
    train, _ = _datasets(tcfg.replace(batch_size=parity.STEP_BATCH), 8)
    jstate, models = jax_word_gan_state(jcfg, next(train.batches(epoch=0)))
    weights = word_gan_from_flax(to_numpy_tree(jstate), tcfg)

    ref = JTrainer.__new__(JTrainer)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "build_models", lambda cfg: models)
        ref.train_step = _recording(
            jstep.make_phased_train_step(jcfg, merge_dg=True), jseen := [])
    ref.config, ref.train_data, ref.mesh = jcfg, jtrain, None
    ref.state, ref.rng, ref.logger = jstate, jax.random.key(0), _Log()
    ref.save_latest_every_steps = 10**9
    want = ref.train_epoch(0)

    port = WordGanTrainer(tcfg.replace(batch_size=parity.STEP_BATCH), train,
                          logdir=str(tmp_path), restart_rss_gb=0,
                          device="cpu")
    port.state = init_state(tcfg, "cpu", weights=weights, rec_dropout=0.0)
    port.train_step = _recording(port.train_step, seen := [])
    got = port.train_epoch(0)
    assert port.state.step == len(seen) == len(jseen) == 2, \
        ("steps", port.state.step, len(seen), len(jseen))
    for i, ((_, _, b), (_, _, jb)) in enumerate(zip(seen, jseen)):
        assert b.keys() == jb.keys(), ("batch keys", i, b.keys(), jb.keys())
        for k in b:
            np.testing.assert_array_equal(b[k], jb[k], ("batch", i, k))

    same = port._reduce(
        [({k: torch.from_numpy(np.array(v)) for k, v in m.items()},
          {key: (torch.from_numpy(np.array(ext[lk])), b[label])
           for key, (lk, label) in CER_KEYS.items()})
         for m, ext, b in jseen], len(jseen), tuple(CER_KEYS))
    for k in same:
        assert same[k] == want[k], ("post-loop pass", k, same[k], want[k])

    ties, flips, n_ids = {}, {}, {}
    for key, (lk, label) in CER_KEYS.items():
        ties[key], flips[key], n_ids[key], gt_len = [], [], 0, 0
        for i, ((_, ext, b), (_, jext, _)) in enumerate(zip(seen, jseen)):
            a, w = ext[lk].numpy(), np.asarray(jext[lk])
            top2 = np.sort(w, -1)[..., -2:]
            clear = top2[..., 1] - top2[..., 0] > 2 * np.abs(a - w).max(-1)
            np.testing.assert_array_equal(a.argmax(-1)[clear],
                                          w.argmax(-1)[clear],
                                          ("ids clear of a tie", i, key))
            ties[key].append(int((~clear).sum()))
            flips[key].append(int((a.argmax(-1) != w.argmax(-1)).sum()))
            n_ids[key] += clear.size
            gt_len += int((b[label] >= 3).sum())
        # CER = 100 * edits / gt_len: compare the edits, which are whole
        # numbers (the two quotients can differ by an ulp more than the
        # bound's own quotient)
        edits = [round(c * gt_len / 100) for c in (got[key], want[key])]
        assert abs(edits[0] - edits[1]) <= sum(ties[key]), \
            ("epoch CER edits", key, got[key], want[key], edits, ties[key])
    print(f"R's ids near a tie, per step, of {n_ids}: {ties}; "
          f"ids that differ: {flips}")
    assert sum(ties["cer_tr"]) <= n_ids["cer_tr"] // 2, (ties, n_ids)

    losses = {k for k in want if k.startswith("l_")}
    assert losses == {k for k in got if k.startswith("l_")}, \
        ("loss keys", losses, got.keys())

    def moved_by_ids(steps) -> set:
        """The losses that R's differing greedy ids may have moved."""
        out = set()
        if any(ties["cer_te"][i] + ties["cer_te2"][i] for i in steps):
            out.add("l_rec")
        if any(flips["cer_tr"][i] for i in steps):
            out.add("l_rec_tr")
        return out

    for i, ((m, _, _), (jm, _, _)) in enumerate(zip(seen, jseen)):
        for k in sorted(losses - moved_by_ids([i])):
            _close_loss(float(m[k]), float(jm[k]), ("step", i, k))
    for k in sorted(losses - moved_by_ids(range(len(seen)))):
        _close_loss(got[k], want[k], ("epoch mean", k))


def _close_loss(got: float, want: float, where) -> None:
    assert np.isfinite(got), where
    assert abs(got - want) <= parity.LOSS_TOL * max(1, abs(want)), \
        (where, "port", got, "jax", want, "tol", parity.LOSS_TOL)


def _recording(step, seen):
    def wrapped(state, batch, generator):
        state, metrics, extras = step(state, batch, generator)
        seen.append((metrics, extras, batch))
        return state, metrics, extras
    return wrapped
