"""The port's line-GAN rotation against the JAX package's, f32 on the
CPU, with ``char_style_dim`` 0: the no-step gen lesson (its deferred
gradients) and the auto-gen lesson (recon + hinge G on the reconstruction
+ the stash, balanced per leaf), each from one state carried over by
``utils/from_flax.line_state_from_flax``; then ``train_iteration`` over
the seven-lesson curriculum (count | no-step,gen | auto,auto-gen | disc |
no-step,gen | auto,auto-gen | disc) in both packages, iteration by
iteration; and the three behaviours of the JAX trainer that ``ADVICE.md``
flags, kept as they are: only auto-gen consumes the stash
(``affganwriting_tpu/train/line_trainer.py:751``), the stash does not
survive a restart (``:676``), and the deferral runs with
``balance_loss=False`` (``:745``).

Setup and the reasons for it: ``test_torch_line_steps.py``'s docstring
(``test_torch_support.line_trainer_pair``: warmed Adam, dropout off,
noise times 0).  Limits (readings on this CPU in brackets): losses 1e-5
relative; the stashed gradients in relative L2 over the main tree,
hinge G 1e-4 [1.0e-5 port against JAX] and CTC 5e-3 [7.4e-4].  Both are
ill-conditioned in f32 in both packages, the CTC one most: against the
port's own f64 run (``port_in_f64`` around ``gen_grads_step``) hinge G
lies 9.3e-6 (port) and 1.8e-5 (JAX) relative L2 away, CTC 9.1e-4 and
1.1e-3 (the 44-nat loss's gradient back through the HWR's ten convs and
the generator's instance norms), while the CTC gradient into the
log-probs agrees to 1e-5 of its largest entry; per leaf the CTC one
reads up to 2.7e-2.  The gradients handed to the optimizers
(``test_torch_support._recording``, ``port_opt_grads``), per leaf in
relative L2: auto-gen's from JAX's stash (its recon and hinge terms and
the per-leaf balance alone) 2e-2 [3.9e-3, the style encoder's recon
gradient]; at each update of the rotation, from each package's own
stash, the main tree 5e-2 [1.5e-2, at the second auto-gen] and D 1e-4
[1.5e-5].  The state after a step 2e-6 absolute, after the
seven-iteration rotation 1e-5 (an update is ~3e-6,
``test_torch_support._warm_opt``: these hold the optimizer's arithmetic,
the limits above the gradients); D's ``u``/``sigma`` 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affganwriting_tpu.train.curriculum import Curriculum as JCurriculum
from affganwriting_torch.train.curriculum import Curriculum
from test_torch_support import (
    check_opt_grads,
    deterministic_line_gan,
    line_batch,
    line_state_errors,
    line_trainer_pair,
    port_main_grads,
    port_opt_grads,
)

torch.set_num_threads(2)   # tier-1 runs six xdist workers

LOSS_TOL, STATE_TOL, ROT_TOL, SN_TOL = 1e-5, 2e-6, 1e-5, 1e-5
GRAD_TOL = {"g_adv": 1e-4, "g_ctc": 5e-3}     # relative L2 over the tree
# the gradients handed to the optimizers, per leaf in relative L2: after
# one auto-gen step, and at each iteration of the rotation
UPDATE_TOL = {"main": 2e-2}
ROT_UPDATE_TOL = {"main": 5e-2, "disc": 1e-4}


@pytest.fixture(scope="module")
def pair():
    with deterministic_line_gan():
        jt, js, tt, ts = line_trainer_pair(0)
        batches = [line_batch(seed=10 + i) for i in range(8)]
        yield dict(jt=jt, js=js, tt=tt, ts=ts, batches=batches)


def _port_grads(jax_grads, pair) -> dict:
    """A JAX main-tree gradient -> {port name: tensor}."""
    return port_main_grads(jax_grads, pair["js"], pair["ts"])


def _grads_close(got: dict, want: dict, what: str):
    """Relative L2 over the main tree: ``GRAD_TOL[what]``."""
    assert got.keys() == want.keys()
    num = sum(float(((got[n] - w) ** 2).sum()) for n, w in want.items())
    den = sum(float((w ** 2).sum()) for w in want.values())
    assert den > 0 and (num / den) ** 0.5 <= GRAD_TOL[what], \
        (what, (num / den) ** 0.5)


def _inputs(pair, batch):
    jt, js, tt, ts = pair["jt"], pair["js"], pair["tt"], pair["ts"]
    spaced = jt.spaced_label(js, batch)
    np.testing.assert_array_equal(tt.spaced_label(ts, batch), spaced)
    t = jt.max_gen_length
    sp = np.zeros((spaced.shape[0], t), spaced.dtype)
    sp[:, : min(t, spaced.shape[1])] = spaced[:, :t]
    style, _ = jax.jit(lambda v, i: jt.model.apply(
        v, i, method=jt.model.extract_style))(jt._variables(js),
                                              batch["image"])
    return sp, np.asarray(style), spaced


def test_no_step_gen_and_auto_gen_match_jax(pair):
    """The no-step lesson's two gradients (no update), then auto-gen from
    the same state consuming them at (0.6, 0.5, 0.4)."""
    jt, js, tt, ts = pair["jt"], pair["js"], pair["tt"], pair["ts"]
    batch = pair["batches"][0]
    sp, style, spaced = _inputs(pair, batch)
    image, label, lengths = tt._put_batch(batch)
    mults = (0.6, 0.5, 0.4)
    with deterministic_line_gan():
        m, g_ctc, g_adv, _ = jt.gen_grads_step(
            js, jnp.asarray(batch["label"]),
            jnp.asarray(batch["label_lengths"]), jnp.asarray(style),
            jax.random.key(5))
        mt, g_ctc_t, g_adv_t, _ = tt.gen_grads_step(
            ts, label, lengths, torch.from_numpy(style.copy()), tt.generator)
        for k, v in m.items():
            assert abs(float(mt[k]) - float(v)) <= LOSS_TOL * max(
                1, abs(float(v))), k
        _grads_close(g_ctc_t, _port_grads(g_ctc, pair), "g_ctc")
        _grads_close(g_adv_t, _port_grads(g_adv, pair), "g_adv")
        assert any(float(v.abs().max()) > 0 for v in g_ctc_t.values())

        for log in jt.opt_grads.values():
            log.clear()
        with port_opt_grads() as port_log:
            js2, m2, _ = jt.auto_gen_step(
                js, jnp.asarray(batch["image"]), jnp.asarray(batch["label"]),
                jnp.asarray(batch["label_lengths"]),
                jax.nn.one_hot(jnp.asarray(sp), jt.n_class),
                jax.random.key(4), jnp.asarray(mults, jnp.float32), g_ctc,
                g_adv, jnp.ones_like(jnp.asarray(batch["image"])))
            # the gradient it hands the optimizer, from JAX's own stash:
            # the recon and hinge terms and the per-leaf balance alone
            ts_j, _, _ = tt.auto_gen_step(
                copy.deepcopy(ts), image, label, lengths,
                tt._spaced_onehot(spaced), tt.generator, mults,
                _port_grads(g_ctc, pair), _port_grads(g_adv, pair),
                torch.ones_like(image))
        assert check_opt_grads(jt, js, port_log, ts_j, UPDATE_TOL,
                               "auto-gen") == ["main"]
        ts2, m2t, _ = tt.auto_gen_step(
            copy.deepcopy(ts), image, label, lengths,
            tt._spaced_onehot(spaced), tt.generator, mults, g_ctc_t,
            g_adv_t, torch.ones_like(image))
    for k, v in m2.items():
        assert abs(float(m2t[k]) - float(v)) <= LOSS_TOL * max(
            1, abs(float(v))), k
    errs = line_state_errors(js2, ts2)
    assert errs["model"] <= STATE_TOL and errs["disc"] == 0.0, errs
    assert errs["sn"] <= SN_TOL and errs["ae"] == 0.0, errs


def test_rotation_matches_jax(pair):
    """``train_iteration`` over the seven-lesson rotation from the carried
    state, both trainers fresh (empty style banks on the same seed): the
    same lessons run, the losses agree at every iteration, the stash is
    pending exactly after each no-step gen lesson and consumed by the
    next auto-gen, and the states agree at the end."""
    jt, tt = copy.copy(pair["jt"]), copy.copy(pair["tt"])
    for t in (jt, tt):
        t._saved_grads = None
        t.style_bank = type(t.style_bank)(seed=0)
    js, ts = pair["js"], copy.deepcopy(pair["ts"])
    pending, kinds = [], []
    with deterministic_line_gan():
        for it in range(7):
            batch = pair["batches"][it]
            for log in jt.opt_grads.values():
                log.clear()
            with port_opt_grads() as port_log:
                js, m = jt.train_iteration(js, it, batch)
                ts, mt = tt.train_iteration(ts, it, batch)
            kinds.append(check_opt_grads(jt, pair["js"], port_log, ts,
                                         ROT_UPDATE_TOL, it))
            assert set(mt) == set(m), (it, sorted(mt), sorted(m))
            for k, v in m.items():
                assert abs(float(mt[k]) - float(v)) <= LOSS_TOL * max(
                    1, abs(float(v))), (it, k, float(mt[k]), float(v))
            assert (tt._saved_grads is None) == (jt._saved_grads is None)
            pending.append(tt._saved_grads is not None)
            if tt._saved_grads is not None:
                for got, want, what in zip(tt._saved_grads, jt._saved_grads,
                                           ("g_ctc", "g_adv")):
                    _grads_close(got, _port_grads(want, pair), what)
    assert pending == [False, True, False, False, True, False, False]
    assert kinds == [["main"], [], ["main"], ["disc"], [], ["main"],
                     ["disc"]], kinds
    errs = line_state_errors(js, ts)
    assert errs["model"] <= ROT_TOL and errs["disc"] <= ROT_TOL, errs
    assert errs["sn"] <= SN_TOL and errs["ae"] == 0.0, errs
    assert ts.step == int(js.step) == pair["js"].step + 5


def test_only_auto_gen_consumes_the_stash_in_both_packages(pair):
    """ADVICE 1 and 3: after a no-step gen lesson the stash stays pending
    through count and disc lessons (and, in the port, a plain auto one)
    and is consumed by the next auto-gen, also with ``balance_loss``
    off."""
    spec = {0: [["no-step", "gen"], ["count"], ["disc"], ["auto"],
                ["auto", "auto-gen"]]}
    jt, tt = copy.copy(pair["jt"]), copy.copy(pair["tt"])
    jt.curriculum = JCurriculum({0: spec[0][:3] + spec[0][4:]})
    tt.curriculum = Curriculum(spec)
    jt.balance_loss = tt.balance_loss = False
    for t in (jt, tt):
        t._saved_grads = None
        t.style_bank = type(t.style_bank)(seed=0)
    js, ts = pair["js"], copy.deepcopy(pair["ts"])
    port, ref = [], []
    with deterministic_line_gan():
        for it in range(5):
            ts, _ = tt.train_iteration(ts, it, pair["batches"][it])
            port.append(tt._saved_grads is not None)
        for it in range(4):
            js, _ = jt.train_iteration(js, it, pair["batches"][it])
            ref.append(jt._saved_grads is not None)
    assert port == [True, True, True, True, False]
    assert ref == [True, True, True, False]


def test_the_stash_does_not_survive_a_restart(pair, tmp_path):
    """ADVICE 2: a checkpoint saved with a stash pending holds no stash
    (state, SWA and iteration only), and a trainer rebuilt from its config
    and loaded from it starts without one, as a fresh JAX trainer does."""
    from affganwriting_tpu.train.line_trainer import LineGanTrainer as JT
    from affganwriting_torch.core.checkpoint import (
        LineCheckpointManager,
        load_line_state,
    )
    from affganwriting_torch.train.line_trainer import LineGanTrainer
    from affganwriting_torch.train.swa import swa_init

    tt, ts = copy.copy(pair["tt"]), copy.deepcopy(pair["ts"])
    tt.curriculum = Curriculum({0: [["no-step", "gen"]]})
    tt.style_bank = type(tt.style_bank)(seed=0)
    with deterministic_line_gan():
        ts, _ = tt.train_iteration(ts, 0, pair["batches"][0])
    assert tt._saved_grads is not None
    mgr = LineCheckpointManager(str(tmp_path))
    mgr.save_latest({"state": ts, "swa": swa_init(ts.main_params()),
                     "iteration": 1}, tt.config_dict)
    saved = mgr.load("latest")
    assert set(saved) == {"state", "swa", "iteration"}
    restarted = LineGanTrainer.from_config(mgr.load_config("latest"),
                                           device="cpu")
    restarted.model, restarted.disc, restarted.ae = tt.model, tt.disc, tt.ae
    state = load_line_state(restarted.init_state(), saved["state"])
    assert restarted._saved_grads is None and state.step == ts.step
    assert JT()._saved_grads is None
