"""The port's line-GAN lesson steps (``train/line_trainer.py``) against the
JAX package's, f32 on the CPU, each from one state carried over by
``utils/from_flax.line_state_from_flax``, with ``char_style_dim`` 4: the
stepping lessons ``count``, ``auto``, ``gen`` and ``disc`` and the
no-update ``valid`` (the no-step gen and auto-gen lessons are held in
``test_torch_line_rotation.py``).

Setup (``test_torch_support.line_trainer_pair``): 12 classes, style 16,
generator 32, D dim 8, AE dim 8, lines of 64 x 128, spaced length 32;
every flax leaf random; both Adam states warmed (moments and counts
carried over, so an update is smooth in its gradient; a fresh Adam's
first step is lr * sign(g), which a gradient of ~1e-9 flips); dropout off
on both sides (flax's ``Dropout`` the identity inside the module's
fixture) and the generator's noise times 0 (the packages' random streams
differ and a noise weight's gradient is the noise).  The spacing draws
(std 1e-8) move no count that is not at a rounding tie.

Limits (readings on this CPU, in brackets): losses 1e-5 relative [<=
1.2e-7]; the gradients that reach the optimizers (after the clip and the
balance; ``test_torch_support._recording`` and ``port_opt_grads``), per
leaf in relative L2 (``GRAD_TOL``): count and auto 1e-3 [1.1e-4, 9.9e-5],
gen 5e-3 [4.8e-4 balanced, 1.4e-4 not; the CTC gradient is
ill-conditioned in f32, ``test_torch_line_rotation.py``], D 1e-4
[3.4e-6], a leaf the loss does not reach exactly 0 on both sides; the
updated state (main tree, HWR and its statistics, D, the AE) 2e-6
absolute [<= 1.8e-7; an update is ~3e-6, ``_warm_opt``, so this holds the
optimizer's arithmetic and moments, not the gradients]; D's
``u``/``sigma`` 1e-5 [<= 2.4e-7]; the spaced labels (host DTW on the two
HWRs' log-probs) and the count targets equal.
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import (
    check_opt_grads,
    deterministic_line_gan,
    line_batch,
    line_state_errors,
    line_trainer_pair,
    port_opt_grads,
)

torch.set_num_threads(2)   # tier-1 runs six xdist workers

LOSS_TOL, STATE_TOL, SN_TOL = 1e-5, 2e-6, 1e-5
# per leaf, relative L2, of the gradient handed to the optimizer
GRAD_TOL = {"count": 1e-3, "auto": 1e-3, "gen": 5e-3, "disc": 1e-4}


@pytest.fixture(scope="module")
def pair():
    with deterministic_line_gan():
        jt, js, tt, ts = line_trainer_pair(4)
        batch = line_batch(seed=1)
        spaced = jt.spaced_label(js, batch)
        # a bank-like style for the gen and disc lessons: the JAX
        # package's extracted style, scaled
        style, _ = jax.jit(lambda v, i: jt.model.apply(
            v, i, method=jt.model.extract_style))(jt._variables(js),
                                                  batch["image"])
        yield dict(jt=jt, js=js, tt=tt, ts=ts, batch=batch, spaced=spaced,
                   port_spaced=tt.spaced_label(ts, batch),
                   style=np.asarray(style) * np.float32(0.9))


def _jax_inputs(p):
    jt, b, spaced = p["jt"], p["batch"], p["spaced"]
    t = jt.max_gen_length
    sp = np.zeros((spaced.shape[0], t), spaced.dtype)
    sp[:, : min(t, spaced.shape[1])] = spaced[:, :t]
    gt = jt.count_targets(spaced, b["label"], b["label_lengths"])
    return dict(image=jnp.asarray(b["image"]), label=jnp.asarray(b["label"]),
                lengths=jnp.asarray(b["label_lengths"]),
                onehot=jax.nn.one_hot(jnp.asarray(sp), jt.n_class),
                gt=jnp.asarray(gt), fg=jnp.ones_like(jnp.asarray(b["image"])))


def _port_inputs(p):
    tt, b, spaced = p["tt"], p["batch"], p["port_spaced"]
    image, label, lengths = tt._put_batch(b)
    return dict(image=image, label=label, lengths=lengths,
                onehot=tt._spaced_onehot(spaced),
                gt=tt._put(tt.count_targets(spaced, b["label"],
                                            b["label_lengths"])),
                fg=torch.ones_like(image))


@contextlib.contextmanager
def _opt_grads(p):
    """Both packages' optimizer gradients, recorded from here on: yields
    the port's log (the JAX one is ``p["jt"].opt_grads``)."""
    for log in p["jt"].opt_grads.values():
        log.clear()
    with port_opt_grads() as log:
        yield log


def _check_grads(p, port_log, ts_new, kind, what):
    """One update in each package, by the ``kind`` optimizer ("main" or
    "disc"), whose gradients agree per leaf within ``GRAD_TOL[what]``."""
    assert check_opt_grads(p["jt"], p["js"], port_log, ts_new,
                           {kind: GRAD_TOL[what]}, what) == [kind]


def _check(m_got, m_want, ts_new, js_new, what):
    assert set(m_got) == set(m_want), what
    for k, v in m_want.items():
        v = float(v)
        assert abs(float(m_got[k]) - v) <= LOSS_TOL * max(1.0, abs(v)), \
            (what, k, float(m_got[k]), v)
    errs = line_state_errors(js_new, ts_new)
    assert errs["model"] <= STATE_TOL, (what, errs)
    assert errs["disc"] <= STATE_TOL, (what, errs)
    assert errs["ae"] == 0.0, (what, errs)
    assert errs["sn"] <= SN_TOL, (what, errs)
    assert ts_new.step == int(js_new.step), what


def test_spaced_labels_and_count_targets_equal(pair):
    np.testing.assert_array_equal(pair["port_spaced"], pair["spaced"])
    assert pair["spaced"].any()


def test_count_step_matches_jax(pair):
    j, t = _jax_inputs(pair), _port_inputs(pair)
    with deterministic_line_gan(), _opt_grads(pair) as log:
        js, m = pair["jt"].count_step(pair["js"], j["image"], j["label"],
                                      j["lengths"], j["gt"],
                                      jax.random.key(3))
        ts, mt = pair["tt"].count_step(copy.deepcopy(pair["ts"]),
                                       t["image"], t["label"], t["lengths"],
                                       t["gt"], pair["tt"].generator)
    _check_grads(pair, log, ts, "main", "count")
    _check(mt, m, ts, js, "count")


def test_auto_step_matches_jax(pair):
    j, t = _jax_inputs(pair), _port_inputs(pair)
    with deterministic_line_gan(), _opt_grads(pair) as log:
        js, m, style = pair["jt"].auto_step(
            pair["js"], j["image"], j["label"], j["lengths"], j["onehot"],
            jax.random.key(4), j["fg"])
        ts, mt, style_t = pair["tt"].auto_step(
            copy.deepcopy(pair["ts"]), t["image"], t["label"], t["lengths"],
            t["onehot"], pair["tt"].generator, t["fg"])
    np.testing.assert_allclose(style_t.numpy(), np.asarray(style),
                               rtol=1e-5, atol=1e-5)
    _check_grads(pair, log, ts, "main", "auto")
    _check(mt, m, ts, js, "auto")


@pytest.mark.parametrize("balance", [True, False])
def test_gen_step_matches_jax(pair, balance):
    """The stepping gen lesson, the CTC gradient balanced into hinge G at
    0.6 (``balance_loss``) or added to it."""
    j, t = _jax_inputs(pair), _port_inputs(pair)
    style = pair["style"]
    jt, tt = pair["jt"], pair["tt"]
    with deterministic_line_gan():
        if not balance:     # the JAX steps capture the flag when built
            jt.balance_loss = tt.balance_loss = False
            jt._build_steps()
        try:
            with _opt_grads(pair) as log:
                js, m, img = jt.gen_step(
                    pair["js"], j["label"], j["lengths"], jnp.asarray(style),
                    jax.random.key(5), jnp.float32(0.6))
                ts, mt, img_t = tt.gen_step(
                    copy.deepcopy(pair["ts"]), t["label"], t["lengths"],
                    torch.from_numpy(style), tt.generator, 0.6)
        finally:
            if not balance:
                jt.balance_loss = tt.balance_loss = True
                jt._build_steps()
    np.testing.assert_allclose(img_t.permute(0, 2, 3, 1).numpy(),
                               np.asarray(img), rtol=1e-4, atol=1e-4)
    _check_grads(pair, log, ts, "main", "gen")
    _check(mt, m, ts, js, f"gen balance={balance}")


def test_disc_step_matches_jax_and_keeps_the_real_pass_stats(pair):
    """Hinge D; both passes from the same spectral-norm state, the real
    pass's ``u``/``sigma`` kept: they differ from the state before and
    equal those of one pass over the real lines alone."""
    j, t = _jax_inputs(pair), _port_inputs(pair)
    style = pair["style"]
    with deterministic_line_gan(), _opt_grads(pair) as log:
        js, m = pair["jt"].disc_step(pair["js"], j["image"], j["label"],
                                     j["lengths"], jnp.asarray(style),
                                     jax.random.key(6))
        ts, mt = pair["tt"].disc_step(copy.deepcopy(pair["ts"]), t["image"],
                                      t["label"], t["lengths"],
                                      torch.from_numpy(style),
                                      pair["tt"].generator)
    _check_grads(pair, log, ts, "disc", "disc")
    _check(mt, m, ts, js, "disc")
    before = pair["ts"].disc.sn_state()
    after = ts.disc.sn_state()
    assert any(not torch.equal(after[k], v) for k, v in before.items())
    real_only = copy.deepcopy(pair["ts"].disc)
    real_only(t["image"], update_stats=True)
    for k, v in real_only.sn_state().items():
        torch.testing.assert_close(after[k], v, rtol=0, atol=0)


def test_valid_step_matches_jax(pair):
    j, t = _jax_inputs(pair), _port_inputs(pair)
    with deterministic_line_gan(), _opt_grads(pair) as log:
        m = pair["jt"].valid_step(pair["js"], j["image"], j["label"],
                                  j["lengths"], j["onehot"],
                                  jax.random.key(0), j["fg"], j["gt"])
        mt = pair["tt"].valid_step(pair["ts"], t["image"], t["label"],
                                   t["lengths"], t["onehot"],
                                   torch.Generator().manual_seed(0),
                                   t["fg"], t["gt"])
    for k, v in m.items():
        assert abs(float(mt[k]) - float(v)) <= LOSS_TOL * max(1, abs(v)), k
    jax.effects_barrier()
    assert not log and not any(pair["jt"].opt_grads.values())
