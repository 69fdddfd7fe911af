"""The port's line-GAN modules and losses against the JAX package's, f32 on
the CPU: ``DiscriminatorAP`` (flax's spectral norm written out) in eval
and train mode with ``u``/``sigma`` written back; the ``Autoencoder``
(``encode``, the reconstruction, the E_HWR head); ``hinge_*``,
``balance_combine`` (zero-mean leaves on both sides) and ``ctc_loss``;
the dropout of D (whole channels at its rates); ``extract_styles`` and
``generate_lines`` on converted weights.

Sizes: D at dim 8 on lines of 64 x 128; the AE at dim 8 (and its E_HWR
head at 12 classes); every flax leaf random (``line_variables``).  Flax's
``Dropout`` is the identity where a JAX side runs in train mode
(``deterministic_line_gan``), the port's dropout off; the JAX sides are
jitted.  Limits: D's heads and the AE 1e-5 (atol and rtol); ``u`` and
``sigma`` 1e-6; the losses 1e-6 relative; ``balance_combine`` 1e-6
relative (the mean over the leaves' means sums in another order);
``extract_styles`` 1e-4 and ``generate_lines`` 1e-4, the limits of
``HWWithStyle`` (``test_torch_line_container.py``).

CTC: for a label too long for T the two packages differ by design.  The
JAX package's guard zeroes infinite losses, but ``optax.ctc_loss`` floors
an impossible alignment at ~1e5 (its ``log_epsilon``), so the guard never
fires there and such a line adds ~1e5 / B to the mean; ``F.ctc_loss``
returns inf, which ``zero_infinity`` zeroes, as the reference's
model/loss.py:28-30 intends.  The test holds the finite lines equal and
reads both values for the impossible one (ROADMAP Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affganwriting_tpu.models.line.autoencoder import Autoencoder as JAE
from affganwriting_tpu.models.line.discriminator import DiscriminatorAP as JD
from affganwriting_tpu.train import line_trainer as jlt
from affganwriting_torch.models.line import discriminator as disc_mod
from affganwriting_torch.models.line.autoencoder import Autoencoder
from affganwriting_torch.models.line.discriminator import DiscriminatorAP
from affganwriting_torch.train import line_trainer as lt
from affganwriting_torch.utils.from_flax import convert_module, disc_from_flax
from test_torch_support import (
    LINE_CLASSES as K,
    close,
    deterministic_line_gan,
    line_batch,
    line_trainer_pair,
    line_variables,
    nchw,
    to_numpy_tree,
)

torch.set_num_threads(2)   # tier-1 runs six xdist workers

RNG = np.random.default_rng(0)
IMG = np.tanh(RNG.normal(size=(3, 64, 128, 1))).astype(np.float32)


@pytest.fixture(scope="module")
def disc_pair():
    jm = JD(dim=8)
    v = line_variables(jm, IMG, seed=1)
    tm = DiscriminatorAP(dim=8)
    tm.load_state_dict(disc_from_flax(to_numpy_tree(v), tm), strict=True)
    return jm, v, tm.eval()


def test_disc_eval_matches_jax_and_leaves_u_alone(disc_pair):
    jm, v, tm = disc_pair
    want = jax.jit(lambda v, x: jm.apply(v, x))(v, IMG)
    before = tm.sn_state()
    with torch.no_grad():
        got = tm(nchw(IMG))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        close(g, w, 1e-5, "D head")
    for k, t in tm.sn_state().items():
        assert torch.equal(t, before[k]), k


def test_disc_train_writes_back_u_and_sigma_as_flax(disc_pair):
    """``update_stats``: one power iteration from the stored ``u``, its
    result and ``sigma`` written back (the JAX ``mutable=["batch_stats"]``
    updates), the heads computed with the new sigma; dropout off."""
    jm, v, tm = disc_pair
    with deterministic_line_gan():
        heads, upd = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.key(0)}))(v, IMG)
    port = DiscriminatorAP(dim=8).eval()      # update_stats, no dropout
    port.load_state_dict(tm.state_dict())
    with torch.no_grad():
        got = port(nchw(IMG), update_stats=True)
    for g, w in zip(got, heads):
        close(g, w, 1e-5, "D head (train)")
    want = disc_from_flax(to_numpy_tree({"params": v["params"],
                                         "batch_stats": upd["batch_stats"]}),
                          port)
    moved = 0
    for k, t in port.sn_state().items():
        close(t, want[k], 1e-6, k)
        moved += not torch.equal(t, tm.sn_state()[k])
    assert moved == 20          # u and sigma of ten SN convs


def test_disc_gradient_through_sigma_matches_jax(disc_pair):
    """The spectral norm's sigma carries the gradient into the kernel
    (``u``, ``v`` do not): d(sum of heads)/d(kernel) in both packages."""
    jm, v, tm = disc_pair

    def jloss(params):
        heads = jm.apply({"params": params,
                          "batch_stats": v["batch_stats"]}, IMG)
        return sum(jnp.sum(h) for h in heads)

    gj = jax.jit(jax.grad(jloss))(v["params"])
    port = DiscriminatorAP(dim=8).eval()
    port.load_state_dict(tm.state_dict())
    sum(h.sum() for h in port(nchw(IMG))).backward()
    for name in ("c1a", "final_low", "c4b0"):
        w = np.asarray(gj[name]["kernel"]).transpose(3, 2, 0, 1)
        g = getattr(port, name).weight.grad.numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_disc_dropout_drops_whole_channels_at_its_rates(monkeypatch):
    """In train mode D drops whole channels (one mask per sample and
    channel, shared over H x W: flax's ``broadcast_dims=(1, 2)``) at 0.05
    after c1b and c3b and 0.025 in the low branch; in eval mode never;
    the masks come from the caller's generator."""
    calls = []
    real = disc_mod.dropout

    def spy(x, p, generator, channels=False):
        out = real(x, p, generator, channels=channels)
        calls.append((p, channels, x, out))
        return out

    monkeypatch.setattr(disc_mod, "dropout", spy)
    d = DiscriminatorAP(dim=8)
    x = torch.from_numpy(np.tanh(RNG.normal(size=(16, 1, 64, 128)))
                         .astype(np.float32))
    with torch.no_grad():
        d.eval()(x)
        assert calls == []
        d.train()
        a = d(x, generator=torch.Generator().manual_seed(3))
        b = d(x, generator=torch.Generator().manual_seed(3))
    assert [(p, c) for p, c, _, _ in calls[:6]] == \
        [(0.05, True)] * 2 + [(0.025, True)] * 4
    for u, w in zip(a, b):
        assert torch.equal(u, w)
    kept = []
    for p, _, inp, out in calls[:6]:
        zero = (out == 0) & (inp != 0)
        per_plane = zero.flatten(2)
        whole = per_plane.all(-1) | ~per_plane.any(-1)
        assert bool(whole.all()), p          # whole channels or none
        kept.append((1 - per_plane.all(-1).float().mean().item(), p))
        np.testing.assert_allclose(out[~zero].numpy(),
                                   (inp[~zero] / (1 - p)).numpy(),
                                   rtol=1e-6)
    # 16 x (16 .. 32) channels a call: the keep rates within 4 binomial
    # standard deviations of 1 - p
    for rate, p in kept:
        n = 16 * 16
        assert abs(rate - (1 - p)) <= 4 * (p * (1 - p) / n) ** 0.5, (rate, p)


@pytest.mark.parametrize("hwr_classes", [None, K])
def test_autoencoder_matches_jax(hwr_classes):
    jm = JAE(dim=8, hwr_classes=hwr_classes)
    v = line_variables(jm, IMG, seed=2)
    tm = Autoencoder(dim=8, hwr_classes=hwr_classes)
    tm.load_state_dict(convert_module(to_numpy_tree(v), tm),
                       strict=True)
    tm.eval()
    feats = jax.jit(lambda v, x: jm.apply(v, x, method=jm.encode))(v, IMG)
    with torch.no_grad():
        got = tm.encode(nchw(IMG))
        recon, ctc = tm(nchw(IMG), return_ctc=True)
    assert len(got) == len(feats) == 5
    for g, w in zip(got, feats):
        close(g.permute(0, 2, 3, 1), w, 1e-5, "AE feature")
    w_recon, w_ctc = jax.jit(lambda v, x: jm.apply(v, x, return_ctc=True))(
        v, IMG)
    close(recon.permute(0, 2, 3, 1), w_recon, 1e-5, "AE reconstruction")
    if hwr_classes is None:
        assert ctc is None and w_ctc is None
    else:
        close(ctc, w_ctc, 1e-5, "E_HWR log-probs")


def test_hinge_losses_match():
    s = RNG.normal(size=(4, 9)).astype(np.float32)
    for f, jf in ((lt.hinge_d_real, jlt.hinge_d_real),
                  (lt.hinge_d_fake, jlt.hinge_d_fake),
                  (lt.hinge_g, jlt.hinge_g)):
        close(f(torch.from_numpy(s)), jf(jnp.asarray(s)), 1e-6, f.__name__)


def test_balance_combine_matches_with_zero_mean_leaves():
    """Base leaves with zero mean take the mean of the nonzero ones; saved
    leaves with zero mean add nothing; every leaf rescaled by its own
    means (a per-leaf rule: the port's leaves are the flax leaves)."""
    rng = np.random.default_rng(4)
    names = ("a", "b", "c", "d")
    shapes = ((3, 4), (5,), (2, 2, 3), (7,))
    base = {n: rng.normal(size=s).astype(np.float32)
            for n, s in zip(names, shapes)}
    base["b"][:] = 0.0
    saved = []
    for mult, zero in ((0.6, "c"), (0.5, None), (0.4, "a")):
        g = {n: rng.normal(size=s).astype(np.float32) * 10.0 ** rng.integers(
            -3, 2) for n, s in zip(names, shapes)}
        if zero:
            g[zero][:] = 0.0
        saved.append((g, mult))
    want = jlt.balance_combine(base, saved)
    got = lt.balance_combine(
        {n: torch.from_numpy(v) for n, v in base.items()},
        [({n: torch.from_numpy(v) for n, v in g.items()}, m)
         for g, m in saved])
    for n in names:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
    assert float(got["b"].abs().sum()) > 0


def test_ctc_loss_matches_and_zeroes_an_impossible_line():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 6, 5)).astype(np.float32)
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    labels = np.array([[1, 2, 3, 0, 0, 0, 0, 0],
                       [4, 1, 0, 0, 0, 0, 0, 0],
                       [2, 2, 2, 2, 2, 2, 2, 2]], np.int32)
    lengths = np.array([3, 2, 8], np.int32)
    finite = slice(0, 2)
    for sl in (finite, slice(0, 3)):
        got = float(lt.ctc_loss(torch.from_numpy(logp[sl]),
                                torch.from_numpy(labels[sl]),
                                torch.from_numpy(lengths[sl])))
        want = float(jlt.ctc_loss(jnp.asarray(logp[sl]),
                                  jnp.asarray(labels[sl]),
                                  jnp.asarray(lengths[sl])))
        if sl is finite:
            assert abs(got - want) <= 1e-6 * abs(want), (got, want)
            finite_mean = got
        else:
            # 8 repeats need 15 steps, T is 6: the port counts the line as
            # 0; optax floors it at ~1e5, which the JAX guard keeps
            assert got == pytest.approx(finite_mean * 2 / 3, rel=1e-6)
            assert want > 3e4, want
    x = torch.from_numpy(logp).requires_grad_()
    lt.ctc_loss(x, torch.from_numpy(labels),
                torch.from_numpy(lengths)).backward()
    assert bool(torch.isfinite(x.grad).all())
    assert float(x.grad[2].abs().max()) == 0.0


@pytest.fixture(scope="module")
def serve_pair():
    with deterministic_line_gan():
        yield line_trainer_pair(4, seed=7)


def test_extract_styles_and_generate_lines_match_jax(serve_pair):
    from affganwriting_tpu.gen import line_inference as jinf
    from affganwriting_torch.gen import line_inference as inf

    jt, js, tt, ts = serve_pair
    batches = []
    for i in range(2):
        b = line_batch(seed=20 + i)
        b.update(authors=[f"w{i}", f"w{i}", f"v{i}", f"v{i}"],
                 a_batch_size=2)
        batches.append(b)
    lib, jlib = inf.extract_styles(tt, ts, batches), \
        jinf.extract_styles(jt, js, batches)
    assert lib.authors == jlib.authors and lib.ids == jlib.ids
    np.testing.assert_allclose(lib.styles, jlib.styles, rtol=1e-4,
                               atol=1e-4)

    class Charset:                     # the 12 small classes
        def encode(self, text):
            return [1 + (ord(c) % (K - 1)) for c in text]

    texts = ["ab c", "hello", "x"]
    styles = lib.styles[:3]
    with deterministic_line_gan():
        got = inf.generate_lines(tt, ts, texts, styles, Charset())
        want = jinf.generate_lines(jt, js, texts, styles, Charset())
    assert got.shape == want.shape == (3, 64, 128, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
