"""The train-step modules of the port vs the JAX package, fp32 on the CPU.

Train-mode BatchNorm, the D/C blocks, D and C, G's pair forward and R in
train mode (batch statistics; dropout 0, built so on both sides), and the
losses.  Every flax leaf is random (tests/test_torch_support.py) and
converted by ``utils/from_flax``.  Tolerances (atol and rtol):

- 1e-4 for single layers and blocks, 1e-5 for the losses: only the
  summation order differs;
- 2e-3 for D, C and R and for the running statistics, as
  tests/test_torch_pipeline.py uses for the stacked models;
- 1e-2 for G's train-mode images.  With batch statistics G amplifies f32
  rounding: scaling the style stack by 1 + 1e-7 moves the JAX package's own
  images by 5e-4 to 8e-4 at this size, and the two packages, which round
  differently at each of ~100 layers, land 2e-3 to 4e-3 apart;
- 2e-2 (relative L2) for the gradient of R's term of G's loss with respect
  to the fakes, as that test says.

Batch 4: over two samples flax's fast variance E[x^2] - E[x]^2 is
ill-conditioned.  A channel whose two values lie within ~sqrt(eps) of each
other turns a 1-ulp difference of the layer below into up to 1e-2 after the
text encoder's BatchNorm (measured: 8e-3 on its AdaIN parameters).
"""

import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affganwriting_tpu.models import blocks as jblocks
from affganwriting_tpu.models.discriminator import Discriminator as JDis
from affganwriting_tpu.models.generator import Generator as JGenerator
from affganwriting_tpu.models.recognizer.seq2seq import (
    Recognizer as JRecognizer,
)
from affganwriting_tpu.models.writer_cla import WriterClassifier as JCla
from affganwriting_tpu.train import losses as jlosses
from affganwriting_tpu.train.step import _pair_method
from affganwriting_torch.models import blocks
from affganwriting_torch.models.discriminator import Discriminator
from affganwriting_torch.models.generator import Generator
from affganwriting_torch.models.recognizer.seq2seq import Recognizer
from affganwriting_torch.models.writer_cla import WriterClassifier
from affganwriting_torch.train import losses
from affganwriting_torch.train.step import generate_pair
from affganwriting_torch.utils.from_flax import convert_module
from test_torch_support import (
    TRAIN_SMALL,
    close,
    load_port,
    nchw,
    nhwc,
    port_in_f64,
    random_variables,
    small_jax_config,
    small_torch_config,
    to_numpy_tree,
)

torch.set_num_threads(2)   # tier-1 runs six xdist workers

F32 = torch.float32
RNG = np.random.default_rng(7)
IMG = RNG.normal(size=(4, 32, 104, 1)).astype(np.float32)
STYLE = RNG.normal(size=(4, 32, 104, 50)).astype(np.float32)
# GO, chars, END, PAD: each row has PAD targets
LABELS = np.asarray([[0, 5, 9, 13, 1, 2, 2, 2], [0, 30, 31, 40, 41, 50, 1, 2],
                     [0, 11, 12, 1, 2, 2, 2, 2], [0, 44, 3, 19, 27, 1, 2, 2]],
                    np.int32)
LABELS_SWAP = np.asarray([[0, 7, 1, 2, 2, 2, 2, 2], [0, 33, 20, 8, 1, 2, 2, 2],
                          [0, 52, 53, 54, 4, 6, 1, 2],
                          [0, 9, 9, 1, 2, 2, 2, 2]], np.int32)


def _stats_of(module, variables, new_stats):
    """The port's state dict for ``variables`` with the flax batch stats
    replaced by ``new_stats``: the reference's running statistics by port
    name."""
    v = to_numpy_tree({"params": variables["params"],
                       "batch_stats": new_stats})
    return {k: t for k, t in convert_module(v, module).items()
            if k.endswith(("running_mean", "running_var"))}


def _assert_stats(module, want: dict, tol: float):
    got = module.state_dict()
    assert want, "no running statistics compared"
    for k, w in want.items():
        close(got[k], w, tol, k)


@pytest.mark.parametrize("shape", [(4, 5, 7, 6), (3, 10), (1, 1, 1, 6)],
                         ids=["map", "dense", "pooled_batch1"])
def test_batchnorm_train_matches_flax(shape):
    """Output and new running statistics (biased variance, momentum 0.9);
    at B = 1 on a pooled 1x1 map the variance is 0 and the bias comes out,
    where F.batch_norm would raise."""
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5, dtype=jnp.float32)
    x = (RNG.normal(size=shape) * 3 + 1).astype(np.float32)
    v = random_variables(jbn, x, seed=3)
    want, upd = jbn.apply(v, x, mutable=["batch_stats"])
    bn = blocks.BatchNorm(shape[-1])
    load_port(bn, v).train()
    to_port = (lambda a: nchw(a)) if x.ndim == 4 else torch.from_numpy
    got = bn(to_port(x))
    close(nhwc(got) if x.ndim == 4 else got.detach(), want, 1e-4, "output")
    close(bn.running_mean, upd["batch_stats"]["mean"], 1e-5, "mean")
    close(bn.running_var, upd["batch_stats"]["var"], 1e-5, "var")
    if shape[0] == 1:
        close(got.detach().flatten(), v["params"]["bias"], 1e-6, "bias")


def test_frozen_stats_normalizes_with_batch_statistics_only():
    bn = blocks.BatchNorm(6).train()
    x = torch.randn(4, 6, 3, 5) * 2 + 3
    with blocks.frozen_stats(bn):
        y = bn(x)
    assert torch.equal(bn.running_mean, torch.zeros(6))
    assert torch.equal(bn.running_var, torch.ones(6))
    assert bn.update_stats
    close(y.mean(dim=(0, 2, 3)), np.zeros(6), 1e-5)
    bn(x)
    close(bn.running_mean, 0.1 * x.mean(dim=(0, 2, 3)), 1e-5)


def test_dropout_masks_whole_channels_from_the_generator():
    x = torch.ones(64, 32, 3, 5)
    y = blocks.dropout(x, 0.5, torch.Generator().manual_seed(0),
                       channels=True)
    planes = y.flatten(2)
    assert torch.equal(planes.amin(-1), planes.amax(-1))
    assert set(planes[..., 0].unique().tolist()) == {0.0, 2.0}
    again = blocks.dropout(x, 0.5, torch.Generator().manual_seed(0),
                           channels=True)
    assert torch.equal(y, again)
    assert blocks.dropout(x, 0.0, None) is x


@pytest.mark.parametrize("case", ["conv_block", "res_same", "res_wider",
                                  "pool"])
def test_blocks_match(case):
    x = RNG.normal(size=(2, 9, 13, 8)).astype(np.float32)
    if case == "pool":
        close(nhwc(blocks.avg_pool_3x3_s2_refpad(nchw(x))),
              jblocks.avg_pool_3x3_s2_refpad(x), 1e-5)
        return
    if case == "conv_block":
        jm = jblocks.Conv2dBlock(12, 3, 1, 1, activation="lrelu",
                                 pad_type="reflect", activation_first=True,
                                 dtype=jnp.float32)
        tm = blocks.Conv2dBlock(8, 12, 3, 1, 1, pad_type="reflect",
                                activation_first=True, dtype=F32)
    else:
        fout = 8 if case == "res_same" else 16
        jm = jblocks.ActFirstResBlock(8, fout, dtype=jnp.float32)
        tm = blocks.ActFirstResBlock(8, fout, dtype=F32)
        assert hasattr(tm, "Conv2dBlock_2") == (fout != 8)
    v = random_variables(jm, x)
    close(nhwc(load_port(tm, v)(nchw(x))), jm.apply(v, x), 1e-4)


@pytest.mark.parametrize("player", ["dis", "cla"])
def test_discriminator_and_writer_classifier(player):
    if player == "dis":
        jm = JDis(32, 104, 1024, 5, jnp.float32)
        tm = Discriminator(32, 104, 1024, 5, F32)
        width = 1024
    else:
        jm = JCla(8, 32, 104, 5, jnp.float32)
        tm = WriterClassifier(8, 32, 104, 5, F32)
        width = 8
    v = random_variables(jm, IMG)
    got = load_port(tm, v)(nchw(IMG))
    assert got.shape == (4, width)
    close(got, jm.apply(v, IMG, train=True), 2e-3)


def test_generator_pair_train_mode():
    """encode_style once + generate twice in train mode: both images and
    every running statistic of G after its sequential updates."""
    jcfg = small_jax_config(**TRAIN_SMALL)
    jgen = JGenerator(jcfg)
    v = random_variables(jgen, STYLE[:1], LABELS, seed=4)
    (want_xg, want_swap), upd = jgen.apply(
        v, STYLE, LABELS, LABELS_SWAP, train=True, method=_pair_method,
        mutable=["batch_stats"])
    gen = load_port(Generator(small_torch_config(**TRAIN_SMALL)), v).train()
    xg, xg_swap = generate_pair(gen, torch.from_numpy(STYLE),
                                torch.from_numpy(LABELS).long(),
                                torch.from_numpy(LABELS_SWAP).long())
    close(nhwc(xg), want_xg, 1e-2, "xg")
    close(nhwc(xg_swap), want_swap, 1e-2, "xg_swap")
    _assert_stats(gen, _stats_of(gen, v, upd["batch_stats"]), 2e-3)


def test_recognizer_train_mode():
    jcfg = small_jax_config(**TRAIN_SMALL)
    jrec = JRecognizer(jcfg.vocab_size, jcfg.rec_hidden, jcfg.rec_embed,
                       jcfg.output_max_len, dropout=0.0, dtype=jnp.float32)
    v = random_variables(jrec, IMG, LABELS, seed=5)
    (want, _), upd = jrec.apply(v, IMG, LABELS, train=True,
                                mutable=["batch_stats"])
    rec = load_port(Recognizer(jcfg.vocab_size, jcfg.rec_hidden,
                               jcfg.rec_embed, jcfg.output_max_len, 32, F32,
                               dropout=0.0), v).train()
    got, _ = rec(nchw(IMG), torch.from_numpy(LABELS).long())
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))
    close(got, want, 2e-3, "logits")
    _assert_stats(rec, _stats_of(rec, v, upd["batch_stats"]), 2e-3)


def _rec_term_case():
    """R at the small config with random leaves, two batches of fakes (tanh
    images) and their labels."""
    jcfg = small_jax_config(**TRAIN_SMALL)
    jrec = JRecognizer(jcfg.vocab_size, jcfg.rec_hidden, jcfg.rec_embed,
                       jcfg.output_max_len, dropout=0.0, dtype=jnp.float32)
    v = random_variables(jrec, IMG, LABELS, seed=6)
    fakes = np.tanh(np.random.default_rng(8).normal(
        size=(2, 4, 32, 104, 1))).astype(np.float32)
    return jcfg, jrec, v, fakes, np.stack([LABELS, LABELS_SWAP])


def _jax_rec_term(jcfg, jrec, v, fakes, labels, jit: bool = True):
    """(l_rec, per-batch logits, d l_rec / d fakes) of the JAX package."""
    ls = jcfg.label_smoothing

    def l_rec(x):
        def one(img, lab):
            (logits, _), _ = jrec.apply(v, img, lab, train=True,
                                        mutable=["batch_stats"])
            return logits

        lp = [one(x[i], labels[i]) for i in range(2)]
        return 0.5 * (jlosses.rec_loss(lp[0], labels[0], ls)
                      + jlosses.rec_loss(lp[1], labels[1], ls)), lp

    fn = jax.value_and_grad(l_rec, has_aux=True)
    if jit:
        (loss, logits), grad = jax.jit(fn)(fakes)
    else:
        with jax.disable_jit():
            (loss, logits), grad = fn(fakes)
    return (float(loss), [np.asarray(p) for p in logits],
            np.asarray(grad, np.float64))


def _port_rec_term(jcfg, v, fakes, labels, f64: bool = False):
    """The same from the port's R, with its statistics frozen as the G
    phase freezes them; also whether the statistics stayed put."""
    ls = jcfg.label_smoothing
    rec = load_port(Recognizer(jcfg.vocab_size, jcfg.rec_hidden,
                               jcfg.rec_embed, jcfg.output_max_len, 32, F32,
                               dropout=0.0), v).train()
    stats = {k: t.clone() for k, t in rec.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    ctx = port_in_f64(rec) if f64 else contextlib.nullcontext()
    with ctx, blocks.frozen_stats(rec):
        xs = [nchw(f).to(torch.get_default_dtype()).requires_grad_()
              for f in fakes]
        lab = [torch.from_numpy(t).long() for t in labels]
        lp = [rec(x, t)[0] for x, t in zip(xs, lab)]
        loss = 0.5 * sum(losses.rec_loss(p, t, ls) for p, t in zip(lp, lab))
        grad = torch.autograd.grad(loss, xs)
    kept = all(torch.equal(rec.state_dict()[k].float(), t)
               for k, t in stats.items())
    return (float(loss.detach()), [p.detach().float().numpy() for p in lp],
            np.stack([nhwc(g).astype(np.float64) for g in grad]), kept)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_recognizer_term_gradient_into_the_fakes():
    """R's term of G's loss as the G phase computes it (train mode, batch
    statistics with their updates discarded, dropout 0, free-running),
    on two batches of fakes: the loss, R's greedy ids and the gradient
    with respect to both image batches, which is all that reaches G.  The
    ids clear their top-2 margins by far more than the packages' logits
    differ (checked), so none can flip.

    The gradient is held to 2e-2 relative L2 per batch, twice the
    reference's own error: against the port run in f64, the port's f32
    gradient is 1e-5 off, and the JAX package's jitted one 1.0e-2 on batch
    0 (2.6e-5 with jit disabled: the error enters in XLA's CPU program) and
    4.8e-3 on batch 1, jitted or not (``python
    tests/test_torch_train_modules.py`` prints these readings).  A cut or a
    wrong backward on this path is an O(1) error."""
    case = _rec_term_case()
    jcfg, _, v, fakes, labels = case
    want, want_logits, want_grad = _jax_rec_term(*case)
    got, got_logits, got_grad, kept = _port_rec_term(jcfg, v, fakes, labels)
    for p, w in zip(got_logits, want_logits):
        top2 = np.sort(w, -1)[..., -2:]
        assert (top2[..., 1] - top2[..., 0]).min() > 10 * np.abs(p - w).max()
        np.testing.assert_array_equal(p.argmax(-1), w.argmax(-1))
    close(got, want, 1e-5, "l_rec")
    for i in range(2):
        assert np.abs(want_grad[i]).max() > 0
        err = _rel(got_grad[i], want_grad[i])
        assert err <= 2e-2, (i, err)
    assert kept, "R's running statistics moved under frozen_stats"


def test_r_term_gradient_gap_is_the_reference_trunk_relu_flips():
    """Where the JAX package's gradient above leaves the port's on batch 1
    (R's loss on that batch alone: 4.79e-3 relative L2, 6.0e-3 max abs
    against the port in f64, jitted or not): its f32 forward through the
    VGG trunk puts a few pre-activations that lie within ~1e-5 of 0 on the
    other side of a ReLU, which then passes or blocks the gradient there.
    With the JAX package's f32 ReLU masks, the port computed in f64 gives
    the JAX package's gradient to 1e-4 (f32 noise, measured 2.7e-5); each
    other stage of R, given the same input and cotangent, agrees to 1e-5
    (``python tests/torch_rec_grad_stages.py`` prints both)."""
    from torch_rec_grad_stages import jax_relu_masks, port_f64, rel

    jcfg, jrec, v, fakes, labels = _rec_term_case()

    def l_rec(x):
        (logits, _), _ = jrec.apply(v, x, labels[1], train=True,
                                    mutable=["batch_stats"])
        return jlosses.rec_loss(logits, labels[1], jcfg.label_smoothing)

    want = np.asarray(jax.jit(jax.grad(l_rec))(fakes[1]), np.float64)
    want = want.transpose(0, 3, 1, 2)
    plain = port_f64(jcfg, v, fakes[1], labels[1])["d_x"]
    masked = port_f64(jcfg, v, fakes[1], labels[1],
                      jax_relu_masks(v, fakes[1]))["d_x"]
    assert rel(want, plain)[0] > 1e-3
    assert rel(want, masked)[0] <= 1e-4, rel(want, masked)


def test_losses_match():
    logits = RNG.normal(size=(4, 7, 55)).astype(np.float32) * 3
    patch = RNG.normal(size=(4, 1024)).astype(np.float32)
    wl = RNG.normal(size=(4, 8)).astype(np.float32)
    wid = np.asarray([0, 3, 7, 3], np.int32)
    a, b = IMG, IMG[::-1].copy()
    t = torch.from_numpy
    pairs = {
        "rec_loss": (losses.rec_loss(t(logits), t(LABELS).long()),
                     jlosses.rec_loss(logits, LABELS, 0.4)),
        "label_smoothing_kl": (
            losses.label_smoothing_kl(t(logits[0]), t(LABELS[1, 1:]).long(),
                                      0.1),
            jlosses.label_smoothing_kl(logits[0], LABELS[1, 1:], 0.1)),
        "dis_real": (losses.dis_real_loss(t(patch)),
                     jlosses.dis_real_loss(patch)),
        "dis_fake": (losses.dis_fake_loss(t(patch)),
                     jlosses.dis_fake_loss(patch)),
        "gen_adv": (losses.gen_adv_loss(t(patch)),
                    jlosses.gen_adv_loss(patch)),
        "writer_ce": (losses.writer_ce_loss(t(wl), t(wid)),
                      jlosses.writer_ce_loss(wl, wid)),
        "recon_l1": (losses.recon_l1(t(a), t(b)), jlosses.recon_l1(a, b)),
    }
    for name, (got, want) in pairs.items():
        close(float(got), float(want), 1e-5, name)


def rec_term_readings():
    """The readings the R-term limit rests on: per batch of fakes, the
    relative L2 error of d l_rec / d fakes against the port's f64 one."""
    case = _rec_term_case()
    jcfg, _, v, fakes, labels = case
    ref = _port_rec_term(jcfg, v, fakes, labels, f64=True)[2]
    rows = {"port f32": _port_rec_term(jcfg, v, fakes, labels)[2],
            "JAX f32, jitted": _jax_rec_term(*case)[2],
            "JAX f32, jit disabled": _jax_rec_term(*case, jit=False)[2]}
    for what, g in rows.items():
        print(f"{what} vs port f64: " + ", ".join(
            f"batch {i} {_rel(g[i], ref[i]):.3g}" for i in range(2)))


if __name__ == "__main__":
    rec_term_readings()
