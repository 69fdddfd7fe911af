"""The four-player step and the Adam carry-over with a non-resnet style
encoder: a tiny dinov2 (embed 64, 4 heads, 4 blocks, each tapped), added to
both packages' ``_ARCHS`` under "s" for this file (the JAX module is
patched, never edited), fp32 on the CPU.

The merged step follows tests/test_torch_train_step.py: the same
configuration, batch and limits (``affganwriting_torch/train/parity.py``),
with ``style_encoder="dinov2_s"``.  The Adam carry-over follows
tests/test_torch_adam_carry.py: ``word_gan_from_flax(...,
with_optimizers=True)`` maps optax's moments of the attention's (D, H, hd)
kernels through the same layouts as the parameters; one more update within
1e-6 relative.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import affganwriting_tpu.models.style_encoders.vit as jvit
import affganwriting_torch.models.style_encoders.vit as tvit
from affganwriting_torch.core.checkpoint import load_payload
from affganwriting_torch.train.parity import (
    LOSS_TOL,
    STATS_TOL,
    STEP_BATCH,
    STEP_CONFIG,
    XG_TOL,
    delta_errors,
    delta_ok,
    is_stat,
)
from affganwriting_torch.train.state import PLAYERS, init_state
from affganwriting_torch.utils.from_flax import (
    convert_module,
    word_gan_from_flax,
)
from test_torch_support import (
    TRAIN_SMALL,
    close,
    jax_word_gan_state,
    small_jax_config,
    small_torch_config,
    to_numpy_tree,
    word_batch,
)
from test_torch_train_step import BATCH_SEED, _jax_step, _port_step

torch.set_num_threads(2)   # tier-1 runs six xdist workers

TINY_VIT = dict(embed=64, depth=4, heads=4, taps=(0, 1, 2, 3))
ENC = dict(style_encoder="dinov2_s")


@pytest.fixture(scope="module")
def tiny_vit():
    with pytest.MonkeyPatch.context() as mp:
        for archs in (jvit._ARCHS, tvit._ARCHS):
            mp.setitem(archs, "s", TINY_VIT)
        yield


@pytest.fixture(scope="module")
def runs(tiny_vit):
    jcfg = small_jax_config(**STEP_CONFIG, **ENC)
    tcfg = small_torch_config(**STEP_CONFIG, **ENC)
    batch = word_batch(tcfg, STEP_BATCH, BATCH_SEED)
    want = _jax_step(jcfg, tcfg, batch)
    return want, _port_step(tcfg, want["before"], batch)


def test_metrics_and_fakes_match(runs):
    want, got = runs
    assert any(k.startswith("enc_image.block3.attn.query")
               for k in want["before"]["gen"])
    for k, w in want["metrics"].items():
        assert abs(got["metrics"][k] - w) <= LOSS_TOL * max(1.0, abs(w)), \
            (k, got["metrics"][k], w)
    err = np.abs(got["extras"]["xg"] - want["extras"]["xg"]).max()
    assert err <= XG_TOL, err


@pytest.mark.parametrize("name", PLAYERS)
def test_parameter_deltas_match(runs, name):
    want, got = runs
    before = want["before"][name]
    l2, per_leaf = delta_errors(got["after"][name], want["after"][name],
                                before)
    worst = max(per_leaf, key=per_leaf.get)
    assert delta_ok(name, l2, per_leaf), (name, l2, worst, per_leaf[worst])
    enc = [k for k in per_leaf if k.startswith("enc_image.")]
    assert name != "gen" or len(enc) > 50


@pytest.mark.parametrize("name", ["gen", "rec"])
def test_running_stats_match(runs, name):
    """G's (iAFF's; the encoder has none) and R's statistics move."""
    want, got = runs
    keys = [k for k in want["after"][name] if is_stat(k)]
    assert keys and not any(k.startswith("enc_image.") for k in keys)
    for k in keys:
        assert not torch.equal(want["after"][name][k],
                               want["before"][name][k]), k
        close(got["after"][name][k], want["after"][name][k], STATS_TOL, k)


def test_adam_state_carries_over_with_the_encoder(tiny_vit):
    jcfg = small_jax_config(**TRAIN_SMALL, **ENC)
    tcfg = small_torch_config(**TRAIN_SMALL, **ENC)
    batch = word_batch(tcfg, 2, 5)
    jstate, _ = jax_word_gan_state(jcfg, batch)
    from affganwriting_tpu.train.state import make_optimizers as jopts

    opts = jopts(jcfg)
    rng = np.random.default_rng(0)

    def grads_like(params, scale):
        return jax.tree.map(lambda p: np.asarray(
            rng.normal(size=p.shape) * scale, np.float32), params)

    @jax.jit
    def update(state, grads):
        new = {}
        for n in PLAYERS:
            p = getattr(state, n)
            u, s = opts[n].update(grads[n], p.opt_state, p.params)
            new[n] = p.replace(params=optax.apply_updates(p.params, u),
                               opt_state=s)
        return state.replace(**new)

    g1 = {n: grads_like(getattr(jstate, n).params, 1e-2) for n in PLAYERS}
    g2 = {n: grads_like(getattr(jstate, n).params, 3e-2) for n in PLAYERS}
    one = update(jstate, g1)
    payload = word_gan_from_flax(to_numpy_tree(one), tcfg,
                                 with_optimizers=True)
    port = load_payload(init_state(tcfg, "cpu", rec_dropout=0.0), payload)
    want = word_gan_from_flax(to_numpy_tree(update(one, g2)), tcfg)
    model, opt = port.gen.model, port.gen.opt
    grads = convert_module({"params": g2["gen"]}, model, params_only=True)
    for name, p in model.named_parameters():
        p.grad = grads[name]
    opt.step()
    got = model.state_dict()
    checked = 0
    for k, w in want["gen"].items():
        if is_stat(k):
            continue
        lim = 1e-6 * max(float(w.abs().max()), 1e-6)
        assert float((got[k] - w).abs().max()) <= lim, k
        checked += k.startswith("enc_image.block")
    assert checked == 4 * 16   # 4 blocks x 8 layers (2 norms, q, k, v, out, 2 mlp) x 2
