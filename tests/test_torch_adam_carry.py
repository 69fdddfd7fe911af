"""The Adam state carried over from the JAX package, on the CPU.

``utils/from_flax.py:word_gan_from_flax(..., with_optimizers=True)`` turns
a JAX ``WordGanState``, optax Adam state included (``inject_hyperparams``
for R, whose rate is set apart from the config's first), into a
checkpoint dict of ``core/checkpoint.py``.  Limit: one more
optax update against one ``opt.step()`` from the converted state, every
parameter of all four players within 1e-6 relative.  The same given
gradient on both sides keeps the step's own ill-conditioning (PERF.md)
out of the comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from affganwriting_torch.core.checkpoint import load_payload
from affganwriting_torch.train.state import PLAYERS, init_state
from affganwriting_torch.utils.from_flax import (
    convert_module,
    word_gan_from_flax,
)
from test_torch_support import (
    TRAIN_SMALL,
    jax_word_gan_state,
    small_jax_config,
    small_torch_config,
    to_numpy_tree,
    word_batch,
)

torch.set_num_threads(2)   # tier-1 runs six xdist workers


def test_adam_state_carries_over_from_the_jax_package():
    """A JAX state after one Adam step on a random gradient, converted with
    its optimizer state; then one more update from the same gradient on
    both sides: every parameter of all four players within 1e-6 relative
    (of its leaf's largest entry).  Without the moments, the step would
    be a fresh Adam's first, off by ~1e-4 absolute here."""
    jcfg = small_jax_config(**TRAIN_SMALL)
    tcfg = small_torch_config(**TRAIN_SMALL)
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
    # R's rate moved as the JAX trainer's plateau step moves it, so a
    # converter that took the config's rate would miss it
    rec_opt = one.rec.opt_state
    hp = dict(rec_opt.hyperparams,
              learning_rate=jnp.asarray(tcfg.lr_rec * 0.1, jnp.float32))
    one = one.replace(rec=one.rec.replace(
        opt_state=rec_opt._replace(hyperparams=hp)))
    payload = word_gan_from_flax(to_numpy_tree(one), tcfg,
                                 with_optimizers=True)
    assert payload["rec"]["opt"]["param_groups"][0]["lr"] == \
        pytest.approx(tcfg.lr_rec * 0.1)
    port = load_payload(init_state(tcfg, "cpu", rec_dropout=0.0), payload)
    assert port.step == 0
    want = word_gan_from_flax(to_numpy_tree(update(one, g2)), tcfg)
    for n in PLAYERS:
        model, opt = getattr(port, n).model, getattr(port, n).opt
        assert all(s["step"] == 1 for s in opt.state.values())
        grads = convert_module({"params": g2[n]}, model, params_only=True)
        for name, p in model.named_parameters():
            p.grad = grads[name]
        opt.step()
        for k, w in want[n].items():
            if k.endswith(("running_mean", "running_var")):
                continue
            got = model.state_dict()[k]
            lim = 1e-6 * max(float(w.abs().max()), 1e-6)
            assert float((got - w).abs().max()) <= lim, (n, k)
