"""The port's ``activation_fn``, ``ResBlock`` and ``LinearBlock``
(``affganwriting_torch/models/blocks.py``) vs the JAX package's, f32 on the
CPU, atol/rtol 1e-5.

No module of either package uses these three (the decoder's residual
blocks are the AdaIN ones): these tests are their users.  Random flax
leaves (tests/test_torch_support.py) are converted by
``utils/from_flax.convert_module``; ``ResBlock`` goes through each
``pad_type`` and each norm its ``Conv2dBlock`` takes, ``LinearBlock``
through each norm it takes, both in train mode (BatchNorm on the batch's
statistics, its running statistics moved as flax moves them) and in eval
mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affganwriting_tpu.models import blocks as jblocks
from affganwriting_torch.models import blocks
from test_torch_support import close, load_port, nchw, nhwc, random_variables

torch.set_num_threads(2)   # tier-1 runs six xdist workers

TOL = 1e-5


@pytest.mark.parametrize("name", ["relu", "lrelu", "tanh", "none"])
def test_activation_fn_matches(name):
    x = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32) * 3
    want, got = jblocks.activation_fn(name), blocks.activation_fn(name)
    assert (want is None) == (got is None)
    if want is not None:
        close(got(torch.from_numpy(x)), want(jnp.asarray(x)), TOL, name)


def test_activation_fn_refuses_an_unknown_name():
    for fn in (jblocks.activation_fn, blocks.activation_fn):
        with pytest.raises(ValueError, match="unknown activation 'gelu'"):
            fn("gelu")


def _run(jmod, tmod, x, train: bool, to_port, from_port):
    """Both modules on ``x`` from the same random leaves: (port output,
    JAX output, the port module, JAX batch statistics after)."""
    variables = random_variables(jmod, x, seed=3)
    load_port(tmod, variables).train(train)
    if train:
        want, updates = jmod.apply(variables, x, train=True,
                                   mutable=["batch_stats"])
        stats = updates.get("batch_stats", {})
    else:
        want, stats = jmod.apply(variables, x, train=False), {}
    got = tmod(to_port(x))
    return from_port(got), np.asarray(want), tmod, stats


def _bn_stats(tmod, stats: dict):
    """(port buffer, flax leaf) pairs of every BatchNorm's statistics
    after a train-mode call (none in eval mode)."""
    pairs = []
    if not stats:
        return pairs
    for name, m in tmod.named_modules():
        if isinstance(m, blocks.BatchNorm):
            node = stats
            for part in name.split("."):
                node = node[part]
            pairs += [(m.running_mean, node["mean"]),
                      (m.running_var, node["var"])]
    return pairs


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("pad_type,norm", [
    ("reflect", "in"), ("replicate", "in"), ("zero", "in"),
    ("reflect", "bn"), ("reflect", "group"), ("zero", "none")])
def test_res_block_matches(pad_type, norm, train):
    dim = 16
    x = np.random.default_rng(1).normal(size=(2, 6, 10, dim)) \
        .astype(np.float32)
    jmod = jblocks.ResBlock(dim, norm=norm, pad_type=pad_type,
                            dtype=jnp.float32)
    tmod = blocks.ResBlock(dim, norm=norm, pad_type=pad_type,
                           dtype=torch.float32)
    got, want, tmod, stats = _run(jmod, tmod, x, train, nchw, nhwc)
    close(got, want, TOL, f"{pad_type} {norm}")
    pairs = _bn_stats(tmod, stats)
    assert len(pairs) == (4 if norm == "bn" and train else 0)
    for port, flax in pairs:
        close(port, flax, TOL, "running statistics")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("norm,activation", [
    ("none", "relu"), ("bn", "relu"), ("bn", "lrelu"), ("none", "none")])
def test_linear_block_matches(norm, activation, train):
    x = np.random.default_rng(2).normal(size=(6, 12)).astype(np.float32)
    jmod = jblocks.LinearBlock(20, norm=norm, activation=activation,
                               dtype=jnp.float32)
    tmod = blocks.LinearBlock(12, 20, norm=norm, activation=activation,
                              dtype=torch.float32)
    got, want, tmod, stats = _run(jmod, tmod, x, train, torch.from_numpy,
                                  lambda t: t.detach().numpy())
    close(got, want, TOL, f"{norm} {activation}")
    pairs = _bn_stats(tmod, stats)
    assert len(pairs) == (2 if norm == "bn" and train else 0)
    for port, flax in pairs:
        close(port, flax, TOL, "running statistics")
