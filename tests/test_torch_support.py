"""Shared helpers of the PyTorch-port parity tests (no tests here).

The JAX side is the reference: its variables are built with
``jax.eval_shape`` and every leaf (kernels, biases, BatchNorm scales and
statistics) is filled from a seeded numpy generator, so a swapped or
skipped mapping in ``utils/from_flax`` cannot hide behind flax's zero
biases and unit statistics.  Inputs are numpy arrays handed to both sides.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from affganwriting_tpu.core.config import default_config
from affganwriting_torch.utils.from_flax import convert_module

# the small fp32 resnet50 configuration of __graft_entry__.py's dryrun
SMALL = dict(compute_dtype="float32", img_height=32, img_width=104,
             max_chars=6, style_dim=64, adain_param_dim=512,
             text_embed_dim=16, rec_hidden=64, rec_embed=16)


def small_jax_config():
    return default_config().replace(**SMALL)


def small_torch_config():
    from affganwriting_torch.core.config import default_config as tdefault

    return tdefault().replace(**SMALL)


def _fill(path, leaf, rng):
    names = [str(getattr(k, "key", k)) for k in path]
    name, shape = names[-1], leaf.shape
    if names[0] == "batch_stats":
        if name == "mean":
            return rng.normal(0.0, 0.1, shape)
        return rng.uniform(0.5, 1.5, shape)
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        return rng.normal(0.0, 1.0, shape) / np.sqrt(fan_in)
    if name == "scale":
        return rng.uniform(0.5, 1.5, shape)
    if name == "embedding":
        return rng.normal(0.0, 1.0, shape)
    return rng.normal(0.0, 0.1, shape)          # biases


def random_variables(module, *args, seed: int = 0, **kwargs):
    """Flax variables of ``module.init(key, *args)``, every leaf drawn from
    numpy (float32) instead of flax's initializers."""
    shapes = jax.eval_shape(lambda key: module.init(key, *args, **kwargs),
                            jax.random.key(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, l: np.asarray(_fill(p, l, rng), np.float32), shapes)


def to_numpy_tree(variables):
    return jax.tree.map(np.asarray, variables)


def load_port(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load converted flax ``variables`` into the port's ``module``."""
    module.load_state_dict(convert_module(to_numpy_tree(variables), module),
                           strict=True)
    return module.eval().requires_grad_(False)


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def close(got, want, tol: float, what: str = "") -> None:
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=what)
