"""Flax variables of the JAX package -> state dicts of the port.

The inverse of ``affganwriting_tpu/utils/torch_import.py``'s layouts.  The
caller hands the flax trees over as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, variables)``), so this module never sees jax.

- conv kernels (KH, KW, I, O) -> (O, I, KH, KW); 1-D conv kernels (K, I, O)
  -> (O, I, K); dense kernels (I, O) -> (O, I).  The upsample (5, 5, Cin, Co)
  and head (7, 7, C, 1) kernels are transposed the same way: the port folds
  them in forward, as the JAX package does.
- ``scale``/``bias`` -> ``weight``/``bias``; ``embedding`` -> ``weight``;
  ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``.
- A depthwise kernel (k, k, 1, C) -> (C, 1, k, k), the patch embedding
  (14, 14, 50, D) -> (D, 50, 14, 14): the conv rule.  ``pos_embed`` keeps
  its (1, N, D); LayerNorm's ``scale`` is its ``weight``.
- flax attention (``MultiHeadDotProductAttention``: ``query``, ``key``,
  ``value`` kernels (D, H, hd) with (H, hd) biases, ``out`` kernel
  (H, hd, D)) -> four linears, the heads flattened head-major: q, k, v
  weights (H * hd, D), biases (H * hd,), ``out`` weight (D, H * hd).
- GRU cells (``ir iz in`` with bias, ``hr hz`` without, ``hn`` with) stack
  as torch's [r, z, n] with ``bias_hh = [0, 0, b_hn]``.  The recognizer's
  BiGRU keeps its four cells at ``enc/rnn/GRUCell_0..3`` in the order fwd0,
  bwd0, fwd1, bwd1: cell k goes to the one-layer bidirectional ``gru{k //
  2}``, its ``_reverse`` weights when k is odd; the decoder's
  cells are ``dec/gru0`` and ``dec/gru1``.

``from_flax`` raises on any flax leaf it did not consume, and on any port
parameter or buffer it did not fill or filled with the wrong shape.

Optimizer state (``word_gan_from_flax(..., with_optimizers=True)``): optax
``adam``'s ``mu``, ``nu`` and ``count`` (under ``inject_hyperparams`` for R)
become ``torch.optim.Adam``'s ``exp_avg``, ``exp_avg_sq`` and ``step``.  The
moments are parameter-shaped trees and take the parameters' layout maps,
the GRU stacking included, so the recurrent r and z biases that torch has
and flax lacks get zero moments.  R's injected ``learning_rate`` becomes
its param group's ``lr``.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

from affganwriting_torch.core.config import WordGanConfig
from affganwriting_torch.models.generator import Generator
from affganwriting_torch.models.recognizer.seq2seq import Recognizer
from affganwriting_torch.train.state import (
    PLAYERS,
    make_optimizers,
    new_models,
)

_GRU_GATES = frozenset(("ir", "iz", "in", "hr", "hz", "hn"))
_ATTENTION = frozenset(("query", "key", "value", "out"))
_KERNEL_PERM = {4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}
_PARAM_LEAVES = {"bias": "bias", "scale": "weight", "embedding": "weight",
                 "pos_embed": "pos_embed"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _key(*parts: str) -> str:
    return ".".join(p for p in parts if p)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _gru(cell: Mapping, prefix: str, suffix: str, path: tuple,
         out: dict, consumed: set) -> None:
    def take(gate, leaf):
        consumed.add(path + (gate, leaf))
        return np.asarray(cell[gate][leaf], np.float32)

    w_ih = np.concatenate([take(g, "kernel").T for g in ("ir", "iz", "in")])
    w_hh = np.concatenate([take(g, "kernel").T for g in ("hr", "hz", "hn")])
    b_ih = np.concatenate([take(g, "bias") for g in ("ir", "iz", "in")])
    b_hn = take("hn", "bias")
    b_hh = np.concatenate([np.zeros_like(b_hn), np.zeros_like(b_hn), b_hn])
    for name, v in (("weight_ih", w_ih), ("weight_hh", w_hh),
                    ("bias_ih", b_ih), ("bias_hh", b_hh)):
        out[_key(prefix, name + suffix)] = _t(v)


def _attention(node: Mapping, prefix: str, path: tuple, out: dict,
               consumed: set) -> None:
    for proj, leaves in node.items():
        for leaf, value in leaves.items():
            a = np.asarray(value, np.float32)
            if proj == "out" and leaf == "kernel":        # (H, hd, D)
                a = a.reshape(-1, a.shape[-1]).T
            elif leaf == "kernel":                         # (D, H, hd)
                a = a.reshape(a.shape[0], -1).T
            else:                                          # (H, hd) or (D,)
                a = a.reshape(-1)
            out[_key(prefix, proj, "weight" if leaf == "kernel" else leaf)] \
                = _t(a)
            consumed.add(path + (proj, leaf))


def _walk(node: Mapping, path: tuple, collection: str, out: dict,
          consumed: set) -> None:
    for name, child in node.items():
        p = path + (name,)
        if isinstance(child, Mapping):
            if collection == "params" and set(child) == _ATTENTION:
                _attention(child, _key(*p), (collection,) + p, out, consumed)
            elif collection == "params" and set(child) == _GRU_GATES:
                m = re.fullmatch(r"GRUCell_(\d+)", name)
                if m:       # a BiGRU cell: layer k // 2, odd k reversed
                    k = int(m.group(1))
                    prefix = _key(*path, f"gru{k // 2}")
                    suffix = "_l0" + ("_reverse" if k % 2 else "")
                else:
                    prefix, suffix = _key(*p), ""
                _gru(child, prefix, suffix, (collection,) + p, out, consumed)
            else:
                _walk(child, p, collection, out, consumed)
            continue
        arr = np.asarray(child)
        if collection == "batch_stats":
            leaf, value = _STAT_LEAVES.get(name), arr
        elif name == "kernel" and arr.ndim in _KERNEL_PERM:
            leaf, value = "weight", arr.transpose(_KERNEL_PERM[arr.ndim])
        else:
            leaf, value = _PARAM_LEAVES.get(name), arr
        if leaf is None:
            continue                    # left unconsumed: reported below
        out[_key(*path, leaf)] = _t(value)
        consumed.add((collection,) + p)


def _leaves(tree: Mapping, path: tuple = ()) -> set:
    found = set()
    for k, v in tree.items():
        if isinstance(v, Mapping):
            found |= _leaves(v, path + (k,))
        else:
            found.add(path + (k,))
    return found


def convert_module(variables: Mapping, module: torch.nn.Module, *,
                   params_only: bool = False) -> dict:
    """Flax ``variables`` of one module -> a state dict for the port's
    counterpart ``module`` (which may live on the meta device); with
    ``params_only``, {parameter name: tensor} for a parameter-shaped tree
    under ``variables["params"]`` (an optimizer moment).  Raises on any
    flax leaf not consumed and on any of ``module``'s parameters (and,
    unless ``params_only``, buffers) not filled, or filled with the wrong
    shape."""
    tensors = (module.named_parameters() if params_only
               else module.state_dict().items())
    expected = {k: tuple(v.shape) for k, v in tensors}
    out: dict[str, torch.Tensor] = {}
    consumed: set = set()
    for collection in ("params", "batch_stats"):
        if collection in variables:
            _walk(variables[collection], (), collection, out, consumed)
    problems = []
    left = sorted("/".join(p) for p in _leaves(variables) - consumed)
    if left:
        problems.append(f"flax leaves not consumed: {left}")
    missing = sorted(set(expected) - set(out))
    if missing:
        problems.append(f"port tensors not filled: {missing}")
    extra = sorted(set(out) - set(expected))
    if extra:
        problems.append(f"converted tensors the port lacks: {extra}")
    bad = sorted(f"{k}: flax gives {tuple(out[k].shape)}, port has "
                 f"{expected[k]}" for k in set(out) & set(expected)
                 if tuple(out[k].shape) != expected[k])
    if bad:
        problems.append(f"shape mismatches: {bad}")
    if problems:
        raise ValueError(f"from_flax ({type(module).__name__}): "
                         + "; ".join(problems))
    return out


def _find(node, pred):
    """The first node of an optax state (nested tuples, named tuples and
    dicts) for which ``pred`` holds, depth first; None if none does."""
    if pred(node):
        return node
    children = node.values() if isinstance(node, Mapping) else (
        node if isinstance(node, tuple) else ())
    for child in children:
        found = _find(child, pred)
        if found is not None:
            return found
    return None


def optimizer_from_flax(opt_state, module: torch.nn.Module,
                        opt: torch.optim.Optimizer) -> dict:
    """One player's optax state -> a state dict for ``opt``, the port's
    optimizer over ``module``'s parameters (``make_optimizers``; it may
    live on the meta device): Adam's moments and step where the optax state
    has them (SGD has none), and an injected ``learning_rate`` as the
    group's ``lr``."""
    out = opt.state_dict()
    adam = _find(opt_state, lambda n: hasattr(n, "mu") and hasattr(n, "nu"))
    if adam is not None:
        mu, nu = (convert_module({"params": tree}, module, params_only=True)
                  for tree in (adam.mu, adam.nu))
        step = float(np.asarray(adam.count))
        out["state"] = {
            i: {"step": torch.tensor(step), "exp_avg": mu[name],
                "exp_avg_sq": nu[name]}
            for i, (name, _) in enumerate(module.named_parameters())}
    hyper = _find(opt_state, lambda n: isinstance(
        getattr(n, "hyperparams", None), Mapping))
    if hyper is not None:
        for group in out["param_groups"]:
            group["lr"] = float(np.asarray(hyper.hyperparams["learning_rate"]))
    return out


def word_gan_from_flax(jax_state, config: WordGanConfig, *,
                       with_optimizers: bool = False) -> dict:
    """A JAX ``WordGanState`` with numpy leaves (``jax.tree.map(np.asarray,
    state)``) -> {"gen", "dis", "cla", "rec"} state dicts for
    ``train/state.py:init_state(weights=...)``: every player's params and
    batch statistics, with ``convert_module``'s leaf accounting.

    With ``with_optimizers``, the whole state as a checkpoint dict of
    ``core/checkpoint.py`` instead: ``{"step", name: {"model": state dict,
    "opt": optimizer state dict or None}}``, for ``load_payload`` into an
    ``init_state(config, ...)``."""
    with torch.device("meta"):
        models = new_models(config)
        opts = make_optimizers(config, models)
    out = {}
    for name in PLAYERS:
        player = getattr(jax_state, name)
        variables = {"params": player.params}
        if player.stats:
            variables["batch_stats"] = player.stats
        out[name] = convert_module(variables, models[name])
        if with_optimizers:
            out[name] = {"model": out[name], "opt": None
                         if opts[name] is None else optimizer_from_flax(
                             player.opt_state, models[name], opts[name])}
    if with_optimizers:
        out["step"] = int(np.asarray(jax_state.step))
    return out


def from_flax(gen_variables: Mapping, rec_variables: Mapping,
              config: WordGanConfig):
    """(G, R) flax variables -> (G, R) state dicts for the port's modules
    built from ``config``."""
    with torch.device("meta"):
        gen = Generator(config)
        rec = Recognizer(config.vocab_size, config.rec_hidden,
                         config.rec_embed, config.output_max_len,
                         config.img_height)
    return (convert_module(gen_variables, gen),
            convert_module(rec_variables, rec))
