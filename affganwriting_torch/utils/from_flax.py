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
  The port's modules carry flax's submodule names, so these rules convert
  the blocks of ``models/blocks.py`` as they stand: ``Conv2dBlock_k/
  Conv_0``, ``BatchNorm_0`` and ``GroupNorm_0`` of ``Conv2dBlock``,
  ``ActFirstResBlock`` and ``ResBlock``, ``Dense_0`` and ``BatchNorm_0``
  of ``LinearBlock``.
- A depthwise kernel (k, k, 1, C) -> (C, 1, k, k), the patch embedding
  (14, 14, 50, D) -> (D, 50, 14, 14): the conv rule.  ``pos_embed`` keeps
  its (1, N, D); LayerNorm's ``scale`` is its ``weight``.
- TrOCR (``models/recognizer/trocr.py``, whose module names are the flax
  tree's): ``cls_token`` and the decoder's ``embed_positions`` table keep
  their shapes; the ViT attention's ``query``/``key``/``value``/``out``
  are plain (D, D) Dense kernels, which the attention rule below reshapes
  to themselves and transposes as the dense rule would.
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
- LSTM cells (flax ``OptimizedLSTMCell``: input kernels ``ii if ig io``
  without bias, hidden kernels ``hi hf hg ho`` with bias) stack as torch's
  [i, f, g, o] with ``bias_ih`` 0.  The line HWRs keep their two cells at
  ``OptimizedLSTMCell_0`` (forward) and ``_1`` (backward): cell k goes to
  the bidirectional ``lstm``, its ``_reverse`` weights when k is odd.
- The line models (``line_from_flax``): the stacked per-class parameters
  of the char-style banks (``w1``, ..., ``bf2``, ``fill_*``) and the
  spacer's ``mean``/``std`` keep their flax shapes; an equal-lr ``weight``
  (kh, kw, I, O) takes the conv rule, a noise weight (C,) stays.

- The line GAN (``line_state_from_flax``): ``DiscriminatorAP`` by the
  conv rule, its spectral-norm ``batch_stats`` (``SpectralNorm_<k>/<conv>/
  kernel/u`` and ``/sigma``) as the buffers ``<conv>.u`` and ``.sigma``;
  the ``Autoencoder`` (and its ``EHWRHead``) by the generic rules of
  ``convert_module``; the partitioned main optimizer
  (optax ``multi_transform`` over main/slow/frozen) as one
  ``train/schedules.py:PartitionedAdam``.  ``flax_paths`` reads the name
  map backwards: port parameter -> JAX path string.
- The pretrained line checkpoints: a JAX ``hwr_final`` tree
  (``hwr_final_from_flax``) and ``ae_final`` tree (``ae_final_from_flax``)
  -> the payloads that the port's ``cli/train_hwr`` and ``cli/train_auto``
  write (the port never reads an orbax directory: orbax needs jax).

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
from affganwriting_torch.gen.inference import new_recognizer
from affganwriting_torch.models.generator import Generator
from affganwriting_torch.train.state import (
    PLAYERS,
    make_optimizers,
    new_models,
)

_GRU_GATES = frozenset(("ir", "iz", "in", "hr", "hz", "hn"))
_LSTM_GATES = frozenset(("ii", "if", "ig", "io", "hi", "hf", "hg", "ho"))
_ATTENTION = frozenset(("query", "key", "value", "out"))
_KERNEL_PERM = {4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}
_PARAM_LEAVES = {"bias": "bias", "scale": "weight", "embedding": "weight",
                 "pos_embed": "pos_embed", "cls_token": "cls_token",
                 "embed_positions": "embed_positions"}
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


def _lstm(cell: Mapping, prefix: str, suffix: str, path: tuple,
          out: dict, consumed: set) -> None:
    def take(gate, leaf):
        consumed.add(path + (gate, leaf))
        return np.asarray(cell[gate][leaf], np.float32)

    w_ih = np.concatenate([take(g, "kernel").T for g in ("ii", "if", "ig",
                                                          "io")])
    w_hh = np.concatenate([take(g, "kernel").T for g in ("hi", "hf", "hg",
                                                          "ho")])
    b_hh = np.concatenate([take(g, "bias") for g in ("hi", "hf", "hg", "ho")])
    for name, v in (("weight_ih", w_ih), ("weight_hh", w_hh),
                    ("bias_ih", np.zeros_like(b_hh)), ("bias_hh", b_hh)):
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
          consumed: set, extra: Mapping, paths: dict | None = None) -> None:
    """``paths``, when given, maps each port key filled from one flax leaf
    to that leaf's path string (``a/b/kernel``)."""
    for name, child in node.items():
        p = path + (name,)
        if isinstance(child, Mapping):
            if collection == "params" and set(child) == _ATTENTION:
                _attention(child, _key(*p), (collection,) + p, out, consumed)
            elif collection == "params" and set(child) == _LSTM_GATES:
                k = int(re.fullmatch(r"OptimizedLSTMCell_(\d+)",
                                     name).group(1))
                _lstm(child, _key(*path, "lstm"),
                      "_l0" + ("_reverse" if k % 2 else ""),
                      (collection,) + p, out, consumed)
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
                _walk(child, p, collection, out, consumed, extra, paths)
            continue
        arr = np.asarray(child)
        if collection == "batch_stats":
            leaf, value = _STAT_LEAVES.get(name), arr
        elif name in extra:
            leaf, value = name, extra[name](arr)
        elif name == "kernel" and arr.ndim in _KERNEL_PERM:
            leaf, value = "weight", arr.transpose(_KERNEL_PERM[arr.ndim])
        else:
            leaf, value = _PARAM_LEAVES.get(name), arr
        if leaf is None:
            continue                    # left unconsumed: reported below
        out[_key(*path, leaf)] = _t(value)
        consumed.add((collection,) + p)
        if paths is not None:
            paths[_key(*path, leaf)] = "/".join(p)


def _leaves(tree: Mapping, path: tuple = ()) -> set:
    found = set()
    for k, v in tree.items():
        if isinstance(v, Mapping):
            found |= _leaves(v, path + (k,))
        else:
            found.add(path + (k,))
    return found


def convert_module(variables: Mapping, module: torch.nn.Module, *,
                   params_only: bool = False,
                   extra: Mapping | None = None,
                   paths: dict | None = None) -> dict:
    """Flax ``variables`` of one module -> a state dict for the port's
    counterpart ``module`` (which may live on the meta device); with
    ``params_only``, {parameter name: tensor} for a parameter-shaped tree
    under ``variables["params"]`` (an optimizer moment).  Raises on any
    flax leaf not consumed and on any of ``module``'s parameters (and,
    unless ``params_only``, buffers) not filled, or filled with the wrong
    shape.  ``extra`` maps further parameter leaf names to functions of
    the flax array giving the port's tensor, under the same name;
    ``paths`` (a dict) receives ``_walk``'s map of port keys to flax
    paths."""
    tensors = (module.named_parameters() if params_only
               else module.state_dict().items())
    expected = {k: tuple(v.shape) for k, v in tensors}
    out: dict[str, torch.Tensor] = {}
    consumed: set = set()
    for collection in ("params", "batch_stats"):
        if collection in variables:
            _walk(variables[collection], (), collection, out, consumed,
                  extra or {}, paths)
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
        rec = new_recognizer(config)
    return (convert_module(gen_variables, gen),
            convert_module(rec_variables, rec))


def gen_quant_from_flax(quant: Mapping) -> dict[str, torch.Tensor]:
    """The JAX generator's calibrated ``"quant"`` collection
    (``calibrate_gen_quant(...)["quant"]``, numpy leaves ``dec/<site>/
    amax``) -> {site path: amax} for ``gen/inference.py:load_gen_quant``."""
    out = {}
    for path in _leaves(quant):
        if path[0] != "dec" or path[-1] != "amax":
            raise ValueError(f"not a decoder quant site: {'/'.join(path)}")
        node = quant
        for k in path:
            node = node[k]
        out["/".join(path[1:-1])] = _t(node)
    return out


def vgg_qparams_from_flax(qparams: Mapping) -> dict:
    """JAX ``ops/quant.py:prepare_vgg_quant`` output (numpy leaves) -> the
    port's: int8 HWIO kernels ``wq``/``wq_gray`` -> (O, I, kh, kw); ``sw``,
    ``sw_gray``, ``b`` and ``amax`` as f32 tensors."""
    layers = []
    for layer in qparams["layers"]:
        entry = {}
        for k, v in layer.items():
            a = np.asarray(v)
            entry[k] = (torch.from_numpy(np.ascontiguousarray(
                a.transpose(3, 2, 0, 1)).astype(np.int8))
                if k in ("wq", "wq_gray") else _t(a))
        layers.append(entry)
    return {"layers": layers}


_LINE_LEAVES = {
    **{k: (lambda a: a) for k in (
        "w1", "b1", "g1s", "g1b", "w2", "b2", "w3", "b3", "g2s", "g2b",
        "wf1", "bf1", "wf2", "bf2", "fill_w1", "fill_b1", "fill_w2",
        "fill_b2", "mean", "std")},
    "weight": lambda a: a.transpose(3, 2, 0, 1) if a.ndim == 4 else a,
}


def line_from_flax(variables: Mapping, module: torch.nn.Module) -> dict:
    """Flax variables (params and batch_stats, numpy leaves) of a line
    model (``models/line/``: ``HWWithStyle`` or any of its parts) -> a
    state dict for the port's ``module``, with ``convert_module``'s leaf
    accounting."""
    return convert_module(variables, module, extra=_LINE_LEAVES)


def hwr_final_from_flax(tree: Mapping, module: torch.nn.Module) -> dict:
    """A JAX ``cli/train_hwr`` checkpoint tree (``{"params",
    "batch_stats"}`` of ``CNNOnlyHWR`` or ``CRNN``, numpy leaves) -> the
    port's ``hwr_final`` payload for ``module``, the same arch, norm and
    classes: ``{"params": {name: tensor}, "batch_stats": {name: running
    statistic}}``."""
    sd = line_from_flax(tree, module)
    return {"params": {n: sd[n] for n, _ in module.named_parameters()},
            "batch_stats": {n: sd[n] for n, _ in module.named_buffers()}}


def ae_final_from_flax(tree: Mapping, module: torch.nn.Module) -> dict:
    """A JAX ``cli/train_auto`` checkpoint tree (``{"params"}`` of the
    ``Autoencoder``, with the E_HWR head when it was trained with CTC;
    numpy leaves) -> the port's ``ae_final`` payload ``{"params": state
    dict}`` for ``module``, built with the same variant and head."""
    return {"params": convert_module({"params": tree["params"]}, module)}


def trocr_core_from_flax(params: Mapping, arch) -> dict:
    """A flax ``TrOCRCore`` param tree (e.g. the JAX package's
    ``import_torch_state_dict`` output, numpy leaves) -> a state dict for
    the port's ``TrOCRCore(arch)``."""
    from affganwriting_torch.models.recognizer.trocr import TrOCRCore

    with torch.device("meta"):
        core = TrOCRCore(arch)
    return convert_module({"params": params}, core)


# port modules whose ``weight`` is a flax leaf named ``weight`` (the
# line generator's equal-lr layers and noise weights)
_FLAX_WEIGHT = ("EqualConv", "FusedUpsample", "NoiseInjection")
_FLAX_SCALE = ("GroupNorm", "BatchNorm")


def flax_paths(model: torch.nn.Module, names) -> dict[str, str]:
    """{port parameter name: the JAX path string of its flax leaf}
    (``affganwriting_tpu/train/schedules.py:_path_str``, e.g.
    ``style_extractor/conv0/kernel``) for ``names`` of ``model``, whose
    module names are the flax tree's: ``weight`` is ``kernel`` of a conv or
    dense, ``scale`` of a norm, ``embedding`` of an embedding, and itself
    in the line generator's equal-lr layers; every other leaf keeps its
    name.  Refuses a fused recurrent tensor (one port tensor of several
    flax leaves)."""
    modules = dict(model.named_modules())
    out = {}
    for name in names:
        mod_name, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        kind = type(modules[mod_name]).__name__
        if isinstance(modules[mod_name], (torch.nn.LSTM, torch.nn.GRU)):
            raise ValueError(f"{name}: a fused recurrent tensor holds "
                             "several flax leaves")
        if leaf == "weight":
            leaf = ("scale" if kind in _FLAX_SCALE else
                    "embedding" if kind == "Embedding" else
                    "weight" if kind in _FLAX_WEIGHT else "kernel")
        out[name] = "/".join([*mod_name.split("."), leaf] if mod_name
                             else [leaf])
    return out


def disc_from_flax(variables: Mapping, module: torch.nn.Module) -> dict:
    """A flax ``DiscriminatorAP``'s variables (numpy leaves) -> a state
    dict for the port's: the kernels by the conv rule, and the
    spectral-norm state ``batch_stats/SpectralNorm_<k>/<conv>/kernel/u``
    and ``.../sigma`` -> the buffers ``<conv>.u`` and ``<conv>.sigma``."""
    out = convert_module({"params": variables["params"]}, module,
                         params_only=True)
    for node in variables.get("batch_stats", {}).values():
        for key, value in node.items():
            conv, leaf, what = key.split("/")
            if leaf != "kernel" or what not in ("u", "sigma"):
                raise ValueError(f"not a spectral-norm leaf: {key}")
            out[f"{conv}.{what}"] = _t(value)
    expected = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in out.items()}
    if got != expected:
        raise ValueError(f"disc_from_flax: port {sorted(expected.items())}, "
                         f"converted {sorted(got.items())}")
    return out


def _adam_moments(opt_state, params: Mapping) -> tuple[dict, dict, int]:
    """(mu, nu, count) of a ``partitioned_optimizer`` state: the main and
    slow groups' Adam moments merged into ``params``-shaped trees (zeros
    where a group masks a leaf, i.e. the frozen leaves)."""
    groups = getattr(opt_state, "inner_states", None) or {"main": opt_state}
    merged = {f: _zeros_tree(params) for f in ("mu", "nu")}
    count = 0
    for group in groups.values():
        adam = _find(group, lambda n: hasattr(n, "mu") and hasattr(n, "nu"))
        if adam is None:
            continue
        count = int(np.asarray(adam.count))
        for f in ("mu", "nu"):
            _merge(getattr(adam, f), merged[f])
    return merged["mu"], merged["nu"], count


def _zeros_tree(tree: Mapping) -> dict:
    return {k: _zeros_tree(v) if isinstance(v, Mapping)
            else np.zeros(np.shape(v), np.float32) for k, v in tree.items()}


def _merge(src, dst: dict) -> None:
    for k, v in src.items():
        if type(v).__name__ == "MaskedNode":     # optax: not in this group
            continue
        if isinstance(v, Mapping):
            _merge(v, dst[k])
        else:
            dst[k] = np.asarray(v, np.float32)


def line_state_from_flax(jax_state, state) -> None:
    """Load a JAX ``LineState`` with numpy leaves (``jax.tree.map(
    np.asarray, state)``) into the port's ``LineState`` ``state`` (from
    ``LineGanTrainer.init_state``, same widths) in place: ``main_params``,
    ``hwr_params`` and ``model_stats`` into ``model``; ``disc_params`` and
    ``disc_stats`` into ``disc``; ``ae_params`` into ``ae``; both Adam
    states (moments, counts) and ``step``.

    Asserts that the main tree maps one flax leaf to one port tensor
    (``balance_combine`` takes a mean per leaf, so a fused tensor would
    change its result): the converter's recorded paths of the main
    parameters equal ``flax_paths`` and cover every flax main leaf."""
    model, params = state.model, {**jax_state.main_params,
                                  "hwr": jax_state.hwr_params}
    variables = {"params": params}
    if jax_state.model_stats:
        variables["batch_stats"] = jax_state.model_stats
    recorded: dict = {}
    sd = convert_module(variables, model, extra=_LINE_LEAVES, paths=recorded)
    names = list(state.main_params())
    want = flax_paths(model, names)
    got = {n: recorded.get(n) for n in names}
    if got != want or len(_leaves(jax_state.main_params)) != len(names):
        raise ValueError("the main tree does not map one flax leaf to one "
                         f"port tensor: {sorted(set(got.items()) ^ set(want.items()))}")
    model.load_state_dict(sd, strict=True)
    state.disc.load_state_dict(disc_from_flax(
        {"params": jax_state.disc_params,
         "batch_stats": jax_state.disc_stats}, state.disc), strict=True)
    state.ae.load_state_dict(convert_module(
        {"params": jax_state.ae_params}, state.ae), strict=True)

    mu, nu, count = _adam_moments(jax_state.main_opt, params)
    conv = [convert_module({"params": t}, model, params_only=True,
                           extra=_LINE_LEAVES) for t in (mu, nu)]
    opt = state.main_opt
    osd = opt.opt.state_dict()
    osd["state"] = {i: {"step": torch.tensor(float(count)),
                        "exp_avg": conv[0][n], "exp_avg_sq": conv[1][n]}
                    for i, n in enumerate(opt.trained)}
    opt.load_state_dict({"opt": osd, "count": count})
    state.disc_opt.load_state_dict(optimizer_from_flax(
        jax_state.disc_opt, state.disc, state.disc_opt))
    state.step = int(np.asarray(jax_state.step))
