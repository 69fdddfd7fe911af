"""Shared helpers of the PyTorch-port parity tests (no tests here).

The JAX side is the reference: its variables are built with
``jax.eval_shape`` and every leaf (kernels, biases, BatchNorm scales and
statistics) is filled from a seeded numpy generator, so a swapped or
skipped mapping in ``utils/from_flax`` cannot hide behind flax's zero
biases and unit statistics.  Inputs are numpy arrays handed to both sides.
"""

from __future__ import annotations

import contextlib
import os

import jax
import numpy as np
import torch

from affganwriting_tpu.core.config import default_config
from affganwriting_torch.train.parity import (  # noqa: F401 (the tests' f64)
    in_f64 as port_in_f64,
)
from affganwriting_torch.utils.from_flax import convert_module

# the small fp32 resnet50 configuration of __graft_entry__.py's dryrun
SMALL = dict(compute_dtype="float32", img_height=32, img_width=104,
             max_chars=6, style_dim=64, adain_param_dim=512,
             text_embed_dim=16, rec_hidden=64, rec_embed=16)


# the train step's players at that size: D and C at 5 layers end at 2x7
# on 32x104, as at 6 layers on 64x216 (at 6 they would reach 1x4, where
# torch's reflect pad raises on the 1-pixel height and jnp's repeats)
TRAIN_SMALL = dict(SMALL, dis_layers=5, num_writers=8)


def small_jax_config(**kw):
    return default_config().replace(**{**SMALL, **kw})


def small_torch_config(**kw):
    from affganwriting_torch.core.config import default_config as tdefault

    return tdefault().replace(**{**SMALL, **kw})


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


def word_batch(cfg, b: int, seed: int) -> dict:
    """A train-step batch of ``b`` words from a numpy seed: a random style
    stack, writer ids, and labels GO + 1..max_chars chars + END + PAD."""
    rng = np.random.default_rng(seed)

    def labels():
        ids = rng.integers(3, cfg.vocab_size, size=(b, cfg.output_max_len))
        for i, n in enumerate(rng.integers(1, cfg.max_chars + 1, size=b)):
            ids[i, n + 1] = 1
            ids[i, n + 2:] = 2
        ids[:, 0] = 0
        return ids.astype(np.int32)

    style = rng.normal(size=(b, cfg.img_height, cfg.img_width,
                             cfg.style_stack)).astype(np.float32)
    return {"style_imgs": style, "label_ch0": labels(), "label_xt": labels(),
            "label_xt_swap": labels(),
            "writer_ids": rng.integers(0, cfg.num_writers, b).astype(np.int32)}


def jax_word_gan_state(jcfg, batch, rec_dropout: float = 0.0):
    """A JAX ``WordGanState`` with random flax leaves (no jitted init) and
    the models it is for, R rebuilt with ``rec_dropout``."""
    import jax.numpy as jnp

    from affganwriting_tpu.train.state import PlayerState, WordGanState
    from affganwriting_tpu.train.state import build_models, make_optimizers

    gen, dis, cla, rec = build_models(jcfg)
    if hasattr(rec, "dropout"):          # the seq2seq R; TrOCR has none
        rec = rec.clone(dropout=rec_dropout)
    style = batch["style_imgs"][:1]
    img, labels = style[..., :1], batch["label_xt"][:1]
    variables = {"gen": random_variables(gen, style, labels, seed=1),
                 "dis": random_variables(dis, img, seed=2),
                 "cla": random_variables(cla, img, seed=3),
                 "rec": random_variables(rec, img, labels, seed=4)}
    opts = make_optimizers(jcfg)

    def player(name):
        v = jax.tree.map(jnp.asarray, variables[name])
        return PlayerState(v["params"], v.get("batch_stats", {}),
                           opts[name].init(v["params"]))

    names = ("gen", "dis", "cla", "rec")
    return (WordGanState(jnp.zeros((), jnp.int32),
                         *(player(n) for n in names)),
            (gen, dis, cla, rec))


def jax_merged_step(jcfg, tcfg, batch, compiler_options=None):
    """One jitted merged step of the JAX package from random leaves
    (``jax_word_gan_state``); the state before and after as port state
    dicts, the metrics and extras.  ``compiler_options`` go to every
    ``jax.jit`` of the step (XLA debug options)."""
    import functools

    import pytest

    import affganwriting_tpu.train.step as jstep

    from affganwriting_torch.utils.from_flax import word_gan_from_flax

    state, models = jax_word_gan_state(jcfg, batch)
    before = to_numpy_tree(state)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "build_models", lambda cfg: models)
        if compiler_options:
            mp.setattr(jax, "jit", functools.partial(
                jax.jit, compiler_options=compiler_options))
        step = jstep.make_phased_train_step(jcfg, merge_dg=True)
    new, metrics, extras = step(state, batch, jax.random.key(0))
    return {"before": word_gan_from_flax(before, tcfg),
            "after": word_gan_from_flax(to_numpy_tree(new), tcfg),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "extras": to_numpy_tree(extras)}


def port_merged_step(tcfg, weights, batch):
    """The port's merged step on the CPU from ``weights`` (R's dropout 0):
    the players' state dicts after, the metrics, the extras and the step."""
    from affganwriting_torch.train.state import PLAYERS, init_state
    from affganwriting_torch.train.step import make_phased_train_step

    port = init_state(tcfg, device="cpu", weights=weights, rec_dropout=0.0)
    port, pm, pe = make_phased_train_step(tcfg, merge_dg=True, device="cpu")(
        port, batch, torch.Generator().manual_seed(0))
    return {"after": {n: getattr(port, n).model.state_dict()
                      for n in PLAYERS},
            "metrics": {k: float(v) for k, v in pm.items()},
            "extras": {k: v.float().numpy() for k, v in pe.items()},
            "step": port.step}


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
    got, want = (t.detach() if isinstance(t, torch.Tensor) else t
                 for t in (got, want))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=what)


TINY_TROCR = dict(enc_hidden=32, enc_layers=2, enc_heads=2, enc_mlp=64,
                  dec_hidden=32, dec_layers=2, dec_heads=2, dec_ffn=64,
                  vocab_tro=384, max_positions=64)


def tiny_hf_trocr(seed: int = 0):
    """A HF ``VisionEncoderDecoderModel`` (ViT encoder, TrOCR decoder) at
    ``TrOCRArch.tiny()``'s dimensions, in eval mode, with every parameter
    drawn from ``seed`` (LayerNorm scales near 1, biases small), built from
    configs here: nothing is fetched."""
    os.environ.setdefault("USE_TF", "0")    # transformers alone, no TF
    from transformers import (
        TrOCRConfig,
        VisionEncoderDecoderConfig,
        VisionEncoderDecoderModel,
        ViTConfig,
    )

    t = TINY_TROCR
    enc = ViTConfig(hidden_size=t["enc_hidden"],
                    num_hidden_layers=t["enc_layers"],
                    num_attention_heads=t["enc_heads"],
                    intermediate_size=t["enc_mlp"], image_size=384,
                    patch_size=16, hidden_act="gelu", qkv_bias=True)
    dec = TrOCRConfig(vocab_size=t["vocab_tro"], d_model=t["dec_hidden"],
                      decoder_layers=t["dec_layers"],
                      decoder_attention_heads=t["dec_heads"],
                      decoder_ffn_dim=t["dec_ffn"],
                      activation_function="gelu",
                      max_position_embeddings=t["max_positions"],
                      layernorm_embedding=True, scale_embedding=False,
                      use_learned_position_embeddings=True,
                      tie_word_embeddings=False, dropout=0.0,
                      attention_dropout=0.0, activation_dropout=0.0,
                      decoder_start_token_id=0, bos_token_id=0,
                      pad_token_id=1, eos_token_id=2)
    cfg = VisionEncoderDecoderConfig.from_encoder_decoder_configs(enc, dec)
    cfg.decoder_start_token_id, cfg.pad_token_id, cfg.eos_token_id = 0, 1, 2
    model = VisionEncoderDecoderModel(config=cfg).eval()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=gen)
                        / p[0].numel() ** 0.5)
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def save_tiny_trocr(path, seed: int = 0, processor: bool = True):
    """``tiny_hf_trocr(seed)`` saved to the directory ``path``, with a
    ``TrOCRProcessor`` (a ViT image processor at 384 and a byte-level BPE
    tokenizer whose vocabulary is the specials and the 52 letters, one
    token each) unless ``processor`` is False.  Returns the model."""
    import json
    import string

    from transformers import RobertaTokenizer, TrOCRProcessor
    from transformers import ViTImageProcessor

    model = tiny_hf_trocr(seed)
    model.save_pretrained(path)
    if processor:
        letters = string.ascii_lowercase + string.ascii_uppercase
        vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "\u0120": 4,
                 ".": 5, ",": 6, "0": 7, "1": 8, "2": 9}
        vocab.update({c: 10 + i for i, c in enumerate(letters)})
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "vocab.json"), "w") as f:
            json.dump(vocab, f)
        with open(os.path.join(path, "merges.txt"), "w") as f:
            f.write("#version: 0.2\n")
        tok = RobertaTokenizer(os.path.join(path, "vocab.json"),
                               os.path.join(path, "merges.txt"))
        images = ViTImageProcessor(size={"height": 384, "width": 384},
                                   image_mean=[0.5] * 3, image_std=[0.5] * 3)
        TrOCRProcessor(image_processor=images,
                       tokenizer=tok).save_pretrained(path)
    return model


LINE_CLASSES = 12       # classes of the small line models


def line_variables(module, *args, method=None, seed: int = 0,
                   zero_noise: bool = False):
    """Flax variables of ``module`` (init with params, noise and spacing
    rngs), every leaf drawn from numpy; with ``zero_noise`` every
    ``NoiseInjection`` weight (a ``noise1``/``noise2`` leaf) is 0."""
    def init(key):
        return module.init({"params": key, "noise": key, "spacing": key},
                           *args, method=method)

    shapes = jax.eval_shape(init, jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [str(getattr(k, "key", k)) for k in path]
        if zero_noise and names[-2] in ("noise1", "noise2"):
            return np.zeros(leaf.shape, np.float32)
        return np.asarray(_fill(path, leaf, rng), np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def japply(module, variables, *args, method=None, rngs=None, **static):
    """``module.apply`` jitted (one XLA compile instead of a compile per
    eager op); ``static`` are Python arguments of ``method``."""
    return jax.jit(lambda v, r, *a: module.apply(
        v, *a, method=method, rngs=r, **static))(variables, rngs, *args)


def load_line(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load flax line-model ``variables`` (``utils/from_flax.
    line_from_flax``) into the port's ``module``, in eval mode."""
    from affganwriting_torch.utils.from_flax import line_from_flax

    module.load_state_dict(line_from_flax(to_numpy_tree(variables), module),
                           strict=True)
    return module.eval().requires_grad_(False)


# the line GAN's small trainer: 12 classes, style 16, generator 32, D dim
# 8, AE dim 8, spaced length 32 (lines of 64 x 128)
LINE_GAN = dict(n_class=LINE_CLASSES, style_dim=16, max_gen_length=32)


@contextlib.contextmanager
def deterministic_line_gan():
    """Inside the block flax's ``Dropout`` is the identity and both
    packages' line-generator ``NoiseInjection`` adds its noise times 0:
    the packages' random streams cannot be matched, and a noise weight's
    gradient is the noise itself.  Nothing in either package changes
    outside the block; jitted JAX functions keep what they traced."""
    import flax.linen as nn

    import affganwriting_tpu.models.line.spaced_gen as jsg
    import affganwriting_torch.models.line.spaced_gen as tsg

    saved = (nn.Dropout.__call__, jsg.NoiseInjection.__call__,
             tsg.NoiseInjection.forward)
    jnoise, tnoise = saved[1], saved[2]
    nn.Dropout.__call__ = lambda self, x, *a, **k: x
    jsg.NoiseInjection.__call__ = lambda self, x, noise: jnoise(
        self, x, noise * 0)
    tsg.NoiseInjection.forward = lambda self, x, noise: tnoise(
        self, x, noise * 0)
    try:
        yield
    finally:
        (nn.Dropout.__call__, jsg.NoiseInjection.__call__,
         tsg.NoiseInjection.forward) = saved


def _warm_opt(opt_state, seed: int, mu_std: float = 1e-2,
              nu_range: tuple = (1e-4, 1e-3)):
    """An optax state with Adam's moments drawn from ``seed`` (mu N(0,
    ``mu_std``), nu U(``nu_range``); by default N(0, 1e-2) and U(1e-4,
    1e-3)) and every count at 3: a first update then moves each parameter
    smoothly in its gradient, where a fresh Adam moves it by lr *
    sign(g).  By default that update (the 4th, b1 0.5, b2 0.999) is
    lr * 0.53 * (mu + g) / sqrt(nu / 0.004) ~ 2.9e-4 * (mu + g) at lr
    2e-4: ~3e-6, the moments' part the same on both sides.  So the state
    after a step holds the optimizer's arithmetic, and the gradients are
    held where they enter the optimizers (``_recording``,
    ``port_opt_grads``)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [str(getattr(k, "name", getattr(k, "key", k)))
                 for k in path]
        a = np.asarray(leaf)
        if "mu" in names:
            return jnp.asarray(rng.normal(0, mu_std, a.shape)
                               .astype(a.dtype))
        if "nu" in names:
            return jnp.asarray(rng.uniform(*nu_range, a.shape)
                               .astype(a.dtype))
        if a.dtype == np.int32:
            return jnp.full(a.shape, 3, jnp.int32)
        return leaf

    return jax.tree_util.tree_map_with_path(fill, opt_state)


def _recording(tx, log: list):
    """Optax transformation ``tx`` that first appends every gradient it is
    given to ``log`` (on the host; read after ``jax.effects_barrier()``)."""
    import optax

    def update(grads, state, params=None):
        jax.debug.callback(log.append, grads)
        return tx.update(grads, state, params)

    return optax.GradientTransformation(tx.init, update)


@contextlib.contextmanager
def port_opt_grads():
    """Inside the block every torch optimizer step first appends
    ``{id(parameter): its gradient}`` to the yielded list: the gradients
    that reach the port's optimizers (``PartitionedAdam`` steps its torch
    Adam with them as ``.grad``)."""
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    log = []

    def hook(opt, args, kwargs):
        log.append({id(p): p.grad.detach().clone()
                    for group in opt.param_groups for p in group["params"]
                    if p.grad is not None})

    handle = register_optimizer_step_pre_hook(hook)
    try:
        yield log
    finally:
        handle.remove()


def named_grads(entry: dict, named: dict) -> dict:
    """One ``port_opt_grads`` entry -> {name: gradient} for those
    parameters of ``named`` ({name: parameter}) that the step covered."""
    return {n: entry[id(p)] for n, p in named.items() if id(p) in entry}


def port_main_grads(jax_grads, js, ts) -> dict:
    """A JAX main-tree gradient -> {port name: tensor} over the port's
    main tree (the converter's layouts; the HWR's slot filled with its
    parameters, then dropped)."""
    from affganwriting_torch.utils.from_flax import _LINE_LEAVES

    tree = {**to_numpy_tree(jax_grads), "hwr": to_numpy_tree(js.hwr_params)}
    out = convert_module({"params": tree}, ts.model, params_only=True,
                         extra=_LINE_LEAVES)
    return {n: out[n] for n in ts.main_params()}


def port_disc_grads(jax_grads, js, ts) -> dict:
    """A JAX D gradient -> {port name: tensor} over D's parameters."""
    from affganwriting_torch.utils.from_flax import disc_from_flax

    out = disc_from_flax({"params": to_numpy_tree(jax_grads),
                          "batch_stats": to_numpy_tree(js.disc_stats)},
                         ts.disc)
    return {n: out[n] for n, _ in ts.disc.named_parameters()}


def leaf_grad_errors(got: dict, want: dict) -> dict:
    """{name: ||got - want|| / ||want||} per leaf (relative L2; a leaf
    whose reference gradient is exactly 0 reads ||got||, in absolute)."""
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
    out = {}
    for n, w in want.items():
        w = torch.as_tensor(w, dtype=torch.float64)
        d = float((got[n].detach().cpu().double() - w).norm())
        nw = float(w.norm())
        out[n] = d / nw if nw > 0 else d
    return out


def check_opt_grads(jt, js, port_log: list, ts, tol: dict, what) -> list:
    """Hold the updates since ``jt.opt_grads`` and ``port_log`` were
    cleared, in order: the same optimizers stepped in both packages, each
    by the gradients of every trained parameter, within ``tol[kind]`` per
    leaf (``leaf_grad_errors``); returns their kinds ("main" or "disc").
    ``js`` and ``ts`` are JAX and port states of the pair (for the
    converters and the port's parameters)."""
    jax.effects_barrier()
    jlog = {k: list(v) for k, v in jt.opt_grads.items()}
    disc = dict(ts.disc.named_parameters())
    kinds = []
    for entry in port_log:
        kind = "disc" if id(next(iter(disc.values()))) in entry else "main"
        kinds.append(kind)
        if kind == "main":
            got = named_grads(entry, ts.main_params())
            assert set(got) == set(ts.main_opt.trained), what
            want = port_main_grads(jlog["main"].pop(0), js, ts)
            want = {n: want[n] for n in got}
        else:
            got = named_grads(entry, disc)
            want = port_disc_grads(jlog["disc"].pop(0), js, ts)
        errs = leaf_grad_errors(got, want)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= tol[kind], (what, kind, worst, errs[worst])
        assert any(float(g.abs().max()) > 0 for g in got.values()), what
    assert not jlog["main"] and not jlog["disc"], (what, kinds)
    return kinds


def line_batch(b: int = 4, t: int = 8, width: int = 128, seed: int = 0):
    """A batch of ``b`` random lines (64 x ``width``, NHWC) and labels of
    the small classes, lengths from t/2 to t."""
    rng = np.random.default_rng(seed)
    img = np.tanh(rng.normal(size=(b, 64, width, 1))).astype(np.float32)
    label = rng.integers(1, LINE_CLASSES, (b, t)).astype(np.int32)
    lengths = rng.integers(t // 2, t + 1, (b,)).astype(np.int32)
    label[np.arange(t)[None, :] >= lengths[:, None]] = 0
    return {"image": img, "label": label, "label_lengths": lengths}


def line_trainer_pair(char_style_dim: int, seed: int = 0, **trainer_kw):
    """(JAX trainer, its ``LineState``, the port's trainer, its state) at
    ``LINE_GAN``'s size: every flax leaf drawn from numpy (noise weights
    0), both Adam states warmed (``_warm_opt``), the port's state carried
    over by ``utils/from_flax.line_state_from_flax``, dropout off in the
    port.  The JAX optimizers record the gradients they are given in
    ``jt.opt_grads["main"]`` and ``["disc"]`` (``_recording``).  Use
    inside ``deterministic_line_gan``."""
    import jax.numpy as jnp

    from affganwriting_tpu.models.line.autoencoder import Autoencoder as JAE
    from affganwriting_tpu.models.line.container import HWWithStyle as JHW
    from affganwriting_tpu.models.line.discriminator import (
        DiscriminatorAP as JD,
    )
    from affganwriting_tpu.train.line_trainer import LineGanTrainer as JT
    from affganwriting_tpu.train.line_trainer import LineState
    from affganwriting_tpu.train.schedules import partitioned_optimizer
    from affganwriting_torch.models.line.autoencoder import Autoencoder
    from affganwriting_torch.models.line.container import HWWithStyle
    from affganwriting_torch.models.line.discriminator import (
        DiscriminatorAP,
    )
    from affganwriting_torch.train.line_trainer import LineGanTrainer
    from affganwriting_torch.utils.from_flax import line_state_from_flax

    kw = dict(LINE_GAN, char_style_dim=char_style_dim)
    jt = JT(**kw, seed=seed, **trainer_kw)
    jt.model = JHW(gen_dim=32, **kw)
    jt.disc = JD(dim=8)
    jt.ae = JAE(dim=8)
    b = line_batch(seed=seed)
    mv = line_variables(jt.model, b["image"], b["label"], b["label_lengths"],
                        method=jt.model.init_all, seed=seed, zero_noise=True)
    dv = line_variables(jt.disc, b["image"], seed=seed + 1)
    av = line_variables(jt.ae, b["image"], seed=seed + 2)
    main = {k: v for k, v in mv["params"].items() if k != "hwr"}
    jt.opt_grads = {"main": [], "disc": []}
    jt.main_opt = _recording(partitioned_optimizer(params=main,
                                                   **jt._opt_cfg),
                             jt.opt_grads["main"])
    jt.disc_opt = _recording(jt.disc_opt, jt.opt_grads["disc"])
    jt._build_steps()
    js = LineState(
        step=jnp.asarray(5, jnp.int32), main_params=main,
        hwr_params=mv["params"]["hwr"],
        model_stats=mv.get("batch_stats", {}),
        disc_params=dv["params"], disc_stats=dv["batch_stats"],
        ae_params=av["params"],
        main_opt=_warm_opt(jt.main_opt.init(main), seed + 3),
        disc_opt=_warm_opt(jt.disc_opt.init(dv["params"]), seed + 4))
    tt = LineGanTrainer(**kw, seed=seed, device="cpu", **trainer_kw)
    tt.model = HWWithStyle(gen_dim=32, **kw)
    tt.disc = DiscriminatorAP(dim=8)
    tt.ae = Autoencoder(dim=8)
    tt.train_dropout = False
    ts = tt.init_state()
    line_state_from_flax(to_numpy_tree(js), ts)
    return jt, js, tt, ts


def line_state_errors(js, ts) -> dict:
    """Max abs difference of a JAX ``LineState`` and the port's: the main
    tree with the HWR and its statistics (``model``), D's parameters
    (``disc``), D's u/sigma (``sn``) and the AE (``ae``)."""
    from affganwriting_torch.utils.from_flax import (
        disc_from_flax,
        line_from_flax,
    )

    jn = to_numpy_tree(js)
    model = line_from_flax({"params": {**jn.main_params,
                                       "hwr": jn.hwr_params},
                            "batch_stats": jn.model_stats}, ts.model)
    disc = disc_from_flax({"params": jn.disc_params,
                           "batch_stats": jn.disc_stats}, ts.disc)
    ae = convert_module({"params": jn.ae_params}, ts.ae)

    def err(want, module, keep):
        got = module.state_dict()
        return max(float((got[k] - v).abs().max())
                   for k, v in want.items() if keep(k))

    return {"model": err(model, ts.model, lambda k: True),
            "disc": err(disc, ts.disc,
                        lambda k: not k.endswith((".u", ".sigma"))),
            "sn": err(disc, ts.disc, lambda k: k.endswith((".u", ".sigma"))),
            "ae": err(ae, ts.ae, lambda k: True)}
