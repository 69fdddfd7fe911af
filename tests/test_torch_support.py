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


@contextlib.contextmanager
def port_in_f64(*modules: torch.nn.Module):
    """The port's ``modules`` compute in f64 inside the block: parameters,
    compute dtypes, and every ``.float()`` they take; an exact reference
    for the f32 readings that the train tests' limits rest on."""
    for module in modules:
        module.double()
        for m in module.modules():
            for attr in ("compute_dtype", "dtype"):
                if getattr(m, attr, None) is torch.float32:
                    setattr(m, attr, torch.float64)
    as_f32 = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.double()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = as_f32
        torch.set_default_dtype(torch.float32)


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
