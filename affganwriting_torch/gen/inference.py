"""Batched, deterministic generate-and-recognize, in bf16 or w8a8.

Port of ``affganwriting_tpu/gen/inference.py:26-205`` and of
``train/state.py:build_models`` for the serving pair (G, R: the seq2seq
recognizer or the TrOCR drop-in, ``new_recognizer``).  The
style stack is encoded once and a batch of words is generated, then read
back by R with greedy decoding.  Public layouts are the JAX package's: style
stacks (S, H, W, 50), labels (B, T), images (B, H, W, 1), greedy ids
(B, T - 1).  The w8a8 serving mode (``make_generate_and_read_quant_fn``)
reads the images with R's VGG trunk in int8 and can run G's decoder convs
in int8 too (``ops/quant.py``).  ``make_sharded_pipeline`` splits the word
batch over a mesh's devices (``parallel/mesh.py``).

Entry points run on the CUDA card unless the caller passes ``device="cpu"``;
with no card and no such request they raise.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from affganwriting_torch.core.config import VOCAB, WordGanConfig
from affganwriting_torch.models.generator import Generator
from affganwriting_torch.models.recognizer.seq2seq import Recognizer
from affganwriting_torch.ops.quant import (
    prepare_vgg_quant,
    qparams_to,
    vgg_quant_apply,
)
from affganwriting_torch.utils.profiling import span


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card; pass "
            "device='cpu' to run it on the CPU")
    return dev


def init_weights(module: nn.Module, seed: int) -> nn.Module:
    """Deterministic random weights from ``seed``, drawn on the CPU:
    LeCun-normal (std 1/sqrt(fan_in)) for every parameter of rank >= 2,
    ones for norm scales, zeros for biases; BatchNorm statistics stay at
    mean 0, variance 1."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() >= 2:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen) / fan_in ** 0.5)
            elif name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()
    return module


def _load(module: nn.Module, state, seed: int, device) -> nn.Module:
    if state is None:
        init_weights(module, seed)
    else:
        module.load_state_dict(state, strict=True)
    return module.to(device).eval().requires_grad_(False)


def build_generator(config: WordGanConfig, device=None, *, state=None,
                    seed: int = 0, subpixel: bool = True) -> Generator:
    """G on ``device`` (``None``: the card) with ``state`` (a state dict,
    e.g. from ``utils/from_flax``) or random weights from ``seed``;
    ``subpixel=False`` builds the exact decoder on the same parameters."""
    dev = resolve_device(device)
    return _load(Generator(config, subpixel=subpixel), state, seed, dev)


def new_recognizer(config: WordGanConfig, rec_dropout: float = 0.5):
    """R behind ``config.recognizer`` (JAX ``train/state.py:48-73``), with
    torch's initial weights: the seq2seq ``Recognizer`` at
    ``config.compute_dtype`` with dropout ``rec_dropout``, or the TrOCR
    drop-in at ``config.trocr_preset``'s dimensions (f32 whatever the
    compute dtype; no dropout) with the config's char->token table."""
    if config.recognizer == "seq2seq":
        return Recognizer(config.vocab_size, config.rec_hidden,
                          config.rec_embed, config.output_max_len,
                          config.img_height,
                          getattr(torch, config.compute_dtype), rec_dropout)
    if config.recognizer == "trocr":
        from affganwriting_torch.models.recognizer.trocr import (
            TrOCRArch,
            TrOCRRecognizer,
        )

        arch = (TrOCRArch.base_handwritten()
                if config.trocr_preset == "base" else TrOCRArch.tiny())
        return TrOCRRecognizer(arch, config.output_max_len,
                               config.trocr_map_vec, config.trocr_valid_mask)
    raise ValueError(f"unknown recognizer {config.recognizer!r}")


def build_recognizer(config: WordGanConfig, device=None, *, state=None,
                     seed: int = 1) -> nn.Module:
    """R (``new_recognizer``) on ``device`` (``None``: the card) in eval
    mode, with ``state`` or random weights from ``seed``."""
    dev = resolve_device(device)
    return _load(new_recognizer(config), state, seed, dev)


def build_models(config: WordGanConfig, device=None, *, seed: int = 0):
    """(G, R) on ``device`` (``None``: the card) with random weights: G from
    ``seed``, R from ``seed + 1``."""
    dev = resolve_device(device)
    return (build_generator(config, dev, seed=seed),
            build_recognizer(config, dev, seed=seed + 1))


def encode_labels(words: list[str], max_len: int) -> np.ndarray:
    return np.asarray(
        [VOCAB.pad_label(w[: max_len - 2], max_len) for w in words], np.int32)


def _tile_pyramid(pyramid, b: int, s: int):
    """Writer i % S styles word i; a batch-1 pyramid broadcasts untiled."""
    if s == b or s == 1:
        return pyramid
    return [tap.repeat(b // s, 1, 1, 1) for tap in pyramid]


def _check_batch(b: int, s: int) -> None:
    if s != b and s != 1 and b % s:
        raise ValueError(
            f"labels batch {b} is not a multiple of the {s} style "
            "stacks; pad or trim the word list")


def make_generate_fn(config: WordGanConfig, gen_state=None, *, device=None,
                     seed: int = 0):
    """Returns ``generate(style_stack (S, H, W, 50), labels (B, T)) ->
    images (B, H, W, 1)``; labels are generated against writer ``i % S``.
    ``generate.gen`` is the Generator."""
    dev = resolve_device(device)
    gen = build_generator(config, dev, state=gen_state, seed=seed)

    @torch.inference_mode()
    def generate(style_stack, labels):
        return generate_images(gen, style_stack, labels, dev)

    generate.gen = gen
    return generate


def generate_images(gen: Generator, style_stack, labels,
                    device) -> torch.Tensor:
    """``gen``'s images (B, H, W, 1) of ``labels`` (B, T), word i in the
    style of stack ``i % S`` of ``style_stack`` (S, H, W, 50), in ``gen``'s
    current mode; the caller picks the grad mode."""
    with span("G"):
        with span("G.upload"):
            style = torch.as_tensor(style_stack, dtype=torch.float32,
                                    device=device)
            labels = torch.as_tensor(labels, device=device).long()
        b, s = labels.shape[0], style.shape[0]
        _check_batch(b, s)
        with span("G.encode_style"):
            pyramid = _tile_pyramid(gen.encode_style(style), b, s)
        return gen.generate(pyramid, labels).permute(0, 2, 3, 1)


def make_generate_and_read_fn(config: WordGanConfig, gen_state=None,
                              rec_state=None, *, device=None, seed: int = 0):
    """Generation + recognition: ``run(style_stack, labels) -> (images
    (B, H, W, 1), greedy ids (B, T - 1))``; ``run`` uploads the labels
    once and hands G and R the device tensor.  ``run.run_gen`` and
    ``run.run_rec`` are the two halves; ``run.gen``/``run.rec`` the
    models.  Random weights come from ``seed`` (G) and ``seed + 1`` (R)
    where no state dict is given."""
    dev = resolve_device(device)
    run_gen = make_generate_fn(config, gen_state, device=dev, seed=seed)
    rec = build_recognizer(config, dev, state=rec_state, seed=seed + 1)

    @torch.inference_mode()
    def run_rec(images, labels):
        with span("R"):
            labels = torch.as_tensor(labels, device=dev).long()
            logits, _ = rec(images.permute(0, 3, 1, 2), labels)
            return logits.argmax(dim=-1)

    def run(style_stack, labels):
        with span("serve.request"):
            # once, before G: a copy from host memory waits for the stream,
            # so one inside R would wait for G's kernels to drain
            labels = torch.as_tensor(labels, device=dev).long()
            images = run_gen(style_stack, labels)
            return images, run_rec(images, labels)

    run.run_gen, run.run_rec = run_gen, run_rec
    run.gen, run.rec = run_gen.gen, rec
    return run


def make_sharded_pipeline(config: WordGanConfig, mesh, gen_state=None,
                          rec_state=None, *, seed: int = 0):
    """Serving scale-out (JAX ``make_sharded_pipeline``): generate-and-read
    with the word batch split over the mesh's 'data' axis, one process per
    device.  G is placed with its TP rules (``expect_tp``: on a model axis
    >1 the text encoder's FC pyramid and the mix hold shards and gather or
    sum over the model group); R replicates; the style stack replicates, so
    a batch-1 stack broadcasts untiled on every rank.  Serving is eval
    mode: no batch statistics are shared, and on a data axis alone no rank
    talks to another until the outputs are gathered.

    Returns ``run(style_stack (S, H, W, 50), labels (B, T)) -> (images
    (B, H, W, 1), greedy ids (B, T - 1))``, the global batch's, gathered to
    every rank; word i is styled by stack ``i % S`` as in the single-device
    pipeline.  ``B`` must divide over 'data' (pad or trim the word list).
    ``run.place(style_stack)`` and ``run.shard_labels(labels)`` place the
    inputs once, ``run.local(style, local_labels)`` is this rank's share
    without the gather, ``run.base`` the single-device pipeline on this
    rank's (placed) models, ``run.gen``/``run.rec`` the models.  Every rank
    of the mesh calls ``run`` with the same arguments."""
    from affganwriting_torch.parallel.mesh import shard_params
    from affganwriting_torch.parallel.ops import gather_rows

    dev = mesh.device
    base = make_generate_and_read_fn(config, gen_state, rec_state,
                                     device=dev, seed=seed)
    gen = shard_params(mesh, base.gen, expect_tp=True)
    n_data, rank = mesh.data, mesh.data_rank

    def place(style_stack) -> torch.Tensor:
        s = style_stack.shape[0]
        if s != 1 and s % n_data:
            raise ValueError(
                f"style stack batch {s} does not divide over the "
                f"{n_data}-way data axis; use one stack or pad")
        return torch.as_tensor(style_stack, dtype=torch.float32, device=dev)

    def shard_labels(labels) -> torch.Tensor:
        b = labels.shape[0]
        if b % n_data:
            raise ValueError(
                f"label batch {b} does not divide over the {n_data}-way "
                "data axis; pad or trim the word list")
        k = b // n_data
        return torch.as_tensor(np.asarray(labels)[rank * k:][:k],
                               device=dev).long()

    @torch.inference_mode()
    def local(style: torch.Tensor, labels: torch.Tensor):
        s, k = style.shape[0], labels.shape[0]
        if s == 1:
            pyramid = gen.encode_style(style)
        else:     # the stacks of this rank's words, global word g -> g % S
            need = (rank * k + torch.arange(k, device=dev)) % s
            uniq, inv = torch.unique(need, return_inverse=True)
            pyramid = [tap[inv] for tap in gen.encode_style(style[uniq])]
        images = gen.generate(pyramid, labels).permute(0, 2, 3, 1)
        return images, base.run_rec(images, labels)

    def run(style_stack, labels):
        _check_batch(labels.shape[0], style_stack.shape[0])
        images, ids = local(place(style_stack), shard_labels(labels))
        group = mesh.data_group if n_data > 1 else None
        return (gather_rows(images, group, rank, n_data),
                gather_rows(ids, group, rank, n_data))

    run.place, run.shard_labels, run.local = place, shard_labels, local
    run.base, run.gen, run.rec = base, gen, base.rec
    return run


def load_gen_quant(gen: Generator, amaxes) -> None:
    """Set G's int8 sites' calibrated ``amax`` from {site path: value}
    (``calibrate_gen_quant``'s result, or ``utils/from_flax.
    gen_quant_from_flax``'s); every site must be given."""
    sites = gen.dec.quant_sites()
    if set(amaxes) != set(sites):
        raise ValueError(f"quant sites {sorted(amaxes)} != G's "
                         f"{sorted(sites)}")
    with torch.no_grad():
        for k, site in sites.items():
            site.amax.copy_(torch.as_tensor(amaxes[k], dtype=torch.float32))


@torch.no_grad()
def calibrate_gen_quant(gen: Generator, style_stack, labels,
                        device) -> dict[str, torch.Tensor]:
    """Record the static int8 mode's per-site activation ``amax`` (JAX
    ``calibrate_gen_quant``): G's decoder in ``calib`` mode (its float
    path) over one representative (style, labels) batch, from zero.  The
    sites keep the values; returns them as {site path: amax}."""
    sites = gen.dec.quant_sites()
    for site in sites.values():
        site.amax.zero_()
    gen.dec.set_quant_mode("calib")
    try:
        generate_images(gen, style_stack, labels, device)
    finally:
        gen.dec.set_quant_mode(None)
    return {k: site.amax.clone() for k, site in sites.items()}


def gen_fn_in_mode(gen: Generator, mode: str | None, device):
    """``run_gen(style_stack, labels) -> images`` with ``gen``'s decoder
    convs in quant ``mode`` (None: the float path) for the call."""
    @torch.inference_mode()
    def run_gen(style_stack, labels):
        gen.dec.set_quant_mode(mode)
        try:
            return generate_images(gen, style_stack, labels, device)
        finally:
            gen.dec.set_quant_mode(None)

    return run_gen


def make_generate_and_read_quant_fn(config: WordGanConfig, gen_state=None,
                                    rec_state=None, *,
                                    quant_gen: bool | str = False,
                                    qparams=None, gen_quant=None,
                                    device=None, seed: int = 0):
    """The generate-and-read pipeline in the w8a8 serving mode (JAX
    ``make_generate_and_read_quant_fn``), as the same two programs:

    - ``run.run_rec`` reads the images with R's VGG trunk in int8
      (``vgg_quant_apply`` at ``run.qparams``, features in bf16 as in the
      JAX package) and R's float tail (``Recognizer.read_features``);
    - ``run.run_gen`` is G in the float path, or with ``quant_gen`` its
      decoder convs in int8: ``"dynamic"`` (or True) per-sample scales,
      ``"static"`` the calibrated ``amax`` of each site.

    ``qparams`` (``prepare_vgg_quant``'s) and ``gen_quant`` (site ``amax``,
    ``load_gen_quant``) may be given; else ``run.calibrate(style_stack,
    labels)`` computes both from one batch as the JAX bench does: R's from
    the float pipeline's images, G's by ``calibrate_gen_quant``.  ``run(
    style_stack, labels) -> (images (B, H, W, 1), greedy ids (B, T - 1))``;
    ``run.gen``/``run.rec`` are the models, ``run.base`` the float
    pipeline on the same models."""
    dev = resolve_device(device)
    base = make_generate_and_read_fn(config, gen_state, rec_state,
                                     device=dev, seed=seed)
    gen, rec = base.gen, base.rec
    mode = "dynamic" if quant_gen is True else (quant_gen or None)
    if mode not in (None, "dynamic", "static"):
        raise ValueError(f"quant_gen must be False, True, 'dynamic' or "
                         f"'static', not {quant_gen!r}")
    if gen_quant is not None:
        load_gen_quant(gen, gen_quant)

    run_gen = gen_fn_in_mode(gen, mode, dev)

    @torch.inference_mode()
    def run_rec(images, labels):
        if run.qparams is None:
            raise RuntimeError("no int8 trunk parameters: pass qparams= or "
                               "call run.calibrate(style_stack, labels)")
        with span("R"):
            labels = torch.as_tensor(labels, device=dev).long()
            with span("R.trunk"):
                feat = vgg_quant_apply(run.qparams,
                                       images.permute(0, 3, 1, 2))
            logits, _ = rec.read_features(feat, labels)
            return logits.argmax(dim=-1)

    def calibrate(style_stack, labels):
        with torch.inference_mode():
            images = base.run_gen(style_stack, labels)
            run.qparams = prepare_vgg_quant(rec, images.permute(0, 3, 1, 2))
        calibrate_gen_quant(gen, style_stack, labels, dev)

    def run(style_stack, labels):
        with span("serve.request"):
            images = run_gen(style_stack, labels)
            return images, run_rec(images, labels)

    run.run_gen, run.run_rec, run.calibrate = run_gen, run_rec, calibrate
    run.gen, run.rec, run.base = gen, rec, base
    run.qparams = None if qparams is None else qparams_to(qparams, dev)
    return run
