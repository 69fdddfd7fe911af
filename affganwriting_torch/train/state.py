"""Training state of the four-player word GAN: G, D, the writer classifier
C and the recognizer R, each a module with its optimizer.

Port of ``affganwriting_tpu/train/state.py``.  The JAX package carries
params, batch statistics and optimizer state as one pytree through its
jitted step; here each player is a module (parameters and BatchNorm
running statistics) beside a ``torch.optim`` optimizer, and the step updates
them in place.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch
from torch import nn

from affganwriting_torch.core.config import WordGanConfig
from affganwriting_torch.gen.inference import (
    init_weights,
    new_recognizer,
    resolve_device,
)
from affganwriting_torch.models.discriminator import Discriminator
from affganwriting_torch.models.generator import Generator
from affganwriting_torch.models.writer_cla import WriterClassifier

PLAYERS = ("gen", "dis", "cla", "rec")
# random weights of player i come from seed + _SEED_OFFSET[i]; G and R as
# in gen/inference.py:build_models
_SEED_OFFSET = {"gen": 0, "rec": 1, "dis": 2, "cla": 3}


@dataclasses.dataclass
class PlayerState:
    model: nn.Module
    opt: torch.optim.Optimizer | None    # None: R with ``rec_frozen``


@dataclasses.dataclass
class WordGanState:
    step: int
    gen: PlayerState
    dis: PlayerState
    cla: PlayerState
    rec: PlayerState


def new_models(config: WordGanConfig, rec_dropout: float = 0.5) -> dict:
    """The four players, constructed on the current default device with
    torch's initial weights: {"gen", "dis", "cla", "rec"}.  R is
    ``config.recognizer``'s (``gen/inference.py:new_recognizer``);
    ``rec_dropout`` is the seq2seq R's dropout rate (0.5 in the JAX
    package; 0 for parity runs)."""
    dtype = getattr(torch, config.compute_dtype)
    return {
        "gen": Generator(config),
        "dis": Discriminator(config.img_height, config.img_width,
                             config.dis_final_size, config.dis_layers, dtype),
        "cla": WriterClassifier(config.num_writers, config.img_height,
                                config.img_width, config.dis_layers, dtype),
        "rec": new_recognizer(config, rec_dropout),
    }


def build_models(config: WordGanConfig, device=None, *, seed: int = 0,
                 weights: Mapping[str, Mapping] | None = None,
                 rec_dropout: float = 0.5) -> dict:
    """The four players on ``device`` (``None``: the card), with the state
    dicts in ``weights`` (e.g. from ``utils/from_flax.word_gan_from_flax``)
    or random weights from ``seed``.  With ``config.rec_frozen`` R's
    parameters take no gradient (the TrOCR drop-in keeps its weights,
    trocr_recognizer.py:119-121); G still gets R's gradient through the
    fakes."""
    dev = resolve_device(device)
    models = new_models(config, rec_dropout)
    for name, model in models.items():
        if weights is None:
            init_weights(model, seed + _SEED_OFFSET[name])
        else:
            model.load_state_dict(weights[name], strict=True)
        models[name] = model.to(dev)
    if config.rec_frozen:
        models["rec"].requires_grad_(False)
    return models


def make_optimizers(config: WordGanConfig, models: Mapping[str, nn.Module]):
    """Adam (torch's defaults are optax ``adam``'s) or, for any other
    ``config.optimizer``, plain SGD (``optax.sgd``), at each player's
    learning rate; R has none when ``rec_frozen``.  R's rate can be changed
    between steps with ``set_rec_lr``."""
    cls = torch.optim.Adam if config.optimizer == "adam" else torch.optim.SGD
    lrs = {"gen": config.lr_gen, "dis": config.lr_dis, "cla": config.lr_cla,
           "rec": config.lr_rec}
    return {name: None if name == "rec" and config.rec_frozen
            else cls(models[name].parameters(), lr=lrs[name])
            for name in PLAYERS}


def set_rec_lr(state: WordGanState, lr: float) -> None:
    """Set R's learning rate for the next steps (the plateau schedule; optax
    ``inject_hyperparams`` in the JAX package)."""
    if state.rec.opt is None:
        raise ValueError("R is frozen (rec_frozen): it has no optimizer")
    for group in state.rec.opt.param_groups:
        group["lr"] = lr


def init_state(config: WordGanConfig, device=None, seed: int = 0, *,
               weights: Mapping[str, Mapping] | None = None,
               rec_dropout: float = 0.5) -> WordGanState:
    """Step 0 of training on ``device`` (``None``: the card; pass
    ``device="cpu"`` for the CPU): the players of ``build_models`` and
    their optimizers."""
    models = build_models(config, device, seed=seed, weights=weights,
                          rec_dropout=rec_dropout)
    opts = make_optimizers(config, models)
    return WordGanState(0, *(PlayerState(models[n], opts[n])
                             for n in PLAYERS))


def param_count(state: WordGanState) -> dict[str, int]:
    return {n: sum(p.numel() for p in getattr(state, n).model.parameters())
            for n in PLAYERS}
