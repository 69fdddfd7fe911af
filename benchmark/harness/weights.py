"""Random weights from the seed, drawn on the device in one call.

Every tensor of a player's state dict, by the reference's names (which are
the program's): LeCun-normal (std 1/sqrt(fan_in)) for tensors of rank 2
and more, ones for norm scales and running variances, zeros for biases and
running means.  Drawn with a ``torch.Generator`` on the device, in float32,
the parameters' type.
"""

from __future__ import annotations

import torch

from benchmark.reference import models as ref

PLAYER_SEED = {"gen": 0, "rec": 1, "dis": 2, "cla": 3}


def shapes(cfg: dict, player: str) -> dict[str, torch.Size]:
    with torch.device("meta"):
        model = ref.build(cfg, player)
    return {k: v.shape for k, v in model.state_dict().items()}


def draw(cfg: dict, player: str, seed: int, device) -> dict[str, torch.Tensor]:
    """The state dict of ``player`` for ``seed``."""
    sh = shapes(cfg, player)
    big = [k for k, s in sh.items() if len(s) >= 2]
    gen = torch.Generator(device=device).manual_seed(
        (seed * 4 + PLAYER_SEED[player]) % (2 ** 63))
    flat = torch.randn(sum(sh[k].numel() for k in big), generator=gen,
                       device=device)
    out, at = {}, 0
    for k in big:
        n = sh[k].numel()
        out[k] = flat[at:at + n].view(sh[k]) / (n // sh[k][0]) ** 0.5
        at += n
    for k, s in sh.items():
        if k in out:
            continue
        leaf = k.rsplit(".", 1)[-1]
        one = leaf in ("running_var",) or (leaf == "weight")
        out[k] = (torch.ones if one else torch.zeros)(s, device=device)
    return out


def materialize(cfg: dict, player: str, state: dict, device):
    """The reference player with ``state``, on ``device``, in float32."""
    with torch.device("meta"):
        model = ref.build(cfg, player)
    model = model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    if hasattr(model, "gate_hooks"):
        model.gate_hooks()
    return model
