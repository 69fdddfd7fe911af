"""Stochastic weight averaging (the reference's base_trainer.py:180-186,
234-237).

The port of ``affganwriting_tpu/train/swa.py`` on the port's parameter
dicts ({name: tensor}): a running average updated after a start
iteration, and an exponential moving average.  The count is a Python int.
"""

from __future__ import annotations

import torch


def swa_init(params: dict[str, torch.Tensor]) -> dict:
    return {"avg": {k: v.detach().clone() for k, v in params.items()},
            "count": 0}


@torch.no_grad()
def swa_update(swa_state: dict, params: dict[str, torch.Tensor]) -> dict:
    """avg <- (avg * n + params) / (n + 1), in the parameters' dtype."""
    n = float(swa_state["count"])
    avg = {k: (a * n + params[k].detach()) / (n + 1.0)
           for k, a in swa_state["avg"].items()}
    return {"avg": avg, "count": swa_state["count"] + 1}


@torch.no_grad()
def ema_update(ema_params: dict[str, torch.Tensor],
               params: dict[str, torch.Tensor],
               decay: float = 0.999) -> dict[str, torch.Tensor]:
    return {k: decay * e + (1.0 - decay) * params[k].detach()
            for k, e in ema_params.items()}
