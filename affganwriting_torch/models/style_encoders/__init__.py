"""Style-encoder registry: each backbone consumes the (S, 50, H, W) style
stack and emits a 5-tap pyramid of ``style_dim``-channel features whose last
tap is resized to (H/8, W/8).  This slice ports ``resnet50`` and
``resnet18``."""

from __future__ import annotations

from typing import Callable

_REGISTRY: dict[str, Callable] = {}


def register(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def get_style_encoder(name: str, **kwargs):
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown style encoder {name!r}; the port has {sorted(_REGISTRY)}"
        ) from None
    return cls(**kwargs)


from affganwriting_torch.models.style_encoders import resnet  # noqa: E402,F401
