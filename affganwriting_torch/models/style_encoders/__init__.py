"""Style-encoder registry: each backbone consumes the (S, 50, H, W) style
stack and emits a pyramid of at least 5 taps whose taps 3 and 4 (the
decoder's skips) and last tap have ``style_dim`` channels, the last resized
to (H/8, W/8).  All ten keys of the JAX package's registry: resnet50,
resnet18, cnn, vgg19, inception_v3, efficientnet_v2_l and dinov2_s/b/l/g.
``vgg19`` has a fixed width of 512 and takes no ``style_dim``."""

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


def available() -> list[str]:
    return sorted(_REGISTRY)


# populate the registry
from affganwriting_torch.models.style_encoders import resnet  # noqa: E402,F401
from affganwriting_torch.models.style_encoders import cnn  # noqa: E402,F401
from affganwriting_torch.models.style_encoders import vgg  # noqa: E402,F401
from affganwriting_torch.models.style_encoders import vit  # noqa: E402,F401
from affganwriting_torch.models.style_encoders import inception  # noqa: E402,F401
from affganwriting_torch.models.style_encoders import efficientnet  # noqa: E402,F401
