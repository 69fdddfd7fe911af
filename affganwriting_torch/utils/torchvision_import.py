"""torchvision state dicts -> state dicts of the port's modules, with the
50-channel first-conv surgery.

The port of ``affganwriting_tpu/utils/torch_import.py`` (and of
``models/style_encoders/efficientnet.py:efficientnet_v2_l_to_flax``).  The
reference loads torchvision ImageNet checkpoints and widens the first conv
to the 50-image style stack: RGB kernels copied, the channel-0 kernel tiled
over channels 3..49 (GAN_word/modules_tro.py:487-491, inception.py:41-50).
The port keeps torch's layouts, so a conversion only renames, drops what the
port lacks (``num_batches_tracked``, the classifier heads) and widens the
first conv.  The 1x1 reducers have no torchvision counterpart: load a
result with ``load_state_dict(..., strict=False)`` over an initialized
module, and only the reducers stay missing.  Nothing is downloaded.
"""

from __future__ import annotations

from typing import Sequence

import torch

from affganwriting_torch.models.style_encoders.efficientnet import V2L_STAGES


def expand_first_conv(weight_oihw: torch.Tensor,
                      in_channels: int) -> torch.Tensor:
    """(O, 3, KH, KW) -> (O, in_channels, KH, KW): RGB copied, channel 0
    tiled over the rest."""
    o, i, kh, kw = weight_oihw.shape
    if i != 3:
        raise ValueError(f"expected an RGB first conv, got {i} channels")
    out = weight_oihw.new_zeros((o, in_channels, kh, kw))
    out[:, :3] = weight_oihw
    if in_channels > 3:
        out[:, 3:] = weight_oihw[:, :1]
    return out


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A ``.pth`` state dict (under ``"state_dict"`` or bare), with any
    ``module.`` prefix of a wrapped model removed."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.replace("module.", ""): v for k, v in sd.items()}


def _tensors(sd) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v) for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def resnet50_state_dict(sd, in_channels: int = 50) -> dict:
    """torchvision ``resnet50`` -> the port's ``ResNet50StyleEncoder``
    (``layer1.0.conv1`` -> ``layer1_0.conv1``, ``downsample.0/1`` ->
    ``down_conv``/``down_bn``); ``fc`` is dropped."""
    out = {}
    for k, v in _tensors(sd).items():
        if k.startswith("fc."):
            continue
        if k == "conv1.weight":
            v = expand_first_conv(v, in_channels)
        parts = k.split(".")
        if parts[0].startswith("layer"):
            parts[:2] = [f"{parts[0]}_{parts[1]}"]
            if parts[1] == "downsample":
                parts[1:3] = ["down_conv" if parts[2] == "0" else "down_bn"]
        out[".".join(parts)] = v
    return out


def inception_v3_state_dict(sd) -> dict:
    """torchvision / pytorch-fid ``inception_v3`` -> the port's
    ``InceptionV3Pool3`` (the same names); ``AuxLogits.*`` and ``fc.*`` are
    dropped."""
    return {k: v for k, v in _tensors(sd).items()
            if not k.startswith(("AuxLogits", "fc."))}


def efficientnet_v2_l_state_dict(sd, in_channels: int = 50,
                                 stages: Sequence = V2L_STAGES) -> dict:
    """torchvision ``efficientnet_v2_l`` -> the port's
    ``EfficientNetV2StyleEncoder`` trunk: the stem and feature stages
    1..len(stages); stages 6-8 and the classifier are dropped."""
    sd = _tensors(sd)
    out = {}

    def conv(name, tv):
        out[f"{name}.weight"] = sd[f"{tv}.weight"]

    def bn(name, tv):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{leaf}"] = sd[f"{tv}.{leaf}"]

    out["stem.weight"] = expand_first_conv(sd["features.0.0.weight"],
                                           in_channels)
    bn("stem_bn", "features.0.1")
    for si, (n, kind, _k, _s, e, _out, _se) in enumerate(stages):
        for bi in range(n):
            name, p = f"stage{si + 1}_{bi}", f"features.{si + 1}.{bi}.block"
            if kind == "fused" and e == 1:
                layers = (("project", "0"),)
            elif kind == "fused":
                layers = (("expand", "0"), ("project", "1"))
            else:
                layers = (("expand", "0"), ("dw", "1"), ("project", "3"))
                for port, tv in (("se_reduce", "fc1"), ("se_expand", "fc2")):
                    conv(f"{name}.{port}", f"{p}.2.{tv}")
                    out[f"{name}.{port}.bias"] = sd[f"{p}.2.{tv}.bias"]
            for port, idx in layers:
                conv(f"{name}.{port}", f"{p}.{idx}.0")
                bn(f"{name}.{port}_bn", f"{p}.{idx}.1")
    return out
