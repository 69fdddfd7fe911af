"""Generator: style encoder + text encoder + mix + AdaIN decoder.

Port of ``affganwriting_tpu/models/generator.py``.  ``encode_style`` runs
once per style stack, ``generate`` consumes the cached pyramid with any
number of words.  Internally NCHW; ``encode_style`` takes the style stack in
the JAX layout (S, H, W, 50).  In eval mode ``generate`` opens the spans
``G.text_mix`` and ``G.dec`` (``utils/profiling.span``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from affganwriting_torch.core.config import WordGanConfig
from affganwriting_torch.models.decoder import Decoder
from affganwriting_torch.models.style_encoders import get_style_encoder
from affganwriting_torch.models.text_encoder import TextEncoderFC
from affganwriting_torch.parallel.ops import all_reduce_model, model_input
from affganwriting_torch.utils.profiling import span


class SplitMix(nn.Module):
    """Dense over concat([style, content]) channels without the concat:
    ``style @ K[:ds] + content @ K[ds:] + b``, so a batch-1 style term
    broadcasts against batch-B content.  The weight is (features, ds + dc),
    the transpose of the flax kernel.  Placed on a mesh's model axis
    (``parallel/mesh.py``: ``tp`` set, the weight holding this rank's block
    of the ds + dc input rows) each rank contracts its rows, the partial
    sums are summed over the model group, and so are the inputs'
    gradients."""

    def __init__(self, ds: int, dc: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, ds + dc))
        self.bias = nn.Parameter(torch.zeros(features))
        self.tp = None

    def _term(self, x, k):
        return torch.einsum("bchw,fc->bfhw", x.to(self.dtype), k).float()

    def forward(self, style_last, content):
        ds = style_last.shape[1]
        k = self.weight.to(self.dtype)
        b = self.bias.view(1, -1, 1, 1)
        if self.tp is None:
            return (self._term(style_last, k[:, :ds])
                    + self._term(content, k[:, ds:]) + b).to(self.dtype)
        # one input for every rank, so each runs the same collectives in
        # backward whichever rows it holds
        b_max = max(style_last.shape[0], content.shape[0])
        x = model_input(torch.cat([
            style_last.expand(b_max, -1, -1, -1).to(self.dtype),
            content.expand(b_max, -1, -1, -1).to(self.dtype)], dim=1),
            self.tp.group)
        lo = self.tp.rank * k.shape[1]
        part = self._term(x[:, lo:lo + k.shape[1]], k)
        return (all_reduce_model(part, self.tp.group) + b).to(self.dtype)


class Generator(nn.Module):
    def __init__(self, config: WordGanConfig, subpixel: bool = True):
        super().__init__()
        dtype = getattr(torch, config.compute_dtype)
        final_hw = (config.img_height // 8, config.img_width // 8)
        # style_dim only when it is not 512, as the JAX Generator passes
        # it: the fixed-width vgg19 has no reducers and refuses it
        extra = ({} if config.style_dim == 512
                 else {"style_dim": config.style_dim})
        self.enc_image = get_style_encoder(
            config.style_encoder, in_channels=config.style_stack,
            final_hw=final_hw, dtype=dtype, **extra)
        self.text_encoder = TextEncoderFC(
            max_len=config.output_max_len, vocab_size=config.vocab_size,
            embed_dim=config.text_embed_dim, content_dim=config.style_dim,
            adain_dim=config.adain_param_dim, dtype=dtype)
        self.dec = Decoder(dim=config.style_dim, subpixel_upsample=subpixel,
                           dtype=dtype)
        self.linear_mix = SplitMix(config.style_dim, config.style_dim,
                                   config.style_dim, dtype)

    def encode_style(self, style_stack: torch.Tensor) -> list[torch.Tensor]:
        """(S, H, W, 50) -> 5-tap NCHW pyramid, last tap (S, 512, H/8, W/8)."""
        return self.enc_image(style_stack.permute(0, 3, 1, 2))

    def generate(self, pyramid: Sequence[torch.Tensor],
                 labels: torch.Tensor) -> torch.Tensor:
        """Style pyramid + labels (B, T) -> image (B, 1, H, W)."""
        serving = not self.training
        f_xs = pyramid[-1]
        with span("G.text_mix", serving):
            adain_params, content = self.text_encoder(labels, f_xs.shape[2:])
            mixed = self.linear_mix(f_xs, content)
        with span("G.dec", serving):
            return self.dec(mixed, adain_params, pyramid)

    def forward(self, style_stack, labels):
        return self.generate(self.encode_style(style_stack), labels)
