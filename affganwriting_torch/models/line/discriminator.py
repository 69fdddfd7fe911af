"""Two-head spectral-norm patch discriminator of the line GAN (NCHW).

Port of ``affganwriting_tpu/models/line/discriminator.py:DiscriminatorAP``
(the reference's line_generation/model/discriminator_ap.py:68-161, config
"condAP wide, use low"): a group-normed 7x7 input conv (valid in height,
padded 3 in width), a spectral-normalized conv pyramid of height-valid 3x3
convs and 2x2 average pools, a mid-resolution patch head ``final_med``
and a further-pooled "low" head ``final_low``.  It returns the two heads,
each flattened to (B, N); the trainer applies the hinge loss per head.

Spectral normalization is flax's ``nn.SpectralNorm``, written out
(``SNConv2d``); torch's ``spectral_norm`` differs from it in each point:

- the kernel is read in flax's layout, (kh * kw * in, out), and the
  power-iteration vector ``u`` is (1, out);
- every call runs one power iteration from the stored ``u`` with eps
  1e-12 (``x * rsqrt(sum(x^2) + eps)``), in eval mode too;
  ``sigma = v W u^T`` carries the gradient into the kernel, ``u`` and
  ``v`` do not;
- ``u`` and ``sigma`` (the buffers that hold the JAX package's
  ``disc_stats``) are written back only when the call asks for it
  (``update_stats``), whatever the module's mode.

Dropout (0.05 after ``c1b`` and ``c3b``, 0.025 in the low branch) drops
whole channels, shared over H x W (flax's ``broadcast_dims=(1, 2)``), in
train mode only, its masks drawn from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from affganwriting_torch.models.blocks import (
    Conv2d,
    GroupNorm,
    dropout,
    get_group_size,
)

SN_EPS = 1e-12


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + SN_EPS)


class SNConv2d(Conv2d):
    """``nn.SpectralNorm(nn.Conv(...))`` of flax with one power iteration;
    buffers ``u`` (1, out), initially N(0, 1), and ``sigma`` (), initially
    1."""

    def __init__(self, cin: int, cout: int, kernel, *, padding=0):
        super().__init__(cin, cout, kernel, padding=padding)
        self.register_buffer("u", torch.randn(1, cout))
        self.register_buffer("sigma", torch.ones(()))

    def normalized_weight(self, update_stats: bool) -> torch.Tensor:
        out = self.weight.shape[0]
        value = self.weight.permute(2, 3, 1, 0).reshape(-1, out)
        with torch.no_grad():
            v0 = _l2_normalize(self.u @ value.T)
            u0 = _l2_normalize(v0 @ value)
        sigma = (v0 @ value @ u0.T)[0, 0]
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u0)
                self.sigma.copy_(sigma)
        return self.weight / torch.where(sigma != 0, sigma,
                                         torch.ones_like(sigma))

    def forward(self, x: torch.Tensor,
                update_stats: bool = False) -> torch.Tensor:
        w = self.normalized_weight(update_stats)
        return F.conv2d(x, w, self.bias, self.stride, self.padding)


def _avg_pool(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    return F.avg_pool2d(x, (kh, kw), stride=(kh, kw))


class DiscriminatorAP(nn.Module):
    def __init__(self, dim: int = 64, use_low: bool = True,
                 use_med: bool = True, leak: float = 0.1):
        super().__init__()
        d = dim
        self.use_low, self.use_med, self.leak = use_low, use_med, leak
        self.in_conv = Conv2d(1, d, 7, padding=(0, 3))
        self.GroupNorm_0 = GroupNorm(get_group_size(d), d)
        self.c1a = SNConv2d(d, d, 3, padding=(0, 1))
        self.c1b = SNConv2d(d, 2 * d, 3, padding=(0, 1))
        self.c2 = SNConv2d(2 * d, 2 * d, 3, padding=(0, 1))
        self.c3a = Conv2d(2 * d, 2 * d, 3, padding=(0, 1))
        self.GroupNorm_1 = GroupNorm(get_group_size(2 * d), 2 * d)
        self.c3b = SNConv2d(2 * d, 4 * d, 3, padding=(0, 1))
        if use_med:
            self.final_med = SNConv2d(4 * d, 1, 3, padding=(0, 1))
        if use_low:
            self.c4a = SNConv2d(4 * d, 2 * d, 3, padding=(0, 1))
            self.c4b0 = SNConv2d(2 * d, 4 * d, (1, 3), padding=(0, 1))
            self.c4b1 = SNConv2d(4 * d, 4 * d, (1, 3), padding=(0, 1))
            self.c4c = SNConv2d(4 * d, 4 * d, (1, 3), padding=(0, 1))
            self.final_low = SNConv2d(4 * d, 1, 1)

    def sn_layers(self) -> dict[str, SNConv2d]:
        return {n: m for n, m in self.named_children()
                if isinstance(m, SNConv2d)}

    def sn_state(self) -> dict[str, torch.Tensor]:
        """A copy of every ``u`` and ``sigma`` (the JAX ``disc_stats``)."""
        return {f"{n}.{b}": getattr(m, b).detach().clone()
                for n, m in self.sn_layers().items() for b in ("u", "sigma")}

    def load_sn_state(self, state: dict[str, torch.Tensor]) -> None:
        with torch.no_grad():
            for n, m in self.sn_layers().items():
                for b in ("u", "sigma"):
                    getattr(m, b).copy_(state[f"{n}.{b}"])

    def forward(self, x: torch.Tensor, *, update_stats: bool = False,
                generator: torch.Generator | None = None
                ) -> list[torch.Tensor]:
        """x (B, 1, H, W) -> [med head (B, N1), low head (B, N2)]."""
        def sn(name, h):
            return getattr(self, name)(h, update_stats)

        def lrelu(h):
            return F.leaky_relu(h, self.leak)

        def drop(h, p):
            if not self.training:
                return h
            return dropout(h, p, generator, channels=True)

        h = lrelu(self.GroupNorm_0(self.in_conv(x)))
        h = _avg_pool(lrelu(sn("c1a", h)), 2, 2)
        h = lrelu(drop(sn("c1b", h), 0.05))
        h = _avg_pool(lrelu(sn("c2", h)), 2, 2)
        h = _avg_pool(lrelu(self.GroupNorm_1(self.c3a(h))), 2, 2)
        mid = lrelu(drop(sn("c3b", h), 0.05))
        heads = []
        if self.use_med:
            p = sn("final_med", mid)
            heads.append(p.reshape(p.shape[0], -1))
        if self.use_low:
            g = _avg_pool(lrelu(drop(sn("c4a", mid), 0.025)), 1, 2)
            g = _avg_pool(lrelu(drop(sn("c4b0", g), 0.025)), 1, 2)
            g = lrelu(drop(sn("c4b1", g), 0.025))
            g = lrelu(drop(sn("c4c", g), 0.025))
            p = sn("final_low", g)
            heads.append(p.reshape(p.shape[0], -1))
        return heads
