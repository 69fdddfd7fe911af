"""Perceptual-autoencoder pretraining (the reference's AutoTrainer).

The port of ``affganwriting_tpu/train/auto_trainer.py`` (the reference's
line_generation/trainer/auto_trainer.py and the
``cf_IAM_auto_2tight_newCTC`` recipe): train the 2tight AE on line images
with L1 reconstruction, optionally CTC-regularized through the E_HWR head
on the AE's bottleneck (the 'newCTC' variant).  The result is the frozen
encoder the line GAN uses for its perceptual loss
(``train/line_trainer.splice_pretrained_ae``).

As in the JAX trainer, the AE is applied in eval mode (flax's
``train=False``): the E_HWR head's dropout is off while it trains.  The
weights are drawn from torch's initializers under ``seed`` (the packages'
random streams differ).  The trainer runs on the card unless it is built
with ``device="cpu"``.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from affganwriting_torch.gen.inference import resolve_device
from affganwriting_torch.models.line.autoencoder import Autoencoder
from affganwriting_torch.train.line_trainer import ctc_loss


@dataclasses.dataclass
class AutoState:
    step: int
    ae: Autoencoder
    opt: torch.optim.Adam


class AutoTrainer:
    """``ctc_weight > 0`` builds the E_HWR head on the AE's bottleneck so
    CTC regularizes the code itself (autoencoder.py:596-629 +
    cf_IAM_auto_2tight_newCTC.json)."""

    def __init__(self, lr: float = 2e-4, seed: int = 0,
                 ctc_weight: float = 0.0, n_class: int = 80,
                 variant: str = "2tight", device=None):
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.ae = Autoencoder(
                variant=variant,
                hwr_classes=n_class if ctc_weight > 0.0 else None)
        self.lr = lr
        self.ctc_weight = ctc_weight
        self.n_class = n_class

    def init_state(self, sample_img=None) -> AutoState:
        """A copy of the AE on the device and a fresh Adam (b1 0.5, b2
        0.999).  ``sample_img`` is not needed (the JAX trainer takes it
        for shapes)."""
        ae = copy.deepcopy(self.ae).to(self.device).eval()
        opt = torch.optim.Adam(ae.parameters(), lr=self.lr,
                               betas=(0.5, 0.999), eps=1e-8)
        return AutoState(step=0, ae=ae, opt=opt)

    def _put(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    def step(self, state: AutoState, img, labels, lengths):
        """One update on NHWC ``img`` (numpy or a tensor): returns (state,
        loss, l1), the losses as detached tensors."""
        x = self._put(img, torch.float32).permute(0, 3, 1, 2)
        recon, ctc_logp = state.ae(x, return_ctc=True)
        l1 = (recon.float() - x.float()).abs().mean()
        loss = l1
        if self.ctc_weight > 0.0:
            loss = loss + self.ctc_weight * ctc_loss(
                ctc_logp, self._put(labels, torch.long),
                self._put(lengths, torch.long))
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        state.opt.step()
        state.step += 1
        return state, loss.detach(), l1.detach()

    def train(self, state: AutoState, batches, iterations: int,
              logger=None) -> AutoState:
        it = 0
        for batch in batches:
            if it >= iterations:
                break
            img = np.asarray(batch["image"])
            labels = batch.get("label",
                               np.zeros((img.shape[0], 1), np.int32))
            lengths = batch.get("label_lengths",
                                np.zeros((img.shape[0],), np.int32))
            state, loss, l1 = self.step(state, img, labels, lengths)
            if logger is not None and it % 50 == 0:
                logger.log(it, {"ae_loss": float(loss), "ae_l1": float(l1)},
                           group="auto")
            it += 1
        return state
