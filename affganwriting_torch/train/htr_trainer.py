"""Standalone HTR trainer: the seq2seq recognizer alone on word images.

Port of ``affganwriting_tpu/train/htr_trainer.py`` (the pre-GANwriting
recognizer project, GAN_word/recognizer/main_torch_latest.py): Adam at 2e-4
under the JAX package's piecewise schedule, a teacher-forcing rate that
decays linearly over the epochs, the label-smoothed recognition loss and
the CER of the greedy ids.  The schedule counts optimizer steps: the rate
is multiplied by ``gamma`` at steps ``m * 1000`` for each milestone ``m``
(the JAX package takes 1000 steps for an epoch there).  Augmentation runs
on the host, in the caller's batch stream (``data/augment.py``).
"""

from __future__ import annotations

from collections.abc import Iterable, Mapping

import numpy as np
import torch

from affganwriting_torch.core.config import WordGanConfig
from affganwriting_torch.eval.cer import cer_counts
from affganwriting_torch.gen.inference import init_weights, resolve_device
from affganwriting_torch.models.recognizer.seq2seq import Recognizer
from affganwriting_torch.train import losses

STEPS_PER_MILESTONE = 1000


def teacher_rate_schedule(epoch: int, total: int = 200) -> float:
    """Linear decay 0.5 -> 0 over ``total`` epochs."""
    return max(0.0, 0.5 * (1.0 - epoch / total))


def piecewise_lr(step: int, lr: float, milestones: tuple[int, ...],
                 gamma: float) -> float:
    """optax ``piecewise_constant_schedule(lr, {m * 1000: gamma})`` at
    ``step`` updates already taken."""
    out = lr
    for m in milestones:
        if step >= m * STEPS_PER_MILESTONE:
            out *= gamma
    return out


class HTRTrainer:
    """R (``config``'s seq2seq recognizer, dropout ``rec_dropout``) on
    ``device`` (``None``: the card) with random weights from ``seed`` or the
    state dict ``weights``, and its Adam.  ``generator`` (on the device,
    seeded from ``seed``) draws the dropout and teacher-forcing masks."""

    def __init__(self, config: WordGanConfig, lr: float = 2e-4,
                 milestones: tuple[int, ...] = (60, 100, 140),
                 gamma: float = 0.5, seed: int = 0, *, device=None,
                 weights: Mapping | None = None, rec_dropout: float = 0.5):
        self.config, self.lr = config, lr
        self.milestones, self.gamma = tuple(milestones), gamma
        self.device = resolve_device(device)
        rec = Recognizer(config.vocab_size, config.rec_hidden,
                         config.rec_embed, config.output_max_len,
                         config.img_height,
                         getattr(torch, config.compute_dtype), rec_dropout)
        if weights is None:
            init_weights(rec, seed)
        else:
            rec.load_state_dict(weights, strict=True)
        self.rec = rec.to(self.device)
        self.opt = torch.optim.Adam(self.rec.parameters(), lr=lr)
        self.steps = 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def lr_now(self) -> float:
        return piecewise_lr(self.steps, self.lr, self.milestones, self.gamma)

    def train_step(self, img, labels, teacher_rate: float = 0.0):
        """One Adam step on a batch: ``img`` (B, H, W, 1) in [-1, 1],
        ``labels`` (B, T), the teacher mask drawn at ``teacher_rate``.
        Returns (loss, logits), detached."""
        x = torch.as_tensor(np.asarray(img), dtype=torch.float32,
                            device=self.device).permute(0, 3, 1, 2)
        y = torch.as_tensor(np.asarray(labels), device=self.device).long()
        for group in self.opt.param_groups:
            group["lr"] = self.lr_now()
        logits, _ = self.rec.train()(x, y, self.generator,
                                     teacher_rate=teacher_rate)
        loss = losses.rec_loss(logits, y, self.config.label_smoothing)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self.steps += 1
        return loss.detach(), logits.detach()

    def train_epoch(self, batches: Iterable[Mapping], epoch: int,
                    total_epochs: int = 200) -> dict:
        """One pass over ``batches`` ({"image", "labels"}) at the epoch's
        teacher rate: {"loss" (mean), "cer" (of the greedy ids),
        "teacher_rate"}."""
        rate = teacher_rate_schedule(epoch, total_epochs)
        loss_sum, n, ed_sum, len_sum = 0.0, 0, 0, 0
        for batch in batches:
            loss, logits = self.train_step(batch["image"], batch["labels"],
                                           rate)
            loss_sum += float(loss)
            n += 1
            labels = torch.as_tensor(np.asarray(batch["labels"]),
                                     device=logits.device).long()
            ed, ln = cer_counts(logits.argmax(-1), labels[:, 1:])
            ed_sum += int(ed)
            len_sum += int(ln)
        return {"loss": loss_sum / max(n, 1),
                "cer": 100.0 * ed_sum / max(len_sum, 1),
                "teacher_rate": rate}
