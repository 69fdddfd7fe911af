"""Losses of the word GAN, all reduced in f32.

Port of ``affganwriting_tpu/train/losses.py``: the recognition loss is the
label-smoothing KL divergence (smoothing 0.4, PAD column and PAD-target rows
zeroed, sum-reduced); D uses BCE-with-logits averaged over its patch
logits, and the writer classifier cross-entropy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from affganwriting_torch.core.config import VOCAB


def recon_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred.float() - target.float()).abs().mean()


def label_smoothing_kl(logits: torch.Tensor, targets: torch.Tensor,
                       smoothing: float = 0.4,
                       pad_id: int = VOCAB.pad) -> torch.Tensor:
    """KL(true_dist || softmax(logits)), sum-reduced.  logits (N, V),
    targets (N,).  true_dist puts 1 - smoothing on the target and
    smoothing / (V - 2) elsewhere, zeroes the PAD column and the rows whose
    target is PAD; p log p at p = 0 counts as 0."""
    return _kl_terms(logits, targets, smoothing, pad_id).sum()


def label_smoothing_kl_per_row(logits: torch.Tensor, targets: torch.Tensor,
                               smoothing: float = 0.4,
                               pad_id: int = VOCAB.pad) -> torch.Tensor:
    """``label_smoothing_kl`` unreduced over the rows: (N,)."""
    return _kl_terms(logits, targets, smoothing, pad_id).sum(-1)


def _kl_terms(logits, targets, smoothing, pad_id) -> torch.Tensor:
    """The (N, V) summands of ``label_smoothing_kl``."""
    logits = logits.float()
    n, v = logits.shape
    true_dist = torch.full((n, v), smoothing / (v - 2), device=logits.device)
    true_dist[torch.arange(n, device=logits.device), targets] = 1.0 - smoothing
    true_dist[:, pad_id] = 0.0
    true_dist[targets == pad_id] = 0.0
    log_probs = F.log_softmax(logits, dim=-1)
    plogp = torch.where(true_dist > 0, true_dist * true_dist.log(),
                        torch.zeros((), device=logits.device))
    return plogp - true_dist * log_probs


def rec_loss(logits: torch.Tensor, labels_with_go: torch.Tensor,
             smoothing: float = 0.4) -> torch.Tensor:
    """Per-step logits (B, T-1, V) against the labels (B, T) without GO."""
    v = logits.shape[-1]
    return label_smoothing_kl(logits.reshape(-1, v),
                              labels_with_go[:, 1:].reshape(-1), smoothing)


def _bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean over every patch logit against an all-``target`` label."""
    logits = logits.float()
    return -(target * F.logsigmoid(logits)
             + (1.0 - target) * F.logsigmoid(-logits)).mean()


def dis_real_loss(patch_logits: torch.Tensor) -> torch.Tensor:
    return _bce_with_logits(patch_logits, 1.0)


def dis_fake_loss(patch_logits: torch.Tensor) -> torch.Tensor:
    return _bce_with_logits(patch_logits, 0.0)


def gen_adv_loss(patch_logits: torch.Tensor) -> torch.Tensor:
    """G wants its fakes scored as real."""
    return _bce_with_logits(patch_logits, 1.0)


def writer_ce_loss(logits: torch.Tensor,
                   writer_ids: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, writer_ids.long()[:, None]).mean()
