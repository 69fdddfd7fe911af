"""Teacher-guided recognizer phase: R fine-tuned on a frozen teacher's
reading of G's words.

Port of ``affganwriting_tpu/train/teacher.py`` (the reference's
GAN_word/main_run.py:310-410, trocr_teacher.py and helpers.py): G, in eval
mode, generates words; a frozen teacher reads them into pseudo labels with
confidences; samples at or above ``conf_threshold`` are kept, and R alone
takes a confidence-weighted, label-smoothed recognition loss under its own
Adam at 1e-5, its gradient clipped to global norm 1.0.

The teachers:

- ``SelfTeacher``: a frozen copy of the port's seq2seq R, reading with its
  batched beam search; the confidence is the mean over its greedy decode's
  steps of the largest softmax probability.
- ``DeviceTrOCRTeacher``: the port's TrOCR (``models/recognizer/trocr.py``)
  on the device, decoding greedily over the 55-symbol vocabulary; the
  confidence is the mean largest probability over the emitted tokens, up to
  and including END (the JAX package's ``FlaxTrOCRTeacher``).
- ``TrOCRTeacher``: a HF ``VisionEncoderDecoderModel`` from a local
  directory, on the host CPU through ``transformers`` (nothing is fetched).

Each ``predict(images (B, H, W, 1) in [-1, 1])`` returns (texts,
confidences (B,) numpy).
"""

from __future__ import annotations

import copy
from collections.abc import Iterable
from typing import Protocol

import numpy as np
import torch
from torch import nn

from affganwriting_torch.core.config import VOCAB, WordGanConfig
from affganwriting_torch.gen.inference import (
    generate_images,
    init_weights,
    resolve_device,
)
from affganwriting_torch.train import losses
from affganwriting_torch.train.state import WordGanState


class Teacher(Protocol):
    def predict(self, images) -> tuple[list[str], np.ndarray]:
        """images (B, H, W, 1) in [-1, 1] -> (texts, confidences)."""
        ...


def _nchw(images, device) -> torch.Tensor:
    x = torch.as_tensor(images, device=device)
    return x.permute(0, 3, 1, 2).float()


class SelfTeacher:
    """Pseudo labels from a frozen copy of the port's seq2seq R: beam
    search for the text, the greedy decode's mean top probability for the
    confidence.  The copy is taken here, so the R that the phase trains
    does not move the teacher."""

    def __init__(self, config: WordGanConfig, rec: nn.Module,
                 beam_size: int = 3):
        self.config, self.beam_size = config, beam_size
        self.rec = copy.deepcopy(rec).eval().requires_grad_(False)
        self.device = next(self.rec.parameters()).device

    @torch.inference_mode()
    def predict(self, images):
        x = _nchw(images, self.device)
        seqs, _ = self.rec.beam_search(x, beam_size=self.beam_size)
        go = torch.full((x.shape[0], 1), VOCAB.go, dtype=torch.long,
                        device=self.device)
        logits, _ = self.rec(x, torch.cat([go, seqs], dim=1))
        conf = torch.softmax(logits.float(), -1).amax(-1).mean(-1)
        return ([VOCAB.decode(s) for s in seqs.cpu().numpy()],
                conf.cpu().numpy())


class DeviceTrOCRTeacher:
    """The port's TrOCR as teacher, on the device: ``ckpt_dir`` imports a
    local HF checkpoint (base dimensions, the tokenizer's table); without
    it, ``state`` (a ``TrOCRCore`` state dict) or random weights from
    ``seed`` at ``arch`` (``TrOCRArch.tiny()`` by default), with the
    default char->token table.  Greedy decoding over the 55-symbol
    vocabulary for ``max_chars + 1`` steps, the encoder run once."""

    def __init__(self, config: WordGanConfig, ckpt_dir: str | None = None,
                 arch=None, state=None, seed: int = 0, device=None):
        from affganwriting_torch.models.recognizer.trocr import (
            TrOCRArch,
            TrOCRRecognizer,
            load_pretrained,
        )

        device = resolve_device(device)
        table = ()
        if ckpt_dir is not None:
            loaded = load_pretrained(ckpt_dir, arch)
            if loaded is None:
                raise FileNotFoundError(ckpt_dir)
            state, *table = loaded
            arch = arch or TrOCRArch.base_handwritten()
        rec = TrOCRRecognizer(arch or TrOCRArch.tiny(), config.output_max_len,
                              *table)
        if state is None:
            init_weights(rec.core, seed)
        else:
            rec.core.load_state_dict(state, strict=True)
        self.rec = rec.to(device).eval().requires_grad_(False)
        self.device = device
        self.max_steps = config.max_chars + 1

    @torch.inference_mode()
    def decode(self, images) -> tuple[torch.Tensor, torch.Tensor]:
        """(ids (B, max_steps) over the 55 symbols, confidences (B,))."""
        from affganwriting_torch.models.recognizer.trocr import (
            preprocess_for_trocr,
        )

        rec = self.rec
        x = _nchw(images, self.device)
        b = x.shape[0]
        enc = rec.core.encode(preprocess_for_trocr(x, rec.arch.image_size))
        tokens = torch.full((b, self.max_steps + 1), VOCAB.pad,
                            dtype=torch.long, device=self.device)
        tokens[:, 0] = VOCAB.go
        conf_sum = x.new_zeros(b)
        n_alive = x.new_zeros(b)
        alive = x.new_ones(b)
        for t in range(self.max_steps):
            logits = rec.core.decode(rec.map_vec[tokens[:, :t + 1]], enc)
            step = rec.vocab_logits(logits[:, t])
            nxt = step.argmax(-1)
            tokens[:, t + 1] = nxt
            # the step that emits END counts, the ones after it do not
            conf_sum += alive * torch.softmax(step, -1).amax(-1)
            n_alive += alive
            alive = alive * (nxt != VOCAB.end).float()
        return tokens[:, 1:], conf_sum / n_alive.clamp_min(1.0)

    def predict(self, images):
        seqs, conf = self.decode(images)
        texts = []
        for row in seqs.cpu().numpy():
            ids = []
            for tid in row:
                if int(tid) == VOCAB.end:
                    break
                ids.append(int(tid))
            texts.append(VOCAB.decode(ids))
        return texts, conf.cpu().numpy()


class TrOCRTeacher:
    """A frozen HF TrOCR from a local checkpoint directory, on the host
    CPU (trocr_teacher.py:63-103): beam generation, confidence the mean top
    token probability over the generated steps, and ' ', '.' and ','
    removed from the texts."""

    BANNED = (" ", ".", ",")

    def __init__(self, ckpt_dir: str, max_new_tokens: int = 16):
        from transformers import TrOCRProcessor, VisionEncoderDecoderModel

        self.processor = TrOCRProcessor.from_pretrained(
            ckpt_dir, local_files_only=True)
        self.model = VisionEncoderDecoderModel.from_pretrained(
            ckpt_dir, local_files_only=True).eval().requires_grad_(False)
        self.max_new_tokens = max_new_tokens

    def predict(self, images):
        if isinstance(images, torch.Tensor):
            images = images.detach().float().cpu().numpy()
        arr = np.asarray(images, np.float32)[..., 0]  # (B, H, W) in [-1, 1]
        arr = ((arr * 0.5 + 0.5) * 255).clip(0, 255).astype(np.uint8)
        rgb = np.stack([255 - arr] * 3, axis=-1)     # ink back to dark
        pixel_values = self.processor(
            images=list(rgb), return_tensors="pt").pixel_values
        with torch.no_grad():
            out = self.model.generate(
                pixel_values, max_new_tokens=self.max_new_tokens,
                output_scores=True, return_dict_in_generate=True)
        texts = self.processor.batch_decode(out.sequences,
                                            skip_special_tokens=True)
        confs = []
        for b in range(len(texts)):
            probs = [torch.softmax(s[b], dim=-1).max().item()
                     for s in out.scores]
            confs.append(float(np.mean(probs)) if probs else 0.0)
        cleaned = []
        for t in texts:
            for ban in self.BANNED:
                t = t.replace(ban, "")
            cleaned.append(t)
        return cleaned, np.asarray(confs, np.float32)


def texts_to_labels(texts: list[str], config: WordGanConfig) -> np.ndarray:
    """Pseudo-label texts -> padded label ids (B, output_max_len): letters
    outside the charset dropped, at most ``max_chars`` kept, "a" for an
    empty text."""
    out = []
    for t in texts:
        t = "".join(c for c in t if c in VOCAB.letters)[: config.max_chars]
        out.append(VOCAB.pad_label(t or "a", config.output_max_len))
    return np.asarray(out, np.int32)


def clip_by_global_norm_(params, max_norm: float = 1.0) -> torch.Tensor:
    """optax ``clip_by_global_norm``: every gradient scaled by ``max_norm /
    norm`` when the global norm reaches ``max_norm`` (no epsilon, unlike
    ``clip_grad_norm_``).  Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


def make_teacher_update(config: WordGanConfig, rec: nn.Module,
                        lr: float = 1e-5, max_norm: float = 1.0):
    """Returns (``update``, its Adam over ``rec``'s parameters).
    ``update(images (B, 1, H, W), labels (B, T), sample_mask (B,), weight,
    generator=None) -> loss``: R in train mode (dropout from ``generator``,
    batch statistics moving), the loss ``weight`` times the sum of the
    label-smoothed KL rows of the kept samples, its gradient clipped to
    global norm ``max_norm``, then one Adam step."""
    opt = torch.optim.Adam(rec.parameters(), lr=lr)
    params = list(rec.parameters())

    def update(images, labels, sample_mask, weight: float,
               generator: torch.Generator | None = None) -> torch.Tensor:
        logits, _ = rec.train()(images, labels, generator)
        b, v = labels.shape[0], logits.shape[-1]
        per_tok = losses.label_smoothing_kl_per_row(
            logits.reshape(-1, v), labels[:, 1:].reshape(-1),
            config.label_smoothing).reshape(b, -1)
        loss = weight * (per_tok * sample_mask[:, None]).sum()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        clip_by_global_norm_(params, max_norm)
        opt.step()
        return loss.detach()

    return update, opt


def run_teacher_phase(state: WordGanState, config: WordGanConfig,
                      teacher: Teacher, batches: Iterable,
                      generator: torch.Generator | None = None,
                      max_steps: int = 200, conf_threshold: float = 0.6
                      ) -> tuple[WordGanState, dict]:
    """Generate -> teacher labels -> filtered R update, for at most
    ``max_steps`` used batches (main_run.py:336-383).  G generates each
    batch's ``label_xt`` from its ``style_imgs`` in eval mode without
    grad; a batch with fewer than 2 samples at ``conf_threshold`` is
    skipped.  R (``state.rec.model``) is updated in place under a fresh
    Adam; ``generator`` gives its dropout masks.  Returns (state, stats)
    with the JAX function's keys; G ran once for each used or skipped
    batch."""
    gen = state.gen.model
    rec = state.rec.model
    dev = next(rec.parameters()).device
    was_training = gen.training
    gen.eval()
    update, _ = make_teacher_update(config, rec)
    stats = {"used_batches": 0, "used_samples": 0, "skipped_small": 0,
             "loss_sum": 0.0, "conf_sum": 0.0}
    steps = 0
    try:
        for batch in batches:
            if steps >= max_steps:
                break
            with torch.inference_mode():
                xg = generate_images(gen, batch["style_imgs"],
                                     batch["label_xt"], dev)
            texts, conf = teacher.predict(xg)
            mask = np.asarray(conf) >= conf_threshold
            n_used = int(mask.sum())
            if n_used < 2:
                stats["skipped_small"] += 1
                continue
            labels = torch.as_tensor(texts_to_labels(texts, config),
                                     device=dev).long()
            mean_conf = float(np.asarray(conf)[mask].mean())
            weight = float(np.clip(mean_conf, conf_threshold, 1.0))
            loss = update(xg.clone().permute(0, 3, 1, 2), labels,
                          torch.as_tensor(mask, dtype=torch.float32,
                                          device=dev), weight, generator)
            stats["used_batches"] += 1
            stats["used_samples"] += n_used
            stats["loss_sum"] += float(loss)
            stats["conf_sum"] += mean_conf
            steps += 1
    finally:
        gen.train(was_training)
    n = max(stats["used_batches"], 1)
    return state, {
        "avg_pseudo_loss": stats["loss_sum"] / n,
        "avg_confidence": stats["conf_sum"] / n,
        "used_batches": stats["used_batches"],
        "used_samples": stats["used_samples"],
        "skipped_small_batches": stats["skipped_small"],
    }
