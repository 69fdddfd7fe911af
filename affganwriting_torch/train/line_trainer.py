"""Line-GAN training runtime: lesson steps, loss balancing, style bank.

The port of ``affganwriting_tpu/train/line_trainer.py`` (the reference's
line_generation/trainer/hw_with_style_trainer.py and base/base_trainer.py):
lesson steps that the curriculum picks on the host,

  * ``auto``: extract the style, regenerate on the DTW-spaced label,
    fg-masked pixel L1 + the frozen AE's perceptual distance;
  * ``auto-gen``: the same, plus hinge G on the reconstruction, balanced
    into the recon gradient together with the deferred gradients of the
    preceding ``no-step gen`` lesson;
  * ``count``: the spacer's MSE against DTW-derived blank/duplicate counts;
  * ``gen``: hinge G + CTC of the frozen HWR on a line generated from a
    bank style (``no-step``: the gradients are kept for the next
    ``auto-gen`` instead of applied);
  * ``disc``: hinge D on real lines against generated ones;
  * ``valid``: the recon and count losses without an update.

State: ``LineState`` holds the modules themselves (``model``, the
``HWWithStyle`` with the frozen HWR and its BatchNorm statistics; ``disc``,
whose spectral-norm ``u``/``sigma`` buffers are the JAX ``disc_stats``;
``ae``, the frozen perceptual autoencoder), both optimizers and ``step``.
The main tree is every parameter of ``model`` outside ``hwr``.  A step
updates the state in place and returns it, as the JAX steps return theirs.

Randomness: one ``torch.Generator`` on the device, seeded from ``seed``
(the JAX trainer's key), draws the spacer's dropout, the spacing noise,
the generator's noise and D's dropout.  ``train_dropout = False`` turns
every dropout off (the JAX tests' deterministic mode).  Within one step,
the losses that the JAX step evaluates twice on one key (auto-gen's recon,
gen's image) are evaluated once and differentiated twice, and D's two
passes in ``disc`` share their dropout masks, as the JAX passes share
their key.

Kept from the JAX trainer as they are (``ADVICE.md``): only ``auto-gen``
consumes the stash of no-step gradients; the stash does not survive a
restart; the deferral runs with ``balance_loss=False`` too.

The trainer runs on the card unless it is built with ``device="cpu"``.

On a mesh (``mesh=``, data-parallel only: no parameter of the line stack
matches a tensor-parallel rule, so a model axis >1 is refused, as the JAX
``shard_state`` refuses it) every rank is handed the same global batch and
runs each lesson on its slice, under ``train/step.py``'s rules: each
rank's loss is its part of the global loss (the hinge, CTC, L1 and
perceptual means over the data size; the count MSE over the global
mask's count), the gradients are summed over the 'data' group before
anything reads them (``balance_combine`` weighs leaves by their mean
magnitude, which is not linear in the ranks' parts), and every random
draw is the global batch's.  Each rank aligns its own lines on the host
(DTW; the labels trimmed at the global batch's longest, as the band width
depends on it); the style bank holds the global batch's styles and draws
the global batch's samples on every rank.  The metrics are the global
batch's, on every rank.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import sys
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from affganwriting_torch.core.checkpoint import load_swapped
from affganwriting_torch.gen.inference import resolve_device
from affganwriting_torch.models.line.autoencoder import Autoencoder
from affganwriting_torch.models.line.container import HWWithStyle
from affganwriting_torch.models.line.discriminator import DiscriminatorAP
from affganwriting_torch.ops.dtw import correct_pred
from affganwriting_torch.parallel.mesh import shard_batch, shard_state
from affganwriting_torch.parallel.ops import (
    batch_shard,
    gather_rows,
    reduce_sum,
    reduce_tensors,
    reduce_values,
)
from affganwriting_torch.train.curriculum import Curriculum
from affganwriting_torch.train.schedules import PartitionedAdam

def splice_pretrained_hwr(path: str, hwr: torch.nn.Module) -> None:
    """Load a ``cli/train_hwr.py`` checkpoint (``{"params",
    "batch_stats"}`` of the standalone recognizer, ``hwr_final``) into the
    container's ``hwr`` in place (the reference's hw_with_style.py:182-194:
    ``model.pretrained_hwr`` loaded into the frozen recognizer).  Names
    and shapes must match: the same arch, norm and n_class as the
    pretrainer."""
    saved = load_swapped(os.path.abspath(path))
    hwr.load_state_dict({**saved["params"], **saved.get("batch_stats", {})},
                        strict=True)


def splice_pretrained_ae(path: str, ae: torch.nn.Module) -> None:
    """Load a ``cli/train_auto.py`` checkpoint (``{"params"}`` of the
    trained autoencoder, ``ae_final``) into the frozen AE ``ae`` in place
    (the reference's hw_with_style_trainer.py:139-149: the AutoTrainer
    snapshot's weights, frozen; the perceptual distance runs in that
    feature space, :735-758).  The 'newCTC' pretrain carries an E_HWR head
    the GAN never applies: only the parameter groups (top-level modules)
    of ``ae`` are taken.  A missing group or a shape that differs raises
    ``ValueError``."""
    saved = load_swapped(os.path.abspath(path))["params"]
    init = ae.state_dict()
    groups = dict.fromkeys(k.split(".")[0] for k in init)
    have = {k.split(".")[0] for k in saved}
    missing = [g for g in groups if g not in have]
    if missing:
        raise ValueError(
            f"pretrained AE at {path} lacks param groups {missing}; "
            "was it trained with a different --variant?")
    for k, v in init.items():
        got = tuple(saved[k].shape) if k in saved else None
        if got != tuple(v.shape):
            raise ValueError(f"pretrained AE shape {got} != init "
                             f"{tuple(v.shape)} ({k})")
    ae.load_state_dict({k: saved[k].to(v.dtype) for k, v in init.items()},
                       strict=True)


@dataclasses.dataclass
class LineState:
    step: int
    model: HWWithStyle        # main tree + frozen HWR (+ its BN statistics)
    disc: DiscriminatorAP     # params + spectral-norm u/sigma
    ae: Autoencoder           # frozen perceptual AE
    main_opt: PartitionedAdam
    disc_opt: torch.optim.Adam

    def main_params(self) -> dict[str, torch.nn.Parameter]:
        return main_params(self.model)


def main_params(model: HWWithStyle) -> dict[str, torch.nn.Parameter]:
    """The main tree: every parameter outside the frozen HWR."""
    return {n: p for n, p in model.named_parameters()
            if not n.startswith("hwr.")}


def hinge_d_real(scores):
    return torch.relu(1.0 - scores.float()).mean()


def hinge_d_fake(scores):
    return torch.relu(1.0 + scores.float()).mean()


def hinge_g(scores):
    return -scores.float().mean()


def balance_combine(base_grads: dict, saved: list) -> dict:
    """Per-parameter gradient balancing (arXiv 1903.00277; the reference's
    hw_with_style_trainer.py:309-386): for each saved gradient R (a dict
    like ``base_grads``) with multiplier x and each leaf i, add ``x * R_i *
    (mean|D_i| / mean|R_i|)`` to the base gradient D.  A zero-mean D leaf
    takes the mean of the nonzero leaves' means; a zero-mean R leaf adds
    nothing.  Leaves are the port's parameters, one per flax leaf
    (``utils/from_flax.line_state_from_flax`` asserts it)."""
    names = list(base_grads)
    d_means = [base_grads[n].abs().mean() for n in names]
    total = torch.stack(d_means).sum()
    count = torch.stack([(m > 0).float() for m in d_means]).sum()
    nonzero = total / torch.clamp_min(count, 1.0)
    d_means = [torch.where(m == 0.0, nonzero, m) for m in d_means]
    out = dict(base_grads)
    for grads, mult in saved:
        for n, dm in zip(names, d_means):
            r = grads[n]
            rm = r.abs().mean()
            scale = torch.where(rm > 0, dm / torch.clamp_min(rm, 1e-30),
                                torch.zeros_like(rm))
            out[n] = out[n] + mult * r * scale
    return out


def ctc_loss(log_probs, labels, label_lengths):
    """log_probs (B, T, K), blank 0; labels (B, N) padded by length: the
    mean of the per-line losses, an infinite one (a label too long for T)
    counting as 0 (the reference's model/loss.py:28-30)."""
    b, t, _ = log_probs.shape
    per = F.ctc_loss(log_probs.float().transpose(0, 1), labels.long(),
                     torch.full((b,), t, dtype=torch.long,
                                device=log_probs.device),
                     label_lengths.long(), blank=0, reduction="none",
                     zero_infinity=True)
    return per.mean()


class StyleBank:
    """Last-N styles with interpolated (extrapolated) sampling
    (hw_with_style_trainer.py:113-128, 984-998; 'extra-0.5')."""

    def __init__(self, size: int = 100, extra: float = 0.5, seed: int = 0):
        self.size = size
        self.extra = extra
        self.bank: list[np.ndarray] = []
        self.rng = np.random.default_rng(seed)

    def add(self, styles: np.ndarray):
        for s in np.asarray(styles):
            self.bank.append(s)
        self.bank = self.bank[-self.size:]

    def sample(self, n: int) -> Optional[np.ndarray]:
        if len(self.bank) < 2:
            return None
        out = []
        for _ in range(n):
            i, j = self.rng.integers(len(self.bank), size=2)
            u = self.rng.uniform(-self.extra, 1.0 + self.extra)
            out.append(self.bank[i] + u * (self.bank[j] - self.bank[i]))
        return np.stack(out).astype(np.float32)


def _zeros_like(params: dict) -> dict:
    return {n: torch.zeros_like(p) for n, p in params.items()}


def _fill(grads, params: dict) -> dict:
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), grads)}


def _clip(grads: dict) -> dict:
    # grad value clip 2 (trainer:390)
    return {n: g.clamp(-2.0, 2.0) for n, g in grads.items()}


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


class LineGanTrainer:
    def __init__(self, n_class: int = 80, style_dim: int = 128,
                 max_gen_length: int = 128, lr: float = 2e-4,
                 curriculum: Optional[Curriculum] = None, seed: int = 0,
                 balance_loss: bool = True, hwr_norm: str = "batch",
                 lr_schedule: str | bool = "none", iterations: int = 240_000,
                 slow_param_names: tuple = (), freeze_param_names: tuple = (),
                 schedule_kw: Optional[dict] = None,
                 pretrained_hwr: str | None = None,
                 pretrained_ae: str | None = None,
                 char_style_dim: int = 0, device=None, mesh=None):
        self.device = mesh.device if mesh is not None else resolve_device(
            device)
        self.mesh = mesh
        self.n_data = 1 if mesh is None else mesh.data
        self.group = None if self.n_data == 1 else mesh.data_group
        # the constructor config, embedded in checkpoints so that
        # generation and the app rebuild the model from a checkpoint alone
        self.config_dict = dict(
            n_class=n_class, style_dim=style_dim,
            max_gen_length=max_gen_length, lr=lr, seed=seed,
            balance_loss=balance_loss, hwr_norm=hwr_norm,
            lr_schedule=lr_schedule, iterations=iterations,
            slow_param_names=list(slow_param_names),
            freeze_param_names=list(freeze_param_names),
            schedule_kw=dict(schedule_kw or {}),
            pretrained_hwr=pretrained_hwr, pretrained_ae=pretrained_ae,
            char_style_dim=char_style_dim)
        # the modules init_state copies onto the device, their weights
        # drawn from ``seed`` (torch's initializers and the modules' own)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = HWWithStyle(
                n_class=n_class, style_dim=style_dim,
                max_gen_length=max_gen_length, hwr_norm=hwr_norm,
                char_style_dim=char_style_dim)
            self.disc = DiscriminatorAP(dim=64, use_low=True, use_med=True)
            self.ae = Autoencoder()
        # the reference's pretrained, frozen recognizer and perceptual AE
        # (model.pretrained_hwr, trainer.encoder_weights): read by
        # init_state, so a restore reads them again before the checkpoint
        self.pretrained_hwr = pretrained_hwr
        self.pretrained_ae = pretrained_ae
        self.curriculum = curriculum or Curriculum()
        self.style_bank = StyleBank(seed=seed)
        self.balance_loss = balance_loss
        # iteration-scheduled balance multipliers, indexed by the stash
        # order within a curriculum cycle (hw_with_style_trainer.py:310-346,
        # 378-386): the no-step gen lesson's CTC, its hinge G, auto-gen's
        # recon-adversarial slot
        self.balance_var_x: dict[int, tuple] = {0: (0.6, 0.5, 0.4, 0.75)}
        self._saved_grads: tuple | None = None
        self.n_class = n_class
        self.max_gen_length = max_gen_length
        self.lr = lr
        self._opt_cfg = dict(
            base_lr=lr, iterations=iterations, schedule=lr_schedule,
            slow_patterns=tuple(slow_param_names),
            freeze_patterns=tuple(freeze_param_names),
            **(schedule_kw or {}))
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.train_dropout = True
        self._spaced_cache: dict = {}

    # ----- init -----
    def init_state(self, sample_batch: dict | None = None) -> LineState:
        """A fresh state: copies of ``model``, ``disc`` and ``ae`` on the
        device, the pretrained HWR and AE spliced in where the trainer was
        given their files, Adam over the main tree (schedule and
        slow/frozen groups) and over D.  ``sample_batch`` is not needed
        (the JAX trainer takes it for shapes)."""
        from affganwriting_torch.utils.from_flax import flax_paths

        dev = self.device
        model = copy.deepcopy(self.model).to(dev).eval()
        if self.pretrained_hwr:
            splice_pretrained_hwr(self.pretrained_hwr, model.hwr)
        disc = copy.deepcopy(self.disc).to(dev).eval()
        ae = copy.deepcopy(self.ae).to(dev).eval().requires_grad_(False)
        if self.pretrained_ae:
            splice_pretrained_ae(self.pretrained_ae, ae)
        model.hwr.requires_grad_(False)
        params = main_params(model)
        main_opt = PartitionedAdam(params, flax_paths(model, params),
                                   **self._opt_cfg)
        disc_opt = torch.optim.Adam(disc.parameters(), lr=self.lr,
                                    betas=(0.5, 0.999), eps=1e-8)
        state = LineState(step=0, model=model, disc=disc, ae=ae,
                          main_opt=main_opt, disc_opt=disc_opt)
        if self.mesh is not None:
            shard_state(self.mesh, state)
        return state

    # ----- helpers -----
    def _put(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _put_image(self, x) -> torch.Tensor:
        """NHWC numpy -> NCHW f32 on the device."""
        return self._put(x, torch.float32).permute(0, 3, 1, 2).contiguous()

    def _put_batch(self, batch: dict):
        return (self._put_image(batch["image"]),
                self._put(batch["label"], torch.long),
                self._put(batch["label_lengths"], torch.long))

    def _fg(self, batch: dict, image: torch.Tensor) -> torch.Tensor:
        fg = batch.get("fg_mask")
        return (self._put_image(fg) if fg is not None
                else torch.ones_like(image))

    def _spaced_onehot(self, spaced: np.ndarray) -> torch.Tensor:
        """Pad/crop the spaced label to the generator's static length, as
        a one-hot (B, max_gen_length, n_class) on the device."""
        t = self.max_gen_length
        sp = np.zeros((spaced.shape[0], t), spaced.dtype)
        sp[:, : min(t, spaced.shape[1])] = spaced[:, :t]
        return F.one_hot(self._put(sp, torch.long), self.n_class).float()

    @torch.no_grad()
    def recognize(self, state: LineState, image) -> np.ndarray:
        """Frozen-HWR log-probs (B, T, K) on the host, for DTW alignment;
        ``image`` NHWC numpy."""
        return state.model.recognize(self._put_image(image)).float().cpu() \
            .numpy()

    def spaced_label(self, state: LineState, batch: dict,
                     label_len: int | None = None) -> np.ndarray:
        """DTW-aligned spaced label (B, T) via the frozen recognizer, cached
        by the image bytes' hash (the HWR is frozen, so a line's alignment
        never changes; author_hw_dataset.py:251-282).  The labels are
        trimmed at ``label_len`` (default: the batch's longest), which sets
        the DTW band."""
        imgs = np.asarray(batch["image"])
        keys = [hash(imgs[i].tobytes()) for i in range(imgs.shape[0])]
        cache = self._spaced_cache
        if any(k not in cache for k in keys):
            logp = self.recognize(state, imgs)             # (B, T, K)
            pred = np.exp(logp).transpose(1, 0, 2)         # (T, B, K)
            label_tb = np.asarray(batch["label"]).T
            if label_len is None:
                label_len = int(np.max(np.asarray(batch["label_lengths"])))
            label_tb = label_tb[: max(1, label_len)]
            spaced = correct_pred(pred, label_tb).T        # (B, T)
            for i, k in enumerate(keys):
                cache[k] = spaced[i]
            if len(cache) > 4096:   # bound the cache
                for k in list(cache)[:1024]:
                    del cache[k]
        t = max(cache[k].shape[0] for k in keys)
        out = np.zeros((imgs.shape[0], t), np.int32)
        for i, k in enumerate(keys):
            row = cache[k]
            out[i, : row.shape[0]] = row
        return out

    # ----- losses -----
    def _gen_forward(self, state, label, lengths, style, gen):
        state.model.spacer.train(self.train_dropout)
        try:
            return state.model(label, lengths, style, generator=gen)
        finally:
            state.model.spacer.eval()

    def _share(self, mean: torch.Tensor) -> torch.Tensor:
        """A mean over this rank's rows -> its part of the global mean."""
        return mean / self.n_data if self.n_data > 1 else mean

    def _heads_g(self, state, img) -> torch.Tensor:
        heads = state.disc(img)          # eval: no dropout, no stats update
        return self._share(sum(hinge_g(h) for h in heads) / len(heads))

    def recon_losses(self, state, image, label, lengths, spaced_onehot, gen,
                     fg_mask):
        """Autoencode losses (trainer:542-621, 735-758): fg-masked pixel L1
        + frozen-AE perceptual distance on the DTW-spaced reconstruction,
        both cropped to the narrower width."""
        model, ae = state.model, state.ae
        style, _ = model.extract_style(image)
        recon, _, _ = model(label, lengths, style, spaced_onehot,
                            generator=gen)
        w = min(recon.shape[3], image.shape[3])
        m = fg_mask[..., :w].float()
        l1 = ((recon[..., :w].float() - image[..., :w].float()) * m).abs() \
            .mean()
        fr = ae.encode(image[..., :w].float())
        ff = ae.encode(recon[..., :w].float())
        perc = sum((a.float() - b.float()).abs().mean()
                   for a, b in zip(fr, ff)) / len(fr)
        l1, perc = self._share(l1), self._share(perc)
        return l1 + perc, (l1, perc, style, recon)

    def count_mse(self, state, image, label, lengths, gt_counts, gen):
        """Spacer MSE vs DTW-derived counts (trainer:626-729)."""
        model = state.model
        style, _ = model.extract_style(image)
        onehot = F.one_hot(label.long(), self.n_class).float()
        s = style if model.char_style_dim == 0 else \
            model._unpack_style(style)[0]
        model.spacer.train(self.train_dropout)
        try:
            counts = model.spacer(onehot, s, gen)
        finally:
            model.spacer.eval()
        mask = (torch.arange(label.shape[1], device=label.device)[None, :]
                < lengths[:, None]).float()
        # over the global batch's count of characters
        return (mask[..., None] * (counts - gt_counts) ** 2).sum() \
            / torch.clamp_min(reduce_sum(mask.sum(), self.group) * 2, 1.0)

    def _grads(self, loss, params: dict, retain: bool = False) -> dict:
        """The gradient of this rank's part of ``loss``, summed over the
        data group: the global loss's."""
        grads = _fill(torch.autograd.grad(loss, list(params.values()),
                                          allow_unused=True,
                                          retain_graph=retain), params)
        reduce_tensors(grads.values(), self.group)
        return grads

    # ----- lesson steps -----
    def auto_step(self, state, image, label, lengths, spaced_onehot, gen,
                  fg_mask):
        """Autoencode lesson: recon on the DTW-spaced label; the pixel L1
        weighted by the Otsu fg mask (all ones when the batch has none)."""
        params = state.main_params()
        loss, (l1, perc, style, _) = self.recon_losses(
            state, image, label, lengths, spaced_onehot, gen, fg_mask)
        state.main_opt.step(self._grads(loss, params))
        state.step += 1
        return state, {"auto": loss.detach(), "auto_l1": l1.detach(),
                       "auto_perceptual": perc.detach()}, style.detach()

    def auto_gen_step(self, state, image, label, lengths, spaced_onehot, gen,
                      mults, saved_ctc, saved_adv, fg_mask):
        """The 'auto-gen' lesson: recon gradients, plus hinge G on the
        reconstruction balanced in as slot 2, and the preceding no-step gen
        lesson's deferred CTC and hinge-G gradients as slots 0 and 1
        (hw_with_style_trainer.py:288-293, 309-386, 792, 818-831); zeros
        when none is pending (a no-op)."""
        params = state.main_params()
        loss, (l1, perc, style, recon) = self.recon_losses(
            state, image, label, lengths, spaced_onehot, gen, fg_mask)
        l_adv = self._heads_g(state, recon)
        g_base = self._grads(loss, params, retain=True)
        g_adv = self._grads(l_adv, params)
        grads = balance_combine(g_base, [(saved_ctc, mults[0]),
                                         (saved_adv, mults[1]),
                                         (g_adv, mults[2])])
        state.main_opt.step(_clip(grads))
        state.step += 1
        return state, {"auto": loss.detach(), "auto_l1": l1.detach(),
                       "auto_perceptual": perc.detach(),
                       "auto_gen_adv": l_adv.detach()}, style.detach()

    def count_step(self, state, image, label, lengths, gt_counts, gen):
        params = state.main_params()
        loss = self.count_mse(state, image, label, lengths, gt_counts, gen)
        state.main_opt.step(self._grads(loss, params))
        state.step += 1
        return state, {"count": loss.detach()}

    def _gen_losses(self, state, label, lengths, style, gen):
        """(hinge G, CTC of the frozen HWR, image) of one generated batch;
        the HWR reads in eval mode."""
        img, _, _ = self._gen_forward(state, label, lengths, style, gen)
        l_adv = self._heads_g(state, img)
        l_ctc = self._share(ctc_loss(state.model.recognize(img), label,
                                     lengths))
        return l_adv, l_ctc, img

    def gen_step(self, state, label, lengths, style, gen, ctc_mult):
        """The stepping gen lesson: hinge G + CTC, the CTC gradient
        balanced into the adversarial one as slot 0 (balance_var_x[0])."""
        params = state.main_params()
        l_adv, l_ctc, img = self._gen_losses(state, label, lengths, style,
                                             gen)
        g_adv = self._grads(l_adv, params, retain=True)
        g_ctc = self._grads(l_ctc, params)
        if self.balance_loss:
            grads = balance_combine(g_adv, [(g_ctc, ctc_mult)])
        else:
            grads = {n: g_adv[n] + g_ctc[n] for n in g_adv}
        state.main_opt.step(_clip(grads))
        state.step += 1
        return state, {"gen_adv": l_adv.detach(),
                       "gen_ctc": l_ctc.detach()}, img.detach()

    def gen_grads_step(self, state, label, lengths, style, gen):
        """The 'no-step' gen lesson: the hinge-G and CTC gradients, kept
        for the next ``auto_gen_step`` (hw_with_style_trainer.py:310-346,
        378-386).  Returns (metrics, g_ctc, g_adv, image); no update."""
        params = state.main_params()
        l_adv, l_ctc, img = self._gen_losses(state, label, lengths, style,
                                             gen)
        g_adv = self._grads(l_adv, params, retain=True)
        g_ctc = self._grads(l_ctc, params)
        return ({"gen_adv": l_adv.detach(), "gen_ctc": l_ctc.detach()},
                g_ctc, g_adv, img.detach())

    def disc_step(self, state, real, label, lengths, style, gen):
        """Hinge D on real vs generated lines.  Both passes start from the
        same spectral-norm state and draw the same dropout masks; the real
        pass's ``u``/``sigma`` are kept (the JAX step applies D twice from
        ``state.disc_stats`` and keeps the first pass's update)."""
        disc = state.disc
        with torch.no_grad():
            fake, _, _ = self._gen_forward(state, label, lengths, style, gen)
        w = min(real.shape[3], fake.shape[3])
        before = disc.sn_state()
        rng = gen.get_state()
        disc.train(self.train_dropout)
        try:
            heads_r = disc(real[..., :w], update_stats=True, generator=gen)
            after = disc.sn_state()
            disc.load_sn_state(before)
            gen.set_state(rng)
            heads_f = disc(fake[..., :w], update_stats=False, generator=gen)
        finally:
            disc.eval()
        l_real = sum(hinge_d_real(h) for h in heads_r) / len(heads_r)
        l_fake = sum(hinge_d_fake(h) for h in heads_f) / len(heads_f)
        loss = self._share(l_real + l_fake)
        params = list(disc.parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        reduce_tensors((p.grad for p in params), self.group)
        state.disc_opt.step()
        state.disc_opt.zero_grad(set_to_none=True)
        disc.load_sn_state(after)
        state.step += 1
        return state, {"disc": loss.detach()}

    @torch.no_grad()
    def valid_step(self, state, image, label, lengths, spaced_onehot, gen,
                   fg_mask, gt_counts):
        """The curriculum's valid lesson set without an update
        (base_trainer.py:278-311): the recon and the spacer count losses.
        ``gen`` seeds both, as the JAX step passes one key to both."""
        rng = gen.get_state()
        loss, (l1, perc, _, _) = self.recon_losses(
            state, image, label, lengths, spaced_onehot, gen, fg_mask)
        gen.set_state(rng)
        mse = self.count_mse(state, image, label, lengths, gt_counts, gen)
        return {"val_auto": loss, "val_auto_l1": l1,
                "val_auto_perceptual": perc, "val_count": mse}

    # ----- host-side count targets (trainer:626-729) -----
    def count_targets(self, spaced: np.ndarray, label: np.ndarray,
                      lengths: np.ndarray) -> np.ndarray:
        """Per-char (leading blanks, duplicates) from a spaced label."""
        b, t_lab = label.shape
        out = np.zeros((b, t_lab, 2), np.float32)
        for i in range(b):
            run = spaced[i]
            ci = 0
            blanks = 0
            x = 0
            while x < len(run) and ci < lengths[i]:
                if run[x] == 0:
                    blanks += 1
                    x += 1
                elif run[x] == label[i, ci]:
                    dup = 0
                    while x < len(run) and run[x] == label[i, ci]:
                        dup += 1
                        x += 1
                    out[i, ci] = (blanks, dup)
                    blanks = 0
                    ci += 1
                else:  # misalignment; skip
                    x += 1
        return out

    def _take_saved_grads(self, state: LineState):
        """Consume the pending no-step gen gradient pair; zeros (a
        ``balance_combine`` no-op) when none is pending, e.g. the first
        cycle after a resume."""
        saved, self._saved_grads = self._saved_grads, None
        if saved is None:
            z = _zeros_like(state.main_params())
            return z, z
        return saved

    def _mults(self, iteration: int) -> tuple:
        """Active balance multipliers: the last ``balance_var_x`` entry
        whose iteration threshold <= iteration (trainer:378-382)."""
        active = (1.0, 1.0, 1.0, 1.0)
        for start in sorted(self.balance_var_x):
            if start <= iteration:
                active = tuple(self.balance_var_x[start])
        return active

    @torch.no_grad()
    def _extract(self, state, image) -> np.ndarray:
        return state.model.extract_style(image)[0].float().cpu().numpy()

    def _global_rows(self, x: torch.Tensor) -> np.ndarray:
        """This rank's rows -> the global batch's, on the host."""
        if self.n_data > 1:
            x = gather_rows(x.detach(), self.group, self.mesh.data_rank,
                            self.n_data)
        return x.float().cpu().numpy()

    def _local_rows(self, x: np.ndarray) -> np.ndarray:
        """The global batch's rows -> this rank's."""
        if self.n_data == 1:
            return x
        k = x.shape[0] // self.n_data
        return x[self.mesh.data_rank * k:][:k]

    def _sharded(self, fn, batch: dict):
        """``fn(local batch, global label length)`` on this rank's slice
        of the global ``batch``, the draws the global batch's, the
        metrics it returns last summed over the data group."""
        label_len = int(np.max(np.asarray(batch["label_lengths"])))
        if self.mesh is None:
            return fn(batch, label_len)
        with batch_shard(self.mesh.data_rank, self.n_data):
            *out, metrics = fn(shard_batch(self.mesh, batch), label_len)
        return (*out, reduce_values(metrics, self.group))

    # ----- one training iteration -----
    def train_iteration(self, state: LineState, iteration: int,
                        batch: dict) -> tuple[LineState, dict]:
        """One lesson of the curriculum on ``batch`` (on a mesh: the global
        batch, the same on every rank)."""
        return self._sharded(
            lambda b, n: self._iteration(state, iteration, b, n), batch)

    def _iteration(self, state, iteration, batch, label_len):
        lesson = self.curriculum.get_lesson(iteration)
        metrics: dict = {}
        gen = self.generator
        image, label, lengths = self._put_batch(batch)

        if "count" in lesson:
            spaced = self.spaced_label(state, batch, label_len)
            gt = self.count_targets(
                spaced, np.asarray(batch["label"]),
                np.asarray(batch["label_lengths"]))
            state, m = self.count_step(state, image, label, lengths,
                                       self._put(gt), gen)
            metrics.update(m)
        if "auto" in lesson or "auto-gen" in lesson:
            spaced_onehot = self._spaced_onehot(
                self.spaced_label(state, batch, label_len))
            fg = self._fg(batch, image)
            if "auto-gen" in lesson:
                saved_ctc, saved_adv = self._take_saved_grads(state)
                state, m, style = self.auto_gen_step(
                    state, image, label, lengths, spaced_onehot, gen,
                    self._mults(iteration)[:3], saved_ctc, saved_adv, fg)
            else:
                state, m, style = self.auto_step(
                    state, image, label, lengths, spaced_onehot, gen, fg)
            metrics.update(m)
            self.style_bank.add(self._global_rows(style))
        if "gen" in lesson or "disc" in lesson:
            style = self.style_bank.sample(image.shape[0] * self.n_data)
            if style is None:
                style = self._global_rows(
                    self._put(self._extract(state, image)))
                self.style_bank.add(style)
            style = self._put(self._local_rows(style), torch.float32)
            if "gen" in lesson:
                if "no-step" in lesson:
                    # defer: the reference stashes this lesson's gradients
                    # (saved_grads, trainer:310-346) for the next auto step
                    m, g_ctc, g_adv, _ = self.gen_grads_step(
                        state, label, lengths, style, gen)
                    self._saved_grads = (g_ctc, g_adv)
                else:
                    state, m, _ = self.gen_step(
                        state, label, lengths, style, gen,
                        self._mults(iteration)[0])
                metrics.update(m)
            if "disc" in lesson:
                state, m = self.disc_step(state, image, label, lengths,
                                          style, gen)
                metrics.update(m)
        return state, metrics

    # ----- periodic training sheets (hw_with_style_trainer.py:1002-1032) --
    @torch.no_grad()
    def dump_sheet(self, state: LineState, batch: dict, out_dir: str,
                   iteration: int) -> str:
        """Write a [real | spaced-recon | bank-style gen] grid with the mean
        discriminator scores (the reference's ``print_images``)."""
        from affganwriting_torch.eval.sheets import write_line_sheet

        model, disc = state.model, state.disc
        image, label, lengths = self._put_batch(batch)
        spaced_onehot = self._spaced_onehot(self.spaced_label(state, batch))
        gen = torch.Generator(self.device).manual_seed(0)
        style = self.style_bank.sample(image.shape[0])
        style = (model.extract_style(image)[0] if style is None
                 else self._put(style, torch.float32))
        ex_style, _ = model.extract_style(image)
        recon, _, _ = model(label, lengths, ex_style, spaced_onehot,
                            generator=gen)
        fake, _, _ = model(label, lengths, style, generator=gen)

        def d_mean(x, w):
            heads = disc(x[..., :w])
            return float(sum(h.mean() for h in heads) / len(heads))

        w = min(image.shape[3], recon.shape[3])
        scores = {"real": d_mean(image, w), "recon": d_mean(recon, w),
                  "gen": d_mean(fake, fake.shape[3])}

        def host(x):
            return x.float().permute(0, 2, 3, 1).cpu().numpy()

        if self.mesh is not None and _rank() != 0:
            return None      # every rank draws the bank alike; rank 0 writes
        return write_line_sheet(
            out_dir, f"iter_{iteration}", host(image), host(recon),
            host(fake), texts=batch.get("texts"), disc_scores=scores)

    @classmethod
    def from_config(cls, config: dict, curriculum=None,
                    device=None, mesh=None) -> "LineGanTrainer":
        """Rebuild a trainer from a checkpoint's embedded config (the
        reference's generate.py:88-97, app.py:65-77)."""
        cfg = dict(config)
        cfg["slow_param_names"] = tuple(cfg.get("slow_param_names", ()))
        cfg["freeze_param_names"] = tuple(cfg.get("freeze_param_names", ()))
        return cls(curriculum=curriculum, device=device, mesh=mesh, **cfg)

    # ----- validation (base_trainer.py:278-311 `_valid_epoch`) -----
    def validate(self, state: LineState, batches: Iterator[dict],
                 max_batches: int | None = None) -> dict:
        """The curriculum's valid lesson set (recon + spacer count), no
        updates, averaged over batches.  Deterministic: every batch's
        randomness is seeded 0, so two validations of a state agree.  On
        a mesh the batches are global and the means the global batch's."""
        sums: dict[str, float] = {}
        n = 0
        def one(batch, label_len):
            spaced = self.spaced_label(state, batch, label_len)
            gt = self.count_targets(
                spaced, np.asarray(batch["label"]),
                np.asarray(batch["label_lengths"]))
            image, label, lengths = self._put_batch(batch)
            return (self.valid_step(
                state, image, label, lengths, self._spaced_onehot(spaced),
                torch.Generator(self.device).manual_seed(0),
                self._fg(batch, image), self._put(gt)),)

        for batch in batches:
            if max_batches is not None and n >= max_batches:
                break
            m, = self._sharded(one, batch)
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        if n == 0:
            # no monitor value: a 0.0 would be saved as an unbeatable best
            print("warning: validation yielded zero batches; skipping "
                  "val_monitor", file=sys.stderr)
            return {}
        out = {k: v / n for k, v in sums.items()}
        # the monitored scalar (lower is better): recon + count quality
        out["val_monitor"] = (out.get("val_auto_l1", 0.0)
                              + out.get("val_count", 0.0))
        return out

    def _validate_swa(self, state, batches, max_batches) -> dict:
        """``validate`` with the SWA average in place of the main tree."""
        params = state.main_params()
        kept = {n: p.detach().clone() for n, p in params.items()}
        try:
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(self.swa_state["avg"][n])
            return self.validate(state, batches, max_batches)
        finally:
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(kept[n])

    def fit(self, state: LineState, batches: Iterator[dict],
            iterations: int, log_every: int = 10,
            logger=None, ckpt=None,
            save_every: int = 2000, save_latest_every: int = 250,
            val_batches_fn=None, val_every: int = 0,
            val_max_batches: int = 4,
            swa_start: int | None = None, swa_state=None,
            start_iteration: int | None = None,
            sheet_every: int = 0, sheet_dir: str | None = None,
            restart_rss_gb: float = 48.0) -> LineState:
        """The BaseTrainer runtime (base_trainer.py:199-326): the iteration
        loop with latest/periodic/best checkpoints, periodic validation
        with monitor-best, SWA past ``swa_start`` (:180-186, 234-237), and
        SIGINT -> save and exit (train.py:75-78).

        ``ckpt`` is a ``LineCheckpointManager``; ``val_batches_fn()``
        returns a fresh iterable of validation batches.  Resume: pass the
        checkpoint's ``iteration`` as ``start_iteration``, so that the
        curriculum and schedule clock goes on where it stopped
        (``state.step`` under-counts).  The SWA average is
        ``self.swa_state`` after fit.  On a mesh ``batches`` are global,
        and rank 0's ``ckpt`` writes (the other ranks' are built with
        ``write=False``) and its ``logger`` logs."""
        import signal

        from affganwriting_torch.data.prefetch import prefetch
        from affganwriting_torch.train.swa import swa_init, swa_update
        from affganwriting_torch.utils.memwatch import maybe_restart

        it = int(state.step) if start_iteration is None else \
            int(start_iteration)
        if swa_state is not None and swa_start is None:
            # a restored active average keeps accumulating on resume
            swa_start = it
        self.swa_state = swa_state

        def _payload(s):
            return {"state": s, "swa": self._swa_payload(s),
                    "iteration": it}

        def _save_latest(s):
            if ckpt is not None:
                ckpt.save_latest(_payload(s), self.config_dict)

        def _sigint(signum, frame):
            if ckpt is not None:
                print("SIGINT: saving checkpoint before exit")
                _save_latest(state)
            raise KeyboardInterrupt

        prev = signal.signal(signal.SIGINT, _sigint)
        try:
            for batch in prefetch(batches):
                if it >= iterations:
                    break
                state, metrics = self.train_iteration(state, it, batch)
                it += 1
                if swa_start is not None and it >= swa_start:
                    if self.swa_state is None:
                        self.swa_state = swa_init(state.main_params())
                    self.swa_state = swa_update(self.swa_state,
                                                state.main_params())
                if logger is not None and it % log_every == 0:
                    logger.log(it, {k: float(v) for k, v in metrics.items()},
                               group="line_train")
                if sheet_every and sheet_dir and it % sheet_every == 0:
                    self.dump_sheet(state, batch, sheet_dir, it)
                if (val_every and val_batches_fn is not None
                        and it % val_every == 0):
                    val = self.validate(state, val_batches_fn(),
                                        max_batches=val_max_batches)
                    if self.swa_state is not None:
                        swa_val = self._validate_swa(
                            state, val_batches_fn(), val_max_batches)
                        val.update({f"swa_{k}": v
                                    for k, v in swa_val.items()})
                    if logger is not None:
                        logger.log(it, val, group="line_valid")
                    if ckpt is not None and "val_monitor" in val:
                        ckpt.maybe_save_best(_payload(state),
                                             self.config_dict,
                                             val["val_monitor"])
                if ckpt is not None:
                    if it % save_every == 0:
                        ckpt.save_step(_payload(state), self.config_dict, it)
                    # not elif: "latest" keeps its own cadence even when it
                    # collides with a periodic save
                    if it % save_latest_every == 0:
                        _save_latest(state)
                    if it % 50 == 0:
                        maybe_restart(restart_rss_gb,
                                      lambda: _save_latest(state),
                                      label="line-gan")
            _save_latest(state)
            if self.mesh is not None:
                import torch.distributed as dist

                dist.barrier()       # the other ranks may restore it next
        finally:
            signal.signal(signal.SIGINT, prev)
        return state

    def _swa_payload(self, state: LineState) -> dict:
        """The SWA slot: the running average when SWA is active, else a
        count-0 copy of the main tree (one structure either way)."""
        if getattr(self, "swa_state", None) is not None:
            return self.swa_state
        from affganwriting_torch.train.swa import swa_init

        return swa_init(state.main_params())
