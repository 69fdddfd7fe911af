"""The four-player train step of the word GAN: R -> C -> D -> G.

Port of ``affganwriting_tpu/train/step.py:make_phased_train_step``.  Each
phase sees the parameters the earlier phases wrote: R learns to read the
real channel-0 word, C to name its writer, D to tell the real channel-0 and
channel-1 words from G's two fakes, and G, against the D, C and R just
updated, to make fakes that D scores real, C assigns to the writer and R
reads as the target words.

G generates a pair per step: the style stack is encoded once and two words
are decoded from it (``generate_pair``).  Its forward runs in train mode and
moves G's running statistics: the style encoder's once, the text encoder's
and decoder's twice, in sequence.  In the G phase R runs in train mode
(batch statistics, dropout) with its running statistics left alone: they
move only in R's own phase.  G's gradient comes from
``torch.autograd.grad`` over G's parameters alone, so D, C and R collect no
``.grad``; R's greedy ``argmax`` feedback is the only cut in the graph, as
in the JAX package.

Two forms (``merge_dg``):

* merged (the ``core/config.py`` default): one G pair forward with grad; D
  updates on its detached fakes, then G's loss runs against the updated D
  and back-propagates through the saved pair graph;
* 4-phase: D's phase re-runs G without grad, with its statistic updates
  discarded, and G's phase runs the pair forward again with grad.

Both give the same update.  The JAX package's ``make_train_step``, the whole
update as one XLA program, exists for XLA's sake (one program to jit or
shard); in eager PyTorch it is the 4-phase form, ``make_train_step``.

On a mesh (``parallel/mesh.py``; the state placed by ``shard_state``)
each rank runs the step on its slice of the batch and the step computes
what the single-process step computes on the whole batch, as GSPMD's one
global program does:

* each rank's loss is its part of the global loss.  R's loss is
  sum-reduced over the rows, so a rank's part is its own sum; the
  adversarial, BCE, writer cross-entropy and L1 terms are means, so a
  rank's part is its local mean over the data size (local sum over the
  global count).  Averaging the ranks' gradients, as DDP does, would
  weigh the sum term wrongly;
* each player's gradients are summed over the 'data' group in one
  coalesced all-reduce before its optimizer step (DDP's hooks do not fit
  the phases: frozen players, several forwards before one backward), and
  so are the reported metrics; on a 'model' axis the replicated
  parameters' gradients are then averaged over the model group
  (``sync_grads``);
* train-mode BatchNorms take the global batch's statistics
  (``models/blocks.BatchNorm``), and every dropout mask is the global
  batch's, drawn from the same-seeded generator on every rank
  (``parallel/ops.batch_shard``);
* on a 'model' axis the TP-ruled layers gather their outputs or sum their
  partial products over the model group (``Linear``, ``SplitMix``).

Under a running ``torch.profiler`` the step is the span ``train.step``
(``utils/profiling.span``) over ``step.to_device`` and, for each phase
``rec``, ``cla``, ``dis`` and ``gen``, ``step.<phase>.fwd`` (the forward
and the loss; G's pair forward is ``step.gen.fwd``, the 4-phase step's
no-grad fakes ``step.dis.fwd``), ``.bwd`` (the backward), ``.opt`` (the
optimizer step) and, on a mesh, ``.allreduce`` (``sync_grads``).
"""

from __future__ import annotations

from collections.abc import Callable, Mapping

import torch

from affganwriting_torch.core.config import WordGanConfig
from affganwriting_torch.gen.inference import resolve_device
from affganwriting_torch.models.blocks import frozen_stats
from affganwriting_torch.parallel.ops import (
    batch_shard,
    reduce_grads,
    reduce_tensors,
    reduce_values,
)
from affganwriting_torch.train import losses
from affganwriting_torch.train.state import WordGanState
from affganwriting_torch.utils.profiling import span


def to_device_batch(batch: Mapping, dev: torch.device) -> dict:
    """A batch in the JAX package's layouts -> tensors on ``dev``: the style
    stack stays (B, H, W, 50) for ``Generator.encode_style``; its channels 0
    and 1 and ``img_xt`` become (B, 1, H, W); labels and writer ids long."""
    style = torch.as_tensor(batch["style_imgs"], dtype=torch.float32,
                            device=dev)
    out = {"style": style,
           "img_ch0": style[..., 0:1].permute(0, 3, 1, 2).contiguous(),
           "img_ch1": style[..., 1:2].permute(0, 3, 1, 2).contiguous()}
    for k in ("label_ch0", "label_xt", "label_xt_swap", "writer_ids"):
        if k in batch:
            out[k] = torch.as_tensor(batch[k], device=dev).long()
    if "img_xt" in batch:
        out["img_xt"] = torch.as_tensor(
            batch["img_xt"], dtype=torch.float32, device=dev).permute(0, 3, 1, 2)
    return out


def generate_pair(gen, style, label_xt, label_xt_swap):
    """Encode the style stack once and decode both target words."""
    pyramid = gen.encode_style(style)
    return gen.generate(pyramid, label_xt), gen.generate(pyramid,
                                                         label_xt_swap)


def sync_grads(params, mesh) -> None:
    """The gradients of ``params`` for the optimizer step on ``mesh``:
    summed over the 'data' group (each rank's loss is its part of the
    global loss); a replicated parameter's is then averaged over the
    'model' group.  The model ranks compute it redundantly, but not bit
    for bit alike on the card (cuDNN's weight gradients and the embedding
    backward accumulate with atomics), and replicas that step apart drift
    apart."""
    if mesh is None:
        return
    params = list(params)
    if mesh.data > 1:
        reduce_grads(params, mesh.data_group)
    if mesh.model > 1:
        rep = [p.grad for p in params
               if p.grad is not None and not hasattr(p, "tp_dim")]
        reduce_tensors(rep, mesh.group("model"))
        for g in rep:
            g.div_(mesh.model)


def _update(opt: torch.optim.Optimizer, loss: torch.Tensor, mesh,
            phase: str) -> None:
    """Back-propagate this rank's part of the loss, bring the gradients
    together over ``mesh`` (``sync_grads``) and step, in ``phase``'s
    spans."""
    with span(f"step.{phase}.bwd"):
        opt.zero_grad(set_to_none=True)
        loss.backward()
    with span(f"step.{phase}.allreduce", mesh is not None):
        sync_grads((p for g in opt.param_groups for p in g["params"]), mesh)
    with span(f"step.{phase}.opt"):
        opt.step()


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.detach().permute(0, 2, 3, 1)


def make_phased_train_step(config: WordGanConfig, merge_dg: bool = False, *,
                           device=None, mesh=None):
    """Returns ``step(state, batch, generator, on_phase=None) -> (state,
    metrics, extras)``.  ``state`` (``train/state.py``) is updated in place
    and returned; ``batch`` holds ``style_imgs`` (B, H, W, 50),
    ``label_ch0``, ``label_xt``, ``label_xt_swap`` (B, T), ``writer_ids``
    (B,) and, unless ``config.oov``, ``img_xt`` (B, H, W, 1); dropout
    masks come from ``generator``, a ``torch.Generator`` on the device.
    ``on_phase(name)`` is called after each phase ("rec", "cla", then
    "dis_gen" merged or "dis" and "gen").  The metrics and extras are the
    JAX step's, as detached tensors; ``extras["xg"]`` is (B, H, W, 1).
    Runs on the card unless ``device="cpu"``.

    With ``mesh`` the step runs on the mesh's device, ``batch`` is this
    rank's slice (``parallel/mesh.shard_batch``), the metrics are the
    global batch's, on every rank, and the extras this rank's rows."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    ls = config.label_smoothing
    n_data = 1 if mesh is None else mesh.data
    group = None if n_data == 1 else mesh.data_group

    def share(mean_loss):
        """A mean over this rank's rows -> its part of the global mean."""
        return mean_loss / n_data if n_data > 1 else mean_loss

    def phase_rec(state, b, rng):
        with span("step.rec.fwd"):
            rec = state.rec.model.train()
            if state.rec.opt is None:   # frozen: forward only; stats move
                with torch.no_grad():
                    logits, _ = rec(b["img_ch0"], b["label_ch0"], rng)
                    return losses.rec_loss(logits, b["label_ch0"], ls), logits
            logits, _ = rec(b["img_ch0"], b["label_ch0"], rng)
            loss = losses.rec_loss(logits, b["label_ch0"], ls)
        _update(state.rec.opt, loss, mesh, "rec")
        return loss.detach(), logits.detach()

    def phase_cla(state, b):
        with span("step.cla.fwd"):
            cla = state.cla.model.train()
            loss = share(losses.writer_ce_loss(cla(b["img_ch0"]),
                                               b["writer_ids"]))
        _update(state.cla.opt, loss, mesh, "cla")
        return loss.detach()

    def phase_dis(state, b, xg, xg_swap):
        """D's update on detached fakes, the batch as [ch0, ch1, xg,
        xg_swap]."""
        n = xg.shape[0]
        with span("step.dis.fwd"):
            quad = torch.cat([b["img_ch0"], b["img_ch1"], xg.detach(),
                              xg_swap.detach()])
            s = state.dis.model.train()(quad)
            loss = share(0.5 * (losses.dis_real_loss(s[:n])
                                + losses.dis_real_loss(s[n:2 * n]))
                         + 0.5 * (losses.dis_fake_loss(s[2 * n:3 * n])
                                  + losses.dis_fake_loss(s[3 * n:])))
        _update(state.dis.opt, loss, mesh, "dis")
        return loss.detach()

    def phase_gen(state, b, xg, xg_swap, rng):
        """G's update against the current D, C and R, back through the
        graph of ``xg`` and ``xg_swap``."""
        n = xg.shape[0]
        with span("step.gen.fwd"):
            dis, cla, rec = (state.dis.model, state.cla.model,
                             state.rec.model.train())
            both = torch.cat([xg, xg_swap])
            d_s = dis(both)
            l_dis = share(0.5 * (losses.gen_adv_loss(d_s[:n])
                                 + losses.gen_adv_loss(d_s[n:])))
            c_s = cla(both)
            l_cla = share(0.5 * (
                losses.writer_ce_loss(c_s[:n], b["writer_ids"])
                + losses.writer_ce_loss(c_s[n:], b["writer_ids"])))
            if config.oov:
                l_l1 = torch.zeros((), device=dev)
            else:
                l_l1 = share(losses.recon_l1(xg, b["img_xt"]))
            with frozen_stats(rec):
                logits_xt, _ = rec(xg, b["label_xt"], rng)
                logits_swap, _ = rec(xg_swap, b["label_xt_swap"], rng)
            l_rec = 0.5 * (
                losses.rec_loss(logits_xt, b["label_xt"], ls)
                + losses.rec_loss(logits_swap, b["label_xt_swap"], ls))
            total = (config.w_dis * l_dis + config.w_cla * l_cla
                     + config.w_l1 * l_l1 + config.w_rec * l_rec)
        params = list(state.gen.model.parameters())
        with span("step.gen.bwd"):
            grads = torch.autograd.grad(total, params, allow_unused=True)
            # the style taps the decoder does not read get no gradient:
            # zero, as jax.grad gives
            for p, g in zip(params, grads):
                p.grad = torch.zeros_like(p) if g is None else g
        with span("step.gen.allreduce", mesh is not None):
            sync_grads(params, mesh)
        with span("step.gen.opt"):
            state.gen.opt.step()
            state.gen.opt.zero_grad(set_to_none=True)
        aux = {"l_dis": l_dis, "l_cla": l_cla, "l_l1": l_l1, "l_rec": l_rec,
               "l_total": total}
        return ({k: v.detach() for k, v in aux.items()},
                logits_xt.detach(), logits_swap.detach())

    def step(state: WordGanState, batch: Mapping, generator: torch.Generator,
             on_phase: Callable[[str], None] | None = None):
        with span("train.step"):
            if mesh is None:
                return run(state, batch, generator, on_phase)
            with batch_shard(mesh.data_rank, n_data):
                state, metrics, extras = run(state, batch, generator,
                                             on_phase)
            return state, reduce_values(metrics, group), extras

    def run(state, batch, generator, on_phase):
        mark = on_phase or (lambda name: None)
        with span("step.to_device"):
            b = to_device_batch(batch, dev)
        l_rec_tr, rec_logits_tr = phase_rec(state, b, generator)
        mark("rec")
        l_cla_tr = phase_cla(state, b)
        mark("cla")
        gen = state.gen.model.train()
        pair = (b["style"], b["label_xt"], b["label_xt_swap"])
        if merge_dg:
            with span("step.gen.fwd"):
                xg, xg_swap = generate_pair(gen, *pair)
            l_dis_tr = phase_dis(state, b, xg, xg_swap)
        else:
            with span("step.dis.fwd"), torch.no_grad(), frozen_stats(gen):
                fakes = generate_pair(gen, *pair)
            l_dis_tr = phase_dis(state, b, *fakes)
            mark("dis")
            with span("step.gen.fwd"):
                xg, xg_swap = generate_pair(gen, *pair)
        aux, logits_xt, logits_swap = phase_gen(state, b, xg, xg_swap,
                                                generator)
        mark("dis_gen" if merge_dg else "gen")
        state.step += 1
        metrics = {"l_rec_tr": l_rec_tr, "l_cla_tr": l_cla_tr,
                   "l_dis_tr": l_dis_tr, **aux}
        extras = {"rec_logits_tr": rec_logits_tr, "logits_xt": logits_xt,
                  "logits_swap": logits_swap, "xg": to_nhwc(xg)}
        return state, metrics, extras

    return step


def make_train_step(config: WordGanConfig, *, device=None, mesh=None):
    """The JAX package's one-program step.  It exists there for XLA, which
    needs a single program to jit or shard; eager PyTorch has no such
    need, so here it is the 4-phase form of ``make_phased_train_step``."""
    return make_phased_train_step(config, merge_dg=False, device=device,
                                  mesh=mesh)
