"""The plain reference of the merged four-player train step, in float32.

R -> C -> D -> G as the port's merged step orders them: R learns to read
the real channel-0 word, C to name its writer, D to tell the real words
from G's two fakes (generated once, in train mode), and G, against the D,
C and R just updated, to make fakes D scores real, C assigns to the writer
and R reads as the target words.  Adam as ``torch.optim.Adam``'s defaults
(which are optax's), written out.  R's dropout masks are drawn from the
generator handed in, in the program's order and shapes; R's greedy feedback
reads the program's ids (``feeds``) so both follow one decoding path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.models import BatchNorm

PLAYERS = ("gen", "dis", "cla", "rec")
LRS = {"gen": "lr_gen", "dis": "lr_dis", "cla": "lr_cla", "rec": "lr_rec"}


def rec_loss(logits, labels, smoothing):
    """Label-smoothing KL, sum-reduced; PAD column and PAD rows zeroed."""
    v = logits.shape[-1]
    lg = logits.reshape(-1, v)
    tgt = labels[:, 1:].reshape(-1)
    n = lg.shape[0]
    dist = torch.full((n, v), smoothing / (v - 2), device=lg.device)
    dist[torch.arange(n, device=lg.device), tgt] = 1.0 - smoothing
    dist[:, 2] = 0.0
    dist[tgt == 2] = 0.0
    plogp = torch.where(dist > 0, dist * dist.clamp_min(1e-30).log(),
                        torch.zeros((), device=lg.device))
    return (plogp - dist * F.log_softmax(lg, dim=-1)).sum()


def bce(logits, target):
    return -(target * F.logsigmoid(logits)
             + (1 - target) * F.logsigmoid(-logits)).mean()


def writer_ce(logits, ids):
    return -F.log_softmax(logits, -1).gather(-1, ids[:, None]).mean()


class Adam:
    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps, self.t = lr, b1, b2, eps, 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            p.sub_(self.lr / c1 * m / (v.sqrt() / c2 ** 0.5 + self.eps))


def _grads(loss, params):
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, gs)]


def _frozen(model, flag):
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.frozen = flag


def make_opts(models, cfg):
    return {n: Adam(models[n].parameters(), cfg[LRS[n]]) for n in PLAYERS}


def step(models, opts, batch, gen, cfg, feeds):
    """One merged step in place.  ``batch``: tensors on the device (style
    (B, H, W, 50), img_ch0, img_ch1 (B, 1, H, W), labels, writer ids);
    ``feeds``: the program's greedy ids of R's three decodes, (B, steps)
    each.  Returns the step's losses, detached."""
    g_, d_, c_, r_ = (models[n] for n in ("gen", "dis", "cla", "rec"))
    ls = cfg["label_smoothing"]
    r_.train()
    logits = r_(batch["img_ch0"], batch["label_ch0"], gen, feeds[0])
    l_rec_tr = rec_loss(logits, batch["label_ch0"], ls)
    opts["rec"].step(_grads(l_rec_tr, opts["rec"].params))

    c_.train()
    l_cla_tr = writer_ce(c_(batch["img_ch0"]), batch["writer_ids"])
    opts["cla"].step(_grads(l_cla_tr, opts["cla"].params))

    g_.train()
    pyr = g_.encode_style(batch["style"])
    xg = g_.generate(pyr, batch["label_xt"])
    xs = g_.generate(pyr, batch["label_xt_swap"])
    n = xg.shape[0]
    s = d_(torch.cat([batch["img_ch0"], batch["img_ch1"], xg.detach(),
                      xs.detach()]))
    l_dis_tr = (0.5 * (bce(s[:n], 1.0) + bce(s[n:2 * n], 1.0))
                + 0.5 * (bce(s[2 * n:3 * n], 0.0) + bce(s[3 * n:], 0.0)))
    opts["dis"].step(_grads(l_dis_tr, opts["dis"].params))

    both = torch.cat([xg, xs])
    d_s = d_(both)
    l_dis = 0.5 * (bce(d_s[:n], 1.0) + bce(d_s[n:], 1.0))
    c_s = c_(both)
    l_cla = 0.5 * (writer_ce(c_s[:n], batch["writer_ids"])
                   + writer_ce(c_s[n:], batch["writer_ids"]))
    _frozen(r_, True)
    try:
        lx = r_(xg, batch["label_xt"], gen, feeds[1])
        lsw = r_(xs, batch["label_xt_swap"], gen, feeds[2])
    finally:
        _frozen(r_, False)
    l_rec = 0.5 * (rec_loss(lx, batch["label_xt"], ls)
                   + rec_loss(lsw, batch["label_xt_swap"], ls))
    total = cfg["w_dis"] * l_dis + cfg["w_cla"] * l_cla + cfg["w_rec"] * l_rec
    opts["gen"].step(_grads(total, opts["gen"].params))
    return {k: v.detach() for k, v in (
        ("l_rec_tr", l_rec_tr), ("l_cla_tr", l_cla_tr),
        ("l_dis_tr", l_dis_tr), ("l_total", total))}
