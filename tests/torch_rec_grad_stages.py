"""Where the JAX package's gradient of R's term leaves the port's.

On batch 1 of ``tests/test_torch_train_modules.py``'s R-term case, the JAX
package's gradient of ``l_rec`` with respect to the fakes lies 4.79e-3
(relative L2) from the port's f64 gradient, while the port's f32 gradient
lies 1e-5 from it.  This script takes R apart into its stages (the VGG
trunk, the BiGRU, the attention decoder's scan, ``rec_loss``) and gives each
package's stage the port's f64 input and cotangent (``jax.vjp`` on the JAX
side), then walks the trunk layer by layer and looks for ReLUs that the JAX
package's f32 forward puts on the other side of 0 than the f64 forward.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_rec_grad_stages.py

It prints, per stage, the JAX f32 and the port f32 input gradients against
the port's f64 one (relative L2, max abs), then each flipped ReLU, then the
port's f64 gradient with the JAX package's f32 ReLU masks against the JAX
package's gradient.  ``test_torch_train_modules.py::
test_r_term_gradient_gap_is_the_reference_trunk_relu_flips`` holds the
finding.
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from affganwriting_tpu.models.recognizer.encoder import _VGG19_CFG
from affganwriting_tpu.train import losses as jlosses
from affganwriting_torch.models import blocks
from affganwriting_torch.models.recognizer.seq2seq import Recognizer
from affganwriting_torch.train import losses
from test_torch_support import load_port, nchw, port_in_f64


def rel(a, b) -> tuple[float, float]:
    """(relative L2, max abs) of ``a`` against ``b``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (float(np.linalg.norm(a - b) / np.linalg.norm(b)),
            float(np.abs(a - b).max()))


def port_rec(jcfg, v) -> Recognizer:
    return load_port(Recognizer(jcfg.vocab_size, jcfg.rec_hidden,
                                jcfg.rec_embed, jcfg.output_max_len, 32,
                                torch.float32, dropout=0.0), v).train()


def port_trunk(rec, x3, masks=None):
    """The port's VGG trunk, with the ReLU after BatchNorm ``ci`` replaced
    by ``masks[ci]`` (NCHW bool) where given."""
    h, ci = x3, 0
    for width in _VGG19_CFG:
        if width == "M":
            h = torch.nn.functional.max_pool2d(h, 2, 2)
            continue
        y = getattr(rec.enc.vgg, f"bn{ci}")(getattr(rec.enc.vgg,
                                                    f"conv{ci}")(h))
        h = torch.relu(y) if masks is None else torch.where(
            masks[ci], y, torch.zeros_like(y))
        ci += 1
    return h


def port_f64(jcfg, v, img, lab, masks=None) -> dict:
    """The port's R in f64 on one batch (train mode, statistics frozen):
    each stage's input and output and the gradient of ``rec_loss`` at
    each, as numpy (NCHW for the trunk)."""
    rec = port_rec(jcfg, v)
    lab_t = torch.from_numpy(lab).long()
    with port_in_f64(rec), blocks.frozen_stats(rec):
        x = nchw(img).double().requires_grad_()
        feat = port_trunk(rec, x.expand(-1, 3, -1, -1), masks)
        b, c, h, w = feat.shape
        seq = feat.permute(0, 3, 2, 1).reshape(b, w, h * c)
        enc, h0 = rec.enc.rnn(seq)
        logits, _ = rec.decode(enc, h0, lab_t)
        ts = dict(feat=feat, seq=seq, enc=enc, h0=h0, logits=logits)
        for t in ts.values():
            t.retain_grad()
        losses.rec_loss(logits, lab_t, jcfg.label_smoothing).backward()
    out = {k: t.detach().numpy() for k, t in ts.items()}
    out.update({f"d_{k}": t.grad.numpy() for k, t in ts.items()})
    out["d_x"] = x.grad.numpy()
    return out


def jax_relu_masks(v, img) -> dict:
    """The JAX package's f32 trunk, layer by layer (eager): which ReLU
    outputs are positive, as NCHW bool tensors."""
    p = v["params"]["enc"]["vgg"]
    s = v["batch_stats"]["enc"]["vgg"]
    h, ci, masks = jnp.concatenate([jnp.asarray(img)] * 3, -1), 0, {}
    for width in _VGG19_CFG:
        if width == "M":
            h = fnn.max_pool(h, (2, 2), strides=(2, 2))
            continue
        h = fnn.Conv(width, (3, 3), padding=((1, 1), (1, 1)),
                     dtype=jnp.float32).apply({"params": p[f"conv{ci}"]}, h)
        h, _ = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                             epsilon=1e-5, dtype=jnp.float32).apply(
            {"params": p[f"bn{ci}"], "batch_stats": s[f"bn{ci}"]}, h,
            mutable=["batch_stats"])
        h = fnn.relu(h)
        masks[ci] = torch.from_numpy(
            np.asarray(h > 0).transpose(0, 3, 1, 2).copy())
        ci += 1
    return masks


def stage_readings(jcfg, jrec, v, img, lab) -> None:
    ref = port_f64(jcfg, v, img, lab)
    rec = port_rec(jcfg, v)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    t32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    lab_j, lab_t = jnp.asarray(lab), torch.from_numpy(lab).long()
    nhwc = lambda a: a.transpose(0, 2, 3, 1)  # noqa: E731

    def apply(fn, *args):
        return jrec.apply(v, *args, method=fn, mutable=["batch_stats"])[0]

    rows = {}
    g = jax.grad(lambda lg: jlosses.rec_loss(
        lg, lab_j, jcfg.label_smoothing))(f32(ref["logits"]))
    lg = t32(ref["logits"]).requires_grad_()
    (gp,) = torch.autograd.grad(losses.rec_loss(lg, lab_t,
                                                jcfg.label_smoothing), lg)
    rows["rec_loss: d/d logits"] = (g, gp, ref["d_logits"])
    _, vjp = jax.vjp(lambda e, h: apply(
        lambda m, e, h: m.decode(e, h, lab_j, train=True)[0], e, h),
        f32(ref["enc"]), f32(ref["h0"]))
    ge, gh = vjp(f32(ref["d_logits"]))
    e, h = (t32(ref[k]).requires_grad_() for k in ("enc", "h0"))
    with blocks.frozen_stats(rec):
        gpe, gph = torch.autograd.grad(rec.decode(e, h, lab_t)[0], (e, h),
                                       t32(ref["d_logits"]))
    rows["decoder scan: d/d enc_out"] = (ge, gpe, ref["d_enc"])
    rows["decoder scan: d/d h0"] = (gh, gph, ref["d_h0"])
    _, vjp = jax.vjp(lambda s: apply(
        lambda m, s: m.enc.rnn(s, train=True), s), f32(ref["seq"]))
    (gs,) = vjp((f32(ref["d_enc"]), f32(ref["d_h0"])))
    s = t32(ref["seq"]).requires_grad_()
    (gps,) = torch.autograd.grad(rec.enc.rnn(s), s, (t32(ref["d_enc"]),
                                                     t32(ref["d_h0"])))
    rows["BiGRU: d/d seq"] = (gs, gps, ref["d_seq"])
    _, vjp = jax.vjp(lambda x: apply(
        lambda m, x: m.enc.vgg(jnp.concatenate([x] * 3, -1), train=True),
        x), f32(img))
    (gx,) = vjp(f32(nhwc(ref["d_feat"])))
    x = nchw(img).requires_grad_()
    with blocks.frozen_stats(rec):
        (gpx,) = torch.autograd.grad(
            port_trunk(rec, x.expand(-1, 3, -1, -1)), x, t32(ref["d_feat"]))
    rows["VGG trunk: d/d image"] = (gx, nhwc(gpx.numpy()),
                                    nhwc(ref["d_x"]))
    for what, (gj, gport, want) in rows.items():
        print(f"  {what:28s} JAX f32 {rel(gj, want)}, port f32 "
              f"{rel(gport, want)}")


def flip_readings(jcfg, v, img, lab):
    """The ReLUs the JAX f32 forward flips, and the port's f64 gradient
    with those flips against the unflipped one; returns (masked, plain)
    d l / d image, NCHW."""
    masks = jax_relu_masks(v, img)
    plain = port_f64(jcfg, v, img, lab)
    masked = port_f64(jcfg, v, img, lab, masks)
    rec = port_rec(jcfg, v)
    with torch.no_grad(), port_in_f64(rec), blocks.frozen_stats(rec):
        h, ci = nchw(img).double().expand(-1, 3, -1, -1), 0
        for width in _VGG19_CFG:
            if width == "M":
                h = torch.nn.functional.max_pool2d(h, 2, 2)
                continue
            y = getattr(rec.enc.vgg, f"bn{ci}")(getattr(rec.enc.vgg,
                                                        f"conv{ci}")(h))
            for j in torch.nonzero(masks[ci] != (y > 0)).tolist():
                print(f"  ReLU after bn{ci}, (n, c, h, w) = {tuple(j)} of "
                      f"{tuple(y.shape)}: f64 input {float(y[tuple(j)]):.3g}"
                      f", the JAX f32 ReLU "
                      f"{'passes' if masks[ci][tuple(j)] else 'blocks'} it")
            h = torch.relu(y)
            ci += 1
    return masked["d_x"], plain["d_x"]


def main() -> None:
    import test_torch_train_modules as modules

    torch.set_num_threads(4)
    jcfg, jrec, v, fakes, labels = modules._rec_term_case()
    want = modules._jax_rec_term(jcfg, jrec, v, fakes, labels, jit=False)[2]
    for i in range(2):
        print(f"batch {i}: each stage from the port's f64 input and "
              "cotangent, against the port's f64 input gradient "
              "(relative L2, max abs)")
        stage_readings(jcfg, jrec, v, fakes[i], labels[i])
        masked, plain = flip_readings(jcfg, v, fakes[i], labels[i])
        # l_rec averages the two batches: its gradient is half of each's
        jg = want[i].transpose(0, 3, 1, 2)
        print(f"  whole R, JAX f32 (jit disabled) vs port f64: "
              f"{rel(jg, 0.5 * plain)}; vs port f64 with the JAX f32 ReLU "
              f"masks: {rel(jg, 0.5 * masked)}")


if __name__ == "__main__":
    main()
