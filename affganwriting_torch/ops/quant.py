"""Post-training w8a8 quantization of the serving path's hot convolutions.

Port of ``affganwriting_tpu/ops/quant.py`` (NHWC there, NCHW at this
module's functions).  The scheme is the JAX package's:

- weights: per-output-channel int8, ``sw[o] = max|w[o]| / 127``, BatchNorm
  folded into the conv first (running statistics);
- activations: per-tensor int8, with a static scale calibrated as
  ``max|x|`` over a representative batch, or a dynamic per-sample scale;
- int8 x int8 products accumulated in int32, then the epilogue
  ``acc.float() * ((amax / 127) * sw) + b`` in f32, in the JAX package's
  association, so that equal int8 inputs give bit-equal int32 sums and, on
  the CPU, equal epilogues.

The JAX package lowers each int8 conv with ``lax.conv`` to XLA.  Here it is
an int8 im2col of the padded NHWC tensor (``Tensor.unfold`` views, one
copy: ``F.unfold`` refuses int8) and ``torch._int_mm``, cuBLASLt's int8
GEMM with int32 accumulation on the card.  ``_int_mm`` wants more than 16
rows and K and N multiples of 8; the im2col's K (ordered (kh, kw, C), the
JAX HWIO kernel's order) and the output channels are padded with zeros
where they are not, which leaves every sum as it is.  No int8 conv runs
as a float conv on dequantized values: sums of int8 products reach
127^2 * 4608 ~ 7.4e7, past f32's exact integers.  The epilogue is plain
PyTorch (XLA fuses it in the JAX package).  Pads and pools of int8
tensors are indexing and ``amax`` (exact: max commutes with the monotone
quantize), which every device takes for every dtype.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

_VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512)


def fold_bn(kernel, bias, scale, bn_bias, mean, var, eps: float = 1e-5):
    """Fold inference BatchNorm into the preceding conv (kernel (O, I, kh,
    kw)): ``s = scale / sqrt(var + eps)`` taken in f64 and rounded to f32,
    kernel * s per output channel, bias ``(b - mean) * s + bn_bias``."""
    s = (scale.double() / torch.sqrt(var.double() + eps)).float()
    return kernel * s[:, None, None, None], (bias - mean) * s + bn_bias


def quantize_weight(w: torch.Tensor):
    """(O, ...) f32 kernel -> (int8 kernel, per-output-channel scale (O,))."""
    amax = w.abs().amax(dim=tuple(range(1, w.dim())))
    sw = amax.clamp_min(1e-12) / 127.0
    shape = (-1,) + (1,) * (w.dim() - 1)
    wq = torch.clamp(torch.round(w / sw.view(shape)), -127, 127)
    return wq.to(torch.int8), sw.float()


def quantize_act(x: torch.Tensor, amax) -> torch.Tensor:
    """Per-tensor symmetric int8 with a static (calibrated) ``amax``."""
    scale = 127.0 / torch.as_tensor(amax, dtype=torch.float32,
                                    device=x.device).clamp_min(1e-12)
    return torch.clamp(torch.round(x.float() * scale), -127, 127) \
        .to(torch.int8)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def reflect_pad_nhwc(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect pad of H and W of an NHWC tensor of any dtype by gathering
    rows and columns (``jnp.pad(mode="reflect")``; a 1-pixel axis repeats,
    as ``jnp.pad`` does)."""
    def index(n):
        i = torch.arange(-pad, n + pad, device=x.device).abs()
        i = torch.where(i >= n, 2 * (n - 1) - i, i)
        return i.clamp(0, n - 1)

    return x.index_select(1, index(x.shape[1])).index_select(
        2, index(x.shape[2]))


def zero_pad_nhwc(x: torch.Tensor, pad: int) -> torch.Tensor:
    b, h, w, c = x.shape
    out = x.new_zeros((b, h + 2 * pad, w + 2 * pad, c))
    out[:, pad:pad + h, pad:pad + w] = x
    return out


def int8_matrix(w_q: torch.Tensor) -> torch.Tensor:
    """(O, I, kh, kw) int8 kernel -> the (K, N) operand of ``_int_mm``, K =
    kh * kw * I ordered (kh, kw, I) and both padded to multiples of 8, laid
    out column-major (the transpose of a contiguous (N, K))."""
    o = w_q.shape[0]
    m = w_q.permute(0, 2, 3, 1).reshape(o, -1)
    k = m.shape[1]
    if k % 8 or o % 8:
        m = F.pad(m, (0, _round_up(k, 8) - k, 0, _round_up(o, 8) - o))
    return m.t()


def int8_conv_acc(x_q: torch.Tensor, w_q: torch.Tensor,
                  stride=(1, 1)) -> torch.Tensor:
    """int32 accumulators of a VALID int8 conv: x_q (B, H, W, I) int8 NHWC,
    already padded; w_q (O, I, kh, kw) int8 -> (B, Ho, Wo, O) int32."""
    o, _, kh, kw = w_q.shape
    sh, sw = stride
    b = x_q.shape[0]
    # (B, Ho, Wo, I, kh, kw) views -> rows (B*Ho*Wo, kh*kw*I), one copy
    cols = x_q.unfold(1, kh, sh).unfold(2, kw, sw)
    ho, wo = cols.shape[1], cols.shape[2]
    cols = cols.permute(0, 1, 2, 4, 5, 3).reshape(b * ho * wo, -1)
    m, k = cols.shape
    if k % 8 or m <= 16:
        cols = F.pad(cols, (0, _round_up(k, 8) - k, 0, max(0, 17 - m)))
    acc = torch._int_mm(cols, int8_matrix(w_q))
    return acc[:m, :o].reshape(b, ho, wo, o)


def _nchw(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 3, 1, 2)


def int8_conv(x_q, w_q, sx, sw, bias, *, padding="SAME", strides=(1, 1),
              out_dtype=torch.bfloat16):
    """int8 conv + the dequant/bias epilogue: x_q (B, I, H, W) int8, w_q
    (O, I, kh, kw) int8, ``sx`` the scalar activation scale (amax / 127),
    ``sw`` (O,) the weight scales, ``bias`` (O,) f32 -> (B, O, Ho, Wo) in
    ``out_dtype``.  ``padding`` "SAME" (odd kernels: (k - 1) / 2 zeros a
    side, stride 1) or "VALID"."""
    x = x_q.permute(0, 2, 3, 1)
    if padding == "SAME":
        x = zero_pad_nhwc(x, (w_q.shape[2] - 1) // 2)
    acc = int8_conv_acc(x, w_q, strides)
    y = acc.float() * (sx * sw) + bias
    return _nchw(y.to(out_dtype))


def _weight_quant_conv(xq, w, amax, bias, padding, strides, out_dtype):
    """The conv of codes xq (B, H, W, I) at scale ``amax`` / 127 (a scalar
    or per sample (B, 1, 1, 1)) with f32 w (O, I, kh, kw) quantized in the
    call, and the epilogue ``acc * ((amax / 127) * sw) + bias``."""
    if padding == "SAME":
        xq = zero_pad_nhwc(xq, (w.shape[2] - 1) // 2)
    wq, sw = quantize_weight(w.float())
    y = int8_conv_acc(xq, wq, strides).float() * ((amax / 127.0) * sw)
    if bias is not None:
        y = y + bias
    return _nchw(y.to(out_dtype))


def dyn_int8_conv(x, w, bias=None, *, padding="VALID", strides=(1, 1),
                  out_dtype=torch.bfloat16):
    """int8 conv with dynamic per-sample activation scales (``max|x|`` of
    each sample, no clipping); the weight quantized in the call.  x (B, I,
    H, W), w (O, I, kh, kw) f32 -> (B, O, Ho, Wo) in ``out_dtype``."""
    x32 = x.float().permute(0, 2, 3, 1)
    amax = x32.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-12)
    return _weight_quant_conv(quantize_act(x32, amax), w, amax, bias,
                              padding, strides, out_dtype)


def static_int8_conv(x, w, amax, bias=None, *, padding="VALID",
                     strides=(1, 1), out_dtype=torch.bfloat16, pad: int = 0,
                     pad_type: str = "reflect"):
    """int8 conv with a static (calibrated) per-tensor ``amax``: x (B, I,
    H, W), w (O, I, kh, kw) f32 -> (B, O, Ho, Wo) in ``out_dtype``.  ``pad``
    reflect-pads the int8 tensor after the quantize (reflect padding
    commutes with an elementwise quantize), so the pad moves int8; the
    decoder's sites pad no other way."""
    if pad and pad_type != "reflect":
        raise ValueError(f"int8 pad type {pad_type!r} is not supported")
    amax = torch.as_tensor(amax, dtype=torch.float32,
                           device=x.device).clamp_min(1e-12)
    xq = quantize_act(x, amax).permute(0, 2, 3, 1)
    if pad:
        xq = reflect_pad_nhwc(xq, pad)
    return _weight_quant_conv(xq, w, amax, bias, padding, strides, out_dtype)


def _vgg_layers(rec) -> list[dict[str, torch.Tensor]]:
    """The recognizer's VGG trunk (``rec.enc.vgg``: ``conv{i}``, ``bn{i}``)
    as folded f32 (w (O, I, 3, 3), b (O,)) pairs."""
    vgg = rec.enc.vgg
    out, i = [], 0
    while hasattr(vgg, f"conv{i}"):
        conv, bn = getattr(vgg, f"conv{i}"), getattr(vgg, f"bn{i}")
        w, b = fold_bn(conv.weight.float(), conv.bias.float(), bn.weight,
                       bn.bias, bn.running_mean, bn.running_var, bn.eps)
        out.append({"w": w, "b": b.float()})
        i += 1
    return out


def nn_max_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride 2 VALID max pool of an NHWC tensor of any dtype."""
    b, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def folded_vgg_apply(folded, img: torch.Tensor, dtype=torch.bfloat16):
    """The trunk with BatchNorm folded, in ``dtype``: the int8 path's float
    reference and its calibration forward.  img (B, 1 or 3, H, W) ->
    (features (B, 512, H/16, W/16), the f32 ``max|x|`` of each conv's
    input)."""
    if img.shape[1] == 1:
        img = img.expand(-1, 3, -1, -1)
    x = img.to(dtype)
    amaxes, ci = [], 0
    for v in _VGG19_CFG:
        if v == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        amaxes.append(x.float().abs().amax())
        layer = folded[ci]
        y = F.conv2d(x, layer["w"].to(dtype), padding=1)
        x = torch.relu(y + layer["b"].to(dtype).view(1, -1, 1, 1)).to(dtype)
        ci += 1
    return x, amaxes


@torch.no_grad()
def prepare_vgg_quant(rec, calib_images: torch.Tensor) -> dict[str, Any]:
    """Fold R's BatchNorms, quantize the weights per channel and calibrate
    each conv's input ``amax`` on ``calib_images`` (B, 1, H, W), e.g. one
    batch of generated words, through the bf16 folded trunk.  Layer 0 also
    gets the grayscale fold ``wq_gray``/``sw_gray``:
    ``conv(concat(x, x, x), w) == conv(x, sum_c w_c)``."""
    folded = _vgg_layers(rec)
    _, amaxes = folded_vgg_apply(folded, calib_images)
    layers = []
    for i, (layer, amax) in enumerate(zip(folded, amaxes)):
        wq, sw = quantize_weight(layer["w"])
        entry = {"wq": wq, "sw": sw, "b": layer["b"],
                 "amax": amax.float().clamp_min(1e-6)}
        if i == 0:
            entry["wq_gray"], entry["sw_gray"] = quantize_weight(
                layer["w"].sum(dim=1, keepdim=True))
        layers.append(entry)
    return {"layers": layers}


def qparams_to(q: dict, device) -> dict:
    """``prepare_vgg_quant``'s dict with every tensor on ``device``."""
    return {"layers": [{k: v.to(device) for k, v in layer.items()}
                       for layer in q["layers"]]}


def vgg_quant_layer(layer: dict, x_q: torch.Tensor, gray: bool,
                    next_amax=None) -> torch.Tensor:
    """One conv of the int8 trunk: x_q (B, H, W, I) int8 NHWC -> its int8
    codes at ``next_amax`` (the next conv's scale, quantized inside this
    epilogue), or the f32 ReLU output (B, H, W, O) without it."""
    wq = layer["wq_gray"] if gray else layer["wq"]
    sw = layer["sw_gray"] if gray else layer["sw"]
    acc = int8_conv_acc(zero_pad_nhwc(x_q, 1), wq)
    y = torch.relu(acc.float() * ((layer["amax"] / 127.0) * sw)
                   + layer["b"])
    return y if next_amax is None else quantize_act(y, next_amax)


def vgg_quant_apply(q: dict, img: torch.Tensor, dtype=torch.bfloat16):
    """The int8 trunk: img (B, 1 or 3, H, W) -> (B, 512, H/16, W/16) in
    ``dtype``.  Every tensor between two layers is int8 (each epilogue
    quantizes with the next conv's scale; the pools run on int8), and a
    grayscale input goes through layer 0's grayscale fold, with no
    3-channel copy."""
    layers = q["layers"]
    gray = img.shape[1] == 1
    if gray and "wq_gray" not in layers[0]:
        img, gray = img.expand(-1, 3, -1, -1), False
    x = quantize_act(img, layers[0]["amax"]).permute(0, 2, 3, 1)
    ci, n = 0, len(layers)
    for v in _VGG19_CFG:
        if v == "M":
            x = nn_max_pool(x)
            continue
        nxt = layers[ci + 1]["amax"] if ci + 1 < n else None
        x = vgg_quant_layer(layers[ci], x, gray and ci == 0, nxt)
        ci += 1
    return _nchw(x.to(dtype))     # the last layer's f32 output
