"""Time each CUDA kernel beside its plain PyTorch version, one library call
that computes the same function, and the card's bound for the work:
``python -m affganwriting_torch.cli.bench_kernels [--batch 256] [--iters
20]``.

The port of ``affganwriting_tpu/cli/bench_kernels.py``, at the decoder's
shapes for 64x216 words, bf16: ``in_relu`` at (B, 256, 16, 54) and (B,
128, 32, 108) NCHW, ``phase_head`` at (B, 256, 36, 112) for B = ``--batch``
and 8.  Every time is ``tools/timing.py:cuda_ms`` (CUDA events, 20 calls a
pair, the median of ``--iters`` pairs; the JAX CLI's ``--iters`` is its
count of timed calls).  The default batch is 256, where the JAX CLI's is
1024: 256 is the serving request that ``PERF.md`` §6 times the kernels
at (one writer's 256 words), and the kernel rows there are at that batch.  The bound is the larger of the bytes the
function must move (each input read once, each output written once) over
the card's memory rate and its operations over the peak rate for their
type (``tools/timing.py:CARD_PEAKS``).  Prints one JSON line per shape;
these are the kernels' times that ``PERF.md`` §6 reports, and ``main``
returns them.  Needs the card.
"""

from __future__ import annotations

import argparse
import json


def kernel_times(peaks, batch: int = 256, log=print, iters: int = 20) -> dict:
    """{"in_relu": row summed over its two shapes (with ``stages``),
    "phase_head": row at ``batch`` (with ``batch8``)}; each row has
    ``ms``, ``plain_ms``, ``library_ms``, ``bound_ms``, ``bound_by``,
    ``bytes`` and ``ops``.  ``peaks`` is ``card_peaks(name)[1]``; each time
    is the median of ``iters`` event pairs."""
    import torch
    import torch.nn.functional as F

    from affganwriting_torch.models.blocks import depth_to_space
    from affganwriting_torch.ops.in_relu_cuda import in_relu, in_relu_plain
    from affganwriting_torch.ops.phase_head_cuda import (
        phase_head,
        phase_head_plain,
        strip_rows,
    )
    from affganwriting_torch.tools import timing

    def cuda_ms(fn):
        return timing.cuda_ms(fn, iters=iters)

    mem_rate, bf16_rate, f32_rate = peaks
    gen = torch.Generator(device="cuda").manual_seed(1)
    dt = torch.bfloat16
    out = {}
    row = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "bytes": 0, "ops": 0, "stages": []}
    for shape in ((batch, 256, 16, 54), (batch, 128, 32, 108)):
        x = torch.randn(shape, generator=gen, device="cuda").to(dt)
        n = x.numel()
        nbytes = 2 * n * x.element_size()
        ops = 6 * n          # sum, square-add, subtract, scale, relu
        bound = max(nbytes / mem_rate, ops / f32_rate) * 1e3
        stage = {
            "shape": list(shape),
            "ms": cuda_ms(lambda: in_relu(x)),
            "plain_ms": cuda_ms(lambda: in_relu_plain(x)),
            "library_ms": cuda_ms(lambda: torch.relu(F.instance_norm(x))),
            "bound_ms": bound,
        }
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            row[k] += stage[k]
        row["bytes"] += nbytes
        row["ops"] += ops
        row["stages"].append(stage)
        log(f"  in_relu {shape} bf16: kernel {stage['ms']:.4f} ms, plain "
            f"{stage['plain_ms']:.4f}, library {stage['library_ms']:.4f}, "
            f"bound {bound:.4f} (bytes)")
    row["bound_by"] = "bytes"
    out["in_relu"] = row
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def head_row(b):
        c4, hp, wp = 256, 36, 112
        h, w = hp - 4, wp - 4
        xp = torch.relu(torch.randn((b, c4, hp, wp), generator=gen,
                                    device="cuda")).to(dt)
        kc = (torch.randn((c4, 100), generator=gen, device="cuda")
              / (49 * 64) ** 0.5).to(dt)
        bias4 = torch.randn(4, generator=gen, device="cuda") * 0.1
        k4 = kc.view(c4, 25, 4).permute(2, 0, 1).reshape(4, c4, 5, 5) \
            .contiguous()
        bias_dt = bias4.to(dt)

        def library():
            y = torch.tanh(F.conv2d(xp, k4) + bias_dt.view(1, 4, 1, 1))
            return depth_to_space(y)

        nbytes = (xp.numel() + kc.numel() + b * 4 * h * w) \
            * xp.element_size() + bias4.numel() * 4
        ops = 2 * c4 * 100 * h * w * b
        t_bytes, t_ops = nbytes / mem_rate * 1e3, ops / bf16_rate * 1e3
        r = strip_rows(b, h, sms)
        head = {
            "ms": cuda_ms(lambda: phase_head(xp, kc, bias4)),
            "plain_ms": cuda_ms(lambda: phase_head_plain(xp, kc, bias4)),
            "library_ms": cuda_ms(library),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "shape": [b, c4, hp, wp],
            "strip_rows": r,
        }
        log(f"  phase_head {(b, c4, hp, wp)} bf16, R = {r}: kernel "
            f"{head['ms']:.4f} ms, plain {head['plain_ms']:.4f}, library "
            f"{head['library_ms']:.4f}, bound {head['bound_ms']:.4f} "
            f"({head['bound_by']}; bytes {t_bytes:.4f}, operations "
            f"{t_ops:.4f})")
        return head

    out["phase_head"] = head_row(batch)
    out["phase_head"]["batch8"] = head_row(8)
    return out


def json_lines(times: dict, device: str) -> list[dict]:
    """One record per timed shape of ``kernel_times``' result."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    lines = [{"kernel": "in_relu", "shape": s["shape"], "dtype": "bf16",
              **{k: s[k] for k in keys}, "bound_by": "bytes",
              "device": device} for s in times["in_relu"]["stages"]]
    for head in (times["phase_head"], times["phase_head"]["batch8"]):
        lines.append({"kernel": "phase_head", "shape": head["shape"],
                      "dtype": "bf16", **{k: head[k] for k in keys},
                      "bound_by": head["bound_by"], "device": device})
    return lines


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=20,
                   help="CUDA event pairs a time is the median of")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    if args.iters < 1:
        raise SystemExit("bench_kernels: --iters must be at least 1")

    from affganwriting_torch.gen.inference import resolve_device
    from affganwriting_torch.ops import cuda_build
    from affganwriting_torch.tools.timing import card_peaks, nvidia_smi_line

    resolve_device(None)
    import torch

    cuda_build.build()
    times = kernel_times(card_peaks(torch.cuda.get_device_name(0))[1],
                         args.batch, log=lambda msg: None,
                         iters=args.iters)
    lines = json_lines(times, nvidia_smi_line())
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
