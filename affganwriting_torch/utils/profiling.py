"""Tracing and numerical-debug switches.

The port of ``affganwriting_tpu/utils/profiling.py``:

  * ``span(name)``: a named range of the program's own layers.  With a
    ``torch.profiler`` running (``torch.autograd._profiler_enabled()``) it
    is ``torch.profiler.record_function(name)``, a ``user_annotation`` in
    the same Kineto trace as the CUDA kernels, on the same clock, with a
    ``gpu_user_annotation`` interval on the device row; with none it is
    one shared no-op context (about half a microsecond), so spans are on
    exactly when a profiler runs and there is no switch.  The tree:

      - ``serve.request`` (``gen/inference.py``, the bf16 and w8a8
        generate-and-read) > ``G`` (``generate_images``) > ``G.upload``,
        ``G.encode_style``, ``G.text_mix``, ``G.dec`` > ``G.dec.res``,
        ``G.dec.up``, ``G.dec.head``; then ``R`` > ``R.trunk``,
        ``R.bigru``, ``R.decode`` (the seq2seq R) or ``R.preprocess``,
        ``R.encode``, ``R.decode``, ``R.vocab`` (TrOCR,
        ``models/recognizer/trocr.py``); on the card ``G.encode_style`` >
        ``G.encode_style.replay`` and ``G.dec`` > ``G.dec.replay``
        (``utils/cuda_graphs.py``, the style encoder's and the decoder's
        graphs; the decoder's replay stands for ``G.dec.res``, ``.up`` and
        ``.head``): 12 a request (13 with TrOCR), and ``<name>.capture``
        beside a replay in a request that captures a new input signature,
        with the decoder's three inside it.  The spans inside the models open
        in eval mode only (``span(name, not self.training)``), where the
        serving path runs them;
      - ``train.step`` (``train/step.py``) > ``step.to_device``, then for
        each phase ``rec``, ``cla``, ``dis``, ``gen``:
        ``step.<phase>.fwd``, ``.bwd``, ``.opt`` and, on a mesh,
        ``.allreduce`` (around ``sync_grads``): at most 16 a step, 20 on
        a mesh;

  * ``trace(logdir)``: a context manager around ``torch.profiler`` (CPU
    and, with a card, CUDA activities) that writes the enclosed work's
    trace to ``logdir/trace.pt.trace.json``, a Chrome trace that
    TensorBoard's PyTorch profiler plugin, ``chrome://tracing`` and
    Perfetto read; it yields the profiler, whose ``key_averages()`` give
    the sums by kernel.  It is the way to see the spans: run the work
    inside it and open the file in Perfetto;
  * ``debug_numerics(True)``: ``torch.autograd.set_detect_anomaly``, the
    reference's anomaly flag (base_trainer.py:196-197) that the JAX
    package maps to jax_debug_nans/infs;
  * the stage profilers' measures (``cli/profile_pipeline.py``,
    ``cli/profile_gen.py``): ``stream_ms`` (calls dispatched back to back,
    one synchronize at the end), ``op_counts`` (FLOPs from
    ``torch.utils.flop_counter.FlopCounterMode``, bytes from
    ``ByteCounter``) and ``stage_row`` (their JSON line against the card's
    peaks, ``tools/timing.card_peaks``).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; its trace goes to
    ``logdir/trace.pt.trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.pt.trace.json"))


def debug_numerics(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


_NO_SPAN = contextlib.nullcontext()


def span(name: str, on: bool = True):
    """``record_function(name)`` while a ``torch.profiler`` runs and ``on``
    holds, else one shared no-op context."""
    if on and torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class ByteCounter(TorchDispatchMode):
    """Sums, over every aten op dispatched inside it, the bytes of its
    tensor operands and results (views move none and are skipped): each
    op reading its inputs once and writing its outputs once, with nothing
    fused.  The CUDA kernels the port launches through ``ctypes`` are not
    dispatched; ``op_counts`` adds what they report."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_flatten((args, kwargs, out))[0]
                              if isinstance(t, torch.Tensor))
        return out


def op_counts(fn, *args) -> dict:
    """{flops, bytes} of one ``fn(*args)``: ``FlopCounterMode``'s count
    (matmuls, convolutions, attention; backward too where ``fn`` runs it)
    and ``ByteCounter``'s, each plus what the port's CUDA kernels launched
    in it report (``ops/cuda_build.work_counter``): an upper bound on the
    bytes the work must move, fused only inside those kernels."""
    from torch.utils.flop_counter import FlopCounterMode

    from affganwriting_torch.ops.cuda_build import work_counter

    with FlopCounterMode(display=False) as flops, ByteCounter() as nbytes, \
            work_counter() as kernels:
        fn(*args)
    return {"flops": float(flops.get_total_flops()) + kernels["flops"],
            "bytes": float(nbytes.bytes) + kernels["bytes"]}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stream_ms(fn, args_a, args_b, n: int, device: torch.device) -> float:
    """ms a call, streaming: one warm call, then ``n`` calls alternating
    the two argument sets dispatched back to back, ended by one
    synchronize."""
    fn(*args_a)
    sync(device)
    t0 = time.perf_counter()
    for i in range(n):
        fn(*(args_a if i % 2 == 0 else args_b))
    sync(device)
    return 1e3 * (time.perf_counter() - t0) / n


def device_peaks(device: torch.device):
    """(the card's name and part, (bytes/s, bf16 FLOP/s, f32 FLOP/s)) of
    the H100 on ``device``, or (``"cpu"``, None): a CPU run has no device
    peaks, and its rows carry no MFU or bandwidth share."""
    if device.type != "cuda":
        return "cpu", None
    from affganwriting_torch.tools.timing import card_peaks

    name = torch.cuda.get_device_name(device)
    part, peaks = card_peaks(name)
    return f"{name} ({part} peaks)", peaks


def stage_row(stage: str, ms: float, counts: dict, peaks, **extra) -> dict:
    """The JAX profilers' JSON keys for one stage; ``mfu`` against the
    dense bf16 peak (``peaks[1]``, the stages' compute dtype) and
    ``hbm_frac`` against the memory rate, both None without peaks."""
    sec = ms / 1e3
    flops, nbytes = counts["flops"], counts["bytes"]
    return {"stage": stage, **extra,
            "ms_per_call": round(ms, 3),
            "gflops_per_call": round(flops / 1e9, 2),
            "achieved_tflops": round(flops / sec / 1e12, 2),
            "mfu": (None if peaks is None
                    else round(flops / sec / peaks[1], 4)),
            "gbytes_per_call": round(nbytes / 1e9, 3),
            "gbytes_is": "no-fusion upper bound",
            "hbm_frac": (None if peaks is None
                         else round(nbytes / sec / peaks[0], 4))}
