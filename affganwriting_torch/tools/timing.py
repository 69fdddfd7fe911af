"""Device timing with CUDA events, wall-clock timing ended by a
``torch.cuda.synchronize()``, and the card's identity and peak rates."""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

# (memory bytes/s, dense bf16 tensor FLOP/s, f32 FLOP/s outside the tensor
# cores) from NVIDIA's H100 data sheet, by the part the card's name names
CARD_PEAKS = {
    "PCIe": (2.0e12, 756e12, 51e12),
    "NVL": (3.9e12, 835e12, 60e12),
    "SXM": (3.35e12, 989e12, 67e12),
}


def card_peaks(name: str):
    """(part, (bytes/s, bf16 FLOP/s, f32 FLOP/s)) of the H100 part that
    ``name`` (``torch.cuda.get_device_name``) names; SXM otherwise."""
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, CARD_PEAKS[key]
    return "SXM", CARD_PEAKS["SXM"]


def nvidia_smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one ``fn()`` in ms: ``reps`` back-to-back calls
    between each event pair, the median over ``iters`` pairs, divided by
    ``reps``; after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def wall_ms(fn, iters: int = 20, warmup: int = 1) -> float:
    """Median wall-clock ms of one ``fn()`` over ``iters`` calls, each
    started and ended by ``torch.cuda.synchronize()``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)
