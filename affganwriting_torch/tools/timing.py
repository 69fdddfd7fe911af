"""Device timing with CUDA events."""

from __future__ import annotations

import statistics

import torch


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
