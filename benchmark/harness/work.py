"""The yardstick's arithmetic: the card's published peaks, and the work of
each hand-written kernel's operation counted from its shapes (each input
byte read once, each output byte written once), whatever the kernel itself
reads or writes.

Peaks: NVIDIA's H100 data sheet, dense rates, by the part the card's name
names (SXM otherwise), at the full power limit; the power limit the card
reports is printed beside every reading.
"""

from __future__ import annotations

import subprocess

CARD_PEAKS = {   # (memory bytes/s, dense bf16 FLOP/s)
    "PCIe": (2.0e12, 756e12),
    "NVL": (3.9e12, 835e12),
    "SXM": (3.35e12, 989e12),
}


def card_peaks(name: str) -> tuple[float, float]:
    for key in ("PCIe", "NVL"):
        if key in name:
            return CARD_PEAKS[key]
    return CARD_PEAKS["SXM"]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def decoder_shapes(cfg: dict, words: int) -> dict:
    """The shapes of the two kernels' operations in one generate call of
    ``words`` words: ``in_relu`` on the first two upsample stages' outputs
    (spatial layout), ``phase_head`` on the last stage's phase tensor."""
    h, w, d = cfg["img_height"] // 8, cfg["img_width"] // 8, cfg["style_dim"]
    return {"in_relu": [(words, d // 2, 2 * h, 2 * w),
                        (words, d // 4, 4 * h, 4 * w)],
            "phase_head": (words, d // 2, 4 * h, 4 * w)}


def in_relu_work(shape, itemsize: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) of relu(instance_norm(x)) of an (N, C, H, W) x:
    x read once, y written once; no matrix FLOPs."""
    n = 1
    for s in shape:
        n *= s
    return 0.0, 2.0 * n * itemsize


def phase_head_work(phase_shape, itemsize: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) of the 7x7 one-channel tanh head over the phase
    tensor (B, 4C, h, w), i.e. the (B, C, 2h, 2w) map: the unpadded phase
    tensor, the (1, C, 7, 7) weights and the bias read once, the
    (B, 1, 2h, 2w) image written once; 2 x 49 x C FLOPs an output pixel."""
    b, c4, h, w = phase_shape
    c, pixels = c4 // 4, b * 4 * h * w
    nbytes = (b * c4 * h * w + 49 * c + 1 + pixels) * itemsize
    return 2.0 * 49 * c * pixels, float(nbytes)


def roofline_share(flops: float, nbytes: float, seconds: float,
                   peaks: tuple[float, float]) -> float:
    """The least time the card needs (the larger of FLOPs at the bf16 peak
    and bytes at the memory rate) over the time taken, in %."""
    least = max(flops / peaks[1], nbytes / peaks[0])
    return 100.0 * least / seconds
