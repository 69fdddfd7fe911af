"""Metrics logging: a JSONL stream, the console, and TensorBoard when it can
be imported.

The port's copy of ``affganwriting_tpu/utils/logging.py``: every scalar goes
to ``<logdir>/metrics.jsonl``, one JSON object per call with ``step``,
``time`` and ``group``, and to stderr as ``[<group> step <n>] k=v ...``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Mapping


def summary_writer(logdir: str):
    """A TensorBoard ``SummaryWriter`` under ``<logdir>/tb``, or None when
    TensorBoard cannot be imported."""
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(os.path.join(logdir, "tb"))
    except Exception:
        return None


class MetricsLogger:
    def __init__(self, logdir: str, also_console: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self.console = also_console
        self._tb = summary_writer(logdir)

    def log(self, step: int, scalars: Mapping[str, float],
            group: str = "train") -> None:
        rec = {"step": int(step), "time": time.time(), "group": group}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.console:
            msg = " ".join(f"{k}={float(v):.4f}" for k, v in scalars.items())
            print(f"[{group} step {step}] {msg}", file=sys.stderr)
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{group}/{k}", float(v), step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class NullLogger:
    """``MetricsLogger``'s interface writing nothing: the logger of a rank
    other than 0 on a mesh, where rank 0 writes for all."""

    def log(self, step: int, scalars: Mapping[str, float],
            group: str = "train") -> None:
        pass

    def close(self) -> None:
        pass
