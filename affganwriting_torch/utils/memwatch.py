"""Host-RSS watchdog: save and re-exec before the host runs out of memory.

The port's copy of ``affganwriting_tpu/utils/memwatch.py``.  At a safe
boundary (the end of an epoch) the trainer calls ``maybe_restart``: once
the process's resident set passes the threshold it saves a latest
checkpoint and replaces the process with its own command line, which
resumes from that checkpoint in a fresh address space.
"""

from __future__ import annotations

import os
import sys


def rss_gb() -> float:
    """This process's resident set size in GiB (0.0 if unreadable)."""
    try:
        with open(f"/proc/{os.getpid()}/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / (1024 * 1024)
    except OSError:
        pass
    return 0.0


def maybe_restart(threshold_gb: float, save_fn, *, label: str = "") -> None:
    """If the RSS is at least ``threshold_gb``: run ``save_fn()`` (the
    checkpoint) and replace this process with its original command line.

    ``threshold_gb <= 0`` disables the watchdog.  The relaunch runs
    ``sys.orig_argv`` (the interpreter invocation, ``-m`` included) with
    the absolute interpreter, so a CLI restarts into its resume path;
    ``AFFG_RESTARTS`` counts the generations in the child's environment.
    """
    if threshold_gb <= 0:
        return
    used = rss_gb()
    if used < threshold_gb:
        return
    gen = int(os.environ.get("AFFG_RESTARTS", "0")) + 1
    print(f"memwatch{f' [{label}]' if label else ''}: host RSS "
          f"{used:.1f} GiB >= {threshold_gb:.1f} GiB: saving a checkpoint "
          f"and re-exec'ing to resume (restart #{gen})", flush=True)
    save_fn()
    os.environ["AFFG_RESTARTS"] = str(gen)
    argv = list(getattr(sys, "orig_argv", ())) or [sys.executable] + sys.argv
    os.execv(sys.executable, [sys.executable] + argv[1:])
