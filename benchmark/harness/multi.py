"""Cells on several cards: one process a card, joined over NCCL on a
data mesh (``parallel/mesh.make_mesh(chips, 1)``).

``launch`` starts the ranks and waits for every one; rank 0's standard
output and error are the run's, the other ranks' errors go to
``build/ranks/`` and are shown when a rank fails.  ``join`` sets a rank
up; ``gather`` brings each rank's set-up, peak and traced readings to
rank 0.
"""

from __future__ import annotations

import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
RANK_TIMEOUT_S = 1500


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(args, chips: int) -> int:
    port = _free_port()
    logs = ROOT / "build" / "ranks"
    logs.mkdir(parents=True, exist_ok=True)
    procs, files = [], []
    for r in range(chips):
        cmd = [sys.executable, str(ROOT / "benchmark" / "run.py"),
               "--workload", args.workload, "--seed", str(args.seed),
               "--seconds", str(args.seconds), "--trace", str(args.trace),
               "--rank", str(r), "--port", str(port)]
        if r == 0:
            procs.append(subprocess.Popen(cmd))
        else:
            f = open(logs / f"rank{r}.err", "w")
            files.append(f)
            procs.append(subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                          stderr=f))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    rcs = [None] * chips
    try:
        while None in rcs and time.monotonic() < deadline:
            for i, p in enumerate(procs):
                if rcs[i] is None:
                    rcs[i] = p.poll()
            if any(rc not in (None, 0) for rc in rcs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for i, p in enumerate(procs):
            rcs[i] = p.wait()
        for f in files:
            f.close()
    for r in range(1, chips):
        if rcs[r] != 0:
            print(f"rank {r} exited {rcs[r]}:\n"
                  + (logs / f"rank{r}.err").read_text()[-4000:],
                  file=sys.stderr)
    return rcs[0] if rcs[0] != 0 else max(rcs, key=abs)


def join(args, chips: int):
    import torch.distributed as dist

    from affganwriting_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(args.rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{args.port}",
                            world_size=chips, rank=args.rank)
    return make_mesh(chips, 1)


def gather(res: dict, mesh) -> dict:
    """Rank 0's result with the set-up and peak of the slowest and
    fullest rank, and the traced busy and window seconds of every rank."""
    import torch.distributed as dist

    tr = res.get("ctx", {}).get("trace")
    mine = {"setup_s": res["e2e"]["setup_s"], "peak": res["peak"],
            "busy_s": tr.busy_s if tr else None,
            "window_s": tr.window_s if tr else None}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    res["e2e"]["setup_s"] = max(e["setup_s"] for e in every)
    res["peak"] = max(e["peak"] for e in every)
    if tr is not None:
        res["ctx"]["busy_each"] = [e["busy_s"] for e in every]
        res["ctx"]["window_each"] = [e["window_s"] for e in every]
    return res


def leave():
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
