"""Process-group start-up and process-local batches.

Port of ``affganwriting_tpu/parallel/multihost.py``.  In the JAX package
one process may drive many devices, and ``global_batch`` stitches each
process's slice into one global array.  Here every device has its own
process (``python -m torch.distributed.run --nproc-per-node N``), so a
process's slice of the global batch is all it ever holds: ``global_batch``
places it, after checking that every data rank holds as many rows, and it
equals ``shard_batch`` of the global batch at this rank (the tests hold
that).

The backend is explicit: ``"nccl"`` for CUDA tensors, one card per rank;
``"gloo"`` for the CPU, or when the caller names it (gloo also carries the
all-reduces of ``parallel/ops.py`` for CUDA tensors, which lets two ranks
share one card).  Nothing switches backends quietly.
"""

from __future__ import annotations

import datetime
import os
from typing import Any

import torch

from affganwriting_torch.parallel.mesh import Mesh, _place, _tree_map

_LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def launched() -> bool:
    """True when torchrun's environment names this process's rank."""
    return all(k in os.environ for k in _LAUNCHER_ENV)


def init_distributed(backend: str | None = None, *, device=None,
                     init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None,
                     timeout_s: float = 600.0) -> bool:
    """Start this process's process group; a no-op returning False when
    nothing names a topology.

    The topology comes from ``init_method``/``rank``/``world_size`` when
    given (e.g. ``file://...`` in tests), else from torchrun's environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``).  ``backend`` defaults to ``"nccl"`` on the CUDA card
    and ``"gloo"`` on the CPU (``device="cpu"``); under NCCL rank
    ``LOCAL_RANK`` takes card ``LOCAL_RANK``, and more ranks than cards on
    a host raise.  Returns True when a process group is up (also at world
    size 1: a 1x1 mesh needs one)."""
    import torch.distributed as dist

    from affganwriting_torch.gen.inference import resolve_device

    dev = resolve_device(device)
    if dist.is_initialized():
        return True
    if init_method is None and not launched():
        return False
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        n_cards = torch.cuda.device_count()
        if local >= n_cards:
            raise RuntimeError(
                f"NCCL takes one card per rank: LOCAL_RANK {local} but "
                f"{n_cards} card(s) here; launch fewer ranks, or pass "
                "backend='gloo' to share a card")
        torch.cuda.set_device(local)
    kw = {"timeout": datetime.timedelta(seconds=timeout_s)}
    if init_method is not None:
        kw.update(init_method=init_method, rank=rank, world_size=world_size)
    dist.init_process_group(backend, **kw)
    return True


def global_batch(mesh: Mesh, host_batch: Any) -> Any:
    """This process's slice of the global batch (a tree of arrays or
    tensors, dim 0 the batch) -> this rank's batch, tensors on the mesh's
    device and numpy on the host, as ``shard_batch`` places them.  Every
    data rank must hold as many rows; a rank that does not raises on
    all of them."""
    from affganwriting_torch.parallel.ops import reduce_sum

    sizes = []
    _tree_map(lambda x: sizes.append(int(x.shape[0]))
              if hasattr(x, "shape") else None, host_batch)
    n = sizes[0] if sizes else 0
    # every rank reaches the same verdict: the rows agree over the group
    # iff data * sum(n^2) == sum(n)^2, and within this tree iff no leaf
    # differs from the first
    mine = torch.tensor([n, n * n, len(set(sizes)) - 1], dtype=torch.long,
                        device=mesh.device)
    s1, s2, odd = (int(v) for v in reduce_sum(mine, mesh.data_group))
    if odd or mesh.data * s2 != s1 * s1:
        raise ValueError(
            f"global_batch: the data ranks hold unequal slices ({sizes} rows "
            f"here, {s1} over {mesh.data} ranks)")
    return _tree_map(lambda x: _place(mesh, x), host_batch)


def mesh_from_flag(spec: str, device=None) -> Mesh | None:
    """A CLI's ``--mesh``: ``'none'`` (or ``'1'`` outside the launcher) ->
    None, one device; any other spec starts this rank's process group
    (``init_distributed``, NCCL on the card, gloo with ``device="cpu"``)
    and builds the mesh over it; rank 0 prints its shape.  Outside
    torchrun's environment such a spec raises ``SystemExit`` naming the
    launcher."""
    from affganwriting_torch.parallel.mesh import parse_mesh_spec

    if not spec or spec == "none":
        return None
    if not launched():
        if spec == "1":
            return None
        raise SystemExit(
            f"--mesh {spec} runs one process per device: launch it with "
            "python -m torch.distributed.run --nproc-per-node N -m "
            f"<this module> --mesh {spec} ...")
    init_distributed(device=device)
    mesh = parse_mesh_spec(spec, device=device)
    if is_writer(mesh):
        print(f"mesh: {mesh.shape}, one process per device")
    return mesh


def is_writer(mesh: Mesh | None) -> bool:
    """True on the process that writes files: the only one, or rank 0."""
    import torch.distributed as dist

    return mesh is None or dist.get_rank() == 0


def spawn(target: str, world: int, *args, timeout_s: float = 600.0,
          env: dict | None = None, cwd: str | None = None) -> list[str]:
    """Run ``target`` (``"module:function"``) in ``world`` fresh Python
    processes as ``function(rank, world, init_method, *args)`` (``args``
    JSON-serializable), over a file store in a temporary directory; the
    function calls ``init_distributed(..., init_method=init_method,
    rank=rank, world_size=world)`` itself.  Returns each rank's standard
    output.  When a rank fails the others are killed (they would wait in
    a collective) and ``RuntimeError`` carries the failing rank's error
    output; past ``timeout_s`` all are killed and it raises too."""
    import json
    import subprocess
    import sys
    import tempfile
    import time

    module, fn = target.split(":")
    code = ("import importlib, json, sys; "
            f"getattr(importlib.import_module({module!r}), {fn!r})"
            "(*json.loads(sys.argv[1]))")
    with tempfile.TemporaryDirectory(prefix="spawn_") as tmp:
        init = f"file://{tmp}/store"
        procs, logs = [], []
        for rank in range(world):
            out = open(os.path.join(tmp, f"out{rank}"), "w+")
            err = open(os.path.join(tmp, f"err{rank}"), "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code,
                 json.dumps([rank, world, init, *args])],
                stdout=out, stderr=err, env=env, cwd=cwd))
        deadline = time.monotonic() + timeout_s
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.returncode not in (None, 0)]
                if bad or time.monotonic() > deadline:
                    failed = bad[0] if bad else None
                    break
                time.sleep(0.05)
            else:
                bad = [r for r, p in enumerate(procs) if p.returncode]
                failed = bad[0] if bad else None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()

        def read(f):
            f.seek(0)
            return f.read()

        outs = [read(o) for o, _ in logs]
        errs = [read(e) for _, e in logs]
        for o, e in logs:
            o.close()
            e.close()
    if failed is not None or any(p.returncode for p in procs):
        r = failed if failed is not None else 0
        what = ("timed out after %.0f s" % timeout_s if failed is None
                else f"rank {r} exited with {procs[r].returncode}")
        raise RuntimeError(f"spawn {target} x {world}: {what}\n"
                           f"--- rank {r} stderr ---\n{errs[r][-6000:]}")
    return outs
