"""The four-card train cell's fault, on the CPU: four processes over gloo
on a data=4 mesh, at a tiny size, with the exchange of gradients between
the cards left out; the run comes out not correct."""

import json
import socket
import sys
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[2]


def _rank(rank: int, port: int, out: str):
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=4, rank=rank)
    import affganwriting_torch.train.step as program_step
    from affganwriting_torch.parallel.mesh import make_mesh

    from benchmark.harness import multi
    from benchmark.harness.train import train
    from benchmark.tests import tiny

    def no_exchange(step):
        def run(*a, **kw):
            saved = program_step.sync_grads
            program_step.sync_grads = lambda params, mesh: None
            try:
                return step(*a, **kw)
            finally:
                program_step.sync_grads = saved
        return run

    mesh = make_mesh(4, 1, device="cpu")
    cell = tiny.tiny_cell("word-resnet50.train-dp4", writers=8, batch=8)
    res = train(cell, 77, 0.5, None, torch.device("cpu"), 0.0, mesh=mesh,
                fault=no_exchange)
    res = multi.gather(res, mesh)
    if rank == 0:
        Path(out).write_text(json.dumps(res["numbers"]))
    multi.leave()


def test_exchange_left_out_is_caught(tmp_path):
    from benchmark.harness import spec
    from benchmark.harness.checks import checks_of, is_correct

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = tmp_path / "numbers.json"
    mp.spawn(_rank, args=(port, str(out)), nprocs=4)
    numbers = json.loads(out.read_text())
    limits = spec.cell("word-resnet50.train-dp4")["check"]["limits"]
    assert is_correct(checks_of(numbers, limits)) is False, numbers
