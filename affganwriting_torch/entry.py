"""The port's single-card entry point: ``entry()`` returns the batched
generate function at ``default_config()`` and example arguments.

Modelled on ``__graft_entry__.py:entry`` of the JAX package: resnet50 G,
64x216 words in bf16, random weights from seed 0, one writer's 50-image
style stack from ``np.random.default_rng(0)`` and 8 words.  The function is
``gen/inference.py:make_generate_fn``'s: ``fn(*args)`` returns the images
(8, 64, 216, 1), generated with both CUDA kernels on the card.  It runs on
the card unless ``device="cpu"`` is asked for.

``dryrun_multichip(n)``, modelled on ``__graft_entry__.py:dryrun_multichip``:
the four-player train step on a data x model mesh of ``n`` CPU ranks over
gloo, at the JAX dryrun's tiny configuration.
"""

from __future__ import annotations

import numpy as np

WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog"]


def entry(device=None):
    """(generate, (style_stack (1, 64, 216, 50), labels (8, 12)))."""
    from affganwriting_torch.core.config import default_config
    from affganwriting_torch.gen.inference import (
        encode_labels,
        make_generate_fn,
    )

    cfg = default_config()
    fn = make_generate_fn(cfg, device=device, seed=0)
    rng = np.random.default_rng(0)
    style = np.asarray(
        rng.normal(size=(1, cfg.img_height, cfg.img_width, cfg.style_stack)),
        np.float32)
    return fn, (style, encode_labels(WORDS, cfg.output_max_len))


# __graft_entry__.py's dryrun configuration: tiny dims, the full program
# structure (four players, DP + TP placement, R's greedy decode)
DRYRUN = dict(compute_dtype="float32", style_encoder="cnn", img_height=32,
              img_width=104, num_writers=8, max_chars=6, style_dim=64,
              adain_param_dim=512, text_embed_dim=16, rec_hidden=64,
              rec_embed=16, attn_filters=16, dis_layers=3,
              dis_final_size=64)


def dryrun_multichip(n_ranks: int, timeout_s: float = 600.0) -> str:
    """Spawn ``n_ranks`` CPU processes over gloo (the dryrun is a CPU
    program by nature, as the JAX one is: it asks for the CPU), build a
    data x model mesh (model=2 when ``n_ranks`` is even), place the state
    with ``shard_state``, take two train steps with the state and Adam's
    moments threaded through, assert finite metrics, round-trip a
    checkpoint (gathered, written by rank 0, restored and re-sharded on
    every rank) and print rank 0's ``dryrun_multichip ok on N ranks ...``
    line, which is returned."""
    import tempfile

    from affganwriting_torch.parallel.multihost import spawn

    with tempfile.TemporaryDirectory(prefix="dryrun_") as ckpt:
        outs = spawn("affganwriting_torch.entry:_dryrun_rank", n_ranks,
                     ckpt, timeout_s=timeout_s)
    line = [x for x in outs[0].splitlines() if x.startswith("dryrun_")][-1]
    print(line)
    return line


def _dryrun_rank(rank: int, world: int, init_method: str, ckpt: str):
    """One rank of ``dryrun_multichip``."""
    import torch
    import torch.distributed as dist

    from affganwriting_torch.core.checkpoint import CheckpointManager
    from affganwriting_torch.core.config import VOCAB, default_config
    from affganwriting_torch.parallel.mesh import (
        make_mesh,
        shard_batch,
        shard_state,
        unsharded,
    )
    from affganwriting_torch.parallel.multihost import init_distributed
    from affganwriting_torch.train.state import init_state
    from affganwriting_torch.train.step import make_phased_train_step

    torch.set_num_threads(1)
    init_distributed("gloo", device="cpu", init_method=init_method,
                     rank=rank, world_size=world, timeout_s=300)
    model = 2 if world % 2 == 0 else 1
    data = world // model
    mesh = make_mesh(data, model, device="cpu")
    b = max(data, 2)
    cfg = default_config().replace(batch_size=b, **DRYRUN)
    state = shard_state(mesh, init_state(cfg, "cpu", seed=0))
    rng = np.random.default_rng(0)

    def lab(w):
        return VOCAB.pad_label(w, cfg.output_max_len)

    batch = shard_batch(mesh, {
        "style_imgs": rng.normal(size=(
            b, cfg.img_height, cfg.img_width, cfg.style_stack)).astype(
                np.float32),
        "img_xt": rng.normal(size=(
            b, cfg.img_height, cfg.img_width, 1)).astype(np.float32),
        "writer_ids": (np.arange(b) % cfg.num_writers).astype(np.int32),
        "label_xt": np.asarray([lab("deep")] * b, np.int32),
        "label_xt_swap": np.asarray([lab("dep")] * b, np.int32),
        "label_ch0": np.asarray([lab("word")] * b, np.int32)})
    step = make_phased_train_step(cfg, merge_dg=cfg.merge_dg, mesh=mesh)
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        state, metrics, _ = step(state, batch, gen)
    bad = {k: float(v) for k, v in metrics.items()
           if not np.isfinite(float(v))}
    assert not bad, bad
    # checkpoint round trip under sharding
    ck = CheckpointManager(ckpt, write=rank == 0)
    with unsharded(state):
        ck.save_latest(state, cfg)
    dist.barrier()
    restored = init_state(cfg, "cpu", seed=1)
    ck.restore("latest", restored)
    shard_state(mesh, restored)
    fc = restored.gen.model.text_encoder.fc1.weight
    assert torch.equal(fc, state.gen.model.text_encoder.fc1.weight)
    if rank == 0:
        print(f"dryrun_multichip ok on {world} ranks: mesh data={data} x "
              f"model={model}, 2 steps, l_total="
              f"{float(metrics['l_total']):.4f}, text_encoder.fc1 shard "
              f"{tuple(fc.shape)}, checkpoint round trip", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    fn, args = entry()
    print(f"entry ok: {tuple(fn(*args).shape)}")
