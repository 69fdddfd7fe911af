"""Rank programs of the port's multi-process tests (no tests here).

Each function runs as one rank of ``parallel/multihost.spawn`` (a fresh
process over gloo on the CPU, one thread) and writes what the parent test
reads to ``<out>/<case>_r<rank>.npz``.  Where the reference is the port's
own single-process run, rank 0 runs it after the sharded one and writes
the comparison, not the full-size arrays (R's VGG trunk alone is 20 M
parameters); every rank writes a digest of its state, so the test holds
the replicas equal.  This module imports torch and the port only, never
jax: the parent pytest process holds the JAX side.
"""

from __future__ import annotations

import os

import numpy as np
import torch

TIMEOUT_S = 120.0     # every collective gives up by then
SPAWN_TIMEOUT_S = 240.0   # a whole rank program, on a loaded machine

# tests/test_parallel_dp.py's configuration: the dryrun's tiny dims
CFG = dict(
    compute_dtype="float32",
    style_encoder="cnn",
    img_height=32,
    img_width=104,
    num_writers=8,
    batch_size=8,
    max_chars=10,
    style_dim=64,
    adain_param_dim=512,
    text_embed_dim=16,
    rec_hidden=64,
    rec_embed=16,
    attn_filters=16,
    dis_layers=3,
    dis_final_size=64,
)


def config(**kw):
    from affganwriting_torch.core.config import default_config

    return default_config().replace(**{**CFG, **kw})


def labels(cfg, lengths) -> np.ndarray:
    """GO + ``n`` characters + END + PAD rows, one per length."""
    from affganwriting_torch.core.config import VOCAB

    rng = np.random.default_rng(len(lengths))
    words = ["".join(rng.choice(list("abcdefghij"), n)) for n in lengths]
    return np.asarray([VOCAB.pad_label(w, cfg.output_max_len)
                       for w in words], np.int32)


def word_batch(cfg, b: int = 8, seed: int = 0) -> dict:
    """A train-step batch whose words have unequal lengths, the short
    ones (many PADs) in the first half: the halves hold unequal PAD
    counts."""
    rng = np.random.default_rng(seed)
    short = [1 + i % 2 for i in range(b // 2)]
    long = [cfg.max_chars - i % 3 for i in range(b - b // 2)]
    return {
        "style_imgs": rng.normal(size=(
            b, cfg.img_height, cfg.img_width,
            cfg.style_stack)).astype(np.float32),
        "img_xt": rng.normal(size=(
            b, cfg.img_height, cfg.img_width, 1)).astype(np.float32),
        "writer_ids": (np.arange(b) % cfg.num_writers).astype(np.int32),
        "label_ch0": labels(cfg, short + long),
        "label_xt": labels(cfg, long + short),
        "label_xt_swap": labels(cfg, short[::-1] + long[::-1]),
    }


def start(rank: int, world: int, init: str):
    from affganwriting_torch.parallel.multihost import init_distributed

    torch.set_num_threads(1)
    init_distributed("gloo", device="cpu", init_method=init, rank=rank,
                     world_size=world, timeout_s=TIMEOUT_S)


def finish():
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def state_arrays(state) -> dict:
    """{player/name: array} of every parameter and buffer (a sharded state
    gathered whole first) and the step."""
    from affganwriting_torch.parallel.mesh import unsharded

    out = {}
    with unsharded(state):
        for player in ("gen", "dis", "cla", "rec"):
            sd = getattr(state, player).model.state_dict()
            out.update({f"{player}/{k}": v.detach().numpy().copy()
                        for k, v in sd.items()})
    return out


def digest(arrays: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def max_diffs(got: dict, want: dict) -> dict:
    """{"maxdiff/<player>": max |got - want| over the player's entries}."""
    out: dict = {}
    for k, v in want.items():
        key = "maxdiff/" + k.split("/")[0]
        out[key] = max(out.get(key, 0.0), float(np.abs(got[k] - v).max()))
    return out


def step_case(cfg, batch, mesh=None) -> tuple[dict, dict]:
    """One SGD word step from seed-0 weights (R's dropout 0.5, masks from
    a seed-1 generator): (metrics, state arrays after the step)."""
    from affganwriting_torch.parallel.mesh import shard_batch, shard_state
    from affganwriting_torch.train.state import init_state
    from affganwriting_torch.train.step import make_phased_train_step

    state = init_state(cfg, "cpu", seed=0)
    if mesh is not None:
        shard_state(mesh, state)
        batch = shard_batch(mesh, batch)
    step = make_phased_train_step(cfg, merge_dg=cfg.merge_dg, device="cpu",
                                  mesh=mesh)
    state, metrics, _ = step(state, batch, torch.Generator().manual_seed(1))
    return ({k: float(v) for k, v in metrics.items()}, state_arrays(state))


def bn_case(mesh, x: np.ndarray, w: np.ndarray) -> dict:
    """A train-mode ``BatchNorm`` over this rank's rows of ``x``: the
    output, the input's gradient of sum(y * w), the parameters' gradients
    summed over the ranks and the running statistics."""
    from affganwriting_torch.models.blocks import BatchNorm
    from affganwriting_torch.parallel.mesh import shard_batch, shard_params
    from affganwriting_torch.parallel.ops import reduce_grads

    bn = BatchNorm(x.shape[1]).train()
    if mesh is not None:
        shard_params(mesh, bn)
        x, w = shard_batch(mesh, (x, w))
    xt = torch.tensor(x, requires_grad=True)
    y = bn(xt)
    (y * torch.tensor(w)).sum().backward()
    if mesh is not None:
        reduce_grads(bn.parameters(), mesh.data_group)
    return {"y": y.detach().numpy(), "x_grad": xt.grad.numpy(),
            "w_grad": bn.weight.grad.numpy(),
            "b_grad": bn.bias.grad.numpy(),
            "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy()}


def rec_loss_case(cfg, batch, mesh=None) -> dict:
    """R's loss sum and parameter gradients in train mode (batch
    statistics, no dropout) on ``batch``: {"loss", "pads", "g/<leaf>"};
    with ``mesh`` also this rank's own loss part ("loss_mine"), and the
    loss and gradients summed over the ranks."""
    from affganwriting_torch.gen.inference import init_weights
    from affganwriting_torch.models.recognizer.seq2seq import Recognizer
    from affganwriting_torch.parallel.mesh import shard_batch, shard_params
    from affganwriting_torch.parallel.ops import reduce_grads, reduce_sum
    from affganwriting_torch.train import losses
    from affganwriting_torch.train.step import to_device_batch

    rec = init_weights(Recognizer(
        cfg.vocab_size, cfg.rec_hidden, cfg.rec_embed, cfg.output_max_len,
        cfg.img_height, torch.float32, 0.0), 4).train()
    if mesh is not None:
        shard_params(mesh, rec)
        batch = shard_batch(mesh, batch)
    b = to_device_batch(batch, torch.device("cpu"))
    logits, _ = rec(b["img_ch0"], b["label_ch0"])
    loss = losses.rec_loss(logits, b["label_ch0"], cfg.label_smoothing)
    loss.backward()
    group = None if mesh is None else mesh.data_group
    reduce_grads(rec.parameters(), group)
    return {"loss": float(reduce_sum(loss.detach(), group)),
            "loss_mine": float(loss), "pads": int((b["label_ch0"] == 2).sum()),
            **{f"g/{k}": p.grad.numpy() for k, p in rec.named_parameters()
               if p.grad is not None}}


def rel_l2(got, want, floor: float = 1e-30) -> float:
    """Relative L2 distance of ``got`` from ``want``, against the larger of
    ``want``'s norm and ``floor``."""
    return float(np.linalg.norm(got - want)
                 / max(float(np.linalg.norm(want)), floor))


def rec_loss_summary(got: dict, want: dict, data: int) -> dict:
    """Per leaf: the sharded gradient's distance from the unsharded one,
    and that of DDP's mean of the ranks' gradients (the sum over
    ``data``), against 1e-3 of the largest leaf's norm at least (a bias
    before a train-mode BatchNorm has a null gradient)."""
    grads = [k for k in want if k.startswith("g/")]
    floor = 1e-3 * max(float(np.linalg.norm(want[k])) for k in grads)
    out = {"loss": got["loss"], "want_loss": want["loss"], "floor": floor}
    for k in grads:
        out[f"err/{k[2:]}"] = rel_l2(got[k], want[k], floor)
        out[f"ddp_err/{k[2:]}"] = rel_l2(got[k] / data, want[k], floor)
        out[f"norm/{k[2:]}"] = float(np.linalg.norm(want[k]))
    return out


def step_summary(rank: int, cfg, batch, mesh) -> dict:
    """The sharded step's metrics ("m/") and state digest on every rank;
    on rank 0 also the single-process step's metrics ("want/") and the
    largest difference per player (``max_diffs``)."""
    metrics, arrays = step_case(cfg, batch, mesh)
    out = {**{f"m/{k}": v for k, v in metrics.items()},
           "digest": digest(arrays)}
    if rank == 0:
        want_m, want = step_case(cfg, batch)
        out.update({f"want/{k}": v for k, v in want_m.items()},
                   **max_diffs(arrays, want))
    return out


def save(out: str, case: str, rank: int, arrays: dict) -> None:
    np.savez(os.path.join(out, f"{case}_r{rank}.npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})


# --- rank programs ----------------------------------------------------------

def two_ranks(rank: int, world: int, init: str, out: str) -> None:
    """The 2-rank cases: global_batch against shard_batch, the global
    BatchNorm, R's loss on shards of unequal PAD counts, the data=2 word
    step, and the serving pipeline at data=2 and at 1x2."""
    from affganwriting_torch.gen.inference import make_sharded_pipeline
    from affganwriting_torch.parallel.mesh import make_mesh, shard_batch
    from affganwriting_torch.parallel.multihost import global_batch

    start(rank, world, init)
    mesh = make_mesh(2, 1, device="cpu")
    cfg = config(optimizer="sgd")
    batch = word_batch(cfg)

    # global_batch of this rank's slice == shard_batch of the global batch
    k = batch["label_ch0"].shape[0] // 2
    local = {n: v[rank * k:(rank + 1) * k] for n, v in batch.items()}
    got = global_batch(mesh, local)
    want = shard_batch(mesh, batch)
    try:
        global_batch(mesh, {"x": np.zeros((k + rank, 2))})
        unequal = "no error"
    except ValueError as e:
        unequal = str(e)
    save(out, "global_batch", rank, {
        **{f"got/{n}": v for n, v in got.items()},
        **{f"want/{n}": v for n, v in want.items()}, "unequal": unequal})

    rng = np.random.default_rng(5)
    x = rng.normal(2.0, 3.0, size=(8, 6, 3, 5)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    save(out, "bn", rank, bn_case(mesh, x, w))
    got = rec_loss_case(cfg, batch, mesh)
    summary = {"pads": got["pads"], "loss_mine": got["loss_mine"]}
    if rank == 0:
        summary.update(rec_loss_summary(got, rec_loss_case(cfg, batch), 2))
    save(out, "rec_loss", rank, summary)
    save(out, "step_dp", rank, step_summary(rank, cfg, batch, mesh))

    weights = torch.load(os.path.join(out, "pipeline_weights.pt"))
    data = np.load(os.path.join(out, "pipeline_inputs.npz"))
    for name, shape in (("pipe_dp", (2, 1)), ("pipe_tp", (1, 2))):
        m = make_mesh(*shape, device="cpu")
        run = make_sharded_pipeline(config(), m, weights["gen"],
                                    weights["rec"])
        images, ids = run(data["style"], data["labels"])
        try:
            run.shard_labels(data["labels"][:7])
            err = "no error"
        except ValueError as e:
            err = str(e)
        fc = run.gen.text_encoder.fc1.weight.shape
        # two writers' stacks: global word i in the style of stack i % 2
        two_img, _ = run(np.concatenate([data["style"], -data["style"]]),
                         data["labels"])
        save(out, name, rank, {"images": images.numpy(), "ids": ids.numpy(),
                               "two_writers": two_img.numpy(),
                               "fc1_rows": fc[0],
                               "mix_cols": run.gen.linear_mix.weight.shape[1],
                               "err": err})
    finish()


def four_ranks(rank: int, world: int, init: str, out: str) -> None:
    """The data=2 x model=2 word step (TP over the text encoder's FC
    pyramid and the mix)."""
    from affganwriting_torch.parallel.mesh import make_mesh

    start(rank, world, init)
    mesh = make_mesh(2, 2, device="cpu")
    cfg = config(optimizer="sgd")
    save(out, "step_tp", rank, step_summary(rank, cfg, word_batch(cfg), mesh))
    finish()


def word_datasets(cfg, n: int):
    """The first ``n`` train and test writers of the port's ground truth,
    as ``tests/test_torch_trainer.py`` builds them."""
    from affganwriting_torch.data import iam
    from affganwriting_torch.data.words import WordStyleDataset

    paths = iam.default_reference_paths()
    corpus = iam.load_corpus(paths["corpus"])[:300]
    out = []
    for split, s in (("train_gt", 0), ("test_gt", 1)):
        gt = dict(list(iam.parse_groundtruth(paths[split]).items())[:n])
        out.append(WordStyleDataset(gt, iam.writer_label_map(gt), cfg,
                                    corpus=corpus, seed=s))
    return out


def line_lessons(mesh=None) -> tuple[dict, dict, str]:
    """One auto and one disc lesson (iterations 2 and 3, as
    ``test_line_trainer_on_mesh``) of ``LineGanTrainer`` at its published
    widths on 4 synthetic lines (2 authors x 2): (the metrics, the
    gradients each lesson hands its optimizers, a digest of the trees
    after)."""
    from affganwriting_torch.data.lines import LineCharset, LineDataset
    from affganwriting_torch.train.line_trainer import LineGanTrainer

    cs = LineCharset()
    ds = LineDataset(cs, a_batch_size=2, width=256, label_len=24, seed=0)
    first = next(ds.batches(batch_authors=2, epoch=0))
    tr = LineGanTrainer(n_class=cs.n_class, max_gen_length=64, seed=0,
                        device="cpu", mesh=mesh)
    state = tr.init_state(first)
    grads = {}
    main_step = state.main_opt.step

    def record_main(g):
        grads.update({f"g_main/{k}": v.detach().numpy().copy()
                      for k, v in g.items() if v is not None})
        main_step(g)

    def record_disc(opt, args, kwargs):
        grads.update({f"g_disc/{k}": p.grad.detach().numpy().copy()
                      for k, p in state.disc.named_parameters()
                      if p.grad is not None})

    state.main_opt.step = record_main
    state.disc_opt.register_step_pre_hook(record_disc)
    metrics = {}
    for it in (2, 3):
        lesson = "+".join(tr.curriculum.get_lesson(it))
        state, m = tr.train_iteration(state, it, first)
        metrics.update({f"m/{lesson}/{k}": float(v) for k, v in m.items()})
    trees = {**{f"main/{k}": p.detach().numpy()
                for k, p in state.main_params().items()},
             **{f"disc/{k}": v.detach().numpy()
                for k, v in state.disc.state_dict().items()}}
    return metrics, grads, digest(trees)


def trainers(rank: int, world: int, init: str, out: str) -> None:
    """On a data=2 mesh: ``WordGanTrainer`` (Adam) for one epoch (one step
    of 4 words, one eval) and a restore on every rank, then the line GAN's
    auto and disc lessons; rank 0 then runs both without a mesh, the
    single-process references.  One step: at random weights a fresh
    Adam's first update, lr * sign(g), turns float noise in near-zero
    gradients into full-rate steps, and a second step's losses then move
    by ~1e-2 between two single-process runs that differ only in their
    thread count."""
    import json
    import shutil

    import torch.distributed as dist

    from affganwriting_torch.parallel.mesh import make_mesh
    from affganwriting_torch.train.loop import WordGanTrainer

    start(rank, world, init)
    import affganwriting_torch.utils.logging as logging

    logging.summary_writer = lambda logdir: None      # no TensorBoard
    cfg = config(batch_size=4)
    train, test = word_datasets(cfg, 4)

    def word_run(mesh, logdir):
        kw = dict(logdir=logdir, eval_every=1, save_every=1,
                  restart_rss_gb=0, device="cpu", mesh=mesh)
        first = WordGanTrainer(cfg, train, test, **kw)
        first.fit(1)
        second = WordGanTrainer(cfg, train, test, **kw)
        a, b = state_arrays(first.state), state_arrays(second.state)
        lines = []
        if first.writer:
            with open(os.path.join(logdir, "metrics.jsonl")) as f:
                lines = [json.loads(x) for x in f]
        return {"restored_equal": all(np.array_equal(a[k], b[k])
                                      for k in a),
                "start_epoch": second.start_epoch, "step": second.state.step,
                "ckpt_files": np.asarray(sorted(os.listdir(
                    os.path.join(logdir, "ckpt")))),
                "metrics": json.dumps(lines), "digest": digest(a)}

    mesh = make_mesh(world, 1, device="cpu")
    logdir = os.path.join(out, "run_mesh")
    got = word_run(mesh, logdir)
    dist.barrier()
    if rank == 0:     # ~0.3 GB a file (R's VGG19 trunk at full width)
        shutil.rmtree(os.path.join(logdir, "ckpt"))
        want = word_run(None, os.path.join(out, "run_one"))
        shutil.rmtree(os.path.join(out, "run_one", "ckpt"))
        got["want_metrics"] = want["metrics"]
    save(out, "word_trainer", rank, got)

    metrics, grads, tree_digest = line_lessons(mesh)
    line = {**metrics, "digest": tree_digest}
    if rank == 0:
        want_m, want_g, _ = line_lessons(None)
        line.update({f"want/{k}": v for k, v in want_m.items()})
        line.update({f"err/{k}": rel_l2(grads[k], want_g[k], 1e-12)
                     for k in want_g})
    save(out, "line", rank, line)
    finish()
