"""Train cells: the port's merged four-player step
(``make_phased_train_step(merge_dg=True)`` on ``init_state``), one new batch
from the style pool a step, copied to the card inside the step's time; the
step ends in a synchronize, as a loop that logs its losses does.

Set-up builds the one state and step, drives them through the first
``CHECK_STEPS`` steps (the checked ones) and one more, and hands the same
objects to the window.  It records each checked step's losses, every
leaf's first gradient as Adam holds it after step 1 (the first moment over
1 - beta1), the change of every parameter and BatchNorm statistic after the
checked steps, and R's greedy ids in each decode.  After the window the
float32 reference (``reference/step.py``) runs the same steps from the same
weights, batches and dropout generator, fed the same ids, and the two are
compared leaf by leaf.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import data, flops, trace, traffic, weights
from benchmark.harness.serve import program_config, quiet_gc
from benchmark.reference import models as ref
from benchmark.reference import step as rstep

CHECK_STEPS = 3
LOSSES = ("l_rec_tr", "l_cla_tr", "l_dis_tr", "l_total")
BETA1 = 0.9
TRACE_STEPS = 3


NUMBERS = ("loss_err", "loss1_err", "fake_rel", "dis_rel", "cla_rel",
           "rec_rel", "grad_err", "grad_med", "delta_err", "delta_med")


def dropout_seed(seed: int) -> int:
    return (seed * 7 + 11) % (2 ** 63)


def make_program(cfg: dict, states: dict, dev, mesh=None):
    """The system under test: the port's state (its four players with
    Adam) and its merged step, with the benchmark's weights."""
    from affganwriting_torch.train.state import init_state
    from affganwriting_torch.train.step import make_phased_train_step

    pc = program_config(cfg)
    with torch.device(dev):
        state = init_state(pc, dev, weights=states)
    if mesh is not None:
        from affganwriting_torch.parallel.mesh import shard_state
        shard_state(mesh, state)
    return state, make_phased_train_step(pc, merge_dg=True, device=dev,
                                         mesh=mesh)


def _models(state):
    return {n: getattr(state, n).model for n in rstep.PLAYERS}


def program_grads(state) -> dict:
    """{player.leaf: norm of the first gradient} from Adam's first moment
    after one step."""
    out = {}
    for n in rstep.PLAYERS:
        ps = getattr(state, n)
        for k, p in ps.model.named_parameters():
            st = ps.opt.state.get(p, {})
            m = st.get("exp_avg")
            out[f"{n}.{k}"] = (torch.zeros((), device=p.device) if m is None
                               else m.float().norm() / (1 - BETA1))
    return {k: float(v) for k, v in out.items()}


def changes(models: dict, init: dict) -> dict:
    """{player.leaf: norm of (now - initial)} over parameters and
    BatchNorm statistics."""
    out = {}
    for n, m in models.items():
        for k, v in m.state_dict().items():
            out[f"{n}.{k}"] = (v.float() - init[n][k].float()).norm()
    return {k: float(v) for k, v in out.items()}


def device_batch(b: dict, dev) -> dict:
    """The program's ``to_device_batch`` layout, made by the benchmark."""
    style = torch.as_tensor(b["style_imgs"], dtype=torch.float32, device=dev)
    out = {"style": style,
           "img_ch0": style[..., 0:1].permute(0, 3, 1, 2).contiguous(),
           "img_ch1": style[..., 1:2].permute(0, 3, 1, 2).contiguous()}
    for k in ("label_ch0", "label_xt", "label_xt_swap", "writer_ids"):
        out[k] = torch.as_tensor(b[k], device=dev).long()
    return out


class IdTap:
    """The ids R fed itself in each of its calls, from R's tap (its
    recognizer part's ``Tap``); ``feeds(k)`` gives step k's three decodes
    once ``close`` has taken them."""

    def __init__(self, rec, cfg: dict):
        self.tap, self.ids = ref.tap(cfg, rec), []

    def close(self) -> None:
        self.ids = [ids for _, ids in self.tap.take()()]
        self.tap.remove()

    def feeds(self, k: int):
        return tuple(self.ids[3 * k:3 * k + 3])


class FirstOutputs:
    """The first step's forward outputs, from hooks: G's fake (the
    decoder's first image), D's scores of the real words (the first two
    quarters of its first call), C's writer logits of the real words, and
    R's per-step logits of its first decode (the real words, from R's
    tap)."""

    def __init__(self, models: dict, cfg: dict):
        self.out, self.handles = {}, []

        def first(name):
            def hook(m, a, o):
                if name not in self.out:
                    self.out[name] = o.detach().float().clone()
            return hook

        for name, mod in (("fake", models["gen"].dec), ("dis", models["dis"]),
                          ("cla", models["cla"])):
            self.handles.append(mod.register_forward_hook(first(name)))
        self.rec_tap = ref.tap(cfg, models["rec"])

    def close(self) -> dict:
        calls = self.rec_tap.take()()
        self.rec_tap.remove()
        for h in self.handles:
            h.remove()
        out = dict(self.out)
        if "dis" in out:        # [ch0, ch1, fake, fake_swap] -> the reals
            n = out["dis"].shape[0] // 4
            out["dis"], out["dis_ch1"] = out["dis"][:n], out["dis"][n:2 * n]
        if calls:
            out["rec"] = calls[0][0].float().clone()
        return out


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||; infinite where the shapes differ."""
    if a.shape != b.shape:
        return float("inf")
    return float((a.to(b.device) - b).norm() / b.norm().clamp_min(1e-30))


def train(cell, seed: int, seconds: float, trace_path, dev, t_start: float,
          build=make_program, mesh=None, fault=None) -> dict:
    """One run of a train cell.  ``fault(step) -> step`` breaks the timed
    path underneath (the fault tests)."""
    cfg, mix = cell["config_file"]["config"], cell["traffic_mix"]
    rank = 0 if mesh is None else mesh.data_rank
    pool = data.StylePool(seed, cfg, mix["writers"], dev)
    vocab = data.corpus(cfg["max_chars"])
    states = {p: weights.draw(cfg, p, seed, dev) for p in rstep.PLAYERS}
    state, step = build(cfg, states, dev, mesh)
    if fault is not None:
        step = fault(step)
    gen = torch.Generator(device=dev).manual_seed(dropout_seed(seed))
    batches = traffic.train_batches(mix, seed, pool, vocab, cfg)
    tap = IdTap(state.rec.model, cfg)
    firsts = FirstOutputs(_models(state), cfg)
    checked, prog = [], {"loss": []}
    for k in range(CHECK_STEPS):
        b = next(batches)
        checked.append(b)
        _, metrics, _ = step(state, shard(b, mesh), gen)
        prog["loss"].append({n: float(metrics[n]) for n in LOSSES})
        if k == 0:
            prog["grad"] = program_grads(state)
            prog["first"] = {n: gather_rows(v.cpu(), mesh)
                             for n, v in firsts.close().items()}
    tap.close()
    prog["delta"] = changes(_models(state), states)
    prog["feeds"] = [tuple(gather_rows(f.cpu(), mesh) for f in tap.feeds(k))
                     for k in range(CHECK_STEPS)]
    del states, tap
    step(state, shard(next(batches), mesh), gen)
    sync(dev)
    setup_s = time.perf_counter() - t_start
    quiet_gc()

    prof = trace.Profiled(trace_path) if trace_path is not None else None
    n_traced = 0
    done, attempted = 0, 0
    t0 = time.perf_counter()
    end = t0 + seconds
    while keep_going(end, mesh):
        b = shard(next(batches), mesh)
        if prof is not None and prof.prof is None \
                and time.perf_counter() - t0 >= 0.4 * seconds:
            prof.start()
        attempted += 1
        step(state, b, gen)
        sync(dev)
        if prof is not None and prof.prof is not None and not prof.stopped:
            n_traced += 1
            if n_traced == TRACE_STEPS:
                prof.stop(n_traced)
        if time.perf_counter() <= end:
            done += 1
        else:
            attempted -= 1          # cut by the window's end: not counted
    if prof is not None and prof.prof is not None and not prof.stopped:
        prof.stop(n_traced)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    chips = 1 if mesh is None else mesh.data
    result = {"attempted": attempted, "failed": 0, "peak": peak,
              "e2e": {"setup_s": setup_s,
                      "train_words_per_s": done * mix["batch"] / seconds}}
    if trace_path is not None:
        result["ctx"] = {"kind": "train", "cfg": cfg, "trace": prof.trace(),
                         "units": n_traced, "chips": chips,
                         "flops_of": lambda n, c=cfg: flops.train(c, n),
                         "batch": mix["batch"]}
    del state, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if rank == 0:
        result["numbers"] = judge(cfg, seed, dev, checked, prog)
    return result


def keep_going(end: float, mesh) -> bool:
    """Whether another step starts: rank 0's clock decides for every
    rank, so that all ranks run the same steps."""
    if mesh is None:
        return time.perf_counter() < end
    import torch.distributed as dist

    flag = torch.tensor([float(time.perf_counter() < end)],
                        device=mesh.device)
    dist.broadcast(flag, src=0)
    return bool(flag.item())


def gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a batch -> the global batch's, in rank order."""
    if mesh is None:
        return t
    import torch.distributed as dist

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, t)
    return torch.cat(every)


def shard(b: dict, mesh):
    if mesh is None:
        return b
    from affganwriting_torch.parallel.mesh import shard_batch
    return shard_batch(mesh, b)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _gaps(prog: dict, ref_: dict, gate) -> tuple[float, float]:
    """(worst, median) over the leaves ``gate`` keeps of |program norm -
    reference norm| over the larger of the reference's norm and its
    player's median leaf norm."""
    gaps = []
    for player in rstep.PLAYERS:
        keys = [k for k in ref_ if k.startswith(player + ".") and gate(k)]
        if not keys:
            continue
        med = sorted(ref_[k] for k in keys)[len(keys) // 2]
        gaps += [abs(prog.get(k, 0.0) - ref_[k]) / max(ref_[k], med, 1e-30)
                 for k in keys]
    gaps.sort()
    return (gaps[-1], gaps[len(gaps) // 2]) if gaps else (0.0, 0.0)


@torch.no_grad()
def _ref_grads(opts) -> dict:
    out = {}
    for n, opt in opts.items():
        for k, m in zip(opt.names, opt.m):
            out[f"{n}.{k}"] = float(m.norm() / (1 - BETA1))
    return out


def judge(cfg: dict, seed: int, dev, batches: list, prog: dict,
          cast=None) -> dict:
    """The compared numbers of the checked steps against the float32
    reference (``cast`` rounds its layers, for the control):

    - ``loss_err``: the largest relative gap of a player's loss over the
      checked steps;
    - ``grad_err``: the worst leaf's gap of its first-gradient norm;
    - ``delta_err``: the worst leaf's gap of its change after the checked
      steps, parameters and BatchNorm statistics.  Each leaf is measured
      against its own player's median, so a player whose state did not
      move reads 1 here however few leaves it has; the pooled medians
      (``grad_med``, ``delta_med``) would not see it.

    A leaf whose reference gradient is under a thousandth of its player's
    median leaf is left out of the change (Adam moves it by round-off)."""
    rows = [len(b["writer_ids"]) for b in batches]
    if len(prog["feeds"]) != len(batches) or any(
            f.shape[0] != n for fs, n in zip(prog["feeds"], rows) for f in fs):
        # the program decoded other rows than the batch holds
        return dict.fromkeys(NUMBERS, float("inf"))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        init = {p: weights.draw(cfg, p, seed, dev) for p in rstep.PLAYERS}
        models = {p: weights.materialize(cfg, p, init[p], dev)
                  for p in rstep.PLAYERS}
        if cast is not None:
            for m in models.values():
                ref.set_cast(m, cast)
        opts = rstep.make_opts(models, cfg)
        for n, opt in opts.items():
            opt.names = [k for k, _ in models[n].named_parameters()]
        gen = torch.Generator(device=dev).manual_seed(dropout_seed(seed))
        loss_err = loss1 = 0.0
        firsts = FirstOutputs(models, cfg)
        for k, b in enumerate(batches):
            feeds = tuple(f.to(dev) for f in prog["feeds"][k])
            with torch.enable_grad():
                losses = rstep.step(models, opts, device_batch(b, dev), gen,
                                    cfg, feeds)
            for n in LOSSES:
                r = float(losses[n])
                gap = abs(prog["loss"][k][n] - r) / max(abs(r), 1e-30)
                loss_err = max(loss_err, gap)
                if k == 0:
                    loss1 = max(loss1, gap)
            if k == 0:
                ref_grad = _ref_grads(opts)
                ref_first = firsts.close()
        delta = changes(models, init)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    meds = {}
    for player in rstep.PLAYERS:
        v = sorted(g for k, g in ref_grad.items()
                   if k.startswith(player + "."))
        meds[player] = v[len(v) // 2]

    def moved(k):   # a parameter the reference's gradient moves, or a stat
        if k not in ref_grad:
            return True
        return ref_grad[k] >= 1e-3 * meds[k.split(".", 1)[0]]

    out = {"loss_err": loss_err, "loss1_err": loss1}
    for n in ("fake", "dis", "cla", "rec"):
        both = ("dis", "dis_ch1") if n == "dis" else (n,)
        mine = [prog["first"].get(k, torch.zeros(0)) for k in both]
        out[f"{n}_rel"] = rel(torch.cat(mine) if all(
            m.shape[1:] == mine[0].shape[1:] for m in mine) else mine[0],
            torch.cat([ref_first[k] for k in both]))
    out["grad_err"], out["grad_med"] = _gaps(prog["grad"], ref_grad,
                                             lambda k: True)
    out["delta_err"], out["delta_med"] = _gaps(prog["delta"], delta, moved)
    return out
