"""The float32 reference agrees with the port computing in float32, at a
tiny size on the CPU: serving (G's images, R's per-step logits fed the
port's ids) for both style encoders, and the merged step's first losses
and R's and C's updates."""

import dataclasses

import pytest
import torch

from benchmark.harness import data, traffic, weights
from benchmark.harness import train as T
from benchmark.reference import models as ref
from benchmark.reference import step as rstep
from benchmark.tests import tiny

DEV = torch.device("cpu")


def f32(cell):
    cell["config_file"]["config"]["compute_dtype"] = "float32"
    return cell


@pytest.mark.parametrize("encoder", ["resnet50", "dinov2_l"])
def test_serving_agrees(encoder):
    from affganwriting_torch.gen.inference import make_generate_and_read_fn
    from affganwriting_torch.core.config import WordGanConfig

    cfg = f32(tiny.synth())["config_file"]["config"]
    cfg["style_encoder"] = encoder
    fields = {f.name for f in dataclasses.fields(WordGanConfig)}
    pc = WordGanConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in cfg.items() if k in fields})
    w = {p: weights.draw(cfg, p, 7, DEV) for p in ("gen", "rec")}
    run = make_generate_and_read_fn(pc, w["gen"], w["rec"], device=DEV)
    pool = data.StylePool(3, cfg, 2, DEV)
    labels = data.encode_labels(data.corpus()[:3], 12)
    tap = ref.tap(cfg, run.rec)
    imgs, ids = run(pool.stacks[:1], labels)
    (logits, fed), = tap.take()()
    g = weights.materialize(cfg, "gen", w["gen"], DEV).eval()
    r = weights.materialize(cfg, "rec", w["rec"], DEV).eval()
    with torch.no_grad():
        lab = torch.as_tensor(labels)
        x = g.generate(g.encode_style(torch.as_tensor(pool.stacks[:1])), lab)
        rl = r(imgs.permute(0, 3, 1, 2).float(), lab, feed=ids)
    torch.testing.assert_close(x.permute(0, 2, 3, 1), imgs, atol=2e-4,
                               rtol=0)
    torch.testing.assert_close(rl, logits, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(fed, ids, atol=0, rtol=0)


def test_first_step_agrees():
    cell = f32(tiny.train())
    cfg, mix = cell["config_file"]["config"], cell["traffic_mix"]
    pool = data.StylePool(5, cfg, mix["writers"], DEV)
    w = {p: weights.draw(cfg, p, 5, DEV) for p in rstep.PLAYERS}
    state, step = T.make_program(cfg, w, DEV)
    b = next(traffic.train_batches(mix, 5, pool, data.corpus(), cfg))
    tap = T.IdTap(state.rec.model, cfg)
    _, metrics, _ = step(state, b, torch.Generator().manual_seed(1))
    tap.close()
    models = {p: weights.materialize(cfg, p, w[p], DEV) for p in rstep.PLAYERS}
    opts = rstep.make_opts(models, cfg)
    losses = rstep.step(models, opts, T.device_batch(b, DEV),
                        torch.Generator().manual_seed(1), cfg, tap.feeds(0))
    for k in T.LOSSES:
        torch.testing.assert_close(losses[k], metrics[k].float(), rtol=1e-5,
                                   atol=0)
    for p in ("rec", "cla"):
        mine = dict(models[p].named_parameters())
        for name, v in getattr(state, p).model.named_parameters():
            torch.testing.assert_close(mine[name], v, atol=1e-6, rtol=0)
