"""The port's multi-device layer on the CPU over gloo: the mesh, the batch
placement, the global-batch BatchNorm, the sharded word step, the sharded
serving pipeline and both trainers on a mesh.

Ranks are fresh processes (``parallel/multihost.spawn``) running the
torch-only programs of ``tests/torch_dist_workers.py`` over a file store
in a temporary directory, one thread each, with ``PYTHONHASHSEED`` fixed
(the synthetic words and lines seed from string hashes); every collective
gives up after ``TIMEOUT_S`` and every spawn after ``SPAWN_TIMEOUT_S``.  The ranks write ``.npz``
files; this process holds the references: the port's single-process step
and trainers, and the JAX package's ``make_sharded_pipeline`` on a 2-device
slice of the 8 virtual CPU devices.

Limits: the word step's are ``tests/test_parallel_dp.py``'s (losses rtol
5e-5; the SGD-updated parameters per player, gen 5e-3, dis and cla 1e-7,
rec 5e-6, with dis and cla at 5e-7 on the TP mesh), the sharded step
against the port's single-process step, which the train-step tests tie to
the JAX step.  The pipeline's images are held at atol 2e-5 against the
port's own single-device pipeline, and against the JAX sharded pipeline at
2e-5 above the single-device port's gap to it (~2.5e-5 at these random
weights: f32 arithmetic of the two packages, not the sharding); tokens
within the 2% budget of ``_assert_tokens_agree``.
"""

import os
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from affganwriting_torch.parallel.multihost import spawn

torch.set_num_threads(2)   # tier-1 runs six xdist workers

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
WORDS = ["word", "deep", "mesh", "chip", "data", "axis", "text", "pens"]


def _spawn(fn: str, world: int, out) -> None:
    env = {**os.environ, "PYTHONPATH": f"{ROOT}{os.pathsep}{TESTS}",
           "PYTHONHASHSEED": "0"}
    spawn(f"torch_dist_workers:{fn}", world, str(out),
          timeout_s=W.SPAWN_TIMEOUT_S, env=env, cwd=str(TESTS))


def _load(out, case: str, rank: int = 0) -> dict:
    with np.load(os.path.join(out, f"{case}_r{rank}.npz")) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def jax_pipeline():
    """The JAX serving pair at the tiny config (its own seeded init), its
    weights converted for the port, and the JAX sharded pipeline's outputs
    on data=2 and on model=2."""
    from affganwriting_tpu.core.config import default_config
    from affganwriting_tpu.gen.inference import (
        encode_labels,
        make_sharded_pipeline,
    )
    from affganwriting_tpu.parallel.mesh import make_mesh
    from affganwriting_tpu.train.state import build_models
    from affganwriting_torch.utils.from_flax import from_flax
    from test_torch_support import to_numpy_tree

    cfg = default_config().replace(**W.CFG)
    gen, _, _, rec = build_models(cfg)
    rng = np.random.default_rng(3)
    style = np.asarray(rng.normal(size=(1, cfg.img_height, cfg.img_width,
                                        cfg.style_stack)), np.float32)
    labels = encode_labels(WORDS, cfg.output_max_len)
    gen_vars = jax.jit(gen.init)(jax.random.key(0), style, labels[:1])
    img0 = np.zeros((1, cfg.img_height, cfg.img_width, 1), np.float32)
    rec_vars = jax.jit(rec.init)(jax.random.key(1), img0, labels[:1])
    out = {"style": style, "labels": labels}
    for name, (data, model) in (("pipe_dp", (2, 1)), ("pipe_tp", (1, 2))):
        mesh = make_mesh(jax.devices()[:2], data=data, model=model)
        images, ids = make_sharded_pipeline(cfg, mesh)(
            gen_vars, rec_vars, style, labels)
        out[name] = (np.asarray(images), np.asarray(ids))
    out["weights"] = from_flax(to_numpy_tree(gen_vars),
                               to_numpy_tree(rec_vars), W.config())
    return out


@pytest.fixture(scope="module")
def two(tmp_path_factory, jax_pipeline):
    out = tmp_path_factory.mktemp("two_ranks")
    torch.save(dict(zip(("gen", "rec"), jax_pipeline["weights"])),
               out / "pipeline_weights.pt")
    np.savez(out / "pipeline_inputs.npz", style=jax_pipeline["style"],
             labels=jax_pipeline["labels"])
    _spawn("two_ranks", 2, out)
    return out


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    out = tmp_path_factory.mktemp("four_ranks")
    _spawn("four_ranks", 4, out)
    return out


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """The trainers on a data=2 mesh, then (rank 0) without a mesh."""
    out = tmp_path_factory.mktemp("trainers")
    _spawn("trainers", 2, out)
    return out


def test_parse_mesh_spec():
    from affganwriting_torch.parallel.mesh import mesh_dims

    assert mesh_dims("none", 8) is None
    assert mesh_dims("", 8) is None
    assert mesh_dims("auto", 8) == (8, 1)
    assert mesh_dims("8", 8) == (8, 1)
    assert mesh_dims("4x2", 8) == (4, 2)
    with pytest.raises(ValueError, match="needs 8 processes, but "
                       "WORLD_SIZE is 2"):
        mesh_dims("4x2", 2)
    with pytest.raises(ValueError, match="needs 4 processes"):
        mesh_dims("4", 8)
    with pytest.raises(ValueError, match="expected 'none', 'auto'"):
        mesh_dims("two", 2)


def test_tp_rule_drift_fails_loudly():
    """A parameter tree with no TP-rule match on a model>1 mesh raises
    instead of silently replicating (``expect_tp``, ``shard_state``); the
    port's G matches the rules on its text encoder and mix."""
    from affganwriting_torch.models.generator import Generator
    from affganwriting_torch.parallel.mesh import (
        param_shardings,
        shard_state,
    )
    from affganwriting_torch.train.state import PlayerState, WordGanState

    mesh = types.SimpleNamespace(data=4, model=2)
    no_match = torch.nn.ModuleDict({"encoder": torch.nn.Conv2d(4, 8, 3)})
    with pytest.raises(ValueError, match="_TP_RULES"):
        param_shardings(mesh, no_match, expect_tp=True)
    player = PlayerState(no_match, None)
    with pytest.raises(ValueError, match="_TP_RULES"):
        shard_state(mesh, WordGanState(0, player, player, player, player))
    # without the expectation (legitimately replicated trees) all replicate
    assert set(param_shardings(mesh, no_match).values()) == {None}
    with torch.device("meta"):
        gen = Generator(W.config())
    specs = {k: v for k, v in param_shardings(
        mesh, gen, expect_tp=True).items() if v is not None}
    assert specs == {"text_encoder.fc0.weight": 0, "text_encoder.fc0.bias": 0,
                     "text_encoder.fc1.weight": 0, "text_encoder.fc1.bias": 0,
                     "text_encoder.fc2.weight": 0, "text_encoder.fc2.bias": 0,
                     "linear_mix.weight": 1}


def test_global_batch_matches_shard_batch(two):
    """Each rank's ``global_batch`` of its own slice is ``shard_batch`` of
    the global batch at that rank; slices of unequal size raise on every
    rank."""
    for rank in (0, 1):
        d = _load(two, "global_batch", rank)
        keys = [k[4:] for k in d if k.startswith("got/")]
        assert len(keys) == 6
        for k in keys:
            np.testing.assert_array_equal(d[f"got/{k}"], d[f"want/{k}"])
            assert d[f"got/{k}"].shape[0] == 4
        assert "unequal slices" in str(d["unequal"])


def test_global_batch_norm_matches_one_process(two):
    """A train-mode ``BatchNorm`` with its statistics summed over 2 ranks
    equals one process on the whole batch: outputs, input gradients,
    parameter gradients and running statistics (flax's fast variance and
    biased running update, not ``SyncBatchNorm``'s)."""
    rng = np.random.default_rng(5)
    x = rng.normal(2.0, 3.0, size=(8, 6, 3, 5)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    want = W.bn_case(None, x, w)
    got = [_load(two, "bn", r) for r in (0, 1)]
    for k in ("y", "x_grad"):
        np.testing.assert_allclose(np.concatenate([g[k] for g in got]),
                                   want[k], rtol=0, atol=1e-5, err_msg=k)
    for k in ("w_grad", "b_grad", "running_mean", "running_var"):
        for g in got:
            np.testing.assert_allclose(g[k], want[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_rec_loss_on_unequal_pad_shards(two):
    """R's loss is sum-reduced over the rows, and the halves of this batch
    hold unequal counts of PAD targets (short words, then long): the sum of
    the ranks' sums and gradients is the whole batch's (per leaf within
    1e-2 relative L2 against 1e-3 of the largest leaf's norm at least: R's
    f32 trunk of train-mode BatchNorms and ReLUs reassociates to ~4e-3 on
    its first conv, the level of the JAX DP test's R limit), while
    averaging the ranks' gradients (DDP) would hand the optimizer half of
    it."""
    d = _load(two, "rec_loss", 0)
    other = _load(two, "rec_loss", 1)
    assert int(d["pads"]) > 2 * int(other["pads"])
    assert abs(float(d["loss_mine"]) - float(other["loss_mine"])) \
        > 0.1 * float(d["loss"])
    np.testing.assert_allclose(float(d["loss"]), float(d["want_loss"]),
                               rtol=1e-5)
    leaves = [k[4:] for k in d if k.startswith("err/")]
    assert len(leaves) > 20
    for k in leaves:
        assert float(d[f"err/{k}"]) <= 1e-2, (k, float(d[f"err/{k}"]))
        if float(d[f"norm/{k}"]) > float(d["floor"]):
            assert float(d[f"ddp_err/{k}"]) > 0.4, k


def _check_step(ranks: list, tight: float):
    """Rank 0's sharded step against the single-process one it also ran;
    every rank's state equal to rank 0's, bit for bit."""
    d = ranks[0]
    metrics = [k[5:] for k in d if k.startswith("want/")]
    assert len(metrics) == 8
    for k in metrics:
        want = float(d[f"want/{k}"])
        assert np.isfinite(want), k
        np.testing.assert_allclose(float(d[f"m/{k}"]), want, rtol=5e-5,
                                   atol=1e-5, err_msg=k)
    limits = {"gen": 5e-3, "dis": tight, "cla": tight, "rec": 5e-6}
    for player, lim in limits.items():
        assert float(d[f"maxdiff/{player}"]) <= lim, (
            player, float(d[f"maxdiff/{player}"]))
    for r in ranks[1:]:
        assert str(r["digest"]) == str(d["digest"])
        for k in metrics:
            assert float(r[f"m/{k}"]) == float(d[f"m/{k}"]), k


def test_word_step_dp_matches_one_process(two):
    """The SGD word step at data=2 (the batch's halves hold unequal PAD
    counts; R's dropout masks drawn for the global batch) equals the
    single-process step: losses, and every player's updated parameters
    and BatchNorm statistics; both ranks hold the same state."""
    _check_step([_load(two, "step_dp", r) for r in (0, 1)], 1e-7)


def test_word_step_tp_matches_one_process(four):
    """The same step on data=2 x model=2: the text encoder's FC pyramid
    split on its output features and the mix on its input rows over
    'model' (gathered whole for the comparison), the batch over 'data'.
    The four ranks end with the same state, bit for bit."""
    _check_step([_load(four, "step_tp", r) for r in range(4)], 5e-7)


@pytest.mark.parametrize("case", ["pipe_dp", "pipe_tp"])
def test_sharded_pipeline_matches_jax(two, jax_pipeline, case):
    """``make_sharded_pipeline`` on 2 ranks (data=2; then 1x2, G's text
    encoder and mix split over 'model') against the JAX package's
    ``make_sharded_pipeline`` on 2 devices, same weights via
    ``utils/from_flax``; every rank holds the gathered outputs.  With two
    writers' stacks word i takes stack i % 2 as in the single-device
    pipeline.  A label batch that does not divide over 'data' raises."""
    from affganwriting_torch.gen.inference import make_generate_and_read_fn
    from test_parallel_dp import _assert_tokens_agree

    images, ids = jax_pipeline[case]
    style, labels = jax_pipeline["style"], jax_pipeline["labels"]
    base_img, base_ids = make_generate_and_read_fn(
        W.config(), *jax_pipeline["weights"], device="cpu")(style, labels)
    base_img = base_img.numpy()
    gap = float(np.abs(base_img - images).max())
    two_style = np.concatenate([style, -style])
    two_img = make_generate_and_read_fn(
        W.config(), *jax_pipeline["weights"], device="cpu")(
            two_style, labels)[0].numpy()
    for rank in (0, 1):
        d = _load(two, case, rank)
        assert d["images"].shape == images.shape
        np.testing.assert_allclose(d["images"], base_img, rtol=0, atol=2e-5)
        np.testing.assert_allclose(d["two_writers"], two_img, rtol=0,
                                   atol=2e-5)
        np.testing.assert_allclose(d["images"], images, rtol=0,
                                   atol=2e-5 + gap)
        _assert_tokens_agree(d["ids"], ids, budget=0.02)
        _assert_tokens_agree(d["ids"], base_ids.numpy(), budget=0.02)
        if case == "pipe_dp":
            assert "does not divide over the 2-way data axis" in str(
                d["err"])
        else:   # one rank holds each half of the FC outputs and mix rows
            assert int(d["fc1_rows"]) == 1024
            assert int(d["mix_cols"]) == W.CFG["style_dim"]


def test_word_trainer_on_mesh(trainers):
    """``WordGanTrainer`` on data=2: the epoch's train and eval metrics
    (global-batch losses, CER counts summed over the ranks) equal the
    single process's; rank 0 alone writes the metrics and one set of
    checkpoint files; a trainer built again on the logdir restores the
    same state on both ranks, which hold equal replicas."""
    import json

    ranks = [_load(trainers, "word_trainer", r) for r in (0, 1)]
    got = json.loads(str(ranks[0]["metrics"]))
    want = json.loads(str(ranks[0]["want_metrics"]))
    assert [g["group"] for g in got] == [w["group"] for w in want] == [
        "train", "eval"]
    for g, w in zip(got, want):
        group = w["group"]
        for k, v in w.items():
            if k in ("step", "time", "group", "epoch_seconds",
                     "steps_per_sec"):
                continue
            if k.startswith("cer"):
                assert abs(g[k] - v) <= 3.0, (group, k, g[k], v)
            else:
                rtol = 5e-5 if group == "train" else 2e-3
                np.testing.assert_allclose(g[k], v, rtol=rtol, atol=1e-5,
                                           err_msg=f"{group} {k}")
    assert json.loads(str(ranks[1]["metrics"])) == []
    for d in ranks:
        assert list(d["ckpt_files"]) == [
            "best", "best.config.json", "best.metric.json", "latest",
            "latest.config.json"]
        assert bool(d["restored_equal"])
        assert int(d["start_epoch"]) == 1 and int(d["step"]) == 1
    assert str(ranks[0]["digest"]) == str(ranks[1]["digest"])


def test_line_trainer_on_mesh(trainers):
    """One auto and one disc lesson of ``LineGanTrainer`` on data=2 (2
    lines a rank; each rank aligns its own lines) against the same lessons
    in one process: the metrics, and per leaf the gradients each lesson
    hands its optimizers (relative L2, 1e-2: ~1e-4 measured; a gradient
    missing its all-reduce is ~0.5 off); both ranks hold equal replicas
    after."""
    d, other = (_load(trainers, "line", r) for r in (0, 1))
    metrics = [k[5:] for k in d if k.startswith("want/")]
    assert any("auto" in k for k in metrics)
    assert any(k.startswith("m/disc/") for k in metrics)
    for k in metrics:
        assert np.isfinite(float(d[f"want/{k}"]))
        np.testing.assert_allclose(float(d[k]), float(d[f"want/{k}"]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        assert float(other[k]) == float(d[k]), k
    errs = {k[4:]: float(v) for k, v in d.items() if k.startswith("err/")}
    assert any(k.startswith("g_main/") for k in errs)
    assert any(k.startswith("g_disc/") for k in errs)
    worst = max(errs.items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-2, worst
    assert str(d["digest"]) == str(other["digest"])


def test_dtype_policy_matches_jax():
    import jax.numpy as jnp

    from affganwriting_torch.core import DtypePolicy
    from affganwriting_tpu.core import DtypePolicy as JaxPolicy

    for compute in ("bfloat16", "float32", "float16"):
        p, jp = DtypePolicy(compute=compute), JaxPolicy(compute=compute)
        assert str(p.compute_dtype) == f"torch.{jnp.dtype(jp.compute_dtype)}"
        assert p.param_dtype == torch.float32
        x = np.linspace(-3, 3, 7).astype(np.float32) / 3.0
        got = p.cast_compute(x)
        assert got.dtype == p.compute_dtype
        np.testing.assert_array_equal(
            got.float().numpy(),
            np.asarray(jp.cast_compute(x).astype(jnp.float32)))


def test_init_distributed_noop_single_host(monkeypatch):
    from affganwriting_torch.parallel.multihost import init_distributed

    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed(device="cpu") is False
