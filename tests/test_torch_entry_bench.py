"""The port's entry point, its bench CLIs, the sweep and the job emitter,
on the CPU.

- ``entry(device="cpu")``: the JAX entry's example arguments exactly (the
  same 8 words, the style stack from ``np.random.default_rng(0)``), and
  one call at ``default_config()`` giving finite images (8, 64, 216, 1) in
  [-1, 1];
- ``cli/bench``: its flags, the one-JSON-line result shape of the JAX
  bench, ``--headline fp8`` refused (int8, as in the JAX package, is the
  only quantized mode), ``--headline int8`` raising without a card (as
  every stage does: tests/test_torch_hygiene.py), and the order and keys of
  the lines it prints with ``--headline int8`` and ``bf16``, the stages'
  rates stubbed (the stages run on the card: ``chip_smoke.py`` phases 9e
  and 10c);
- ``cli/bench_kernels``: its flags and the JSON lines of a result;
- ``train/sweep.py``: the JAX package's trial configs, best trial and saved
  study, exactly, for the same seed;
- ``cli/emit_jobs``: the JAX package's scripts, byte for byte but for the
  package name in the command.
"""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(2)   # tier-1 runs six xdist workers


def test_entry_builds_the_jax_entrys_arguments_and_runs_on_the_cpu():
    from affganwriting_tpu.core.config import default_config as jdefault
    from affganwriting_tpu.gen.inference import encode_labels as jencode
    from affganwriting_torch.entry import WORDS, entry

    fn, (style, labels) = entry(device="cpu")
    cfg = jdefault()
    want_style = np.asarray(np.random.default_rng(0).normal(
        size=(1, cfg.img_height, cfg.img_width, cfg.style_stack)),
        np.float32)
    assert WORDS == ["the", "quick", "brown", "fox", "jumps", "over",
                     "lazy", "dog"]
    np.testing.assert_array_equal(style, want_style)
    np.testing.assert_array_equal(labels,
                                  jencode(WORDS, cfg.output_max_len))
    images = fn(style, labels)
    assert tuple(images.shape) == (8, 64, 216, 1)
    img = images.float()
    assert bool(torch.isfinite(img).all()) and float(img.abs().max()) <= 1


def test_bench_flags_and_int8_refusal(capsys):
    from affganwriting_torch.cli import bench

    with pytest.raises(SystemExit) as e:
        bench.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--batch" in out and "--quick" in out and "--headline" in out
    with pytest.raises(SystemExit) as e:
        bench.main(["--headline", "fp8"])
    assert e.value.code == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.main(["--headline", "int8", "--batch", "8"])


@pytest.mark.parametrize("headline", ["int8", "bf16"])
def test_bench_headline_lines(headline, capsys, monkeypatch):
    """The headline's stage runs first and gives ``value``; ``--quick``
    stops after the headline stages; without it the int8 stage follows the
    bf16 one.  The stages and the card's identity are stubbed."""
    from affganwriting_torch.cli import bench
    from affganwriting_torch.gen import inference
    from affganwriting_torch.tools import timing

    monkeypatch.setattr(inference, "resolve_device", lambda d: "cuda")
    monkeypatch.setattr(timing, "nvidia_smi_line", lambda: "card, 700 W")
    monkeypatch.setattr(bench, "fetch_floor_ms", lambda: 0.02)
    ran = []

    def stage(name, rates):
        def fn(b):
            ran.append(name)
            return rates
        fn.__name__ = name
        return fn

    monkeypatch.setattr(bench, "run_gen_read_int8",
                        stage("int8", {"stream": 2500.0}))
    monkeypatch.setattr(bench, "run_gen_read", stage("bf16", {
        "stream": 4000.0, "fetch_stream": 3500.0, "fetch_mb_per_sec": 99.0,
        "percall": 3900.0}))
    monkeypatch.setattr(bench, "run_gen_only", stage("gen_only", None))
    monkeypatch.setattr(bench, "run_train_step", stage("train", None))
    for quick in (True, False):
        ran.clear()
        capsys.readouterr()
        result = bench.main(["--batch", "8", "--headline", headline]
                            + ["--quick"] * quick)
        lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
        assert lines[-1] == result
        want = 2500.0 if headline == "int8" else 4000.0
        assert {x["value"] for x in lines} == {want}
        assert lines[0]["metric"].endswith("(w8a8 serving mode)") == \
            (headline == "int8")
        order = ["int8", "bf16"] if headline == "int8" else ["bf16"]
        if not quick:
            order = (order + ["gen_only", "train"] if headline == "int8"
                     else order + ["int8", "gen_only", "train"])
        assert ran == order
        extra = result["extra"]
        if headline == "int8" or not quick:
            assert extra["gen_read_int8_imgs_per_sec"] == 2500.0
            assert extra["gen_read_int8_batch"] == 8
            assert extra["gen_read_int8_mode"] == bench.INT8_MODE
        assert extra["gen_read_bf16_imgs_per_sec"] == 4000.0


def test_bench_prints_the_jax_benchs_result_shape(capsys):
    from affganwriting_torch.cli import bench

    extra = {"gen_read_batch": 256, "gen_read_bf16_imgs_per_sec": 4000.04}
    result = bench._emit("generate+recognize 64x216 word images/sec/chip",
                         4000.04, extra)
    line = capsys.readouterr().out
    assert line.count("\n") == 1 and json.loads(line) == result
    assert result == {
        "metric": "generate+recognize 64x216 word images/sec/chip",
        "value": 4000.0, "unit": "images/sec/chip", "vs_baseline": 0.8,
        "extra": extra}


def test_bench_kernels_iters_is_the_event_pairs(monkeypatch, capsys):
    """``--iters`` (default 20, the JAX CLI's flag) is the number of CUDA
    event pairs each of ``kernel_times``' timings is the median of; the
    card, its build and its timings are stubbed here."""
    import affganwriting_torch.gen.inference as inference
    from affganwriting_torch.cli import bench_kernels
    from affganwriting_torch.ops import cuda_build
    from affganwriting_torch.tools import timing

    p = bench_kernels.parser()
    assert (p.parse_args([]).iters, p.parse_args([]).batch) == (20, 256)
    assert p.parse_args(["--iters", "5"]).iters == 5
    with pytest.raises(SystemExit):
        bench_kernels.main(["--iters", "0"])
    seen = []
    monkeypatch.setattr(inference, "resolve_device", lambda d: None)
    monkeypatch.setattr(cuda_build, "build", lambda: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "card")
    monkeypatch.setattr(timing, "nvidia_smi_line", lambda: "card, 1 W")
    monkeypatch.setattr(timing, "card_peaks", lambda name: ("SXM", None))

    def kernel_times(peaks, batch, log, iters):
        seen.append((batch, iters))
        return {}

    monkeypatch.setattr(bench_kernels, "kernel_times", kernel_times)
    monkeypatch.setattr(bench_kernels, "json_lines", lambda t, d: [])
    for argv, want in (([], (256, 20)), (["--iters", "5", "--batch", "8"],
                                          (8, 5))):
        bench_kernels.main(argv)
        assert seen.pop() == want


def test_bench_kernels_flags_and_lines(capsys):
    from affganwriting_torch.cli import bench_kernels

    with pytest.raises(SystemExit) as e:
        bench_kernels.main(["--help"])
    assert e.value.code == 0
    assert "--batch" in capsys.readouterr().out

    def row(shape):
        return {"shape": shape, "ms": 1.0, "plain_ms": 2.0,
                "library_ms": 3.0, "bound_ms": 0.5, "bound_by": "bytes"}

    times = {"in_relu": {"stages": [row([4, 256, 16, 54]),
                                    row([4, 128, 32, 108])]},
             "phase_head": dict(row([4, 256, 36, 112]),
                                batch8=dict(row([8, 256, 36, 112]),
                                            bound_by="operations"))}
    lines = bench_kernels.json_lines(times, "card")
    assert [(r["kernel"], r["shape"][0], r["bound_by"]) for r in lines] == [
        ("in_relu", 4, "bytes"), ("in_relu", 4, "bytes"),
        ("phase_head", 4, "bytes"), ("phase_head", 8, "operations")]
    for r in lines:
        assert set(r) == {"kernel", "shape", "dtype", "ms", "plain_ms",
                          "library_ms", "bound_ms", "bound_by", "device"}
        json.dumps(r)


def test_sweep_matches_jax(tmp_path):
    from affganwriting_tpu.core.config import default_config as jdefault
    from affganwriting_tpu.train import sweep as jsweep
    from affganwriting_torch.core.config import default_config
    from affganwriting_torch.train import sweep

    for seed in (0, 3):
        ours, theirs = sweep.Study(default_config(), seed=seed), \
            jsweep.Study(jdefault(), seed=seed)
        for i in range(4):
            a, b = ours.suggest(), theirs.suggest()
            assert a.to_json() == b.to_json()
            ours.report(float(i % 3))
            theirs.report(float(i % 3))
        assert ours.best == theirs.best
        ours.save(str(tmp_path / "ours.json"))
        theirs.save(str(tmp_path / "theirs.json"))
        assert (tmp_path / "ours.json").read_text() == \
            (tmp_path / "theirs.json").read_text()
    space = {"lr_gen": sweep.LogUniform(1e-4, 1e-2)}
    got = sweep.Study(default_config(), space, seed=5).run(
        lambda c: c.lr_gen, 3)
    want = jsweep.Study(jdefault(), {"lr_gen": jsweep.LogUniform(1e-4, 1e-2)},
                        seed=5).run(lambda c: c.lr_gen, 3)
    assert got == want


@pytest.mark.parametrize("flags", [
    [], ["--split", "train", "--shard", "3", "--writers-per-job", "5",
         "--corpus", "in_vocab", "--ckpt-name", "latest"]])
def test_emit_jobs_matches_jax(tmp_path, flags, capsys):
    from affganwriting_tpu.cli import emit_jobs as jemit
    from affganwriting_torch.cli import emit_jobs

    common = ["--ckpt", "runs/x/ckpt", "--gen-out", "runs/gen"] + flags
    ours = emit_jobs.main(common + ["--out", str(tmp_path / "ours")])
    theirs = jemit.main(common + ["--out", str(tmp_path / "theirs")])
    assert [p.split("/")[-1] for p in ours] == \
        [p.split("/")[-1] for p in theirs]
    assert len(ours) == (3 if flags else 1)
    for a, b in zip(ours, theirs):
        got, want = open(a).read(), open(b).read()
        assert "affganwriting_tpu" not in got
        assert got == want.replace("affganwriting_tpu.cli",
                                   "affganwriting_torch.cli")
        assert got.count("--writers") >= 1
