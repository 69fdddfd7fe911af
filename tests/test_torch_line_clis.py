"""The line stack's CLIs on the CPU, through ``main([... "--device",
"cpu"])``: ``train_hwr`` and ``train_auto`` (a few iterations of 64 x 128
lines), ``train_line`` with ``--pretrained-hwr``, ``--pretrained-ae`` and
``--xml-root`` on an IAM-format checkout (``tools/iam_fixture``), its
restore, ``evaluate_line`` on its checkpoint (synthetic lines and
``--xml-root``), the headless ``line_repl`` through every action, and the
two profilers on the small word configuration (``default_config``
patched, as ``tests/test_torch_cli.py`` patches ``train_word``'s).

``train_line`` builds the line models at their published widths (cut to
``--max-gen-length 32``); the spliced recognizer and AE are held bit for
bit against the two files.  TensorBoard is kept out (its import pulls in
a large framework here).
"""

import json
import os

import numpy as np
import pytest
import torch

from affganwriting_torch.cli import (
    evaluate_line,
    line_repl,
    profile_gen,
    profile_pipeline,
    train_auto,
    train_hwr,
    train_line,
)
from affganwriting_torch.core.checkpoint import (
    load_swapped,
    restore_line_trainer,
)
from affganwriting_torch.tools.iam_fixture import write_iam_checkout
from test_torch_support import small_torch_config

torch.set_num_threads(2)   # tier-1 runs six xdist workers


@pytest.fixture(scope="module")
def line_run(tmp_path_factory):
    """hwr_final, ae_final, an IAM checkout and a 2-iteration train_line
    run with all three."""
    import affganwriting_torch.utils.logging as logging

    saved = logging.summary_writer
    logging.summary_writer = lambda logdir: None
    try:
        root = tmp_path_factory.mktemp("line")
        small = ["--iterations", "2", "--batch-size", "2", "--width", "128",
                 "--device", "cpu"]
        model, hwr_path = train_hwr.main(
            small + ["--logdir", str(root / "hwr"), "--save-every", "1"])
        trainer, state, ae_path = train_auto.main(
            small + ["--logdir", str(root / "auto")])
        xml_dir, _ = write_iam_checkout(str(root / "iam"))
        logdir = str(root / "gan")
        tr, st = train_line.main([
            "--iterations", "2", "--max-gen-length", "32", "--logdir", logdir,
            "--pretrained-hwr", hwr_path, "--pretrained-ae", ae_path,
            "--xml-root", xml_dir, "--image-root", str(root / "iam"),
            "--val-every", "2", "--val-batches", "1", "--sheet-every", "0",
            "--restart-rss-gb", "0", "--device", "cpu"])
        yield dict(root=root, hwr=hwr_path, ae=ae_path, xml=xml_dir,
                   ckpt=os.path.join(logdir, "ckpt"), trainer=tr, state=st,
                   hwr_model=model, auto_state=state)
    finally:
        logging.summary_writer = saved


def _equal(sd: dict, want: dict) -> bool:
    return set(sd) == set(want) and all(torch.equal(sd[k].cpu(), want[k])
                                        for k in want)


def test_pretrain_files_splice_bit_for_bit(line_run):
    hwr = load_swapped(line_run["hwr"])
    ae = load_swapped(line_run["ae"])
    assert set(hwr) == {"params", "batch_stats"} and set(ae) == {"params"}
    assert hwr["params"]["c1d_out.weight"].shape == (80, 512, 3)
    assert any(k.startswith("e_hwr.") for k in ae["params"])
    # the files hold what the two trainers ended with
    assert _equal({k: v for k, v in line_run["hwr_model"].state_dict()
                   .items()}, {**hwr["params"], **hwr["batch_stats"]})
    assert _equal(line_run["auto_state"].ae.state_dict(), ae["params"])
    lines = [json.loads(s) for s in open(os.path.join(
        os.path.dirname(line_run["hwr"]), "metrics.jsonl"))]
    assert [r["group"] for r in lines] == ["hwr"] and \
        np.isfinite(lines[0]["ctc"])
    # the trainer's frozen HWR and AE are the files, E_HWR dropped; a
    # restore reads them again, then the checkpoint
    plain_ae = {k: v for k, v in ae["params"].items()
                if not k.startswith("e_hwr.")}
    st = line_run["state"]
    assert _equal(st.model.hwr.state_dict(),
                  {**hwr["params"], **hwr["batch_stats"]})
    assert _equal(st.ae.state_dict(), plain_ae)
    tr, payload = restore_line_trainer(line_run["ckpt"], device="cpu")
    assert tr.pretrained_hwr == line_run["hwr"]
    assert tr.pretrained_ae == line_run["ae"]
    assert _equal(payload["state"].model.hwr.state_dict(),
                  {**hwr["params"], **hwr["batch_stats"]})
    assert _equal(payload["state"].ae.state_dict(), plain_ae)
    assert payload["iteration"] == 2


@pytest.mark.parametrize("xml", [False, True], ids=["synthetic", "xml_root"])
def test_evaluate_line_on_the_checkpoint(line_run, tmp_path, xml):
    out = str(tmp_path / "eval.json")
    argv = ["--ckpt", line_run["ckpt"], "--ckpt-name", "latest",
            "--max-batches", "2", "--out", out, "--device", "cpu"]
    if xml:
        argv += ["--xml-root", line_run["xml"], "--image-root",
                 str(line_run["root"] / "iam"), "--split", "train"]
    res = evaluate_line.main(argv)
    assert json.load(open(out)) == res
    assert {"rec_cer", "gen_cer", "recon_l1", "wer", "top1",
            "top5"} <= set(res)
    assert all(np.isfinite(v) for v in res.values())


def test_line_repl_runs_every_action_headless(line_run, tmp_path):
    out = tmp_path / "repl"
    p1, p2 = out / "interp0.png", out / "interp1.png"
    script = ";".join([
        "a", "r", "2", "hello there", "s", "0", "v", "2", "gaussian", "m",
        "", "", "", "A", "", "R", "2", "", "t", "1", "f", str(p1), str(p2),
        "transfer", "u", "h", "q"])
    line_repl.main(["--ckpt", line_run["ckpt"], "--out", str(out),
                    "--script", script, "--device", "cpu"])
    names = set(os.listdir(out))
    for want in ("interp0.png", "interp1.png", "vae0.png", "vae1.png",
                 "math.png", "average.png", "rand0.png", "rand1.png",
                 "transfer0.png", "transfer3.png", "umap_sheet.png",
                 "gen0_0.png", "mturk"):
        assert want in names, (want, sorted(names))
    assert sorted(os.listdir(out / "mturk")) == [
        "gen_0.png", "genfalse_0.png", "real_0.png", "text.csv"]
    from PIL import Image

    with Image.open(out / "interp0.png") as im:
        assert im.size == (4 * 32, 64)


@pytest.mark.parametrize("cli", ["profile_pipeline", "profile_gen"])
def test_profilers_run_on_the_cpu(monkeypatch, capsys, cli):
    mod = {"profile_pipeline": profile_pipeline,
           "profile_gen": profile_gen}[cli]
    monkeypatch.setattr(mod, "default_config", small_torch_config)
    argv = ["--batch", "4", "--n-stream", "1", "--device", "cpu"]
    if cli == "profile_pipeline":
        argv += ["--train-batch", "2", "--stages",
                 "style_encode,generate,rec_full,rec_trunk,rec_encoder,"
                 "train_step,train_phases"]
        stages = ["train_step"] + [f"train_phase/{k}" for k in (
            "rec", "cla", "dis", "gen", "dis_gen", "TOTAL")] + [
            "style_encode", "generate", "rec_full", "rec_trunk",
            "rec_encoder"]
    else:
        stages = ["text_mix", "res", "res_plain", "upchain"]
    rows = mod.main(argv)
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert printed == rows and [r["stage"] for r in rows] == stages
    for r in rows:
        assert r["device"] == "cpu"
        if "mfu" in r:
            # a CPU run has no device peaks
            assert r["mfu"] is None and r["hbm_frac"] is None
            assert r["gflops_per_call"] > 0 and r["gbytes_per_call"] > 0
            assert r["gbytes_is"] == "no-fusion upper bound"
    if cli == "profile_gen":
        res, plain = rows[1], rows[2]
        assert res["gbytes_per_call"] > plain["gbytes_per_call"]



def test_op_counts_add_the_kernels_reported_work():
    """The port's CUDA kernels launch through ``ctypes``, which no torch
    dispatch mode sees; their wrappers report each launch's work
    (``cuda_build.count_work``) to every open ``work_counter``, and
    ``op_counts`` adds it to ``FlopCounterMode``'s and ``ByteCounter``'s
    counts.  The kernels themselves report on the card (``chip_smoke.py``
    phase 13f holds their reports against ``cli/bench_kernels``' bound
    inputs)."""
    from affganwriting_torch.ops import cuda_build
    from affganwriting_torch.utils.profiling import op_counts

    a, b = torch.ones(8, 16), torch.ones(16, 4)
    base = op_counts(lambda: a @ b)
    assert base == {"flops": 2 * 8 * 16 * 4,
                    "bytes": (8 * 16 + 16 * 4 + 8 * 4) * 4}

    def fn():
        a @ b
        cuda_build.count_work(1e9, 2e6)

    with cuda_build.work_counter() as outer:
        got = op_counts(fn)
    assert got == {"flops": base["flops"] + 1e9,
                   "bytes": base["bytes"] + 2e6}
    assert outer == {"flops": 1e9, "bytes": 2e6}
    cuda_build.count_work(1.0, 1.0)       # no counter open: nothing kept
    assert outer == {"flops": 1e9, "bytes": 2e6}
    assert not cuda_build._work_counters