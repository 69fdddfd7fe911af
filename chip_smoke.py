"""On-card smoke of the PyTorch/CUDA port: builds the kernels, holds each
against its plain PyTorch version and the port on the card against the
port on the CPU, and drives every path of the port at full width with its
launch counts checked.  It times nothing: ``benchmark/run.py`` times the
port, and ``python -m affganwriting_torch.cli.bench_kernels`` the kernels.

    python3 chip_smoke.py

Needs one CUDA card (H100, ``sm_90a``) and ``nvcc``; with no card it exits
non-zero before printing any result.  Phases, each fatal on failure:

1. device and build: card, versions, ``nvidia-smi`` name and power limit;
   builds ``affganwriting_torch/csrc/*.cu`` and prints ``ptxas``'s
   registers and spills;
2. kernel parity at the main path's shapes (batch 64), f32 and bf16,
   including ReLU off and a duplicated plane; ``phase_head`` on both
   routes (f32: the CUDA-core kernel, 1e-4; bf16: the wgmma kernel,
   2^-6 x max(1, |ref|)), the bf16 route also at batch 1 and with a strip
   height that does not divide h, with one and with two 64-pixel halves;
   bf16 shapes the wgmma kernel does not take must raise;
3. reference: the port on the card vs the port on the CPU (plain versions,
   themselves held against the JAX package by ``tests/test_torch_*.py``) on
   a small fp32 config;
4. main path: ``default_config()`` (resnet50 G, seq2seq R, 64x216, bf16),
   random weights from a seed, three requests (1 writer x 256 words,
   1 x 8, 2 x 8) with the launch counters set to 0 just before and read
   just after, each generate call checked to capture the decoder on its
   wgmma route, and a repeated request to replay it;
5. none: the kernels' times are ``cli/bench_kernels``'s to print;
6. train: one merged step of the port on the card vs on the CPU (small
   fp32 config: losses, fakes, every player's delta, G's and R's new
   running statistics); then ``default_config()`` at full width (bf16,
   Adam, batch 8): 13 steps with finite losses, all four players moved,
   G's and R's running statistics moved and R's not in the G phase, no
   kernel launched by a train step; one eval step, which must capture the
   decoder; two 4-phase steps; two merged steps at batch 64;
7. trainer runtime at ``default_config()``: ``cli/train_word`` for 2 epochs
   of 16 writers (JSONL lines finite, ``latest``, ``step_00000001`` and
   ``best`` written, one capture of the decoder per eval over 2 batches,
   no launch in the train epochs), a resume on the same logdir that must
   be bit-equal to the last save (Adam moments and R's rate included) and
   train one more epoch, ``cli/generate_word`` from ``best`` with beams of
   3 and 1 and greedily (17 files each, one capture of the decoder a call,
   the width-1 beam reading as the greedy path), ``cli/inspect_ckpt``;
8. evaluation and the other style encoders: (a) on a small fp32 config,
   each of the eight new encoders' pyramids, ``InceptionV3Pool3``'s
   activations and ``FIDScorer``'s random features on the card against the
   CPU (1e-3 of max(1, |CPU|)); (b) each encoder at full width
   (``default_config().replace(style_encoder=...)``, bf16): one request of
   1 writer x 64 words through ``make_generate_and_read_fn`` (images finite,
   in [-1, 1], one capture of the decoder on its wgmma route), then four
   merged train steps at batch 8 (losses finite, all four players moved in
   the first, efficientnet's running statistics moved, inception's
   bit-unchanged);
   (c) ``cli/quality_report`` on phase 7's ``best`` (2 writers, 64 real
   words each): its keys, ``cer`` equal to ``cer_of_folder``, a finite
   ``fid_random_features``, the kernel launches;
   (d) ``cli/evaluate`` on the same folders, with and without
   ``--per-writer``;
9. TrOCR, the teacher phase, HTR, entry and benches, TrOCR in f32
   throughout: (a) TrOCR ``tiny`` on the card against the CPU, one forward
   and the gradient into the images (1e-4 of max(1, |CPU|) and of the
   largest gradient entry); (b) ``train_word --recognizer trocr
   --trocr-preset base`` at ``default_config()`` (TrOCR base, random
   weights from the seed, frozen): 8 merged steps at batch 8 (losses
   finite, TrOCR bit-unchanged, G moved, no kernel), one eval step (a
   capture of the decoder) and a 1 x 64-word request (a replay); (c)
   ``run_teacher_phase`` over 4 batches of 8 with the on-device TrOCR
   teacher (base) and with ``SelfTeacher`` (beam 3), each at
   ``conf_threshold`` 0.6 and 0.0 (there R must move, the losses be finite
   and every batch be used), one capture of the decoder a run;
   (d) ``HTRTrainer``: one epoch of 10 steps at batch 32 on synthetic words
   with ``marcal_augment``, teacher rate 0.5 (loss finite, R moved); (e)
   ``entry()`` once (images (8, 64, 216, 1), a capture of the decoder),
   ``cli/bench --batch 256 --quick`` and ``cli/bench_kernels --batch
   256``, each printing its JSON lines;
10. w8a8 serving at ``default_config()`` (random weights, 1 writer x 256
   words): (a) calibration, the int8 route against the bf16 route under
   the JAX package's gates (trunk features correlation > 0.98 and
   relative error < 0.2, the static and dynamic decoders' images
   correlation > 0.99), 23 ``torch._int_mm`` calls a request (no int8 conv
   as a float conv), ``int8_conv``'s int32 sums on the card bit-equal to
   the CPU's at three trunk layer shapes and G's ``res0.conv0``; (b) the
   int8 generate call's launches (the decoder eager), and 10 int8 and 10
   bf16 requests in turns, none capturing again; (c)
   ``tools/ab_int8_static`` and ``cli/bench --headline int8 --batch 256
   --quick``; (d) ``tools/ab_int8_cer`` on phase 7's ``best``;
11. the line models: (a) a small f32 ``HWWithStyle`` on the card against
   the CPU, ``char_style_dim`` 0 and 16; (b) ``HWWithStyle`` at its
   published widths with ``cf_synth_charSpecMulti``'s ``char_style_dim``
   16 and ``max_gen_length`` 128: ``extract_style`` of 16 lines of 64 x 512
   (``a_batch_size`` 2) and ``generate`` of 16 lines, no kernel launched;
12. the line GAN: (a) each lesson step (count, auto, auto-gen, no-step
   gen, gen, disc, valid) of a small f32 ``LineGanTrainer`` on the card
   against the CPU from one state (losses, the updated main tree and D,
   D's ``u``/``sigma``, ``LINE_TOL``; the gradient each stepping lesson
   hands its optimizer, per leaf against the CPU's f64, ``LINE_GRAD_TOL``
   plus twice the CPU's own f32 gap, ``grad_check``); (b)
   ``LineGanTrainer`` at the published widths with
   ``cf_synth_charSpecMulti`` (4 lines of 64 x 512): three rotations of
   the seven-lesson curriculum, ``validate``, parameter counts;
   losses finite, the HWR, its BatchNorm statistics and the AE
   bit-unchanged, D's ``u`` moved, the no-step stash consumed at auto-gen,
   no kernel launched; (c) ``cli/train_line --config
   configs/cf_synth_charSpecMulti.json`` for 7 iterations, the checkpoint
   restored bit for bit (Adam, SWA, iteration), 2 more iterations resumed,
   ``validate``, ``cli/get_styles --ckpt``, ``generate_lines`` of 16 texts
   (no kernel launched), ``serve/app.py --selftest --ckpt`` (PNG decoded
   back to the same page);
13. line pretraining, the IAM line data, line evaluation, the REPL and
   the profilers, f32 with TF32 off: (a) ``cli/train_hwr``'s step
   (``CNNOnlyHWR``, BatchNorm, 80 classes, 8 lines of 64 x 512) on the
   card against the CPU from one state with warmed Adam moments
   (``PRETRAIN_TOL``; the gradient against the CPU's f64,
   ``PRETRAIN_GRAD_TOL`` plus twice the CPU's f32 gap), then the CLI for 20
   iterations (bf16 compute, as the JAX CLI), ``hwr_final``; (b) the
   same for ``AutoTrainer`` (2tight
   AE with E_HWR at 80 classes, L1 + CTC) and ``cli/train_auto``,
   ``ae_final``; (c) ``cli/train_line --config cf_synth_charSpecMulti``
   with ``--pretrained-hwr``, ``--pretrained-ae`` and ``--xml-root`` on an
   IAM-format checkout written here (``tools/iam_fixture``): HWR and AE
   bit-equal to the files on the card, 7 iterations, the restore bit-equal
   to the save; (d) ``cli/evaluate_line`` on it (synthetic lines and
   ``--xml-root``); (e) ``cli/line_repl --script`` through every action;
   (f) ``cli/profile_pipeline --batch 256 --train-batch 8`` and
   ``cli/profile_gen --batch 256`` (10-call streams) with their JSON
   lines, the kernels' launches in one ``profile_gen --stages upchain``
   and one ``profile_pipeline --stages generate`` call, and one
   ``up_chain`` call in ``utils/profiling.trace`` (``in_relu`` twice,
   ``phase_head`` once by name) and under ``work_counter``.

14. multi-device (``parallel/``) on the one card: (a) NCCL at world 1,
   ``default_config()``, 1 writer x 256 words through
   ``make_sharded_pipeline`` on a 1x1 mesh, bit-equal to the unsharded
   call (one capture of the decoder, added to the kernels line), and
   ``generate_word --mesh auto`` under ``torch.distributed.run`` writing
   the files of ``--mesh none``; (b) two processes sharing the card over
   gloo (NCCL takes one card a rank): the sharded pipeline at data=2, 128
   words a rank, against the unsharded call (``bf16_tolerance_ok``, 2% of
   tokens), the kernels at the rank's shapes (``phase_head`` at its batch
   128 strip height) against their plain versions; (c) the word step at
   full width (batch 8, f32, SGD, TF32 off, R's dropout 0) on data=2 and
   on 1x2 against one process's step (``MESH_STEP_*`` plus twice the
   one-process step's own spread with the batch's rows reversed); (d) an
   auto and a disc lesson of ``LineGanTrainer`` at its published widths,
   2 lines a rank, against one process's (``MESH_LINE_*``).
15. batch invariance at ``default_config()``: (a) ``in_relu`` at its two
   shapes and ``phase_head`` on xp (256, 256, 36, 112), f32 and bf16, on
   rows 0-63 alone and inside batch 256, which must be bit-equal
   (``strip_rows`` gives the bf16 route R = 16 and 32 there; both printed);
   (b) a reading, not a gate: the bf16 request of 1 writer x words 0-63
   alone and inside the 256-word request under each ``cudnn.benchmark`` x
   ``cudnn.deterministic`` setting (restored after), the max|diff| of rows
   0-63 at every stage (style encoder, text encoder, mix, res blocks,
   upsample convs and their IN + ReLU, head, R's trunk, BiGRU, logits), the
   first that differs and the ids that flip; (d)
   ``tools/ab_subpixel_quality`` on phase 7's ``best`` (2 + 1 epochs: not
   trained), so phase 7's logdir lives until here.

Each phase prints its seconds.  The last lines are the ``kernels`` JSON
(launch counts, parity errors, ``ptxas``), the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import shutil
import sys
import tempfile
import time
from pathlib import Path

SEED = 0
WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog"]
NEW_ENCODERS = ("cnn", "vgg19", "inception_v3", "efficientnet_v2_l",
                "dinov2_s", "dinov2_b", "dinov2_l", "dinov2_g")
# writers of phase 8c's report: each costs a 2048x2048 scipy sqrtm on the
# host (~21 s) in quality_report and again in evaluate --per-writer; 2 keep
# the whole smoke near 10 minutes
QUALITY_WRITERS = 2

def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_info(build_log: str, kernel: str) -> dict:
    """Registers and spill bytes that ``nvcc -Xptxas -v`` reported for each
    entry function whose mangled name contains ``kernel``, by its mangled
    template arguments (``ILb1E`` for ``<true>``) where it has any."""
    info, cur = {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(kernel + r"(I\w*?E)?E", line)
            cur = info.setdefault(m.group(1) or kernel, {}) if m else None
        elif cur is not None and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill (stores|loads)", line)
            cur.update({f"spill_{k}": int(v) for v, k in nums})
        elif cur is not None and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
            cur = None
    return info


def dec_launches(captures: int = 0, eager: int = 0) -> tuple:
    """The host counts (``in_relu``, ``phase_head`` wgmma route, f32 route)
    of G decoder calls on the bf16 route: ``in_relu`` twice and
    ``phase_head`` once a forward run by the host.  A call that captures
    the decoder's CUDA graph runs it twice (a warm-up and the capture,
    ``utils/cuda_graphs.py``), an eager call once, and a replay of the
    graph not at all.  On the card a capturing call launches as many (the
    warm-up's, then the first replay's), a replaying call one forward's."""
    n = 2 * captures + eager
    return (2 * n, n, 0)


def bf16_tolerance_ok(got, ref) -> tuple[float, bool]:
    """bf16: the kernel and the plain version round the same f32 statistics
    and sums, taken in another order, to bf16, so an element may land one
    bf16 ulp (2^-8 relative) apart.  Allowed: 2^-6 * max(1, |ref|)."""
    d = (got.float() - ref.float()).abs()
    lim = ref.float().abs().clamp_min(1.0) * 2.0 ** -6
    return float(d.max()), bool((d <= lim).all())


def phase_parity(torch):
    from affganwriting_torch.ops.in_relu_cuda import in_relu, in_relu_plain
    from affganwriting_torch.ops.phase_head_cuda import (
        phase_head,
        phase_head_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {"in_relu": {}, "phase_head": {}}
    tol32 = {"in_relu": 1e-5, "phase_head": 1e-4}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        worst = 0.0
        for shape in ((64, 256, 16, 54), (64, 128, 32, 108)):
            x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1) \
                .to(dtype)
            x[:, 1] = x[:, 0]                      # a duplicated plane
            for relu in (True, False):
                got = in_relu(x, relu=relu)
                ref = in_relu_plain(x, relu=relu)
                torch.cuda.synchronize()
                if not torch.equal(got[:, 0], got[:, 1]):
                    raise AssertionError(f"in_relu {tag} {shape}: equal "
                                         "planes gave different outputs")
                if dtype == torch.float32:
                    err = float((got - ref).abs().max())
                    ok = err <= tol32["in_relu"]
                else:
                    err, ok = bf16_tolerance_ok(got, ref)
                log(f"  in_relu {tag} {shape} relu={relu}: max|err| "
                    f"{err:.3g} ({'ok' if ok else 'FAIL'})")
                if not ok:
                    raise AssertionError(f"in_relu {tag} parity failed")
                worst = max(worst, err)
        errs["in_relu"][tag] = worst

        worst = 0.0
        shapes = [(64, 256, 36, 112)]
        if dtype == torch.bfloat16:
            # batch 1; strips of R = 7 rows, which do not divide h = 20,
            # with one 64-pixel half (w+4 = 64) and a ragged second half
            shapes += [(1, 256, 36, 112), (44, 256, 24, 64),
                       (44, 256, 24, 72)]
        for shape in shapes:
            xp = torch.relu(torch.randn(shape, generator=gen,
                                        device="cuda")).to(dtype)
            kc = (torch.randn((256, 100), generator=gen, device="cuda")
                  / (49 * 64) ** 0.5).to(dtype)
            bias4 = torch.randn(4, generator=gen, device="cuda") * 0.1
            before = (phase_head.launches, phase_head.launches_wgmma)
            got = phase_head(xp, kc, bias4)
            ref = phase_head_plain(xp, kc, bias4)
            torch.cuda.synchronize()
            route = (phase_head.launches - before[0],
                     phase_head.launches_wgmma - before[1])
            if route != ((1, 0) if dtype == torch.float32 else (0, 1)):
                raise AssertionError(f"phase_head {tag} took the wrong route "
                                     f"{route}")
            if dtype == torch.float32:
                err = float((got - ref).abs().max())
                ok = err <= tol32["phase_head"]
            else:
                err, ok = bf16_tolerance_ok(got, ref)
            log(f"  phase_head {tag} {shape}: max|err| "
                f"{err:.3g} ({'ok' if ok else 'FAIL'})")
            if not ok:
                raise AssertionError(f"phase_head {tag} parity failed")
            worst = max(worst, err)
        errs["phase_head"][tag] = worst
    # bf16 shapes the wgmma kernel does not take raise, with no fallback
    kc = torch.zeros((96, 100), device="cuda", dtype=torch.bfloat16)
    for shape in ((2, 96, 36, 112), (2, 64, 36, 60), (2, 64, 36, 136)):
        xp = torch.zeros(shape, device="cuda", dtype=torch.bfloat16)
        try:
            phase_head(xp, kc[:shape[1]], torch.zeros(4))
        except ValueError as e:
            log(f"  phase_head bf16 {shape} refused: {e}")
        else:
            raise AssertionError(f"phase_head took bf16 {shape}")
    return errs


def phase_reference(torch):
    """The port on the card vs the port on the CPU, small fp32 config."""
    import numpy as np

    from affganwriting_torch.core.config import default_config
    from affganwriting_torch.gen.inference import (
        encode_labels,
        make_generate_and_read_fn,
    )

    cfg = default_config().replace(
        compute_dtype="float32", img_height=32, img_width=104, max_chars=6,
        style_dim=64, adain_param_dim=512, text_embed_dim=16, rec_hidden=64,
        rec_embed=16)
    rng = np.random.default_rng(SEED)
    style = rng.normal(size=(2, 32, 104, 50)).astype(np.float32)
    labels = encode_labels(WORDS[:4], cfg.output_max_len)
    cuda_run = make_generate_and_read_fn(cfg, seed=SEED)
    cpu_run = make_generate_and_read_fn(cfg, seed=SEED, device="cpu")
    img_gpu, _ = cuda_run(style, labels)
    img_cpu, _ = cpu_run(style, labels)
    err = float((img_gpu.cpu() - img_cpu).abs().max())
    log(f"  images card vs CPU: max|err| {err:.3g} (tol 2e-3)")
    if not err <= 2e-3:
        raise AssertionError("port on the card disagrees with the CPU")
    # R on the same images on both sides: logits close, ids equal where
    # the top-2 margin is clear of the difference
    with torch.inference_mode():
        lab = torch.as_tensor(labels).long()
        lg_cpu, _ = cpu_run.rec(img_cpu.permute(0, 3, 1, 2), lab)
        lg_gpu, _ = cuda_run.rec(img_cpu.cuda().permute(0, 3, 1, 2),
                                 lab.cuda())
    lerr = float((lg_gpu.cpu() - lg_cpu).abs().max())
    top2 = lg_cpu.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 10 * max(lerr, 1e-6)
    same = lg_gpu.cpu().argmax(-1) == lg_cpu.argmax(-1)
    log(f"  logits card vs CPU: max|err| {lerr:.3g} (tol 2e-3); greedy ids "
        f"equal at {int(same.sum())}/{same.numel()} steps")
    if not lerr <= 2e-3 or not bool(same[clear].all()):
        raise AssertionError("recognizer on the card disagrees with the CPU")


def phase_main_path(torch, launches):
    import numpy as np

    from affganwriting_torch.core.config import default_config
    from affganwriting_torch.gen.inference import (
        encode_labels,
        make_generate_and_read_fn,
    )
    from affganwriting_torch.ops.in_relu_cuda import in_relu
    from affganwriting_torch.ops.phase_head_cuda import phase_head

    cfg = default_config()
    run = make_generate_and_read_fn(cfg, seed=SEED)
    rng = np.random.default_rng(SEED)
    stacks = rng.normal(size=(2, cfg.img_height, cfg.img_width,
                              cfg.style_stack)).astype(np.float32)
    requests = [(stacks[:1], WORDS * 32), (stacks[:1], WORDS),
                (stacks, WORDS)]
    def counts():
        return (in_relu.launches, phase_head.launches_wgmma,
                phase_head.launches)

    in_relu.launches = phase_head.launches_wgmma = phase_head.launches = 0
    outs = []
    for style, words in requests:
        before = counts()
        outs.append(run(style, encode_labels(words, cfg.output_max_len)))
        # each request meets a new signature: the decoder's capture
        got = tuple(a - b for a, b in zip(counts(), before))
        if got != dec_launches(captures=1):
            raise AssertionError(f"a bf16 generate call launched {got}, not "
                                 f"{dec_launches(captures=1)} (a capture "
                                 "of the decoder on its wgmma route)")
    torch.cuda.synchronize()
    launches["in_relu"], launches["phase_head"], launches["phase_head_f32"] \
        = counts()
    # a second request of a size replays: the host launches neither kernel
    before = counts()
    run(requests[0][0], encode_labels(requests[0][1], cfg.output_max_len))
    got = tuple(a - b for a, b in zip(counts(), before))
    if got != dec_launches():
        raise AssertionError(f"a repeated bf16 request launched {got}, not "
                             "a replay of the decoder's graph")
    log(f"  launches over {len(requests)} requests: in_relu "
        f"{launches['in_relu']}, phase_head wgmma route "
        f"{launches['phase_head']}, f32 route {launches['phase_head_f32']}")
    for (style, words), (images, ids) in zip(requests, outs):
        b = len(words)
        if tuple(images.shape) != (b, cfg.img_height, cfg.img_width, 1) \
                or tuple(ids.shape) != (b, cfg.output_max_len - 1):
            raise AssertionError(f"bad shapes {tuple(images.shape)} "
                                 f"{tuple(ids.shape)}")
        img = images.float()
        if not bool(torch.isfinite(img).all()) or float(img.abs().max()) > 1:
            raise AssertionError("images not finite or outside [-1, 1]")
        if int(ids.min()) < 0 or int(ids.max()) >= cfg.vocab_size:
            raise AssertionError("greedy ids outside the vocabulary")
        log(f"  {style.shape[0]} writer(s) x {b} words: images "
            f"{tuple(images.shape)} {images.dtype} in "
            f"[{float(img.min()):.3f}, {float(img.max()):.3f}], ids "
            f"{tuple(ids.shape)}; first word read as {ids[0].tolist()}")


def random_batch(torch, cfg, b: int, gen, device):
    """A train batch from ``gen``: a normal style stack, writer ids, labels
    GO + 1..max_chars chars + END + PAD."""
    t = cfg.output_max_len
    ids = torch.randint(3, cfg.vocab_size, (3, b, t), generator=gen,
                        device=device)
    n = torch.randint(1, cfg.max_chars + 1, (3, b, 1), generator=gen,
                      device=device)
    pos = torch.arange(t, device=device)
    ids = torch.where(pos == n + 1, 1, torch.where(pos > n + 1, 2, ids))
    ids[..., 0] = 0
    return {"style_imgs": torch.randn(b, cfg.img_height, cfg.img_width,
                                      cfg.style_stack, generator=gen,
                                      device=device),
            "label_ch0": ids[0], "label_xt": ids[1], "label_xt_swap": ids[2],
            "writer_ids": torch.randint(0, cfg.num_writers, (b,),
                                        generator=gen, device=device)}


def snapshot(torch, state):
    from affganwriting_torch.train.state import PLAYERS

    return {n: {k: v.detach().float().cpu().clone() for k, v in
                getattr(state, n).model.state_dict().items()}
            for n in PLAYERS}


def phase_train_reference(torch):
    """One merged step of the port on the card and on the CPU from the
    same weights and batch: losses, fakes, every player's delta, G's and
    R's new running statistics, held to the limits the CPU tests hold the
    port to against the JAX package (``train/parity.py``)."""
    from affganwriting_torch.core.config import default_config
    from affganwriting_torch.train import parity
    from affganwriting_torch.train.state import PLAYERS, init_state
    from affganwriting_torch.train.step import make_phased_train_step

    cfg = default_config().replace(**parity.STEP_CONFIG)
    cpu = init_state(cfg, device="cpu", seed=SEED, rec_dropout=0.0)
    before = snapshot(torch, cpu)
    card = init_state(cfg, seed=SEED, rec_dropout=0.0, weights={
        n: getattr(cpu, n).model.state_dict() for n in PLAYERS})
    batch = {k: v.numpy() for k, v in random_batch(
        torch, cfg, parity.STEP_BATCH, torch.Generator().manual_seed(SEED),
        "cpu").items()}
    outs = {}
    for dev, state in (("cpu", cpu), ("cuda", card)):
        state, metrics, extras = make_phased_train_step(
            cfg, merge_dg=True, device=dev)(
            state, batch, torch.Generator(device=dev).manual_seed(SEED))
        outs[dev] = (snapshot(torch, state),
                     {k: float(v) for k, v in metrics.items()},
                     {k: v.float().cpu() for k, v in extras.items()})
    (want, wm, we), (got, gm, ge) = outs["cpu"], outs["cuda"]
    problems = []
    for k, w in wm.items():
        if not abs(gm[k] - w) <= parity.LOSS_TOL * max(1.0, abs(w)):
            problems.append(f"metric {k}: card {gm[k]}, CPU {w}")
    xerr = float((ge["xg"] - we["xg"]).abs().max())
    if not xerr <= parity.XG_TOL:
        problems.append(f"xg max|err| {xerr}")
    if not torch.equal(ge["rec_logits_tr"].argmax(-1),
                       we["rec_logits_tr"].argmax(-1)):
        problems.append("R's greedy ids on the real words differ")
    errs = {"xg": xerr}
    for n in PLAYERS:
        l2, per_leaf = parity.delta_errors(got[n], want[n], before[n])
        worst = max(per_leaf.values())
        errs[f"{n}_delta_l2"], errs[f"{n}_delta_leaf"] = l2, worst
        if not parity.delta_ok(n, l2, per_leaf):
            problems.append(f"{n} delta: L2 {l2:.3g}, leaf {worst:.3g} "
                            f"(limits {parity.DELTA_TOL[n]})")
        if n in ("gen", "rec"):
            serr = max(float((got[n][k] - want[n][k]).abs().max()
                             / max(1.0, float(want[n][k].abs().max())))
                       for k in want[n] if parity.is_stat(k))
            errs[f"{n}_stats"] = serr
            if not serr <= parity.STATS_TOL:
                problems.append(f"{n} running stats max|err| {serr}")
    log("  card vs CPU, one merged step: " + ", ".join(
        f"{k} {v:.3g}" for k, v in errs.items()))
    log("  losses card/CPU: " + ", ".join(
        f"{k} {gm[k]:.6g}/{wm[k]:.6g}" for k in wm))
    if problems:
        raise AssertionError("train step on the card disagrees with the "
                             "CPU: " + "; ".join(problems))
    return errs


def phase_train(torch):
    """The merged train step at full width: default_config (resnet50 G,
    D and C at 6 layers, R hidden 512, bf16 on f32 parameters, Adam), batch
    8, random weights and batch from the seed; 13 steps, then one eval
    step, two 4-phase steps and two merged steps at batch 64."""
    from affganwriting_torch.core.config import default_config
    from affganwriting_torch.ops.in_relu_cuda import in_relu
    from affganwriting_torch.ops.phase_head_cuda import phase_head
    from affganwriting_torch.train.eval_step import make_eval_step
    from affganwriting_torch.train.parity import is_stat
    from affganwriting_torch.train.state import (
        PLAYERS,
        init_state,
        param_count,
    )
    from affganwriting_torch.train.step import make_phased_train_step

    def counts():
        return (in_relu.launches, phase_head.launches_wgmma,
                phase_head.launches)

    cfg = default_config()
    b = cfg.batch_size
    state = init_state(cfg, seed=SEED)
    log(f"  parameters {param_count(state)}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = random_batch(torch, cfg, b, gen, "cuda")
    step = make_phased_train_step(cfg, merge_dg=True)
    before = snapshot(torch, state)
    rec_stats = {}

    def on_phase(name):
        if name == "rec":
            rec_stats.update({k: v.clone() for k, v in
                              state.rec.model.state_dict().items()
                              if is_stat(k)})

    in_relu.launches = phase_head.launches_wgmma = phase_head.launches = 0
    losses = []
    for _ in range(13):
        _, metrics, extras = step(state, batch, gen, on_phase)
        losses.append({k: float(v) for k, v in metrics.items()})
        moved = [k for k, v in state.rec.model.state_dict().items()
                 if is_stat(k) and not torch.equal(v, rec_stats[k])]
        if moved:
            raise AssertionError(f"R's running stats moved in the G phase: "
                                 f"{moved[:3]}")
    train_counts = counts()
    bad = [(i, k, v) for i, m in enumerate(losses) for k, v in m.items()
           if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite losses: {bad[:5]}")
    if train_counts != (0, 0, 0):
        raise AssertionError(f"a train step launched a forward-only kernel: "
                             f"{train_counts}")
    if tuple(extras["xg"].shape) != (b, cfg.img_height, cfg.img_width, 1):
        raise AssertionError(f"bad xg shape {tuple(extras['xg'].shape)}")
    after = snapshot(torch, state)
    for n in PLAYERS:
        params = [k for k in before[n] if not is_stat(k)]
        if not any(not torch.equal(before[n][k], after[n][k])
                   for k in params):
            raise AssertionError(f"{n}'s parameters did not move")
        stats = [k for k in before[n] if is_stat(k)]
        if n in ("gen", "rec") and not all(
                not torch.equal(before[n][k], after[n][k]) for k in stats):
            raise AssertionError(f"{n}'s running stats did not all move")
    log(f"  13 steps, losses finite; all four players moved; G's and R's "
        f"running stats moved, R's not in the G phase; kernel launches in "
        f"13 train steps: {train_counts}")
    log(f"  step 0 losses {losses[0]}")
    log(f"  step 12 losses {losses[-1]}")

    eval_step = make_eval_step(cfg)
    in_relu.launches = phase_head.launches_wgmma = phase_head.launches = 0
    em, preds, images = eval_step(state, {k: v for k, v in batch.items()
                                          if k != "label_ch0"})
    torch.cuda.synchronize()
    eval_counts = counts()
    log(f"  eval step: losses { {k: float(v) for k, v in em.items()} }, "
        f"launches in_relu {eval_counts[0]}, phase_head wgmma "
        f"{eval_counts[1]}, f32 {eval_counts[2]}")
    if eval_counts != dec_launches(captures=1):
        raise AssertionError(f"an eval step launched {eval_counts}, not "
                             f"{dec_launches(captures=1)} (a capture of the "
                             "decoder on its wgmma route)")
    if not all(math.isfinite(float(v)) for v in em.values()):
        raise AssertionError("non-finite eval losses")

    four = make_phased_train_step(cfg, merge_dg=False)
    for _ in range(2):
        _, m4, _ = four(state, batch, gen)
        if not all(math.isfinite(float(v)) for v in m4.values()):
            raise AssertionError("non-finite losses in the 4-phase step")
    log(f"  two 4-phase steps, batch {b}: losses finite")

    big = random_batch(torch, cfg, 64, gen, "cuda")
    for _ in range(2):
        _, m64, _ = step(state, big, gen)
        if not all(math.isfinite(float(v)) for v in m64.values()):
            raise AssertionError("non-finite losses at batch 64")
    log("  two merged steps, batch 64: losses finite")
    return {"launches_13_train_steps": list(train_counts),
            "launches_eval_step": list(eval_counts)}


def _counted(method, record: list, counts):
    """``method`` with the kernel launches of each call appended to
    ``record``, with what it returned."""
    def run(*a, **k):
        before = counts()
        out = method(*a, **k)
        record.append((tuple(x - y for x, y in zip(counts(), before)), out))
        return out
    return run


def phase_trainer_runtime(torch, tmp: str):
    """The word trainer runtime at full width (default_config: resnet50,
    bf16 on f32 parameters, Adam, merged D+G, batch 8, synthetic images
    from the in-repo GT), in a temporary logdir under ``build/``:

    (a) ``cli/train_word`` for 2 epochs of 16 writers (2 train steps and 2
        eval batches an epoch), evaluating and saving every epoch, the
        launches of each epoch and evaluation counted;
    (b) a trainer built on the same logdir resumes at epoch 2 with every
        parameter, statistic and optimizer field of the last save, R's
        learning rate included, and trains one more epoch;
    (c) ``cli/generate_word`` from ``best``: the word ladder for one writer
        with a beam of 3, of 1 (which must read as the greedy path up to
        the first END) and greedily;
    (d) ``cli/inspect_ckpt`` prints ``param_count``'s counts.

    The run stays in ``tmp`` (phase 8 scores its ``best``)."""
    import contextlib
    import io
    import os

    from affganwriting_torch.cli import generate_word, inspect_ckpt, train_word
    from affganwriting_torch.core.checkpoint import state_payload
    from affganwriting_torch.core.config import VOCAB
    from affganwriting_torch.ops.in_relu_cuda import in_relu
    from affganwriting_torch.ops.phase_head_cuda import phase_head
    from affganwriting_torch.train.state import param_count, set_rec_lr

    def counts():
        return (in_relu.launches, phase_head.launches_wgmma,
                phase_head.launches)

    logdir = os.path.join(tmp, "run")
    argv = ["--epochs", "2", "--max-writers", "16", "--eval-every", "1",
            "--save-every", "1", "--restart-rss-gb", "0", "--logdir", logdir]
    out = {}
    in_relu.launches = phase_head.launches_wgmma = phase_head.launches = 0
    # train_word.main, with the trainer's epochs and evaluations counted
    trainer, epochs_n = train_word.build_trainer(argv)
    epochs, evals = [], []
    trainer.train_epoch = _counted(trainer.train_epoch, epochs, counts)
    trainer.evaluate = _counted(trainer.evaluate, evals, counts)
    trainer.fit(epochs_n)
    lines = [json.loads(s) for s in open(f"{logdir}/metrics.jsonl")]
    if [r["group"] for r in lines] != ["train", "eval"] * 2:
        raise AssertionError(
            f"metrics groups {[r['group'] for r in lines]}")
    for r in lines:
        vals = {k: v for k, v in r.items() if k != "group"}
        if not all(math.isfinite(v) for v in vals.values()) or min(
                v for k, v in vals.items() if k.startswith("cer")) < 0:
            raise AssertionError(f"bad metrics line {r}")
    ck = os.listdir(f"{logdir}/ckpt")
    if not {"latest", "step_00000001", "best"} <= set(ck):
        raise AssertionError(f"checkpoints {sorted(ck)}")
    nb = len(trainer.test_data) // trainer.config.batch_size
    # each eval follows a train epoch, whose train() dropped the
    # decoder's graph: its first batch captures, the second replays
    if [cnt for cnt, _ in evals] != [dec_launches(captures=1)] * 2 \
            or nb != 2:
        raise AssertionError(f"eval launches {[c for c, _ in evals]} over "
                             f"{nb} batches: not one capture of the "
                             "decoder over 2 batches")
    if any(cnt != (0, 0, 0) for cnt, _ in epochs):
        raise AssertionError(f"a train epoch launched a forward-only "
                             f"kernel: {[c for c, _ in epochs]}")
    for (cnt, m), (ecnt, _) in zip(epochs, evals):
        log(f"  epoch: launches {cnt}; eval of {nb} batches, launches "
            f"{ecnt}; cer_tr {m['cer_tr']:.2f}, l_total {m['l_total']:.4f}")
    out["eval_launches_per_batch"] = [c // nb for c in evals[-1][0]]

    # the last save of (a), with R's rate moved as a plateau step would
    set_rec_lr(trainer.state, trainer.config.lr_rec * 0.1)
    trainer.ckpt.save_latest(trainer.state, trainer.config)
    saved = state_payload(trainer.state)
    cfg = trainer.config

    trainer_b, _ = train_word.build_trainer(["--epochs", "3"] + argv[2:])
    if trainer_b.start_epoch != 2:
        raise AssertionError(f"resumed at epoch {trainer_b.start_epoch}")
    got = state_payload(trainer_b.state)
    fields = _compare_payloads(torch, got, saved)
    lr = got["rec"]["opt"]["param_groups"][0]["lr"]
    if lr != cfg.lr_rec * 0.1:
        raise AssertionError(f"R's lr {lr} not restored")
    log(f"  resumed at epoch 2: {fields} tensors and optimizer fields "
        f"bit-equal to the last save, R's lr {lr:g}")
    del trainer, saved, got
    trainer_b.fit(3)
    last = [json.loads(s) for s in open(f"{logdir}/metrics.jsonl")][-2:]
    if [r["group"] for r in last] != ["train", "eval"] or not all(
            math.isfinite(v) for r in last for k, v in r.items()
            if k.startswith("l_")):
        raise AssertionError(f"resumed epoch: {last}")
    log(f"  resumed epoch 2: l_total {last[0]['l_total']:.4f}, cer_te "
        f"{last[1]['cer_te']:.2f}")
    counts_b = param_count(trainer_b.state)
    del trainer_b
    torch.cuda.empty_cache()

    reads = {}
    for beam in (3, 1, 0):
        before = counts()
        res = generate_word.main([
            "--ckpt", f"{logdir}/ckpt", "--ckpt-name", "best",
            "--corpus", "ladder", "--max-writers", "1", "--beam",
            str(beam), "--out", os.path.join(tmp, f"gen{beam}")])
        launched = tuple(a - b for a, b in zip(counts(), before))
        files = os.listdir(os.path.join(tmp, f"gen{beam}"))
        ids = res["pred_ids"]
        if len(files) != 17 or len(res["files"]) != 17 or not all(
                f.endswith((".png", ".png.npy")) for f in files):
            raise AssertionError(f"generate_word wrote {len(files)} files")
        if ids.shape != (17, cfg.output_max_len - 1) or ids.min() < 0 \
                or ids.max() >= VOCAB.size:
            raise AssertionError(f"beam ids {ids.shape} in "
                                 f"[{ids.min()}, {ids.max()}]")
        if launched != dec_launches(captures=1):
            raise AssertionError(f"a generate_word call launched "
                                 f"{launched}, not one capture of the "
                                 "decoder")
        reads[beam] = [_until_end(r, VOCAB.end) for r in ids.tolist()]
        if beam == 0:
            out["generate_word_launches"] = list(launched)
        log(f"  generate_word --beam {beam}: 17 files, launches "
            f"{launched}; first read {VOCAB.decode(ids[0])!r}")
    if reads[1] != reads[0]:
        raise AssertionError("a width-1 beam read differently from the "
                             "greedy path")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        shown = inspect_ckpt.main([f"{logdir}/ckpt"])
    if shown["param_counts"] != counts_b or not all(
            f'"{n}": {c}' in buf.getvalue() for n, c in counts_b.items()):
        raise AssertionError(f"inspect_ckpt printed {shown}, "
                             f"param_count {counts_b}")
    log(f"  inspect_ckpt: step {shown['step']}, parameters "
        f"{shown['param_counts']}")
    torch.cuda.empty_cache()
    return out


def _rel_err(got, ref) -> float:
    """max |got - ref| over max(1, max |ref|), on the CPU in f32."""
    got, ref = got.float().cpu(), ref.float().cpu()
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def phase_eval_reference(torch):
    """(a) On a small fp32 config (32x104 style stacks, batch 2), each new
    encoder's pyramid, ``InceptionV3Pool3``'s activations (8 crops) and
    ``FIDScorer``'s random features on the card against the CPU: the same
    weights (drawn on the CPU from the seed) within 1e-3 of max(1, |CPU|)
    per tap; the scorer's features bit-equal."""
    import numpy as np

    from affganwriting_torch.eval.fid import FIDScorer, crop64_preprocess
    from affganwriting_torch.gen.inference import init_weights
    from affganwriting_torch.models.style_encoders import get_style_encoder

    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.normal(size=(2, 50, 32, 104)).astype(np.float32))
    errs = {}
    for name in NEW_ENCODERS:
        enc = init_weights(get_style_encoder(
            name, final_hw=(4, 13), dtype=torch.float32), SEED).eval()
        with torch.no_grad():
            cpu = enc(x)
            gpu = enc.cuda()(x.cuda())
        errs[name] = max(_rel_err(g, c) for g, c in zip(gpu, cpu))
        log(f"  {name}: {len(cpu)} taps, last {tuple(cpu[-1].shape)}; card "
            f"vs CPU {errs[name]:.3g} (tol 1e-3)")
        if not errs[name] <= 1e-3:
            raise AssertionError(f"{name}'s pyramid on the card disagrees "
                                 "with the CPU")
        del enc, cpu, gpu
    on_card, on_cpu = FIDScorer(), FIDScorer(device="cpu")
    for k, v in on_cpu.model.state_dict().items():
        if not torch.equal(on_card.model.state_dict()[k].cpu(), v):
            raise AssertionError(f"FIDScorer's random features differ on "
                                 f"the card: {k}")
    imgs = crop64_preprocess(rng.random((8, 64, 216)).astype(np.float32))
    a_card, a_cpu = on_card.activations(imgs), on_cpu.activations(imgs)
    errs["inception_pool3"] = _rel_err(torch.from_numpy(a_card),
                                       torch.from_numpy(a_cpu))
    log(f"  FIDScorer ({on_card.provenance}): the same features on the card "
        f"as on the CPU; pool3 activations {a_card.shape} card vs CPU "
        f"{errs['inception_pool3']:.3g} (tol 1e-3)")
    if not errs["inception_pool3"] <= 1e-3:
        raise AssertionError("InceptionV3 on the card disagrees with the CPU")
    return errs


def phase_encoders(torch, counts, zero):
    """(b) Each new encoder at full width (``default_config()`` with it,
    bf16, random weights from the seed): one request of 1 writer x 64
    words; parameters; merged train steps at batch 8 (Adam): one checked,
    then 3 more with finite losses."""
    import numpy as np

    from affganwriting_torch.core.config import default_config
    from affganwriting_torch.gen.inference import (
        encode_labels,
        make_generate_and_read_fn,
    )
    from affganwriting_torch.train.parity import is_stat
    from affganwriting_torch.train.state import PLAYERS, init_state
    from affganwriting_torch.train.step import make_phased_train_step

    rng = np.random.default_rng(SEED)
    out = {}
    for name in NEW_ENCODERS:
        cfg = default_config().replace(style_encoder=name)
        style = rng.normal(size=(1, cfg.img_height, cfg.img_width,
                                 cfg.style_stack)).astype(np.float32)
        labels = encode_labels(WORDS * 8, cfg.output_max_len)
        torch.cuda.empty_cache()
        run = make_generate_and_read_fn(cfg, seed=SEED)
        n_enc = sum(p.numel() for p in run.gen.enc_image.parameters())
        n_gen = sum(p.numel() for p in run.gen.parameters())
        zero()
        images, ids = run(style, labels)
        torch.cuda.synchronize()
        launched = counts()
        img = images.float()
        if tuple(images.shape) != (64, cfg.img_height, cfg.img_width, 1) \
                or not bool(torch.isfinite(img).all()) \
                or float(img.abs().max()) > 1:
            raise AssertionError(f"{name}: images {tuple(images.shape)} not "
                                 "finite or outside [-1, 1]")
        if launched != dec_launches(captures=1):
            raise AssertionError(f"{name}: a generate call launched "
                                 f"{launched}, not {dec_launches(captures=1)}"
                                 " (a capture of the decoder on its wgmma "
                                 "route)")
        del run, images, ids
        torch.cuda.empty_cache()

        state = init_state(cfg, seed=SEED)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        batch = random_batch(torch, cfg, cfg.batch_size, gen, "cuda")
        step = make_phased_train_step(cfg, merge_dg=True)
        before = {n: {k: v.clone() for k, v in
                      getattr(state, n).model.state_dict().items()}
                  for n in PLAYERS}
        zero()
        _, metrics, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        losses = {k: float(v) for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"{name}: non-finite losses {losses}")
        if counts() != (0, 0, 0):
            raise AssertionError(f"{name}: a train step launched a "
                                 f"forward-only kernel: {counts()}")
        for n in PLAYERS:
            now = getattr(state, n).model.state_dict()
            if all(torch.equal(now[k], v) for k, v in before[n].items()
                   if not is_stat(k)):
                raise AssertionError(f"{name}: {n}'s parameters did not move")
        enc_stats = [k for k in before["gen"] if k.startswith("enc_image.")
                     and is_stat(k)]
        now = state.gen.model.state_dict()
        moved = sum(not torch.equal(now[k], before["gen"][k])
                    for k in enc_stats)
        if name == "efficientnet_v2_l" and moved != len(enc_stats):
            raise AssertionError(f"efficientnet: {moved}/{len(enc_stats)} "
                                 "running statistics moved in G's phase")
        if name == "inception_v3" and (not enc_stats or moved):
            raise AssertionError(f"inception_v3: {moved}/{len(enc_stats)} "
                                 "trunk statistics changed")
        del before, now
        for _ in range(3):
            _, metrics, _ = step(state, batch, gen)
            if not all(math.isfinite(float(v)) for v in metrics.values()):
                raise AssertionError(f"{name}: non-finite losses")
        del state, batch, step
        torch.cuda.empty_cache()
        out[name] = {"encoder_params": n_enc, "gen_params": n_gen,
                     "launches_generate_call": list(launched),
                     "step0_losses": losses,
                     "enc_stats": len(enc_stats), "enc_stats_moved": moved}
        log(f"  {name}: encoder {n_enc / 1e6:.2f} M of G's {n_gen / 1e6:.2f}"
            f" M parameters; 1 x 64 words, launches {launched}; merged "
            f"steps at batch {cfg.batch_size}, losses finite, encoder "
            f"statistics moved {moved}/{len(enc_stats)}; step 0 l_total "
            f"{losses['l_total']:.4f}")
    return out


def phase_quality_report(torch, tmp: str, counts, zero):
    """(c) ``cli/quality_report`` on phase 7's ``best`` with 2 writers and
    64 real words each; (d) ``cli/evaluate`` on its two folders, with and
    without ``--per-writer``."""
    import contextlib
    import io
    import os

    from affganwriting_torch.cli import evaluate, quality_report
    from affganwriting_torch.eval.generated import cer_of_folder

    out_dir = os.path.join(tmp, "quality")
    zero()
    with contextlib.redirect_stdout(io.StringIO()):
        report = quality_report.main([
            "--ckpt", os.path.join(tmp, "run", "ckpt"), "--ckpt-name",
            "best", "--max-writers", str(QUALITY_WRITERS),
            "--words-per-writer", "64",
            "--out", out_dir])
    torch.cuda.synchronize()
    launched = counts()
    gen_dir, real_dir = (os.path.join(out_dir, d)
                         for d in ("generated", "real"))
    keys = {"scenario", "ckpt", "cer", "fid_provenance",
            "fid_random_features", "seconds"}
    if not keys <= set(report) or not (
            "wid_fid_random_features" in report or "wid_fid_error" in report):
        raise AssertionError(f"quality_report keys {sorted(report)}")
    if report["cer"] != cer_of_folder(gen_dir):
        raise AssertionError(f"report cer {report['cer']} is not "
                             f"cer_of_folder's {cer_of_folder(gen_dir)}")
    if not math.isfinite(report["fid_random_features"]):
        raise AssertionError(f"fid {report['fid_random_features']}")
    w = QUALITY_WRITERS
    n = report["cer"]["count"] // w
    calls = n // 64 + (n % 64 > 0)
    # one capture of the decoder a batch size (64 and the rest), replayed
    # for every other call
    sizes = len({min(64, n - 64 * i) for i in range(calls)})
    if launched != dec_launches(captures=sizes):
        raise AssertionError(f"quality_report launched {launched} for "
                             f"{w * calls} generate calls of {sizes} sizes")
    n_real = len(os.listdir(real_dir))
    log(f"  quality_report: {report['cer']['count']} generated and "
        f"{n_real} real words; cer {report['cer']['cer']:.3f} (= "
        f"cer_of_folder), fid_random_features "
        f"{report['fid_random_features']:.6g}, wid "
        f"{report.get('wid_fid_random_features', report.get('wid_fid_error'))}"
        f"; launches {launched} over {w * calls} generate calls")
    report.pop("seconds")
    res = {"report": report, "launches": list(launched),
           "generate_calls": w * calls, "real_words": n_real}
    for extra, key in (([], "fid_random_features"),
                       (["--per-writer"], "wid_fid_random_features")):
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            ev = evaluate.main([gen_dir, "--real", real_dir] + extra)
        if json.loads(buf.getvalue()) != ev or set(ev) != {
                "cer", "fid_provenance", key}:
            raise AssertionError(f"evaluate {extra}: {ev}")
        if ev["cer"] != report["cer"] or not math.isfinite(ev[key]):
            raise AssertionError(f"evaluate {extra}: {ev}")
        if key in report and abs(ev[key] - report[key]) > 1e-3 * max(
                1.0, abs(report[key])):
            raise AssertionError(f"evaluate's {key} {ev[key]} is not the "
                                 f"report's {report[key]}")
        res[f"evaluate{''.join(extra)}"] = ev
        log(f"  evaluate {' '.join(extra)}: {key} {ev[key]:.6g}, cer as the "
            "report's")
    return res


def phase_trocr_reference(torch):
    """(a) TrOCR ``tiny`` on the card vs on the CPU, f32: one forward and
    the gradient into the images."""
    from affganwriting_torch.gen.inference import init_weights
    from affganwriting_torch.models.recognizer.trocr import (
        TrOCRArch,
        TrOCRRecognizer,
    )

    cpu = init_weights(TrOCRRecognizer(TrOCRArch.tiny()), SEED)
    card = TrOCRRecognizer(TrOCRArch.tiny()).cuda()
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(SEED)
    img = (torch.rand(2, 1, 64, 216, generator=gen) * 2 - 1).detach()
    labels = torch.randint(3, 55, (2, 12), generator=gen)
    labels[:, 0] = 0
    w = torch.randn(2, 11, 55, generator=gen)
    out = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("card", card, "cuda")):
        x = img.to(dev, copy=True).requires_grad_()
        logits, _ = model(x, labels.to(dev))
        (logits * w.to(dev)).sum().backward()
        out[name] = (logits.detach().cpu(), x.grad.cpu())
    d = (out["card"][0] - out["cpu"][0]).abs()
    lerr = float(d.max())
    within = bool((d <= 1e-4 * out["cpu"][0].abs().clamp_min(1.0)).all())
    gerr = float((out["card"][1] - out["cpu"][1]).abs().max())
    gscale = float(out["cpu"][1].abs().max())
    log(f"  tiny TrOCR card vs CPU (f32): logits max|err| {lerr:.3g} (tol "
        f"1e-4 of max(1, |CPU|)); image gradient max|err| {gerr:.3g} of max "
        f"{gscale:.3g} (tol 1e-4 of it)")
    if not (within and gerr <= 1e-4 * gscale and gscale > 0):
        raise AssertionError("TrOCR on the card disagrees with the CPU")
    return {"logits_max_abs_err": lerr, "grad_max_abs_err": gerr,
            "grad_scale": gscale}


def phase_trocr(torch, tmp: str, counts, zero):
    """(b) ``train_word --recognizer trocr --trocr-preset base`` at
    ``default_config()`` (TrOCR base, random weights, frozen; f32), batch
    8: 8 merged steps, one eval step, one 64-word request."""
    from affganwriting_torch.cli import train_word
    from affganwriting_torch.gen.inference import (
        encode_labels,
        make_generate_and_read_fn,
    )
    from affganwriting_torch.train.state import param_count

    trainer, _ = train_word.build_trainer([
        "--recognizer", "trocr", "--trocr-preset", "base",
        "--batch-size", "8", "--max-writers", "8", "--restart-rss-gb", "0",
        "--logdir", f"{tmp}/trocr"])
    cfg, state = trainer.config, trainer.state
    if (cfg.recognizer, cfg.rec_frozen, cfg.trocr_preset) != \
            ("trocr", True, "base") or state.rec.opt is not None:
        raise AssertionError("train_word did not build a frozen TrOCR base")
    counts_p = param_count(state)
    log(f"  train_word --recognizer trocr --trocr-preset base: parameters "
        f"{counts_p}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = random_batch(torch, cfg, 8, gen, "cuda")
    before = snapshot(torch, state)
    zero()
    losses = []
    for _ in range(8):
        _, metrics, _ = trainer.train_step(state, batch, gen)
        losses.append({k: float(v) for k, v in metrics.items()})
    train_counts = counts()
    bad = [(i, k) for i, m in enumerate(losses) for k, v in m.items()
           if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite losses with TrOCR: {bad[:5]}")
    after = snapshot(torch, state)
    if any(not torch.equal(before["rec"][k], after["rec"][k])
           for k in before["rec"]):
        raise AssertionError("the frozen TrOCR moved")
    if all(torch.equal(before["gen"][k], after["gen"][k])
           for k in before["gen"]):
        raise AssertionError("G did not move against the frozen TrOCR")
    if train_counts != (0, 0, 0):
        raise AssertionError(f"a train step launched a kernel: "
                             f"{train_counts}")
    log(f"  8 merged steps with TrOCR base, batch 8: losses finite, TrOCR "
        f"bit-unchanged, G moved; last losses {losses[-1]}")

    zero()
    em, _, _ = trainer.eval_step(state, {k: v for k, v in batch.items()
                                         if k != "label_ch0"})
    torch.cuda.synchronize()
    eval_counts = counts()
    if eval_counts != dec_launches(captures=1) or not all(
            math.isfinite(float(v)) for v in em.values()):
        raise AssertionError(f"eval step with TrOCR: launches "
                             f"{eval_counts}, losses {em}")
    log(f"  eval step: losses { {k: float(v) for k, v in em.items()} }, "
        f"launches {eval_counts}")

    run = make_generate_and_read_fn(
        cfg, state.gen.model.state_dict(), state.rec.model.state_dict(),
        seed=SEED)
    style = torch.randn(1, cfg.img_height, cfg.img_width, cfg.style_stack,
                        generator=gen, device="cuda")
    labels = encode_labels((WORDS * 8)[:64], cfg.output_max_len)
    run(style, labels)
    zero()
    images, ids = run(style, labels)
    torch.cuda.synchronize()
    req_counts = counts()
    # after the warm call the decoder replays: no kernel launched by the host
    if req_counts != dec_launches() or tuple(ids.shape) != (64, 11) or \
            not bool(torch.isfinite(images.float()).all()):
        raise AssertionError(f"TrOCR request: launches {req_counts}, ids "
                             f"{tuple(ids.shape)}")
    log(f"  1 x 64-word request with TrOCR base: launches a call "
        f"{req_counts}")
    trainer.logger.close()
    return {"param_count": counts_p,
            "launches_8_train_steps": list(train_counts),
            "launches_eval_step": list(eval_counts),
            "launches_request": list(req_counts)}


def phase_teacher(torch, counts, zero):
    """(c) ``run_teacher_phase`` at ``default_config()``, random weights,
    over 4 batches of 8: the on-device TrOCR teacher (base) and
    ``SelfTeacher`` (beam 3), each at ``conf_threshold`` 0.6 and 0.0."""
    from affganwriting_torch.core.config import default_config
    from affganwriting_torch.models.recognizer.trocr import TrOCRArch
    from affganwriting_torch.train.state import init_state
    from affganwriting_torch.train.teacher import (
        DeviceTrOCRTeacher,
        SelfTeacher,
        run_teacher_phase,
    )

    cfg = default_config()
    state = init_state(cfg, seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    batches = [random_batch(torch, cfg, 8, gen, "cuda") for _ in range(4)]
    teachers = {"trocr_base": DeviceTrOCRTeacher(
                    cfg, arch=TrOCRArch.base_handwritten(), seed=SEED),
                "self_beam3": SelfTeacher(cfg, state.rec.model, 3)}
    out, per_call = {}, set()
    for name, teacher in teachers.items():
        for threshold in (0.6, 0.0):
            before = snapshot(torch, state)["rec"]
            zero()
            _, stats = run_teacher_phase(state, cfg, teacher, iter(batches),
                                         gen, conf_threshold=threshold)
            calls = stats["used_batches"] + stats["skipped_small_batches"]
            c = counts()
            per_call.add(c)
            if calls != 4:
                raise AssertionError(f"teacher phase: {calls} generate "
                                     f"calls, launches {c}")
            after = snapshot(torch, state)["rec"]
            moved = any(not torch.equal(v, after[k])
                        for k, v in before.items())
            if threshold == 0.0 and not (
                    stats["used_batches"] == 4 and moved and math.isfinite(
                        stats["avg_pseudo_loss"])):
                raise AssertionError(f"teacher phase at threshold 0 did not "
                                     f"train R: {stats}, moved {moved}")
            log(f"  {name} at conf_threshold {threshold}: {stats}; R moved: "
                f"{moved}; launches over {calls} generate calls {c}")
            out[f"{name}@{threshold}"] = dict(stats, r_moved=moved)
    # each run puts G back in train mode, which drops the decoder's graph:
    # its first generate call captures, the other three replay
    if per_call != {dec_launches(captures=1)}:
        raise AssertionError(f"a teacher phase's 4 generate calls launched "
                             f"{per_call}, not one capture of the decoder")
    return {"runs": out, "launches_4_generate_calls": list(*per_call)}


def phase_htr(torch):
    """(d) ``HTRTrainer`` at ``default_config()``, batch 32: one epoch of 10
    steps on synthetic words with ``marcal_augment``, teacher rate 0.5."""
    import numpy as np

    from affganwriting_torch.core.config import VOCAB, default_config
    from affganwriting_torch.data.augment import marcal_augment
    from affganwriting_torch.data.words import synthetic_word_image
    from affganwriting_torch.train.htr_trainer import HTRTrainer

    cfg = default_config()
    trainer = HTRTrainer(cfg, seed=SEED)
    rng = np.random.default_rng(SEED)
    words = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog",
             "hello", "world", "recognizer", "word"]
    batches = []
    for _ in range(10):
        pick = [words[int(i)] for i in rng.integers(len(words), size=32)]
        img = np.stack([marcal_augment(
            (synthetic_word_image(w, int(s)) + 1.0) * 0.5, rng) * 2.0 - 1.0
            for w, s in zip(pick, rng.integers(500, size=32))])
        batches.append({"image": img[..., None].astype(np.float32),
                        "labels": np.asarray([VOCAB.pad_label(
                            w, cfg.output_max_len) for w in pick], np.int32)})
    before = {k: v.clone() for k, v in trainer.rec.state_dict().items()}
    m = trainer.train_epoch(batches, epoch=0, total_epochs=2)
    moved = any(not torch.equal(v, trainer.rec.state_dict()[k])
                for k, v in before.items())
    if not (math.isfinite(m["loss"]) and moved and m["teacher_rate"] == 0.5):
        raise AssertionError(f"HTR epoch: {m}, R moved {moved}")
    log(f"  HTR epoch of 10 steps, batch 32, teacher rate 0.5: {m}")
    return {"loss": m["loss"], "cer": m["cer"]}


def _corr(a, b) -> float:
    import numpy as np

    a = a.float().flatten().cpu().numpy().astype(np.float64)
    b = b.float().flatten().cpu().numpy().astype(np.float64)
    return float(np.corrcoef(a, b)[0, 1])


def phase_int8(torch, counts, zero):
    """10 (a), (b): the w8a8 serving mode at ``default_config()`` (bf16,
    random weights from the seed), 1 writer x 256 words.  (a) calibration
    (R's trunk on one bf16 batch, G's sites on the same request), the
    int8 route against the port's bf16 route under the JAX package's gates
    (trunk features: correlation > 0.98, relative error < 0.2; the static
    and dynamic decoders' images: correlation > 0.99), every int8 site
    through ``torch._int_mm`` (23 calls a request), and ``int8_conv``'s
    int32 sums on the card bit-equal to the CPU's at three of the trunk's
    layer shapes and G's ``res0.conv0`` (batch 8, random int8 codes);
    (b) the launches of the int8 generate call, then 10 int8 and 10 bf16
    requests in turns, none capturing the decoder again."""
    import numpy as np

    from affganwriting_torch.core.config import default_config
    from affganwriting_torch.gen.inference import (
        encode_labels,
        gen_fn_in_mode,
        make_generate_and_read_quant_fn,
    )
    from affganwriting_torch.ops.quant import (
        int8_conv_acc,
        quantize_weight,
        vgg_quant_apply,
    )

    cfg = default_config()
    run = make_generate_and_read_quant_fn(cfg, quant_gen="static", seed=SEED)
    gen, rec = run.gen, run.rec
    rng = np.random.default_rng(SEED)
    style = rng.normal(size=(1, cfg.img_height, cfg.img_width,
                             cfg.style_stack)).astype(np.float32)
    labels = encode_labels(WORDS * 32, cfg.output_max_len)

    out = {}
    run.calibrate(style, labels)
    with torch.inference_mode():
        img_bf16 = run.base.run_gen(style, labels)
        x = img_bf16.permute(0, 3, 1, 2)

    # (a) the int8 route against the bf16 route
    with torch.inference_mode():
        feat_ref = rec.enc.vgg(x.expand(-1, 3, -1, -1)).float()
        feat_q = vgg_quant_apply(run.qparams, x).float()
        corr = _corr(feat_q, feat_ref)
        rel = float((feat_q - feat_ref).norm() / feat_ref.norm())
        gates = {"trunk_corr": corr, "trunk_rel_err": rel}
        for mode in ("static", "dynamic"):
            img_q = gen_fn_in_mode(gen, mode, "cuda")(style, labels)
            gates[f"gen_{mode}_corr"] = _corr(img_q, img_bf16)
    log(f"  int8 vs bf16: trunk features corr {corr:.5f} (> 0.98), rel err "
        f"{rel:.4f} (< 0.2); images corr static "
        f"{gates['gen_static_corr']:.5f}, dynamic "
        f"{gates['gen_dynamic_corr']:.5f} (> 0.99)")
    if not (corr > 0.98 and rel < 0.2 and gates["gen_static_corr"] > 0.99
            and gates["gen_dynamic_corr"] > 0.99):
        raise AssertionError(f"int8 route outside the JAX gates: {gates}")
    out["gates"] = gates

    calls = [0]
    int_mm = torch._int_mm

    def counted(a, m):
        calls[0] += 1
        return int_mm(a, m)

    torch._int_mm = counted
    try:
        run(style, labels)
        torch.cuda.synchronize()
    finally:
        torch._int_mm = int_mm
    log(f"  torch._int_mm calls in an int8 request: {calls[0]} (16 trunk "
        "convs + 7 decoder sites)")
    if calls[0] != 23:
        raise AssertionError(f"{calls[0]} int8 GEMMs in a request, not 23")

    layers = run.qparams["layers"]
    g = torch.Generator().manual_seed(SEED)
    cases = {"vgg.conv0 (gray)": (layers[0]["wq_gray"], (8, 66, 218, 1)),
             "vgg.conv4": (layers[4]["wq"], (8, 18, 56, 128)),
             "vgg.conv12": (layers[12]["wq"], (8, 6, 15, 512)),
             "dec.res0.conv0": (quantize_weight(
                 gen.dec.res0.conv0.weight.float())[0], (8, 10, 29, 512))}
    exact = {}
    for name, (w, shape) in cases.items():
        xq = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        want = int8_conv_acc(xq, w.cpu())
        got = int8_conv_acc(xq.cuda(), w).cpu()
        exact[name] = bool(torch.equal(got, want))
        log(f"  int8_conv sums card vs CPU, {name} x {shape} w "
            f"{tuple(w.shape)}: {'bit-equal' if exact[name] else 'DIFFER'}"
            f" (max |acc| {int(want.abs().max())})")
    if not all(exact.values()):
        raise AssertionError(f"int8 sums differ card vs CPU: {exact}")

    # (b) the int8 generate call, then int8 and bf16 requests in turns
    zero()
    run(style, labels)
    torch.cuda.synchronize()
    launched = counts()
    if launched != dec_launches(eager=1):
        raise AssertionError(f"an int8 generate call launched {launched}, "
                             "not in_relu 2 and phase_head 1 (wgmma): the "
                             "decoder eager")
    out["launches_int8_generate_call"] = list(launched)
    run.base(style, labels)         # the float path's decoder graph
    zero()
    for _ in range(10):
        run(style, labels)
        run.base(style, labels)
    # the int8 calls run the decoder eager, and the bf16 calls between
    # them replay its graph: none captures again
    if counts() != dec_launches(eager=10):
        raise AssertionError(f"10 int8 and 10 bf16 requests in turns "
                             f"launched {counts()}, not "
                             f"{dec_launches(eager=10)}")
    log(f"  1 x {labels.shape[0]} words: int8 generate call launches "
        f"{launched}; 10 int8 and 10 bf16 requests in turns launched "
        f"{counts()}")
    del run, gen, rec
    torch.cuda.empty_cache()
    return out


def phase_int8_tools(torch, tmp: str):
    """10 (c) ``tools/ab_int8_static`` at batch 256 and ``cli/bench
    --headline int8 --batch 256 --quick``; (d) ``tools/ab_int8_cer`` on
    phase 7's ``best`` (4 writers x 64 words; the CER of random weights
    only shows the path runs)."""
    import os

    from affganwriting_torch.cli import bench
    from affganwriting_torch.tools import ab_int8_cer, ab_int8_static

    log("  tools/ab_int8_static --batch 256:")
    ab_int8_static.main(["--batch", "256"])
    torch.cuda.empty_cache()
    log("  cli/bench --headline int8 --batch 256 --quick:")
    result = bench.main(["--headline", "int8", "--batch", "256", "--quick"])
    if "gen_read_int8_imgs_per_sec" not in result["extra"] \
            or not result["metric"].endswith("(w8a8 serving mode)"):
        raise AssertionError(f"cli/bench --headline int8: {result}")
    torch.cuda.empty_cache()
    log("  tools/ab_int8_cer on phase 7's best:")
    cer = ab_int8_cer.main(["--ckpt", os.path.join(tmp, "run", "ckpt"),
                            "--ckpt-name", "best", "--writers", "4",
                            "--words", "64"])
    if cer["bf16"]["count"] != cer["int8"]["count"] or \
            not cer["bf16"]["count"]:
        raise AssertionError(f"ab_int8_cer read {cer}")
    torch.cuda.empty_cache()
    return {"ab_int8_cer": cer}


def _line_model(torch, seed: int, **kw):
    from affganwriting_torch.gen.inference import init_weights
    from affganwriting_torch.models.line.container import HWWithStyle

    return init_weights(HWWithStyle(**kw), seed).eval().requires_grad_(False)


def _line_batch(torch, b: int, t: int, width: int, n_class: int, seed: int):
    """Lines (b, 1, 64, width) and labels (b, t) of classes 1..n_class-1
    with lengths from t/2 to t, from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    img = torch.tanh(torch.randn((b, 1, 64, width), generator=g))
    label = torch.randint(1, n_class, (b, t), generator=g)
    lengths = torch.randint(t // 2, t + 1, (b,), generator=g)
    return img, label, lengths


def phase_line_reference(torch):
    """11 (a) A small f32 ``HWWithStyle`` (12 classes, style 16, generator
    32, spaced length 12; random weights from the seed) on the card
    against the CPU, with ``char_style_dim`` 0 and 16: the HWR's
    log-probs, the style (``a_batch_size`` 2), the counts and the spaced
    line, and the line generated from them with the same noise tensors;
    1e-3 of max(1, |CPU|), the spaced lines equal."""
    errs = {}
    for csd in (0, 16):
        kw = dict(n_class=12, style_dim=16, gen_dim=32, max_gen_length=12,
                  char_style_dim=csd)
        cpu_m = _line_model(torch, SEED, **kw)
        gpu_m = _line_model(torch, SEED, **kw).cuda()
        img, label, lengths = _line_batch(torch, 4, 5, 64, 12, SEED)
        g = torch.Generator().manual_seed(SEED)
        with torch.inference_mode():
            style, pred = cpu_m.extract_style(img, 2)
            spaced, counts, _ = cpu_m.space(label, lengths, style,
                                            generator=g)
            noise = [torch.randn(s, generator=g) for s in _noise_shapes(
                cpu_m, 4, 12)]
            line, _, _ = cpu_m(label, lengths, style, spaced, noise=noise)
            style_c, pred_c = gpu_m.extract_style(img.cuda(), 2)
            spaced_c, counts_c, _ = gpu_m.space(
                label.cuda(), lengths.cuda(), style_c,
                generator=torch.Generator(device="cuda").manual_seed(SEED))
            line_c, _, _ = gpu_m(label.cuda(), lengths.cuda(), style_c,
                                 spaced_c, noise=[n.cuda() for n in noise])
        e = {k: _rel_err(c.cpu(), w) for k, c, w in (
            ("pred", pred_c, pred), ("style", style_c, style),
            ("counts", counts_c, counts), ("line", line_c, line))}
        same = bool(torch.equal(spaced_c.cpu(), spaced))
        log(f"  char_style_dim {csd}: card vs CPU " + ", ".join(
            f"{k} {v:.3g}" for k, v in e.items())
            + f" (tol 1e-3); spaced lines {'equal' if same else 'DIFFER'}")
        if not same or max(e.values()) > 1e-3:
            raise AssertionError(f"line model card vs CPU: {e}, spaced "
                                 f"equal {same}")
        errs[csd] = e
    return errs


def _noise_shapes(model, b: int, length: int):
    """The ten noise shapes of the line generator for ``b`` lines of
    spaced length ``length``: two (b, C, H, W) a block."""
    gen = model.generator
    shapes, h, w = [], 4, length
    for i in range(5):
        block = getattr(gen, f"block{i}")
        if i in (1, 2):
            h *= 2
        elif i in (3, 4):
            h, w = 2 * h, 2 * w
        c = block.noise1.weight.shape[0]
        shapes += [(b, c, h, w)] * 2
    return shapes


def phase_line_full(torch, counts, zero):
    """11 (b) ``HWWithStyle`` at its published widths (80 classes, style
    128, generator 256, the cnn_only HWR with BatchNorm) with
    ``configs/cf_synth_charSpecMulti.json``'s ``char_style_dim`` 16 and
    ``max_gen_length`` 128, f32, random weights from the seed:
    ``extract_style`` on 16 lines of 64 x 512 with ``a_batch_size`` 2 and
    ``generate`` of 16 lines (16, 1, 64, 512); parameters; no kernel
    launched."""
    from affganwriting_torch.core.line_config import load_config

    root = Path(__file__).resolve().parent
    conf = load_config(str(root / "configs" / "cf_synth_charSpecMulti.json"))
    kw = dict(n_class=80, style_dim=128, gen_dim=256, hwr_type="cnn_only",
              char_style_dim=conf["model"]["char_style_dim"],
              max_gen_length=conf["model"]["max_gen_length"])
    a = conf["data_loader"]["a_batch_size"]
    model = _line_model(torch, SEED, **kw).cuda()
    n_params = sum(p.numel() for p in model.parameters())
    img, label, lengths = _line_batch(torch, 16, 40, 512, 80, SEED)
    img, label, lengths = img.cuda(), label.cuda(), lengths.cuda()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = {"params": n_params, **kw, "a_batch_size": a}
    zero()
    with torch.inference_mode():
        style, pred = model.extract_style(img, a)
        lines = model.generate(label, lengths, style, generator=g)
    torch.cuda.synchronize()
    out["launches"] = list(counts())
    d = kw["char_style_dim"]
    if tuple(style.shape) != (16, 128 + d + 80 * d) or \
            tuple(lines.shape) != (16, 1, 64, 512) or \
            not bool(torch.isfinite(lines).all()) or \
            not bool(torch.isfinite(style).all()) or \
            float(lines.abs().max()) > 1:
        raise AssertionError(f"line models: style {tuple(style.shape)}, "
                             f"lines {tuple(lines.shape)}")
    if not torch.equal(style[0], style[1]):
        raise AssertionError("an author's two lines got different styles")
    if out["launches"] != [0, 0, 0]:
        raise AssertionError(f"the line path launched {out['launches']}")
    log(f"  HWWithStyle {n_params / 1e6:.2f} M parameters (char_style_dim "
        f"{d}, max_gen_length {kw['max_gen_length']}): extract_style of "
        f"16 x 64 x 512, a_batch_size {a}; generate (16, 1, 64, 512); HWR "
        f"log-probs {tuple(pred.shape)}; kernel launches {out['launches']}")
    del model
    torch.cuda.empty_cache()
    return out


LINE_SMALL = dict(n_class=12, style_dim=16, max_gen_length=32,
                  char_style_dim=4)
# phase 12a's limits, card against CPU (f32, TF32 off): losses 1e-4 of
# max(1, |CPU|); parameters after the update 1e-6 absolute (the warmed
# Adam's 4th update, b1 0.5, is lr * 0.53 * (mu + g) / sqrt(nu / 0.004)
# ~ 2.9e-4 * (mu + g) at lr 2e-4, ~3e-6, the moments' part the same on
# both sides: this holds Adam's arithmetic, not the gradient); u/sigma
# 1e-5
LINE_TOL = {"loss": 1e-4, "param": 1e-6, "sn": 1e-5}
# the gradient each stepping lesson hands its optimizer (after the clip
# and the balance), per leaf in relative L2: the card's f32 against the
# CPU's f64 on the same batch and state, within the lesson's limit here
# plus twice the CPU's own f32 gap to f64 on that leaf (``grad_check``).
# Readings card against CPU f32 on an H100 over runs: count
# 1.0e-3-4.2e-3, auto 1.8e-3-1.6e-2, auto-gen 9.1e-4-2.0e-3, gen
# 3.4e-4-4.0e-4, disc 9.3e-6-1.7e-5.  The worst leaves of count and auto
# are the style encoder's GroupNorm and first conv, whose gradients are
# cancelled sums (norm ~5e-4 in auto) that f32 and the card's reduction
# order move by up to ~1e-2; the CTC gradient in gen and auto-gen is
# ill-conditioned too (tests/test_torch_line_rotation.py).  The batch's
# synthetic lines seed from ``hash(author)``, so every process draws
# another batch, and on some draws the f32 gradient itself lies far from
# f64: over 28 string-hash seeds (tests/torch_line_grad_noise.py) the
# CPU's worst leaf read up to count 7.0e-3, auto 1.8e-2, auto-gen 1.4e-2,
# gen 4.7e-3 and disc 6.5e-2 (D's ``c4c.bias``; median 1.6e-4), and one
# whole run read disc 1.33e-3 card against CPU.  The gap term takes that
# draw's noise; the limits are the card-vs-CPU ones of the first line
# GAN check, so a leaf off by more than them on a well-conditioned draw
# fails.  Over 13 seeds on an H100 the card's f32 read at most 0.39 of its
# limit (gen 1.97e-3, disc 3.8e-4 against f64).
LINE_GRAD_TOL = {"count": 5e-2, "auto": 1e-1, "auto-gen": 2e-2,
                 "gen": 5e-3, "disc": 1e-3}
# a leaf whose f64 gradient is under 1e-6 of the step's largest (a bias
# before a train-mode norm, whose batch mean cancels it) is null: its
# card gradient, over that largest norm, stays under this
GRAD_NULL_TOL = 1e-5
# the same gradient computed in f64 on the card and on the CPU, from the
# same inputs (12a's spaced labels, which the trainer aligns on each
# device, are discrete), per leaf in relative L2.  Readings on an H100
# over 4 string-hash seeds: 1.9e-15-2.5e-13 in every 12a lesson, the
# stash and 13a/b.  A fault in the card's code path shows here far below
# the f32 limits, which a kink of the losses' ReLUs and hinges crossed in
# f32 rounding can reach.
F64_TOL = 1e-9
# the no-step lesson's stashed gradients, relative L2 over the main tree,
# the card's f32 against the CPU's f64 within the limit here plus twice
# the CPU's own f32 gap, and the card's f64 within ``F64_TOL``: f32 puts
# the CTC one ~1e-3 from f64 on either device (the same reading as
# tests/test_torch_line_rotation.py's), hinge G ~1e-5.  Over 15
# string-hash seeds on an H100 the card's f32 G gradient through D read
# 6.8e-7-2.2e-5 from f64 on 13 draws and 1.35e-4 and 3.19e-4 on two,
# where the CPU's read 7.1e-7 and 7.6e-7 and the card's f64 within 8.9e-7
# of the CPU's (the CPU's own f32 reached 4.7e-4 on a third draw): a
# heavy tail of f32 rounding that the first limit, 1e-4, sat inside
STASH_TOL = {"g_ctc": 5e-3, "g_adv": 1e-3}


class _ZeroNoise:
    """Inside the block the line generator's noise injections add nothing
    (their inputs' noise times 0): the card's and the CPU's generators
    draw different noise, and a noise weight's gradient is the noise."""

    def __enter__(self):
        from affganwriting_torch.models.line import spaced_gen

        self.cls, self.orig = spaced_gen.NoiseInjection, \
            spaced_gen.NoiseInjection.forward
        orig = self.orig
        self.cls.forward = lambda m, x, noise: orig(m, x, noise * 0)
        return self

    def __exit__(self, *exc):
        self.cls.forward = self.orig


def _small_line_trainer(torch, device):
    """``LineGanTrainer`` at phase 12a's size (12 classes, style 16,
    generator 32, D dim 8, AE dim 8, spaced length 32, char_style_dim 4),
    its modules drawn from the seed, dropout off, its Adam moments warmed
    from the seed: the same state on every device."""
    from affganwriting_torch.models.line.autoencoder import Autoencoder
    from affganwriting_torch.models.line.container import HWWithStyle
    from affganwriting_torch.models.line.discriminator import DiscriminatorAP
    from affganwriting_torch.train.line_trainer import LineGanTrainer

    tr = LineGanTrainer(**LINE_SMALL, seed=SEED, device=device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        tr.model = HWWithStyle(gen_dim=32, **LINE_SMALL)
        tr.disc = DiscriminatorAP(dim=8)
        tr.ae = Autoencoder(dim=8)
    tr.train_dropout = False
    state = tr.init_state()
    g = torch.Generator().manual_seed(SEED)
    for opt, named in ((state.main_opt.opt, state.main_opt.trained),
                       (state.disc_opt, None)):
        params = [p for grp in opt.param_groups for p in grp["params"]]
        for p in params:
            opt.state[p] = {
                "step": torch.tensor(3.0),
                "exp_avg": (torch.randn(p.shape, generator=g) * 1e-2).to(p),
                "exp_avg_sq": (torch.rand(p.shape, generator=g) * 9e-4
                               + 1e-4).to(p)}
    state.main_opt.count = 3
    return tr, state


def _line_lessons(torch, tr, state, batch):
    """Each lesson step once from (a copy of) ``state``: {lesson: (losses,
    the state after it, {name: the gradient handed to the optimizer} or
    None where no optimizer steps)}; the no-step gen lesson's gradients
    feed auto-gen."""
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    log = []

    def hook(opt, args, kwargs):
        log.append({id(p): p.grad.detach().clone()
                    for grp in opt.param_groups for p in grp["params"]
                    if p.grad is not None})

    handle = register_optimizer_step_pre_hook(hook)
    try:
        out = _line_lesson_steps(torch, tr, state, batch, log)
    finally:
        handle.remove()
    return out


def _line_lesson_steps(torch, tr, state, batch, log):
    import copy

    def grads(lesson, s, kind=None):
        """The optimizer steps logged since the last call: one by ``kind``
        ("main" or "disc") of ``s``, as {name: gradient}, or none."""
        entries = list(log)
        log.clear()
        if kind is None:
            if entries:
                raise AssertionError(f"{lesson}: an optimizer stepped")
            return None
        named = (s.main_params() if kind == "main"
                 else dict(s.disc.named_parameters()))
        if len(entries) != 1:
            raise AssertionError(f"{lesson}: {len(entries)} optimizer steps")
        got = {n: entries[0][id(p)] for n, p in named.items()
               if id(p) in entries[0]}
        if not got:
            raise AssertionError(f"{lesson}: the {kind} optimizer did not "
                                 "step")
        return got

    image, label, lengths = tr._put_batch(batch)
    spaced = tr.spaced_label(state, batch)
    oh = tr._spaced_onehot(spaced)
    gt = tr._put(tr.count_targets(spaced, batch["label"],
                                  batch["label_lengths"]))
    fg = torch.ones_like(image)
    style = tr._put(tr._extract(state, image))
    g = tr.generator
    out = {}
    log.clear()
    s, m = tr.count_step(copy.deepcopy(state), image, label, lengths, gt, g)
    out["count"] = (m, s, grads("count", s, "main"))
    s, m, _ = tr.auto_step(copy.deepcopy(state), image, label, lengths, oh,
                           g, fg)
    out["auto"] = (m, s, grads("auto", s, "main"))
    m, g_ctc, g_adv, _ = tr.gen_grads_step(state, label, lengths, style, g)
    out["no-step gen"] = (m, state, grads("no-step gen", state))
    out["stash"] = {"g_ctc": g_ctc, "g_adv": g_adv}
    s, m, _ = tr.auto_gen_step(copy.deepcopy(state), image, label, lengths,
                               oh, g, (0.6, 0.5, 0.4), g_ctc, g_adv, fg)
    out["auto-gen"] = (m, s, grads("auto-gen", s, "main"))
    s, m, _ = tr.gen_step(copy.deepcopy(state), label, lengths, style, g,
                          0.6)
    out["gen"] = (m, s, grads("gen", s, "main"))
    s, m = tr.disc_step(copy.deepcopy(state), image, label, lengths, style,
                        g)
    out["disc"] = (m, s, grads("disc", s, "disc"))
    m = tr.valid_step(state, image, label, lengths, oh,
                      torch.Generator(tr.device).manual_seed(0), fg, gt)
    out["valid"] = (m, state, grads("valid", state))
    return out


def _rel_l2(got, want) -> float:
    """||got - want|| / ||want|| in f64 (absolute where ``want`` is 0)."""
    d = float((got.double() - want.double()).norm())
    n = float(want.double().norm())
    return d / n if n > 0 else d


def _tree_rel_l2(got: dict, want: dict) -> float:
    """||got - want|| / ||want|| over every leaf of {name: tensor}, in
    f64."""
    num = sum(float(((got[n].cpu().double() - w.double()) ** 2).sum())
              for n, w in want.items())
    return (num / sum(float((w.double() ** 2).sum())
                      for w in want.values())) ** 0.5


def grad_check(what: str, card: dict, cpu: dict, f64: dict, card64: dict,
               tol: float) -> dict:
    """Per leaf of {name: gradient}: the card's f32 against the CPU's f64
    on the same batch and state, in relative L2, within ``tol`` plus twice
    the CPU's own f32 gap to f64 there; the card's f64 (``card64``)
    against the CPU's within ``F64_TOL``; a null leaf (f64 norm under 1e-6
    of the largest) within ``GRAD_NULL_TOL`` of the largest norm.  Returns
    the readings; raises over a limit."""
    if any(d.keys() != f64.keys() for d in (card, cpu, card64)):
        raise AssertionError(f"{what}: the runs' gradients name other "
                             "parameters")
    scale = max(float(g.norm()) for g in f64.values())
    rows, null, same = [], 0.0, 0.0
    for k, ref in f64.items():
        norm = float(ref.norm())
        if norm <= 1e-6 * scale:
            null = max(null, float(card[k].double().norm()) / scale)
            continue
        err = _rel_l2(card[k].cpu(), ref)
        gap = _rel_l2(cpu[k], ref)
        same = max(same, _rel_l2(card64[k].cpu(), ref))
        rows.append((err / (tol + 2 * gap), k, err, gap, norm / scale))
    ratio, k, err, gap, rel_norm = max(rows)
    out = {"worst": k, "card_f64": err, "cpu_f64": gap,
           "limit": tol + 2 * gap, "norm": rel_norm, "null": null,
           "card_cpu": _rel_l2(card[k].cpu(), cpu[k]), "f64_card_cpu": same}
    if ratio > 1 or null > GRAD_NULL_TOL or same > F64_TOL:
        raise AssertionError(f"{what}: gradient {out} over its limit "
                             f"({tol} + 2 x the CPU's gap; null "
                             f"{GRAD_NULL_TOL}; f64 {F64_TOL})")
    return out


def line_lesson_grads(torch, batch, f64: bool, device="cpu") -> dict:
    """{lesson: {name: the gradient its optimizer was handed}} of each
    stepping lesson (count, auto, auto-gen, gen, disc) of phase 12a's
    small trainer on ``device``, from its seeded state on ``batch``, in
    f32 or with the port's modules in f64 (``in_f64``), and under "stash"
    the no-step lesson's {"g_ctc", "g_adv": {name: gradient}}; every
    gradient on the host, in f64."""
    import copy

    from torch.optim.optimizer import register_optimizer_step_pre_hook

    from affganwriting_torch.train.parity import in_f64

    log = []

    def hook(opt, args, kwargs):
        log.append({id(p): p.grad.detach().double().cpu()
                    for grp in opt.param_groups for p in grp["params"]
                    if p.grad is not None})

    def maybe_f64(s):
        return in_f64(s.model, s.disc, s.ae) if f64 else \
            contextlib.nullcontext()

    with _ZeroNoise():
        tr, state = _small_line_trainer(torch, device)
        image, label, lengths = tr._put_batch(batch)
        spaced = tr.spaced_label(state, batch)
        oh = tr._spaced_onehot(spaced)
        gt = tr._put(tr.count_targets(spaced, batch["label"],
                                      batch["label_lengths"]))
        fg = torch.ones_like(image)
        if f64:
            image, oh, gt, fg = (t.double() for t in (image, oh, gt, fg))
        # the style codes in f64 too: the CTC gradient amplifies an f32
        # rounding of its inputs up to ~5e-4 on an ill-conditioned draw
        with maybe_f64(state):
            style = tr._put(tr._extract(state, image))
        g = tr.generator
        out = {}

        def run(lesson, kind, fn, s):
            log.clear()
            try:
                with maybe_f64(s):
                    fn(s)
            except RuntimeError:
                # Adam's f32 moments refuse an f64 gradient after the
                # hook has logged it
                if not f64:
                    raise
            named = (s.main_params() if kind == "main"
                     else dict(s.disc.named_parameters()))
            out[lesson] = {n: log[0][id(p)] for n, p in named.items()
                           if id(p) in log[0]}

        handle = register_optimizer_step_pre_hook(hook)
        try:
            run("count", "main", lambda s: tr.count_step(
                s, image, label, lengths, gt, g), copy.deepcopy(state))
            run("auto", "main", lambda s: tr.auto_step(
                s, image, label, lengths, oh, g, fg), copy.deepcopy(state))
            stash = copy.deepcopy(state)
            with maybe_f64(stash):
                _, g_ctc, g_adv, _ = tr.gen_grads_step(
                    stash, label, lengths, style, g)
            out["stash"] = {k: {n: t.detach().double().cpu() for n, t in
                                tree.items()}
                            for k, tree in (("g_ctc", g_ctc),
                                            ("g_adv", g_adv))}
            run("auto-gen", "main", lambda s: tr.auto_gen_step(
                s, image, label, lengths, oh, g, (0.6, 0.5, 0.4), g_ctc,
                g_adv, fg), stash)
            run("gen", "main", lambda s: tr.gen_step(
                s, label, lengths, style, g, 0.6), copy.deepcopy(state))
            run("disc", "disc", lambda s: tr.disc_step(
                s, image, label, lengths, style, g), copy.deepcopy(state))
        finally:
            handle.remove()
    return out


def line_small_batch() -> dict:
    """Phase 12a's batch: 2 synthetic lines of 64 x 128 (seeded from
    ``hash(author)``), their labels folded into ``LINE_SMALL``'s 12
    classes."""
    import numpy as np

    from affganwriting_torch.data.lines import LineCharset, LineDataset

    ds = LineDataset(LineCharset(), authors=["a000", "a001"],
                     a_batch_size=2, width=128, label_len=24, seed=SEED)
    batch = next(ds.batches(2))
    k = LINE_SMALL["n_class"]
    batch["label"] = np.where(batch["label"] > 0,
                              batch["label"] % (k - 1) + 1, 0)
    return batch


def phase_line_train_reference(torch):
    """12 (a) Each of the seven lesson steps (count, auto, auto-gen,
    no-step gen, gen, disc, valid) of a small f32 ``LineGanTrainer`` on the
    card against the CPU, from one state (the seed's weights, warmed Adam
    moments, dropout off, generator noise times 0): losses, the updated
    main tree and D, D's ``u``/``sigma`` (``LINE_TOL``), the gradient
    each stepping lesson hands its optimizer (``LINE_GRAD_TOL``), the
    no-step lesson's stashed gradients (``STASH_TOL``); synthetic lines
    of 64 x 128, their labels folded into the 12 classes.  The gradients
    are held against the same lessons on the CPU in f64
    (``line_lesson_grads``, ``grad_check``)."""
    batch = line_small_batch()
    with _ZeroNoise():
        cpu_tr, cpu_state = _small_line_trainer(torch, "cpu")
        card_tr, card_state = _small_line_trainer(torch, "cuda")
        want = _line_lessons(torch, cpu_tr, cpu_state, batch)
        got = _line_lessons(torch, card_tr, card_state, batch)
    ref = line_lesson_grads(torch, batch, f64=True)
    card64 = line_lesson_grads(torch, batch, f64=True, device="cuda")
    errs = {}
    stash_want, stash_got = want.pop("stash"), got.pop("stash")
    for k, tol in STASH_TOL.items():
        f64 = ref["stash"][k]
        errs[k] = {"card_f64": _tree_rel_l2(stash_got[k], f64),
                   "cpu_f64": _tree_rel_l2(stash_want[k], f64),
                   "card_cpu": _tree_rel_l2(stash_got[k], stash_want[k]),
                   "f64_card_cpu": _tree_rel_l2(card64["stash"][k], f64)}
        errs[k]["limit"] = tol + 2 * errs[k]["cpu_f64"]
        log(f"  stashed {k}, relative L2 over the tree: card vs f64 "
            f"{errs[k]['card_f64']:.3g}, CPU vs f64 {errs[k]['cpu_f64']:.3g}"
            f", limit {errs[k]['limit']:.3g}; card vs CPU "
            f"{errs[k]['card_cpu']:.3g}; in f64 card vs CPU "
            f"{errs[k]['f64_card_cpu']:.3g}")
        if not (errs[k]["card_f64"] <= errs[k]["limit"]
                and errs[k]["f64_card_cpu"] <= F64_TOL):
            raise AssertionError(f"stashed {k}: {errs[k]}")
    for lesson, (m_want, s_want, g_want) in want.items():
        m_got, s_got, g_got = got[lesson]
        loss = max(abs(float(m_got[k]) - float(v)) / max(1.0, abs(float(v)))
                   for k, v in m_want.items())
        pairs = zip([*s_got.model.parameters(), *s_got.disc.parameters()],
                    [*s_want.model.parameters(), *s_want.disc.parameters()])
        param = max(float((p.detach().cpu() - q.detach()).abs().max())
                    for p, q in pairs)
        sn_got, sn_want = s_got.disc.sn_state(), s_want.disc.sn_state()
        sn = max(float((sn_got[k].cpu() - v).abs().max())
                 for k, v in sn_want.items())
        errs[lesson] = {"loss": loss, "param": param, "sn": sn}
        log(f"  {lesson}: losses {loss:.3g}, parameters {param:.3g}, "
            f"u/sigma {sn:.3g} (card vs CPU; limits {LINE_TOL})")
        if any(errs[lesson][k] > tol for k, tol in LINE_TOL.items()):
            raise AssertionError(f"line lesson {lesson}: card vs CPU "
                                 f"{errs[lesson]}")
        if g_want is not None:
            grad = grad_check(f"line lesson {lesson}", g_got, g_want,
                              ref[lesson], card64[lesson],
                              LINE_GRAD_TOL[lesson])
            errs[lesson]["grad"] = grad
            log(f"    optimizer's gradient, worst leaf {grad['worst']} "
                f"(norm {grad['norm']:.3g} of the largest): card vs f64 "
                f"{grad['card_f64']:.3g}, CPU vs f64 {grad['cpu_f64']:.3g}, "
                f"limit {grad['limit']:.3g}; card vs CPU "
                f"{grad['card_cpu']:.3g}; in f64 card vs CPU "
                f"{grad['f64_card_cpu']:.3g}; null leaves {grad['null']:.3g}")
    moved = any(not torch.equal(want["disc"][1].disc.sn_state()[k], v)
                for k, v in cpu_state.disc.sn_state().items())
    if not moved:
        raise AssertionError("disc did not move D's u/sigma")
    return errs


def _frozen_snapshot(state) -> dict:
    sd = {f"model.{k}": v.detach().clone()
          for k, v in state.model.state_dict().items()
          if k.startswith("hwr.")}
    sd.update({f"ae.{k}": v.detach().clone()
               for k, v in state.ae.state_dict().items()})
    return sd


def phase_line_train(torch, counts, zero):
    """12 (b) ``LineGanTrainer`` at the published widths (80 classes, style
    128, generator 256, the cnn_only HWR with BatchNorm, D at dim 64, the
    default ``Autoencoder``) with ``configs/cf_synth_charSpecMulti.json``'s
    ``char_style_dim`` 16 and ``max_gen_length`` 128, f32, random weights
    from the seed, on synthetic lines (2 authors x ``a_batch_size`` 2, 64 x
    512): three rotations of the seven-lesson curriculum and one
    ``validate`` batch; losses finite, the HWR (its BatchNorm statistics
    included) and the AE bit-unchanged, D's ``u`` moved, the no-step stash
    consumed at auto-gen; parameter counts; no kernel launched."""
    from affganwriting_torch.core.line_config import load_config
    from affganwriting_torch.data.lines import LineCharset, LineDataset
    from affganwriting_torch.train.line_trainer import LineGanTrainer

    root = Path(__file__).resolve().parent
    conf = load_config(str(root / "configs" / "cf_synth_charSpecMulti.json"))
    charset = LineCharset()
    tr = LineGanTrainer(n_class=charset.n_class, style_dim=128,
                        max_gen_length=conf["model"]["max_gen_length"],
                        char_style_dim=conf["model"]["char_style_dim"],
                        lr=conf["optimizer"]["lr"], seed=SEED)
    ds = LineDataset(charset, a_batch_size=conf["data_loader"]["a_batch_size"],
                     width=512, seed=SEED)
    batches = (b for epoch in range(100) for b in ds.batches(
        conf["data_loader"]["batch_size"], epoch=epoch))
    state = tr.init_state()
    counts_p = {
        "main": sum(p.numel() for p in state.main_params().values()),
        "hwr": sum(p.numel() for p in state.model.hwr.parameters()),
        "disc": sum(p.numel() for p in state.disc.parameters()),
        "ae": sum(p.numel() for p in state.ae.parameters())}
    frozen = _frozen_snapshot(state)
    u0 = state.disc.sn_state()
    n_rot = len(tr.curriculum.stages[0][1])
    zero()
    stash = []
    for it in range(3 * n_rot):
        batch = next(batches)
        lesson = ",".join(tr.curriculum.get_lesson(it))
        state, metrics = tr.train_iteration(state, it, batch)
        stash.append((lesson, tr._saved_grads is not None))
        bad = {k: float(v) for k, v in metrics.items()
               if not math.isfinite(float(v))}
        if bad or not metrics:
            raise AssertionError(f"iteration {it} ({lesson}): metrics "
                                 f"{ {k: float(v) for k, v in metrics.items()} }")
    launches = list(counts())
    val = tr.validate(state, iter([next(batches)]))
    changed = [k for k, v in _frozen_snapshot(state).items()
               if not torch.equal(v, frozen[k])]
    if changed:
        raise AssertionError(f"frozen HWR/AE tensors moved: {changed[:5]}")
    if all(torch.equal(state.disc.sn_state()[k], v) for k, v in u0.items()
           if k.endswith(".u")):
        raise AssertionError("D's u did not move")
    for lesson, pending in stash:
        want = "no-step" in lesson
        if pending != want:
            raise AssertionError(f"the stash after {lesson}: pending "
                                 f"{pending}")
    if launches != [0, 0, 0]:
        raise AssertionError(f"the line train iterations launched "
                             f"{launches}")
    if not all(math.isfinite(v) for v in val.values()):
        raise AssertionError(f"validate {val}")
    log(f"  LineGanTrainer at full width (char_style_dim "
        f"{conf['model']['char_style_dim']}, max_gen_length "
        f"{conf['model']['max_gen_length']}, 4 lines of 64 x 512): "
        f"{3 * n_rot} iterations, losses finite; validate (1 batch) {val}")
    log(f"  parameters {counts_p}; HWR, its BatchNorm statistics and the AE "
        f"bit-unchanged ({len(frozen)} tensors); D's u moved; stash "
        f"{stash[:n_rot]}; kernel launches {launches}")
    out = {"params": counts_p, "launches": launches, "val": val}
    del tr, state
    torch.cuda.empty_cache()
    return out


def phase_line_clis(torch, tmp: str, counts, zero):
    """12 (c) The user's path through the CLIs, on the card, in ``tmp``:
    ``cli/train_line --config configs/cf_synth_charSpecMulti.json`` for one
    rotation (7 iterations, SWA from 5, validation and a sheet at 7, a save
    of ``latest``), its checkpoint restored bit for bit (Adam, SWA and
    iteration included), then resumed for 2 iterations more;
    ``validate``; ``cli/get_styles`` from the checkpoint; ``generate_lines``
    of 16 texts in library styles; and
    ``serve/app.py --selftest`` on the checkpoint (the image finite, its
    PNG bytes decoded back by ``utils/png``'s zlib reader to the same
    page).  Kernel launches of the generate call counted."""
    import os

    import numpy as np

    from affganwriting_torch.cli import get_styles, train_line
    from affganwriting_torch.core.checkpoint import (
        LineCheckpointManager,
        line_payload,
        restore_line_trainer,
    )
    from affganwriting_torch.data.lines import LineCharset, LineDataset
    from affganwriting_torch.gen.line_inference import generate_lines
    from affganwriting_torch.serve import app
    from affganwriting_torch.utils.png import decode_gray_png

    root = Path(__file__).resolve().parent
    logdir = os.path.join(tmp, "line")
    ckdir = os.path.join(logdir, "ckpt")
    base = ["--config", str(root / "configs" / "cf_synth_charSpecMulti.json"),
            "-a", "trainer.save_step_minor=7", "-a", "trainer.val_step=7",
            "-a", "trainer.save_step=7", "-a", "trainer.swa_start=5",
            "--val-batches", "1", "--sheet-every", "7",
            "--restart-rss-gb", "0", "--logdir", logdir]
    out = {}
    train_line.main(base + ["-a", "trainer.iterations=7"])
    saved = LineCheckpointManager(ckdir).load("latest", "cpu")
    if saved["iteration"] != 7 or saved["swa"]["count"] != 3:
        raise AssertionError(f"latest: iteration {saved['iteration']}, SWA "
                             f"count {saved['swa']['count']}")
    tr, payload = restore_line_trainer(ckdir)
    again = line_payload(payload)
    fields = _compare_payloads(torch, _to_cpu(torch, again), saved)
    lines = [json.loads(s) for s in open(f"{logdir}/metrics.jsonl")]
    if not any(r["group"] == "line_valid" for r in lines) or not all(
            math.isfinite(v) for r in lines for k, v in r.items()
            if k not in ("group", "step", "time")):
        raise AssertionError(f"metrics {lines}")
    sheets = os.listdir(os.path.join(logdir, "sheets"))
    charset = LineCharset()
    val = tr.validate(payload["state"], LineDataset(
        charset, a_batch_size=2, width=512, seed=SEED + 1).batches(2),
        max_batches=1)
    train_line.main(base + ["-a", "trainer.iterations=9"])
    resumed = LineCheckpointManager(ckdir).load("latest", "cpu")
    if resumed["iteration"] != 9 or resumed["swa"]["count"] != 5:
        raise AssertionError(f"resumed latest: iteration "
                             f"{resumed['iteration']}, SWA count "
                             f"{resumed['swa']['count']}")
    lib_path = os.path.join(tmp, "styles.pkl")
    library = get_styles.main(["--ckpt", ckdir, "--out", lib_path,
                               "--n-authors", "8", "--width", "512",
                               "--eval-writer-id"])
    tr, payload = restore_line_trainer(ckdir, name="best" if os.path.exists(
        os.path.join(ckdir, "best")) else "latest")
    texts = [" ".join(WORDS[i % 8: i % 8 + 3]) for i in range(16)]
    styles = library.styles[np.arange(16) % len(library.styles)]
    zero()
    lines_out = generate_lines(tr, payload["state"], texts, styles, charset)
    out["launches_generate_call"] = list(counts())
    if lines_out.shape != (16, 64, 4 * tr.max_gen_length, 1) or \
            not np.isfinite(lines_out).all():
        raise AssertionError(f"generate_lines {lines_out.shape}")
    del tr, payload
    res = app.main(["--selftest", "--ckpt", ckdir])
    decoded = decode_gray_png(res["png"])
    if res["image"].shape[:2] != (1, 64) or \
            not np.isfinite(res["image"]).all() or \
            not np.array_equal(decoded, res["page"]):
        raise AssertionError(f"selftest image {res['image'].shape}, PNG "
                             "decoded to another page")
    if out["launches_generate_call"] != [0, 0, 0]:
        raise AssertionError(f"generate_lines launched "
                             f"{out['launches_generate_call']}")
    log(f"  train_line --config cf_synth_charSpecMulti: 7 iterations; "
        f"restore bit-equal to the save in {fields} fields (Adam, SWA "
        f"count 3, iteration 7); sheets {sorted(sheets)}; resumed for 2 "
        f"more (iteration 9, SWA count 5); validate {val}; get_styles "
        f"{len(library.styles)} styles; generate_lines 16 x (64, "
        f"{4 * 128}), launches {out['launches_generate_call']}; selftest "
        f"{res['image'].shape}, "
        f"PNG {len(res['png'])} bytes decoded equal, emuru "
        f"{res['emuru'][:40]}")
    out.update(fields=fields, validate=val, styles=len(library.styles),
               png_bytes=len(res["png"]))
    torch.cuda.empty_cache()
    return out


def _to_cpu(torch, tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(torch, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(torch, v) for v in tree)
    return tree


def phase_entry_and_benches(torch, counts, zero):
    """(e) ``entry()``, ``cli/bench --batch 256 --quick`` and
    ``cli/bench_kernels`` at batch 256."""
    from affganwriting_torch.cli import bench, bench_kernels
    from affganwriting_torch.entry import entry

    fn, args = entry()
    zero()
    images = fn(*args)
    torch.cuda.synchronize()
    c = counts()
    if tuple(images.shape) != (8, 64, 216, 1) or \
            c != dec_launches(captures=1) or \
            not bool(torch.isfinite(images.float()).all()):
        raise AssertionError(f"entry(): {tuple(images.shape)}, launches {c}")
    log(f"  entry(): images {tuple(images.shape)} {images.dtype}, launches "
        f"{c}")
    log("  cli/bench --batch 256 --quick:")
    bench.main(["--batch", "256", "--quick"])
    log("  cli/bench_kernels --batch 256:")
    lines = bench_kernels.main(["--batch", "256"])
    if [r["kernel"] for r in lines] != ["in_relu", "in_relu", "phase_head",
                                        "phase_head"]:
        raise AssertionError(f"bench_kernels --batch 256: {lines}")
    return {"entry_launches": list(c)}


def _until_end(row, end):
    return row[: row.index(end)] if end in row else row


def _compare_payloads(torch, got, want, where="") -> int:
    """Bit-equality of two checkpoint dicts; returns the fields compared."""
    if isinstance(want, torch.Tensor):
        if not (got.dtype == want.dtype and torch.equal(got, want)):
            raise AssertionError(f"{where} differs after the resume")
        return 1
    if isinstance(want, dict):
        if got.keys() != want.keys():
            raise AssertionError(f"{where}: keys differ after the resume")
        return sum(_compare_payloads(torch, got[k], want[k], f"{where}.{k}")
                   for k in want)
    if isinstance(want, (list, tuple)):
        return sum(_compare_payloads(torch, g, w, f"{where}[{i}]")
                   for i, (g, w) in enumerate(zip(got, want)))
    if got != want:
        raise AssertionError(f"{where}: {got} != {want} after the resume")
    return 1


# phase 13: card vs CPU limits of one pretraining step (f32, TF32 off):
# the loss relative, the parameters absolute, the BatchNorm statistics
# relative to max(1, |CPU|); the gradient that reaches Adam per leaf in
# relative L2 (leaves with a null gradient, the conv biases before a
# train-mode BatchNorm, held as null leaves), by trainer, the card's f32
# against the CPU's f64 within the limit here plus twice the CPU's own
# f32 gap (``grad_check``).  With Adam's moments warmed at the gradients'
# scale an update is ~1e-6..1e-5, so the parameter limit holds Adam's
# arithmetic and the gradient limit the gradient.  Card against CPU f32,
# chip calls read 6.0e-3-7.9e-3 on the HWR's worst leaf
# (``cnn.conv0.bias``; 8 lines of 64 x 512 through three train-mode
# BatchNorm stages, whose batch-mean subtraction cancels, in another
# reduction order on each device) and 8.4e-4-5.2e-3 on the AE's.  The
# batch seeds from ``hash(author)``: over 28 string-hash seeds the CPU's
# own f32 gradient lay up to 1.2e-2 (HWR) and 4.9e-3 (AE) from f64 on its
# worst leaf (tests/torch_line_grad_noise.py); the gap term takes that
# draw's noise.  The card's own f32 HWR gradient is no less noisy: over
# 13 string-hash seeds on an H100 it read 3.2e-3-1.02e-2 from f64 on its
# worst leaf where the CPU's read 2.2e-4-8.9e-3 (4.6e-3 against 2.2e-4 on
# one draw), the AE's 6.8e-6-7.2e-4; hence the HWR's 2e-2.  The card's
# f64 gradient lies within 2.6e-13 of the CPU's (``F64_TOL``).
PRETRAIN_TOL = {"loss": 1e-4, "param": 1e-6, "stats": 1e-4}
PRETRAIN_GRAD_TOL = {"train_hwr": 2e-2, "AutoTrainer": 1e-3}


def _warm_adam(torch, opt, seed: int) -> None:
    """Adam's moments drawn from ``seed`` at the gradients' scale (mu N(0,
    0.1), nu U(0.1, 1)), every step count at 3: the same on every
    device."""
    g = torch.Generator().manual_seed(seed)
    for grp in opt.param_groups:
        for p in grp["params"]:
            opt.state[p] = {
                "step": torch.tensor(3.0),
                "exp_avg": (torch.randn(p.shape, generator=g) * 0.1).to(p),
                "exp_avg_sq": (torch.rand(p.shape, generator=g) * 0.9
                               + 0.1).to(p)}


def pretrain_grads(torch, what: str, f64: bool, device="cpu") -> dict:
    """{name: gradient} of one step of ``what`` ("train_hwr": the CNNOnly
    recognizer's CTC in train mode; "AutoTrainer": the AE's L1 + CTC) on
    phase 13's batch on ``device`` from the seeded weights, in f32 or with
    the port's modules in f64 (``in_f64``); on the host, in f64."""
    from affganwriting_torch.cli import train_hwr
    from affganwriting_torch.train.auto_trainer import AutoTrainer
    from affganwriting_torch.train.line_trainer import ctc_loss
    from affganwriting_torch.train.parity import in_f64

    charset, batch = _pretrain_batch()
    x = torch.as_tensor(batch["image"], device=device).permute(0, 3, 1, 2)
    x = x.double() if f64 else x
    lab = torch.as_tensor(batch["label"], device=device).long()
    lens = torch.as_tensor(batch["label_lengths"], device=device).long()
    if what == "train_hwr":
        model = train_hwr.build_hwr("cnn_only", "batch", charset.n_class,
                                    SEED, "cpu", dtype=torch.float32)
        model.to(device).train()

        def loss():
            return ctc_loss(model(x), lab, lens)
    else:
        model = AutoTrainer(ctc_weight=1.0, n_class=charset.n_class,
                            seed=SEED, device=device).init_state().ae

        def loss():
            recon, logp = model(x, return_ctc=True)
            return (recon - x).abs().mean() + ctc_loss(logp, lab, lens)

    with in_f64(model) if f64 else contextlib.nullcontext():
        loss().backward()
    return {n: p.grad.detach().double().cpu()
            for n, p in model.named_parameters()}


def _pretrain_step_check(torch, what, run, model_of) -> dict:
    """``run(device)`` -> (loss, the model after one step, its gradients
    {name: tensor}) on the card and on the CPU, held within
    ``PRETRAIN_TOL``, the gradients against ``pretrain_grads`` in f64
    (``grad_check``, ``PRETRAIN_GRAD_TOL[what]``); returns the
    readings."""
    card_loss, card, card_g = run("cuda")
    cpu_loss, cpu, cpu_g = run("cpu")
    grad = grad_check(what, card_g, cpu_g,
                      pretrain_grads(torch, what, f64=True),
                      pretrain_grads(torch, what, f64=True, device="cuda"),
                      PRETRAIN_GRAD_TOL[what])
    params = dict(model_of(cpu).named_parameters())
    sd_card = {k: v.cpu() for k, v in model_of(card).state_dict().items()}
    out = {"loss_card": float(card_loss), "loss_cpu": float(cpu_loss),
           "grad": grad, "param_abs": 0.0, "stats_rel": 0.0}
    for k, want in model_of(cpu).state_dict().items():
        d = (sd_card[k].double() - want.double()).abs()
        if k in params:
            out["param_abs"] = max(out["param_abs"], float(d.max()))
        elif want.is_floating_point():
            out["stats_rel"] = max(out["stats_rel"], float(
                (d / want.double().abs().clamp_min(1.0)).max()))
    rel = abs(out["loss_card"] - out["loss_cpu"]) / max(
        1.0, abs(out["loss_cpu"]))
    log(f"  {what} step card vs CPU: loss {out['loss_card']:.6f} vs "
        f"{out['loss_cpu']:.6f} (rel {rel:.2e}), parameters "
        f"{out['param_abs']:.2e} abs, statistics {out['stats_rel']:.2e} "
        f"rel; gradient, worst leaf {grad['worst']} (norm "
        f"{grad['norm']:.3g} of the largest): card vs f64 "
        f"{grad['card_f64']:.3g}, CPU vs f64 {grad['cpu_f64']:.3g}, limit "
        f"{grad['limit']:.3g}; card vs CPU {grad['card_cpu']:.3g}; in f64 "
        f"card vs CPU {grad['f64_card_cpu']:.3g}; null leaves "
        f"{grad['null']:.3g}")
    if rel > PRETRAIN_TOL["loss"] or \
            out["param_abs"] > PRETRAIN_TOL["param"] or \
            out["stats_rel"] > PRETRAIN_TOL["stats"]:
        raise AssertionError(f"{what}: card vs CPU {out} over "
                             f"{PRETRAIN_TOL}")
    return out


def _pretrain_batch():
    from affganwriting_torch.data.lines import LineCharset, LineDataset

    charset = LineCharset()
    ds = LineDataset(charset, a_batch_size=1, width=512, seed=SEED)
    return charset, next(ds.batches(8))


def phase_hwr_pretrain(torch, tmp: str) -> dict:
    """13 (a) ``cli/train_hwr`` at its published widths (``CNNOnlyHWR``,
    BatchNorm, the ``LineCharset``'s 80 classes, 8 lines of 64 x 512): one
    f32 step on the card against the CPU from one state (warmed Adam;
    neither arch has dropout), then the CLI itself (bf16 compute, as the
    JAX CLI) for 20 iterations, which writes ``hwr_final``."""
    import os

    from affganwriting_torch.cli import train_hwr
    from affganwriting_torch.core.checkpoint import load_swapped

    charset, batch = _pretrain_batch()

    def run(device):
        model = train_hwr.build_hwr("cnn_only", "batch", charset.n_class,
                                    SEED, "cpu", dtype=torch.float32)
        model.to(device)
        opt = torch.optim.Adam(model.parameters(), lr=2e-4,
                               betas=(0.9, 0.999), eps=1e-8)
        _warm_adam(torch, opt, SEED)
        x = torch.as_tensor(batch["image"], device=device).permute(0, 3, 1, 2)
        loss = train_hwr.hwr_step(
            model, opt, x, torch.as_tensor(batch["label"], device=device)
            .long(), torch.as_tensor(batch["label_lengths"], device=device)
            .long())
        grads = {n: p.grad.detach().cpu() for n, p in
                 model.named_parameters()}
        return loss, model, grads

    out = {"check": _pretrain_step_check(torch, "train_hwr", run,
                                         lambda m: m)}
    logdir = os.path.join(tmp, "hwr")
    _, path = train_hwr.main(["--iterations", "20", "--batch-size", "8",
                              "--logdir", logdir, "--save-every", "10",
                              "--log-every", "10"])
    saved = load_swapped(path)
    lines = [json.loads(s) for s in open(f"{logdir}/metrics.jsonl")]
    if set(saved) != {"params", "batch_stats"} or len(lines) != 2 or \
            not all(math.isfinite(r["ctc"]) for r in lines):
        raise AssertionError(f"hwr_final {sorted(saved)}, metrics {lines}")
    out["ctc"] = [r["ctc"] for r in lines]
    log(f"  cli/train_hwr 20 iterations of 8 x 64 x 512 (bf16 compute): ctc "
        f"{out['ctc']}; hwr_final {len(saved['params'])} parameters, "
        f"{len(saved['batch_stats'])} statistics")
    out["path"] = path
    return out


def phase_auto_pretrain(torch, tmp: str) -> dict:
    """13 (b) ``cli/train_auto`` at its published widths (the 2tight AE
    with the E_HWR head at 80 classes, 8 lines of 64 x 512, L1 + CTC):
    one f32 step of ``AutoTrainer`` on the card against the CPU from one
    state (warmed Adam; the head's dropout is off, as in the JAX
    trainer), then the CLI for 20 iterations, which writes ``ae_final``."""
    import os

    from affganwriting_torch.cli import train_auto
    from affganwriting_torch.core.checkpoint import load_swapped
    from affganwriting_torch.train.auto_trainer import AutoTrainer

    charset, batch = _pretrain_batch()

    def run(device):
        tr = AutoTrainer(ctc_weight=1.0, n_class=charset.n_class, seed=SEED,
                         device=device)
        st = tr.init_state()
        _warm_adam(torch, st.opt, SEED)
        st, loss, _ = tr.step(st, batch["image"], batch["label"],
                              batch["label_lengths"])
        grads = {n: p.grad.detach().cpu() for n, p in
                 st.ae.named_parameters()}
        return loss, st, grads

    out = {"check": _pretrain_step_check(torch, "AutoTrainer", run,
                                         lambda st: st.ae)}
    logdir = os.path.join(tmp, "auto")
    _, _, path = train_auto.main(["--iterations", "20", "--batch-size", "8",
                                  "--logdir", logdir, "--save-every", "10",
                                  "--log-every", "10"])
    saved = load_swapped(path)
    lines = [json.loads(s) for s in open(f"{logdir}/metrics.jsonl")]
    if set(saved) != {"params"} or not any(
            k.startswith("e_hwr.") for k in saved["params"]) or \
            len(lines) != 2 or not all(math.isfinite(r["ae_loss"])
                                       for r in lines):
        raise AssertionError(f"ae_final {sorted(saved)}, metrics {lines}")
    out["ae_loss"] = [r["ae_loss"] for r in lines]
    log(f"  cli/train_auto 20 iterations of 8 x 64 x 512: ae_loss "
        f"{out['ae_loss']}; ae_final {len(saved['params'])} tensors (E_HWR "
        f"included)")
    out["path"] = path
    return out


def phase_line_pretrained(torch, tmp: str, hwr_path: str, ae_path: str,
                          counts, zero) -> dict:
    """13 (c)-(e) ``cli/train_line --config
    configs/cf_synth_charSpecMulti.json`` with ``--pretrained-hwr``,
    ``--pretrained-ae`` and ``--xml-root`` on an IAM-format checkout
    written here (``tools/iam_fixture``: 3 writers x 2 train forms + 1
    valid form x 3 lines, PNG pages): the trainer's HWR and AE bit-equal
    to the two files on the card, 7 iterations, the restore (the files
    read again, then the checkpoint, bit-equal to the save); (d)
    ``cli/evaluate_line`` on it, synthetic lines and ``--xml-root``; (e)
    ``cli/line_repl --script`` through every action."""
    import os

    from affganwriting_torch.cli import evaluate_line, line_repl, train_line
    from affganwriting_torch.core.checkpoint import (
        LineCheckpointManager,
        line_payload,
        load_swapped,
        restore_line_trainer,
    )
    from affganwriting_torch.tools.iam_fixture import write_iam_checkout

    def same(sd, want) -> bool:
        return sd.keys() == want.keys() and all(
            torch.equal(sd[k].cpu(), want[k]) for k in want)

    hwr = load_swapped(hwr_path)
    hwr = {**hwr["params"], **hwr["batch_stats"]}
    ae = {k: v for k, v in load_swapped(ae_path)["params"].items()
          if not k.startswith("e_hwr.")}
    iam = os.path.join(tmp, "iam")
    xml_dir, _ = write_iam_checkout(iam)
    logdir = os.path.join(tmp, "line")
    ckdir = os.path.join(logdir, "ckpt")
    root = Path(__file__).resolve().parent
    out = {}
    tr, st = train_line.main([
        "--config", str(root / "configs" / "cf_synth_charSpecMulti.json"),
        "-a", "trainer.iterations=7", "-a", "trainer.save_step_minor=7",
        "-a", "trainer.val_step=7", "--val-batches", "1",
        "--sheet-every", "0", "--restart-rss-gb", "0", "--logdir", logdir,
        "--pretrained-hwr", hwr_path, "--pretrained-ae", ae_path,
        "--xml-root", xml_dir, "--image-root", iam])
    if next(st.model.hwr.parameters()).device.type != "cuda" or \
            not same(st.model.hwr.state_dict(), hwr) or \
            not same(st.ae.state_dict(), ae):
        raise AssertionError("train_line: the HWR or AE is not the "
                             "pretrained file")
    saved = LineCheckpointManager(ckdir).load("latest", "cpu")
    tr2, payload = restore_line_trainer(ckdir)
    fields = _compare_payloads(torch, _to_cpu(torch, line_payload(payload)),
                               saved)
    if tr2.pretrained_hwr != hwr_path or tr2.pretrained_ae != ae_path or \
            not same(payload["state"].model.hwr.state_dict(), hwr) or \
            not same(payload["state"].ae.state_dict(), ae) or \
            saved["iteration"] != 7:
        raise AssertionError("restore: pretrained paths or weights differ")
    lines = [json.loads(s) for s in open(f"{logdir}/metrics.jsonl")]
    if not any(r["group"] == "line_valid" for r in lines) or not all(
            math.isfinite(v) for r in lines for k, v in r.items()
            if k not in ("group", "step", "time")):
        raise AssertionError(f"metrics {lines}")
    log(f"  train_line --config cf_synth_charSpecMulti --pretrained-hwr "
        f"--pretrained-ae --xml-root: HWR ({len(hwr)} tensors) and AE "
        f"({len(ae)}, E_HWR dropped) bit-equal to the files on the card; 7 "
        f"iterations on IAM-format lines; restore bit-equal to the save in "
        f"{fields} fields")
    del tr, st, tr2, payload
    for name, extra in (("synthetic", ["--width", "512"]),
                        ("xml_root", ["--xml-root", xml_dir, "--image-root",
                                      iam])):
        res = evaluate_line.main(["--ckpt", ckdir, "--ckpt-name", "latest",
                                  "--max-batches", "2"] + extra)
        if not {"rec_cer", "gen_cer", "recon_l1", "wer", "top1",
                "top5"} <= set(res) or not all(
                    math.isfinite(v) for v in res.values()):
            raise AssertionError(f"evaluate_line {name}: {res}")
        out[f"evaluate_{name}"] = res
        log(f"  evaluate_line ({name}): {json.dumps(res, sort_keys=True)}")
    repl = os.path.join(tmp, "repl")
    script = ";".join([
        "a", "r", "2", "hello there", "s", "0", "v", "2", "gaussian", "m",
        "", "", "", "A", "", "R", "2", "", "t", "1", "f",
        os.path.join(repl, "interp0.png"), os.path.join(repl, "interp1.png"),
        "transfer", "u", "h", "q"])
    zero()
    line_repl.main(["--ckpt", ckdir, "--out", repl, "--script", script])
    names = set(os.listdir(repl))
    want = {"interp0.png", "interp1.png", "vae0.png", "vae1.png",
            "math.png", "average.png", "rand0.png", "rand1.png",
            "transfer0.png", "transfer3.png", "umap_sheet.png", "gen0_0.png",
            "mturk"}
    mturk = sorted(os.listdir(os.path.join(repl, "mturk")))
    if not want <= names or mturk != ["gen_0.png", "genfalse_0.png",
                                      "real_0.png", "text.csv"] or \
            counts() != (0, 0, 0):
        raise AssertionError(f"line_repl wrote {sorted(names)}, mturk "
                             f"{mturk}, launches {counts()}")
    out["repl_files"] = len(names)
    log(f"  line_repl --script (a r s v m A R t f u h q): {len(names)} "
        f"entries, launches {counts()}")
    return out


def _upchain_work(batch: int) -> dict:
    """The work the decoder's kernels must do in one ``up_chain`` call of
    64x216 words at ``batch`` in bf16, as ``cli/bench_kernels`` bounds
    them: ``in_relu`` reads and writes its two planes once, ``phase_head``
    reads xp, the folded kernel and the bias and writes the image once."""
    in_relu = sum(2 * 2 * batch * c * h * w
                  for c, h, w in ((256, 16, 54), (128, 32, 108)))
    c4, h, w = 256, 32, 108
    head = 2 * (batch * c4 * (h + 4) * (w + 4) + c4 * 100
                + batch * 4 * h * w) + 4 * 4
    return {"flops": float(2 * c4 * 100 * h * w * batch),
            "bytes": float(in_relu + head)}


def phase_profilers(torch, tmp: str, counts, zero) -> dict:
    """13 (f) ``cli/profile_pipeline --batch 256 --train-batch 8`` and
    ``cli/profile_gen --batch 256`` (10-call streams), their JSON lines;
    the launches of one ``profile_gen --stages upchain`` and one
    ``profile_pipeline --stages generate`` call; one ``up_chain`` call
    inside ``utils/profiling.trace``, its Chrome trace written and its
    kernels counted by name; and the work its kernels report to the
    profilers' counts (``ops/cuda_build.work_counter``), equal to the
    bound inputs of ``cli/bench_kernels`` at batch 256
    (``_upchain_work``)."""
    import os

    from affganwriting_torch.cli import profile_gen, profile_pipeline
    from affganwriting_torch.core.config import default_config
    from affganwriting_torch.gen.inference import build_generator
    from affganwriting_torch.ops.cuda_build import work_counter
    from affganwriting_torch.utils.profiling import trace

    rows = profile_pipeline.main(
        ["--batch", "256", "--train-batch", "8", "--n-stream", "10"])
    rows += profile_gen.main(["--batch", "256", "--n-stream", "10"])
    for row in rows:
        if row["device"].split(" (")[0] != torch.cuda.get_device_name(0) or \
                not (0 < row["mfu"] < 1 and 0 < row["hbm_frac"]):
            raise AssertionError(f"profiler row {row}")
    out = {}
    # the decoder forwards the host runs in one CLI call: ``up_chain`` is
    # eager in its warm call, the 10-call stream and the counted call;
    # profile_pipeline's generate stage captures the decoder's graph once
    # and replays it, but for the counted call, which runs eager under the
    # op counters
    want = {"launches_profile_gen_upchain": list(dec_launches(eager=12)),
            "launches_profile_pipeline_generate": list(
                dec_launches(captures=1, eager=1))}
    zero()
    profile_gen.main(["--batch", "256", "--n-stream", "10", "--stages",
                      "upchain"])
    out["launches_profile_gen_upchain"] = list(counts())
    zero()
    profile_pipeline.main(["--batch", "256", "--n-stream", "10",
                           "--stages", "generate"])
    out["launches_profile_pipeline_generate"] = list(counts())
    for key, n in want.items():
        if out[key] != n:
            raise AssertionError(f"{key}: {out[key]}, not {n}")
    gen = build_generator(default_config(), seed=SEED)
    x = torch.randn(256, 512, 8, 27, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(SEED)
                    ).to(torch.bfloat16)
    # a trace of the call alone once held ``in_relu`` 0 of 2 times and
    # ``phase_head`` 1 of 1, the call's first kernels missing while CUPTI
    # started: other kernels run first inside the trace
    logdir = os.path.join(tmp, "trace13f")
    with torch.inference_mode(), trace(logdir) as prof:
        y = x[:1].float()
        for _ in range(20):
            y = y * 1.0
        torch.cuda.synchronize()
        gen.dec.up_chain(x)
        torch.cuda.synchronize()
    if not os.path.getsize(os.path.join(logdir, "trace.pt.trace.json")):
        raise AssertionError("utils/profiling.trace wrote no Chrome trace")
    seen = prof.key_averages()
    traced = {k: sum(e.count for e in seen
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and name in e.key)
              for k, name in (("in_relu", "in_relu_kernel"),
                              ("phase_head", "phase_head_wgmma_kernel"))}
    out["traced_upchain_kernels"] = traced
    if traced != {"in_relu": 2, "phase_head": 1}:
        raise AssertionError(f"the trace saw {traced} in up_chain")
    with torch.inference_mode(), work_counter() as work:
        gen.dec.up_chain(x)
    want = _upchain_work(256)
    out["upchain_kernel_work"] = work
    if work != want:
        raise AssertionError(f"up_chain's kernels reported {work}, not "
                             f"{want}")
    log(f"  profile_pipeline and profile_gen: {len(rows)} rows; launches "
        f"of one --stages upchain "
        f"call {out['launches_profile_gen_upchain']} (12 up_chain calls), "
        f"of one --stages generate call "
        f"{out['launches_profile_pipeline_generate']} (13 generate calls); "
        f"the trace of one up_chain call: {traced}; its kernels' "
        f"work in the profilers' counts {work['flops'] / 1e9:.2f} GFLOP, "
        f"{work['bytes'] / 1e9:.3f} GB")
    del gen
    torch.cuda.empty_cache()
    return out


# phase 14: two ranks share the one card over gloo (NCCL takes one card a
# rank); the ranks' programs below run in fresh processes
# (parallel/multihost.spawn), each printing one "PHASE14 {json}" line
MESH_WORDS = WORDS * 32            # 1 writer x 256 words, 128 a rank
# the word step on a mesh against one process, f32 with TF32 off: losses
# within 1e-5 + rtol x |loss|, the SGD-updated parameters per player
# absolute (the JAX DP test's limits, tests/test_parallel_dp.py), BatchNorm
# statistics absolute; each plus twice the one-process step's own spread
# under another summation order (``_mesh_step``)
MESH_STEP_LOSS_RTOL = 5e-5
MESH_STEP_TOL = {"gen": 5e-3, "dis": 1e-7, "cla": 1e-7, "rec": 5e-6}
MESH_STATS_TOL = 1e-6
# the line lessons on a mesh against one process: metrics relative; the
# gradients each lesson hands its optimizers in relative L2, over each
# tree (main, D) and per leaf (against the larger of the leaf's norm and
# 1e-3 of the largest leaf's).  D's deepest leaves carry f32 noise with a
# heavy tail (phase 12's readings, LINE_GRAD_TOL's notes): a CPU rehearsal
# of this check read 4.2e-2 on c4b1.bias between two summation orders,
# where a gradient missing its all-reduce is off by ~0.5
MESH_LINE_RTOL = 1e-3
MESH_LINE_GRAD_TOL = 1e-2
MESH_LINE_LEAF_TOL = 0.1


def _mesh_serve(torch, rank: int) -> dict:
    """14b on one rank: the sharded pipeline at data=2 on the full
    request, launches, parity with this rank's unsharded call, the kernels
    at this rank's shapes against their plain versions."""
    import numpy as np

    from affganwriting_torch.core.config import default_config
    from affganwriting_torch.gen.inference import (
        encode_labels,
        make_sharded_pipeline,
    )
    from affganwriting_torch.ops.in_relu_cuda import in_relu, in_relu_plain
    from affganwriting_torch.ops.phase_head_cuda import (
        phase_head,
        phase_head_plain,
        strip_rows,
    )
    from affganwriting_torch.parallel.mesh import make_mesh

    def counts():
        return (in_relu.launches, phase_head.launches_wgmma,
                phase_head.launches)

    mesh = make_mesh(2, 1, device="cuda:0")
    cfg = default_config()
    run = make_sharded_pipeline(cfg, mesh, seed=SEED)
    rng = np.random.default_rng(SEED)
    style = rng.normal(size=(2, cfg.img_height, cfg.img_width,
                             cfg.style_stack)).astype(np.float32)[:1]
    labels = encode_labels(MESH_WORDS, cfg.output_max_len)
    in_relu.launches = phase_head.launches_wgmma = phase_head.launches = 0
    images, ids = run(style, labels)
    torch.cuda.synchronize()
    launches = counts()
    if launches != dec_launches(captures=1):
        raise AssertionError(f"rank {rank}: a sharded call launched "
                             f"{launches}, not one capture of the decoder")
    ref_img, ref_ids = run.base(style, labels)        # whole batch, 1 rank
    err, ok = bf16_tolerance_ok(images, ref_img)
    flips = float((ids != ref_ids).float().mean())
    if not ok or flips > 0.02 or tuple(images.shape) != tuple(ref_img.shape):
        raise AssertionError(f"rank {rank}: sharded images max|err| {err} "
                             f"(ok={ok}), token flips {flips}")
    # the kernels at this rank's shapes (batch 128) against the plain
    # versions, as phase 2 holds them
    gen = torch.Generator(device="cuda").manual_seed(SEED + rank)
    kerr = {}
    for shape in ((128, 256, 16, 54), (128, 128, 32, 108)):
        x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1).to(
            torch.bfloat16)
        e, good = bf16_tolerance_ok(in_relu(x), in_relu_plain(x))
        if not good:
            raise AssertionError(f"rank {rank}: in_relu {shape} max|err| {e}")
        kerr[f"in_relu{shape}"] = e
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    xp = torch.relu(torch.randn((128, 256, 36, 112), generator=gen,
                                device="cuda")).to(torch.bfloat16)
    kc = (torch.randn((256, 100), generator=gen, device="cuda")
          / (49 * 64) ** 0.5).to(torch.bfloat16)
    bias4 = torch.randn(4, generator=gen, device="cuda") * 0.1
    e, good = bf16_tolerance_ok(phase_head(xp, kc, bias4),
                                phase_head_plain(xp, kc, bias4))
    if not good:
        raise AssertionError(f"rank {rank}: phase_head batch 128 max|err| {e}")
    kerr["phase_head(128, 256, 36, 112)"] = e
    return {"launches": launches, "max_abs_err": err, "token_flips": flips,
            "kernel_max_abs_err": kerr, "words": len(MESH_WORDS),
            "strip_rows": {"batch_128": strip_rows(128, 32, sms),
                           "batch_256": strip_rows(256, 32, sms)}}


def _state_tensors(torch, state) -> dict:
    from affganwriting_torch.parallel.mesh import unsharded
    from affganwriting_torch.train.state import PLAYERS

    with unsharded(state):
        return {f"{n}/{k}": v.detach().clone() for n in PLAYERS
                for k, v in getattr(state, n).model.state_dict().items()}


def _mesh_step(torch, rank: int) -> dict:
    """14c on one rank: the SGD word step at full width (batch 8, f32, TF32
    off, R's dropout 0) on data=2 and on 1x2, against one process's step
    on rank 0.  G's update at random weights is ill-conditioned (f32
    reassociation moves it by several percent, ``train/parity.py``), so
    rank 0 also takes the one-process step on the batch in reverse row
    order, the same sums in another order, and each limit is
    ``MESH_STEP_*`` plus twice that floor."""
    import torch.distributed as dist

    from affganwriting_torch.core.config import default_config
    from affganwriting_torch.parallel.mesh import (
        make_mesh,
        shard_batch,
        shard_state,
    )
    from affganwriting_torch.train.state import init_state
    from affganwriting_torch.train.step import make_phased_train_step

    cfg = default_config().replace(compute_dtype="float32", optimizer="sgd")
    batch = {k: v.cpu().numpy() for k, v in random_batch(
        torch, cfg, 8, torch.Generator().manual_seed(SEED), "cpu").items()}

    def one_step(mesh, b):
        state = init_state(cfg, "cuda", seed=SEED, rec_dropout=0.0)
        if mesh is not None:
            shard_state(mesh, state)
            b = shard_batch(mesh, b)
        step = make_phased_train_step(cfg, merge_dg=cfg.merge_dg, mesh=mesh)
        state, m, _ = step(state, b, torch.Generator("cuda").manual_seed(1))
        return ({k: float(v) for k, v in m.items()},
                _state_tensors(torch, state))

    def diffs(got, want):
        """(|loss diffs|, max |diff| per player and of the BN stats)."""
        worst: dict[str, float] = {}
        for k, v in want[1].items():
            kind = "stats" if k.endswith(("running_mean", "running_var")) \
                else k.split("/")[0]
            worst[kind] = max(worst.get(kind, 0.0),
                              float((got[1][k] - v).abs().max()))
        return {k: abs(got[0][k] - v) for k, v in want[0].items()}, worst

    ref = floor = None
    if rank == 0:
        ref = one_step(None, batch)
        floor = diffs(one_step(None, {k: v[::-1].copy()
                                      for k, v in batch.items()}), ref)
    out = {}
    for name, shape in (("data2", (2, 1)), ("data1_model2", (1, 2))):
        got = one_step(make_mesh(*shape, device="cuda:0"), batch)
        res = {"checksum": float(sum(
            v.double().sum() for v in got[1].values()))}
        if ref is not None:
            loss_d, worst = diffs(got, ref)
            res.update(loss_diff=loss_d, max_abs_diff=worst,
                       floor_loss_diff=floor[0], floor_max_abs_diff=floor[1])
            lims = {**MESH_STEP_TOL, "stats": MESH_STATS_TOL}
            res["fails"] = [k for k, d in loss_d.items() if d > 1e-5
                            + MESH_STEP_LOSS_RTOL * abs(ref[0][k])
                            + 2 * floor[0][k]] + [
                k for k, lim in lims.items()
                if worst[k] > lim + 2 * floor[1][k]]
        out[name] = res
        del got
        torch.cuda.empty_cache()
        dist.barrier()
    return out


def _tree_checksum(tensors) -> float:
    return float(sum(v.double().sum() for v in tensors))


def _mesh_line(torch, rank: int) -> dict:
    """14d on one rank: one auto and one disc lesson of ``LineGanTrainer``
    at its published widths on 4 lines (2 a rank), against the same lessons
    in one process on rank 0."""
    import torch.distributed as dist

    from affganwriting_torch.data.lines import LineCharset, LineDataset
    from affganwriting_torch.parallel.mesh import make_mesh
    from affganwriting_torch.train.line_trainer import LineGanTrainer

    cs = LineCharset()
    ds = LineDataset(cs, a_batch_size=2, width=512, seed=SEED)
    first = next(ds.batches(batch_authors=2, epoch=0))

    def lessons(mesh):
        tr = LineGanTrainer(n_class=cs.n_class, seed=SEED, device="cuda",
                            mesh=mesh)
        state = tr.init_state(first)
        got = {}
        main_step = state.main_opt.step

        def record_main(grads):
            got.update({f"g_main/{k}": v.detach().clone()
                        for k, v in grads.items() if v is not None})
            main_step(grads)

        def record_disc(opt, args, kwargs):
            got.update({f"g_disc/{k}": p.grad.detach().clone()
                        for k, p in state.disc.named_parameters()
                        if p.grad is not None})

        state.main_opt.step = record_main
        state.disc_opt.register_step_pre_hook(record_disc)
        metrics = {}
        for it in (2, 3):
            lesson = "+".join(tr.curriculum.get_lesson(it))
            state, m = tr.train_iteration(state, it, first)
            metrics.update({f"{lesson}/{k}": float(v) for k, v in m.items()})
        trees = list(state.main_params().values()) + list(
            state.disc.state_dict().values())
        return metrics, got, _tree_checksum(trees)

    mesh = make_mesh(2, 1, device="cuda:0")
    metrics, grads, checksum = lessons(mesh)
    out = {"metrics": metrics, "checksum": checksum}
    if rank == 0:
        want_m, want_g, _ = lessons(None)
        out["metric_rel"] = {k: abs(metrics[k] - v) / max(abs(v), 1e-12)
                             for k, v in want_m.items()}
        floor = 1e-3 * max(float(v.norm()) for v in want_g.values())
        rel = {k: float((grads[k] - v).norm())
               / max(float(v.norm()), floor) for k, v in want_g.items()}
        trees = {}
        for tree in ("g_main/", "g_disc/"):
            ks = [k for k in want_g if k.startswith(tree)]
            trees[tree[:-1]] = (sum(float((grads[k] - want_g[k]).norm()) ** 2
                                    for k in ks)
                                / sum(float(want_g[k].norm()) ** 2
                                      for k in ks)) ** 0.5
        out["grad_rel_l2_trees"] = trees
        out["grad_rel_l2_worst"] = sorted(rel.items(),
                                          key=lambda kv: -kv[1])[:3]
        out["fails"] = [k for k, v in out["metric_rel"].items()
                        if v > MESH_LINE_RTOL] + [
            k for k, v in trees.items() if v > MESH_LINE_GRAD_TOL] + [
            k for k, v in rel.items() if v > MESH_LINE_LEAF_TOL]
    dist.barrier()
    return out


def _mesh_rank(rank: int, world: int, init: str) -> None:
    """One of the two ranks of phases 14b-d: gloo over CUDA tensors, both
    ranks on the one card."""
    import torch
    import torch.distributed as dist

    from affganwriting_torch.ops import cuda_build
    from affganwriting_torch.parallel.multihost import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed("gloo", device="cuda", init_method=init, rank=rank,
                     world_size=world, timeout_s=300)
    cuda_build.library()      # the parent's build
    out = {"rank": rank}
    for key, fn in (("serve", lambda: _mesh_serve(torch, rank)),
                    ("step", lambda: _mesh_step(torch, rank)),
                    ("line", lambda: _mesh_line(torch, rank))):
        out[key] = fn()
        torch.cuda.empty_cache()
    print("PHASE14 " + json.dumps(out), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def phase_mesh_world1(torch, tmp: str, counts, zero) -> dict:
    """(a) NCCL at world 1: the sharded pipeline on a 1x1 mesh, bit-equal
    to the unsharded call; then ``generate_word --mesh auto`` under
    ``torch.distributed.run`` against ``--mesh none``."""
    import os
    import subprocess

    import numpy as np
    import torch.distributed as dist

    from affganwriting_torch.core.config import default_config
    from affganwriting_torch.gen.inference import (
        encode_labels,
        make_generate_and_read_fn,
        make_sharded_pipeline,
    )
    from affganwriting_torch.parallel.mesh import make_mesh
    from affganwriting_torch.parallel.multihost import init_distributed

    init_distributed("nccl", init_method=f"file://{tmp}/store14a", rank=0,
                     world_size=1)
    try:
        cfg = default_config()
        rng = np.random.default_rng(SEED)
        style = rng.normal(size=(2, cfg.img_height, cfg.img_width,
                                 cfg.style_stack)).astype(np.float32)[:1]
        labels = encode_labels(MESH_WORDS, cfg.output_max_len)
        want = make_generate_and_read_fn(cfg, seed=SEED)(style, labels)
        run = make_sharded_pipeline(cfg, make_mesh(1, 1), seed=SEED)
        zero()
        got = run(style, labels)
        torch.cuda.synchronize()
        launches = counts()
        if launches != dec_launches(captures=1):
            raise AssertionError(f"the 1x1 sharded call launched {launches}")
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError("the 1x1 sharded call differs from the "
                                 "unsharded one")
        log(f"  1x1 mesh over NCCL, {len(MESH_WORDS)} words: images and ids "
            f"bit-equal to the unsharded call; launches in_relu "
            f"{launches[0]}, phase_head {launches[1]}")
    finally:
        dist.destroy_process_group()
    env = {**os.environ, "PYTHONHASHSEED": "0"}
    common = ["-m", "affganwriting_torch.cli.generate_word", "--corpus",
              "ladder", "--max-writers", "1", "--seed", str(SEED)]
    outs = {}
    for mesh, pre in (("auto", ["-m", "torch.distributed.run", "--standalone",
                                "--nproc-per-node", "1"]), ("none", [])):
        outs[mesh] = os.path.join(tmp, f"gen_{mesh}")
        proc = subprocess.run([sys.executable, *pre, *common, "--mesh", mesh,
                               "--out", outs[mesh]], env=env,
                              capture_output=True, text=True, timeout=300)
        if proc.returncode:
            raise AssertionError(f"generate_word --mesh {mesh}: "
                                 f"{proc.stderr[-3000:]}")
    files = sorted(os.listdir(outs["none"]))
    if not files or sorted(os.listdir(outs["auto"])) != files or any(
            Path(outs["auto"], f).read_bytes()
            != Path(outs["none"], f).read_bytes() for f in files):
        raise AssertionError("generate_word --mesh auto wrote other files "
                             "than --mesh none")
    log(f"  generate_word --mesh auto (torch.distributed.run, 1 process) "
        f"and --mesh none wrote the same {len(files)} files, byte for byte")
    return {"launches_sharded_call": list(launches),
            "cli_files_equal": len(files)}


def phase_mesh_two_ranks(torch) -> dict:
    """(b)-(d) on two ranks sharing the card over gloo."""
    import os

    from affganwriting_torch.parallel.multihost import spawn

    # one string-hash seed: the synthetic lines seed from hash(author), and
    # every rank renders the global batch
    outs = spawn("chip_smoke:_mesh_rank", 2, timeout_s=600,
                 env={**os.environ, "PYTHONHASHSEED": "0"},
                 cwd=str(Path(__file__).resolve().parent))
    ranks = [json.loads(next(x for x in o.splitlines()
                             if x.startswith("PHASE14 "))[8:]) for o in outs]
    check_mesh_ranks(ranks)
    return {"ranks": ranks}


def check_mesh_ranks(ranks: list) -> None:
    """Print and hold the two ranks' phase 14b-d results."""
    for r in ranks:
        s = r["serve"]
        log(f"  [14b] rank {r['rank']}: {s['words'] // 2} of {s['words']} "
            f"words, launches in_relu {s['launches'][0]}, phase_head "
            f"{s['launches'][1]}; images max|err| {s['max_abs_err']:.3g} vs "
            f"the unsharded call, token flips {s['token_flips']:.4f}; "
            f"kernels vs plain {s['kernel_max_abs_err']}; strip rows "
            f"{s['strip_rows']}")
    step, line = ranks[0]["step"], ranks[0]["line"]
    for name in ("data2", "data1_model2"):
        res = step[name]
        log(f"  [14c] word step {name} (batch 8, f32, SGD): |loss diff| "
            f"{ {k: f'{v:.2g}' for k, v in res['loss_diff'].items()} }, "
            f"max|diff| { {k: f'{v:.2g}' for k, v in res['max_abs_diff'].items()} }; "
            f"the one-process floor (rows reversed): |loss diff| "
            f"{ {k: f'{v:.2g}' for k, v in res['floor_loss_diff'].items()} }, "
            f"max|diff| { {k: f'{v:.2g}' for k, v in res['floor_max_abs_diff'].items()} }")
        if res["fails"]:
            raise AssertionError(f"word step {name} on the mesh: {res['fails']}")
        other = ranks[1]["step"][name]["checksum"]
        if other != res["checksum"]:
            raise AssertionError(f"word step {name}: the ranks' states "
                                 f"differ ({res['checksum']} vs {other})")
    log(f"  [14d] line lessons (auto, disc) at data=2: metrics rel "
        f"{ {k: f'{v:.2g}' for k, v in line['metric_rel'].items()} }; "
        f"gradients rel L2 by tree {line['grad_rel_l2_trees']}, worst leaves "
        f"{line['grad_rel_l2_worst']}")
    if line["fails"]:
        raise AssertionError(f"line lessons on the mesh: {line['fails']}")
    if ranks[1]["line"]["checksum"] != line["checksum"]:
        raise AssertionError("line lessons: the ranks' trees differ")


# ---- phase 15: batch invariance ------------------------------------------

INVARIANCE_WORDS = WORDS * 32        # 1 writer x 256 words; rows 0-63 alone


def _kernel_rows_equal(torch, fn, x, rows: int = 64):
    """``fn`` on all of x and on its first ``rows`` rows alone: (bit-equal,
    max|diff|) of those rows."""
    full = fn(x)
    part = fn(x[:rows].contiguous())
    torch.cuda.synchronize()
    diff = float((full[:rows].float() - part.float()).abs().max())
    return bool(torch.equal(full[:rows], part)), diff


def batch_invariance_kernels(torch) -> dict:
    """(a) Each kernel on the same rows at batch 64 and at batch 256, f32
    and bf16: ``in_relu`` at its two main-path shapes, ``phase_head`` on
    xp (256, 256, 36, 112), where ``strip_rows`` gives the bf16 route
    another strip height at each batch.  Rows 0-63 must be bit-equal: the
    arithmetic of an output may depend on neither the grid nor R."""
    from affganwriting_torch.ops.in_relu_cuda import in_relu
    from affganwriting_torch.ops.phase_head_cuda import phase_head, strip_rows

    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res, bad = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for shape in ((256, 256, 16, 54), (256, 128, 32, 108)):
            x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1) \
                .to(dtype)
            equal, diff = _kernel_rows_equal(torch, in_relu, x)
            key = f"in_relu {tag} {shape[1:]}"
            res[key] = {"bit_equal": equal, "max_abs_diff": diff}
            log(f"  [15a] {key}: rows 0-63 at batch 64 vs 256 "
                f"{'bit-equal' if equal else f'DIFFER by {diff:.3g}'}")
            bad += [] if equal else [key]
        xp = torch.relu(torch.randn((256, 256, 36, 112), generator=gen,
                                    device="cuda")).to(dtype)
        kc = (torch.randn((256, 100), generator=gen, device="cuda")
              / (49 * 64) ** 0.5).to(dtype)
        bias4 = torch.randn(4, generator=gen, device="cuda") * 0.1
        equal, diff = _kernel_rows_equal(
            torch, lambda t: phase_head(t, kc, bias4), xp)
        key = f"phase_head {tag} (256, 36, 112)"
        rows = ({"R_batch64": strip_rows(64, 32, sms),
                 "R_batch256": strip_rows(256, 32, sms)}
                if dtype == torch.bfloat16 else {})
        res[key] = {"bit_equal": equal, "max_abs_diff": diff, **rows}
        log(f"  [15a] {key}: rows 0-63 at batch 64 vs 256 "
            f"{'bit-equal' if equal else f'DIFFER by {diff:.3g}'}"
            + (f"; strip height R = {rows['R_batch64']} at batch 64, "
               f"{rows['R_batch256']} at batch 256 ({sms} SMs)"
               if rows else " (CUDA-core route, 16x16 tiles)"))
        bad += [] if equal else [key]
    if bad:
        raise AssertionError(f"batch-dependent kernel results: {bad}")
    return res


def _stage_outputs(torch, run, style, labels) -> dict:
    """Every stage's output of one request, by forward hooks: G's style
    encoder, text encoder, mix, res blocks, upsample convs and their
    IN + ReLU (the next module's input), head; R's trunk, BiGRU outputs
    (not its final states, which are layer-major), logits; the greedy
    ids.  The decoder's graphs are dropped first: its submodules' hooks
    fire in the warm-up and capture of a new graph (the capture's outputs,
    which the replay that follows writes again), never in a replay, and a
    capture takes the current cuDNN settings."""
    from affganwriting_torch.utils.cuda_graphs import drop_graphs

    gen, rec = run.gen, run.rec
    drop_graphs(gen.dec)
    out, hooks = {}, []

    def keep(name, what):
        def hook(module, args, result):
            out[name] = (args[0] if what == "in" else
                         result[0] if what == "first" else result)
        return hook

    stages = [("G.encode_style", gen.enc_image, "out"),
              ("text encoder", gen.text_encoder, "out"),
              ("mix", gen.linear_mix, "out"),
              ("res0", gen.dec.res0, "out"), ("res1", gen.dec.res1, "out")]
    for i in range(gen.dec.ups):
        stages.append((f"up{i} conv", getattr(gen.dec, f"up{i}"), "out"))
        nxt = getattr(gen.dec, f"up{i + 1}", gen.dec.head)
        stages.append((f"up{i} IN+ReLU", nxt, "in"))
    stages += [("head", gen.dec.head, "out"), ("R.trunk", rec.enc.vgg, "out"),
               ("R.bigru", rec.enc.rnn, "first"),
               ("R.decode logits", rec, "first")]
    for name, module, what in stages:
        hooks.append(module.register_forward_hook(keep(name, what)))
    try:
        _, ids = run(style, labels)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    out["ids"] = ids
    return out


def _flat_rows(torch, value, rows: int):
    """A stage's output as one f32 vector of its first ``rows`` rows (a
    batch-1 tensor, the style pyramid's, whole)."""
    if isinstance(value, (tuple, list)):
        return torch.cat([_flat_rows(torch, v, rows) for v in value])
    t = value[:rows] if value.shape[0] > 1 else value
    return t.float().reshape(-1)


def batch_invariance_pipeline(torch) -> dict:
    """(b) The bf16 request of 1 writer x words 0-63 alone and inside the
    256-word request, under each setting of ``cudnn.benchmark`` x
    ``cudnn.deterministic`` (restored after): the max|diff| of rows 0-63 at
    each stage, the first stage that differs and the ids that flip.  A
    reading, not a gate."""
    import numpy as np

    from affganwriting_torch.core.config import default_config
    from affganwriting_torch.gen.inference import (
        encode_labels,
        make_generate_and_read_fn,
    )

    cfg = default_config()
    run = make_generate_and_read_fn(cfg, seed=SEED)
    style = np.random.default_rng(SEED).normal(
        size=(1, cfg.img_height, cfg.img_width, cfg.style_stack)) \
        .astype(np.float32)
    labels = encode_labels(INVARIANCE_WORDS, cfg.output_max_len)
    cudnn = torch.backends.cudnn
    before = (cudnn.benchmark, cudnn.deterministic)
    readings = {}
    try:
        for bench in (False, True):
            for det in (False, True):
                cudnn.benchmark, cudnn.deterministic = bench, det
                small = _stage_outputs(torch, run, style, labels[:64])
                full = _stage_outputs(torch, run, style, labels)
                diffs = {k: float((_flat_rows(torch, small[k], 64)
                                   - _flat_rows(torch, full[k], 64))
                                  .abs().max()) for k in small}
                first = next((k for k, v in diffs.items() if v > 0), None)
                flips = int((small["ids"] != full["ids"][:64]).sum())
                key = f"benchmark={bench} deterministic={det}"
                readings[key] = {"max_abs_diff": diffs,
                                 "first_differing_stage": first,
                                 "ids_flipped": flips,
                                 "ids": int(small["ids"].numel())}
                log(f"  [15b] cudnn {key}: first differing stage {first}; "
                    f"{flips} of {small['ids'].numel()} ids flip")
                log("  [15b]   max|diff| rows 0-63, batch 64 vs 256: "
                    + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items()
                                if k != "ids"))
    finally:
        cudnn.benchmark, cudnn.deterministic = before
    del run
    torch.cuda.empty_cache()
    return readings


def phase_batch_invariance(torch, ckpt: str) -> dict:
    """15: (a) the kernels' gate, (b) the pipeline's reading, (d)
    ``tools/ab_subpixel_quality`` on phase 7's ``best`` (2 + 1 epochs: not
    trained)."""
    from affganwriting_torch.tools import ab_subpixel_quality

    kernels = batch_invariance_kernels(torch)
    pipeline = batch_invariance_pipeline(torch)
    log("  [15d] tools/ab_subpixel_quality on phase 7's best (not trained):")
    ab = ab_subpixel_quality.main(["--ckpt", ckpt, "--ckpt-name", "best"])
    if not ab["fast"]["count"] or ab["fast"]["count"] != \
            ab["exact"]["count"] or not math.isfinite(ab["image_corr"]):
        raise AssertionError(f"ab_subpixel_quality: {ab}")
    torch.cuda.empty_cache()
    return {"kernels": kernels, "pipeline": pipeline,
            "ab_subpixel_quality_not_trained": ab}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card",
              file=sys.stderr)
        return 2
    from affganwriting_torch.ops import cuda_build
    from affganwriting_torch.tools.timing import nvidia_smi_line

    t_start = time.perf_counter()

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 references in f32
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[1] device: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi}")
    cached = cuda_build.library_path().is_file()
    lib_path, build_log = cuda_build.build()
    log(f"    {'cached build found at' if cached else 'built'} {lib_path}")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"    {line.strip()}")
    cuda_build.library()
    seconds = {"1": time.perf_counter() - t_start}

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[label] = time.perf_counter() - t0
        log(f"  phase {label} took {seconds[label]:.1f} s")
        return out

    from affganwriting_torch.ops.in_relu_cuda import in_relu
    from affganwriting_torch.ops.phase_head_cuda import phase_head

    def counts():
        return (in_relu.launches, phase_head.launches_wgmma,
                phase_head.launches)

    def zero():
        in_relu.launches = phase_head.launches_wgmma = phase_head.launches = 0

    log("[2] kernel parity vs the plain versions (batch 64)")
    errs = timed("2", phase_parity, torch)
    log("[3] reference: port on the card vs port on the CPU, small fp32 "
        "config")
    timed("3", phase_reference, torch)
    log("[4] main path at full width (default_config, bf16)")
    launches: dict[str, int] = {}
    timed("4", phase_main_path, torch, launches)
    sources = {"in_relu": ("affganwriting_torch/csrc/in_relu.cu",
                           "affganwriting_tpu/ops/in_relu_pallas.py:51"),
               "phase_head": ("affganwriting_torch/csrc/phase_head.cu",
                              "affganwriting_tpu/ops/phase_head_pallas.py:72")}
    kernels = [{"name": k, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[k],
                "max_abs_err": errs[k]["bf16"],
                "max_abs_err_f32": errs[k]["f32"], "detail": {}}
               for k, (src, replaces) in sources.items()]
    kernels[1]["detail"].update({
        "route": "wgmma+tma",
        "ptxas_wgmma": ptxas_info(build_log, "phase_head_wgmma_kernel"),
        "ptxas_from": "cached build.log" if cached else "this build",
        "f32_route_launches": launches["phase_head_f32"]})
    log("[6] train: the merged step on the card vs on the CPU, small fp32 "
        "config")
    train_ref = timed("6a", phase_train_reference, torch)
    log("[6] train: full width (default_config, bf16, Adam, batch 8)")
    train = timed("6b", phase_train, torch)
    # counts are (in_relu, phase_head wgmma route, phase_head f32 route)
    for k, routes in (("in_relu", (0,)), ("phase_head", (1, 2))):
        kernels[[r["name"] for r in kernels].index(k)]["detail"].update({
            key: sum(train[key][i] for i in routes)
            for key in ("launches_13_train_steps", "launches_eval_step")})
    log("[7] trainer runtime: train_word 2 epochs -> resume -> "
        "generate_word -> inspect_ckpt (default_config, bf16, batch 8)")
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase7_", dir=root)
    try:
        runtime = timed("7", phase_trainer_runtime, torch, tmp)
        log("[8] evaluation and the other style encoders")
        log("[8a] card vs CPU, small fp32 config")
        eval_ref = timed("8a", phase_eval_reference, torch)
        log("[8b] each new style encoder at full width (default_config, "
            "bf16)")
        encoders = timed("8b", phase_encoders, torch, counts, zero)
        log("[8c,d] quality_report on phase 7's best; evaluate")
        quality = timed("8cd", phase_quality_report, torch, tmp, counts,
                        zero)
        log("[9] TrOCR, the teacher phase, HTR, entry and benches")
        log("[9a] tiny TrOCR card vs CPU, f32")
        trocr_ref = timed("9a", phase_trocr_reference, torch)
        tmp9 = tempfile.mkdtemp(prefix="phase9_", dir=root)
        try:
            log("[9b] train_word --recognizer trocr --trocr-preset base "
                "(default_config, batch 8)")
            trocr = timed("9b", phase_trocr, torch, tmp9, counts, zero)
        finally:
            shutil.rmtree(tmp9, ignore_errors=True)
        log("[9c] the teacher phase (default_config, 4 batches of 8)")
        teacher = timed("9c", phase_teacher, torch, counts, zero)
        log("[9d] HTRTrainer (default_config, batch 32, 10 steps)")
        htr = timed("9d", phase_htr, torch)
        log("[9e] entry(), cli/bench --batch 256 --quick, cli/bench_kernels")
        benches = timed("9e", phase_entry_and_benches, torch, counts, zero)
        seconds["9"] = sum(seconds[k] for k in ("9a", "9b", "9c", "9d",
                                                "9e"))
        log("[10] w8a8 serving at full width (default_config, 1 x 256 "
            "words)")
        log("[10a,b] int8 vs bf16 gates, int8 sums card vs CPU, launches")
        int8 = timed("10ab", phase_int8, torch, counts, zero)
        log("[10c,d] tools/ab_int8_static, cli/bench --headline int8, "
            "tools/ab_int8_cer on phase 7's best")
        int8_tools = timed("10cd", phase_int8_tools, torch, tmp)
        log("[11] the line-generation models")
        log("[11a] a small f32 HWWithStyle card vs CPU, char_style_dim 0 "
            "and 16")
        line_ref = timed("11a", phase_line_reference, torch)
        log("[11b] HWWithStyle at full width (cf_synth_charSpecMulti)")
        line = timed("11b", phase_line_full, torch, counts, zero)
        log("[12] the line GAN: lessons, trainer, CLIs and serving")
        log("[12a] each lesson step of a small f32 LineGanTrainer, card vs "
            "CPU")
        line_train_ref = timed("12a", phase_line_train_reference, torch)
        log("[12b] LineGanTrainer at full width (cf_synth_charSpecMulti)")
        line_train = timed("12b", phase_line_train, torch, counts, zero)
        tmp12 = tempfile.mkdtemp(prefix="phase12_", dir=root)
        try:
            log("[12c] train_line -> resume -> validate -> get_styles -> "
                "generate_lines -> app --selftest")
            line_clis = timed("12c", phase_line_clis, torch, tmp12, counts,
                              zero)
        finally:
            shutil.rmtree(tmp12, ignore_errors=True)
        log("[13] line pretraining, IAM-format lines, line evaluation, the "
            "line REPL and the profilers")
        tmp13 = tempfile.mkdtemp(prefix="phase13_", dir=root)
        try:
            log("[13a] train_hwr: one step card vs CPU, then the CLI")
            hwr = timed("13a", phase_hwr_pretrain, torch, tmp13)
            log("[13b] train_auto: one step card vs CPU, then the CLI")
            auto = timed("13b", phase_auto_pretrain, torch, tmp13)
            log("[13c-e] train_line --pretrained-hwr --pretrained-ae "
                "--xml-root -> restore -> evaluate_line -> line_repl")
            line_pre = timed("13cde", phase_line_pretrained, torch, tmp13,
                             hwr.pop("path"), auto.pop("path"), counts, zero)
        finally:
            shutil.rmtree(tmp13, ignore_errors=True)
        log("[13f] profile_pipeline and profile_gen at batch 256")
        profilers = timed("13f", phase_profilers, torch, tmp, counts, zero)
        seconds["13"] = sum(seconds[k] for k in ("13a", "13b", "13cde", "13f"))
        log("[14] multi-device: the mesh on torch.distributed")
        tmp14 = tempfile.mkdtemp(prefix="phase14_", dir=root)
        try:
            log("[14a] NCCL at world 1: the 1x1 sharded pipeline, "
                "generate_word --mesh auto")
            mesh1 = timed("14a", phase_mesh_world1, torch, tmp14, counts,
                          zero)
        finally:
            shutil.rmtree(tmp14, ignore_errors=True)
        log("[14b-d] two ranks sharing the card over gloo: the sharded "
            "pipeline, the word step (data=2, 1x2), the line lessons")
        mesh2 = timed("14bcd", phase_mesh_two_ranks, torch)
        seconds["14"] = seconds["14a"] + seconds["14bcd"]
        log("[15] batch invariance: the kernels and the bf16 request at "
            "batch 64 vs 256 (default_config)")
        invariance = timed("15", phase_batch_invariance, torch,
                           str(Path(tmp) / "run" / "ckpt"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k, key in (("in_relu", 0), ("phase_head", 1)):
        row = kernels[[r["name"] for r in kernels].index(k)]
        row["launches_profile_gen_upchain_call"] = \
            profilers["launches_profile_gen_upchain"][key]
        row["launches_profile_pipeline_generate_call"] = \
            profilers["launches_profile_pipeline_generate"][key]
        row["launches_line_train_iteration"] = line_train["launches"][key]
        row["launches_line_serve_call"] = \
            line_clis["launches_generate_call"][key]
        row["launches_int8_generate_call"] = \
            int8["launches_int8_generate_call"][key]
        row["launches_line_path"] = line["launches"][key]
        row["launches_teacher_4_generate_calls"] = \
            teacher["launches_4_generate_calls"][key]
        row["launches_sharded_call_world1"] = \
            mesh1["launches_sharded_call"][key]
        row["launches_sharded_call_per_rank"] = [
            r["serve"]["launches"][key] for r in mesh2["ranks"]]
        row["launches"] += mesh1["launches_sharded_call"][key]
        row["detail"].update({
            "launches_trainer_eval_batch":
                runtime["eval_launches_per_batch"][key],
            "launches_generate_word_call":
                runtime["generate_word_launches"][key],
            "launches_quality_report_call": quality["launches"][key],
            "launches_encoder_generate_call": {
                n: e["launches_generate_call"][key]
                for n, e in encoders.items()},
            "launches_trocr_eval_step": trocr["launches_eval_step"][key],
            "launches_entry_call": benches["entry_launches"][key]})
    log(f"phase seconds: { {k: round(v, 1) for k, v in seconds.items()} }")
    log(json.dumps({"train_reference": train_ref,
                    "train": train, "trainer_runtime": runtime,
                    "eval_reference": eval_ref, "encoders": encoders,
                    "quality_report": quality, "trocr_reference": trocr_ref,
                    "trocr": trocr, "teacher": teacher, "htr": htr,
                    "benches": benches, "int8": int8,
                    "int8_tools": int8_tools, "line_reference": line_ref,
                    "line": line, "line_train_reference": line_train_ref,
                    "line_train": line_train, "line_clis": line_clis,
                    "hwr_pretrain": hwr, "auto_pretrain": auto,
                    "line_pretrained": line_pre, "profilers": profilers,
                    "mesh_world1": mesh1, "mesh_two_ranks": mesh2,
                    "batch_invariance": invariance, "phase_s": seconds}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
