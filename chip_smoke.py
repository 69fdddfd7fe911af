"""On-card smoke of the PyTorch/CUDA port: builds the kernels, holds each
against its plain PyTorch version, serves the main path at full width and
times it.

    python3 chip_smoke.py

Needs one CUDA card (H100, ``sm_90a``) and ``nvcc``; with no card it exits
non-zero before printing any result.  Phases, each fatal on failure:

1. device and build: card, versions, ``nvidia-smi`` name and power limit;
   builds ``affganwriting_torch/csrc/*.cu`` and prints the build seconds;
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
   just after, each generate call checked to launch ``in_relu`` twice and
   ``phase_head`` once on its wgmma route; then the 256-word request
   timed, each stage's device time, and one ``torch.profiler`` trace
   (kernel time, idle share, top kernels);
5. kernel times beside the plain version, one library call and the card's
   bound (CUDA events, 20 launches per event pair): ``in_relu`` at batch
   256, ``phase_head`` at batch 256 and 8;
6. train: one merged step of the port on the card vs on the CPU (small
   fp32 config: losses, fakes, every player's delta, G's and R's new
   running statistics); then ``default_config()`` at full width (bf16,
   Adam, batch 8): 3 warm-up and 10 timed steps with finite losses, all
   four players moved, G's and R's running statistics moved and R's not in
   the G phase, no kernel launched by a train step; step time, words/s,
   per-phase device time, peak memory and one traced step; one eval step,
   which must launch ``in_relu`` 4 times and ``phase_head`` twice; one
   4-phase step; the merged step at batch 64;
7. trainer runtime at ``default_config()``: ``cli/train_word`` for 2 epochs
   of 16 writers (JSONL lines finite, ``latest``, ``step_00000001`` and
   ``best`` written, ``in_relu`` 4 and ``phase_head`` 2 launches per eval
   batch, none in the train steps), a resume on the same logdir that must
   be bit-equal to the last save (Adam moments and R's rate included) and
   train one more epoch, ``cli/generate_word`` from ``best`` greedily as a
   warm-up, then with beams of 3 and 1 and greedily (17 files each, 2 + 1
   launches a call, the width-1 beam reading as the greedy path),
   ``cli/inspect_ckpt``; epoch, eval, checkpoint save and load times and
   sizes, a batch's upload, the CER pass and the data stream alone,
   generate_word words/s;
8. evaluation and the other style encoders: (a) on a small fp32 config,
   each of the eight new encoders' pyramids, ``InceptionV3Pool3``'s
   activations and ``FIDScorer``'s random features on the card against the
   CPU (1e-3 of max(1, |CPU|)); (b) each encoder at full width
   (``default_config().replace(style_encoder=...)``, bf16): one request of
   1 writer x 64 words through ``make_generate_and_read_fn`` (images finite,
   in [-1, 1], ``in_relu`` 2 and ``phase_head`` 1 launches on its wgmma
   route), request ms, parameters and peak memory, then merged train
   steps at batch 8 (losses finite, all four players moved, efficientnet's
   running statistics moved, inception's bit-unchanged in the first; 3
   more timed);
   (c) ``cli/quality_report`` on phase 7's ``best`` (4 writers, 64 real
   words each): its keys, ``cer`` equal to ``cer_of_folder``, a finite
   ``fid_random_features``, the seconds of each part, the kernel launches,
   and the activation pass alone (ms an image over 512 crops);
   (d) ``cli/evaluate`` on the same folders, with and without
   ``--per-writer``.

Each phase prints its seconds.  The last lines are the ``kernels`` JSON, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SEED = 0
WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog"]
NEW_ENCODERS = ("cnn", "vgg19", "inception_v3", "efficientnet_v2_l",
                "dinov2_s", "dinov2_b", "dinov2_l", "dinov2_g")

# (memory bytes/s, dense bf16 tensor FLOP/s, f32 FLOP/s outside the tensor
# cores) from NVIDIA's H100 data sheet, by the part the card's name names
CARD_PEAKS = {
    "PCIe": (2.0e12, 756e12, 51e12),
    "NVL": (3.9e12, 835e12, 60e12),
    "SXM": (3.35e12, 989e12, 67e12),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def card_peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, CARD_PEAKS[key]
    return "SXM", CARD_PEAKS["SXM"]


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


def phase_main_path(torch, launches, card: str):
    import numpy as np

    from affganwriting_torch.core.config import default_config
    from affganwriting_torch.gen.inference import (
        encode_labels,
        make_generate_and_read_fn,
    )
    from affganwriting_torch.ops.in_relu_cuda import in_relu
    from affganwriting_torch.ops.phase_head_cuda import phase_head

    cfg = default_config()
    t0 = time.perf_counter()
    run = make_generate_and_read_fn(cfg, seed=SEED)
    log(f"  models built with random weights (seed {SEED}) in "
        f"{time.perf_counter() - t0:.1f} s")
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
        if tuple(a - b for a, b in zip(counts(), before)) != (2, 1, 0):
            raise AssertionError("a bf16 generate call did not launch "
                                 "in_relu twice and phase_head once, on "
                                 "its wgmma route")
    torch.cuda.synchronize()
    launches["in_relu"], launches["phase_head"], launches["phase_head_f32"] \
        = counts()
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

    style, words = requests[0]
    labels = encode_labels(words, cfg.output_max_len)
    for _ in range(3):
        run(style, labels)
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run(style, labels)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    wall = statistics.median(walls)
    log(f"  256-word request: median {wall * 1e3:.3f} ms over 10 -> "
        f"{len(words) / wall:.1f} imgs/s on {card}")
    stages = stage_times(torch, run, style, labels)
    kernel_ms, idle, launches = traced(
        torch, lambda: run(style, labels), 3, wall * 1e3, "request")
    return {"imgs_per_s": len(words) / wall, "request_ms": wall * 1e3,
            "stages_ms": stages, "kernel_ms": kernel_ms, "idle_share": idle,
            "launches_per_request": launches}


def stage_times(torch, run, style, labels):
    """Device ms of each stage of the 256-word request (CUDA events, two
    calls per event pair, median of 10 pairs)."""
    from affganwriting_torch.tools.timing import cuda_ms

    gen, rec = run.gen, run.rec
    style_t = torch.as_tensor(style, device="cuda")
    lab = torch.as_tensor(labels, device="cuda").long()
    with torch.inference_mode():
        pyramid = gen.encode_style(style_t)
        images = gen.generate(pyramid, lab)
        seq = rec.enc.sequence(images)
        enc_out, h0 = rec.enc.rnn(seq)
        stages = {
            "G.encode_style": lambda: gen.encode_style(style_t),
            "G.generate": lambda: gen.generate(pyramid, lab),
            "R.trunk": lambda: rec.enc.sequence(images),
            "R.bigru": lambda: rec.enc.rnn(seq),
            "R.decode": lambda: rec.decode(enc_out, h0, lab),
        }
        stages = {k: cuda_ms(fn, iters=10, reps=2)
                  for k, fn in stages.items()}
    for k, v in stages.items():
        log(f"  stage {k:16s} {v:9.3f} ms")
    return stages


def traced(torch, fn, reps: int, unprofiled_ms: float, what: str):
    """Kernel time per call of ``fn`` from ``torch.profiler`` over ``reps``
    calls, the device's idle share against the unprofiled median (the
    profiler's own host cost would count as idle otherwise), the launch
    count and the kernels that take the most device time.  Profiler ranges
    on the device timeline (``Optimizer.step``) are not kernels and are
    left out."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise AssertionError("torch.profiler recorded no device time")
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    launches = sum(e.count for e in kernels) / reps
    idle = 1 - kernel_ms / unprofiled_ms
    log(f"  traced: kernel time {kernel_ms:.3f} ms a {what}, idle share "
        f"{idle:.3f} of the unprofiled {unprofiled_ms:.3f} ms, "
        f"{launches:.0f} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3 / reps:9.3f} ms "
            f"{e.count // reps:5d}x  {e.key[:100]}")
    return kernel_ms, idle, launches


def phase_kernel_times(torch, F, peaks):
    from affganwriting_torch.models.blocks import depth_to_space
    from affganwriting_torch.ops.in_relu_cuda import in_relu, in_relu_plain
    from affganwriting_torch.ops.phase_head_cuda import (
        phase_head,
        phase_head_plain,
        strip_rows,
    )
    from affganwriting_torch.tools.timing import cuda_ms

    mem_rate, bf16_rate, f32_rate = peaks
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    dt = torch.bfloat16
    out = {}
    row = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "bytes": 0, "ops": 0, "stages": []}
    for shape in ((256, 256, 16, 54), (256, 128, 32, 108)):
        x = torch.randn(shape, generator=gen, device="cuda").to(dt)
        n = x.numel()
        nbytes = 2 * n * x.element_size()
        ops = 6 * n          # sum, square-add, subtract, scale, relu
        bound = max(nbytes / mem_rate, ops / f32_rate) * 1e3
        stage = {
            "shape": list(shape),
            "ms": cuda_ms(lambda: in_relu(x)),
            "plain_ms": cuda_ms(lambda: in_relu_plain(x)),
            "library_ms": cuda_ms(lambda: torch.relu(F.instance_norm(x))),
            "bound_ms": bound,
        }
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            row[k] += stage[k]
        row["bytes"] += nbytes
        row["ops"] += ops
        row["stages"].append(stage)
        log(f"  in_relu {shape} bf16: kernel {stage['ms']:.4f} ms, plain "
            f"{stage['plain_ms']:.4f}, library {stage['library_ms']:.4f}, "
            f"bound {bound:.4f} (bytes)")
    row["bound_by"] = "bytes"
    out["in_relu"] = row

    def head_row(b):
        c4, hp, wp = 256, 36, 112
        h, w = hp - 4, wp - 4
        xp = torch.relu(torch.randn((b, c4, hp, wp), generator=gen,
                                    device="cuda")).to(dt)
        kc = (torch.randn((c4, 100), generator=gen, device="cuda")
              / (49 * 64) ** 0.5).to(dt)
        bias4 = torch.randn(4, generator=gen, device="cuda") * 0.1
        k4 = kc.view(c4, 25, 4).permute(2, 0, 1).reshape(4, c4, 5, 5) \
            .contiguous()
        bias_dt = bias4.to(dt)

        def library():
            y = torch.tanh(F.conv2d(xp, k4) + bias_dt.view(1, 4, 1, 1))
            return depth_to_space(y)

        nbytes = (xp.numel() + kc.numel() + b * 4 * h * w) \
            * xp.element_size() + bias4.numel() * 4
        ops = 2 * c4 * 100 * h * w * b
        t_bytes, t_ops = nbytes / mem_rate * 1e3, ops / bf16_rate * 1e3
        r = strip_rows(b, h, sms)
        row = {
            "ms": cuda_ms(lambda: phase_head(xp, kc, bias4)),
            "plain_ms": cuda_ms(lambda: phase_head_plain(xp, kc, bias4)),
            "library_ms": cuda_ms(library),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "shape": [b, c4, hp, wp],
            "strip_rows": r,
        }
        log(f"  phase_head {(b, c4, hp, wp)} bf16, R = {r}: kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, library "
            f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
            f"({row['bound_by']}; bytes {t_bytes:.4f}, operations "
            f"{t_ops:.4f})")
        return row

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row = head_row(256)
    row["batch8"] = head_row(8)
    out["phase_head"] = row
    return out


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


def phase_train(torch, card: str):
    """The merged train step at full width: default_config (resnet50 G,
    D and C at 6 layers, R hidden 512, bf16 on f32 parameters, Adam), batch
    8, random weights and batch from the seed; 3 warm-up and 10 timed
    steps, then one eval step, one 4-phase step and the merged step at
    batch 64."""
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
    t0 = time.perf_counter()
    state = init_state(cfg, seed=SEED)
    log(f"  state built in {time.perf_counter() - t0:.1f} s; parameters "
        f"{param_count(state)}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = random_batch(torch, cfg, b, gen, "cuda")
    step = make_phased_train_step(cfg, merge_dg=True)
    before = snapshot(torch, state)
    rec_stats = {}
    events = {}

    def on_phase(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[name] = ev
        if name == "rec":
            rec_stats.update({k: v.clone() for k, v in
                              state.rec.model.state_dict().items()
                              if is_stat(k)})

    in_relu.launches = phase_head.launches_wgmma = phase_head.launches = 0
    walls, phase_ms, losses = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(13):
        torch.cuda.synchronize()
        t = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        _, metrics, extras = step(state, batch, gen, on_phase)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        losses.append({k: float(v) for k, v in metrics.items()})
        phase_ms.append({
            "R": start.elapsed_time(events["rec"]),
            "C": events["rec"].elapsed_time(events["cla"]),
            "D+G": events["cla"].elapsed_time(events["dis_gen"])})
        moved = [k for k, v in state.rec.model.state_dict().items()
                 if is_stat(k) and not torch.equal(v, rec_stats[k])]
        if moved:
            raise AssertionError(f"R's running stats moved in the G phase: "
                                 f"{moved[:3]}")
    train_counts = counts()
    peak = torch.cuda.max_memory_allocated()
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
    timed = walls[3:]
    step_ms = statistics.median(timed) * 1e3
    phases = {k: statistics.median(p[k] for p in phase_ms[3:])
              for k in ("R", "C", "D+G")}
    log(f"  13 steps, losses finite; all four players moved; G's and R's "
        f"running stats moved, R's not in the G phase; kernel launches in "
        f"13 train steps: {train_counts}")
    log(f"  step 0 losses {losses[0]}")
    log(f"  step 12 losses {losses[-1]}")
    log(f"  merged step, batch {b}: median {step_ms:.3f} ms over 10 (min "
        f"{min(timed) * 1e3:.3f}, max {max(timed) * 1e3:.3f}) -> "
        f"{b / (step_ms / 1e3):.1f} words/s on {card}")
    log("  phase device ms (CUDA events, median of 10): " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()))
    log(f"  peak memory {peak / 2**30:.3f} GiB")
    kernel_ms, idle, launches = traced(
        torch, lambda: step(state, batch, gen), 1, step_ms, "step")

    eval_step = make_eval_step(cfg)
    in_relu.launches = phase_head.launches_wgmma = phase_head.launches = 0
    em, preds, images = eval_step(state, {k: v for k, v in batch.items()
                                          if k != "label_ch0"})
    torch.cuda.synchronize()
    eval_counts = counts()
    log(f"  eval step: losses { {k: float(v) for k, v in em.items()} }, "
        f"launches in_relu {eval_counts[0]}, phase_head wgmma "
        f"{eval_counts[1]}, f32 {eval_counts[2]}")
    if eval_counts != (4, 2, 0):
        raise AssertionError("an eval step did not launch in_relu 4 times "
                             "and phase_head twice on its wgmma route")
    if not all(math.isfinite(float(v)) for v in em.values()):
        raise AssertionError("non-finite eval losses")

    four = make_phased_train_step(cfg, merge_dg=False)
    four(state, batch, gen)
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, m4, _ = four(state, batch, gen)
    torch.cuda.synchronize()
    four_ms = (time.perf_counter() - t) * 1e3
    if not all(math.isfinite(float(v)) for v in m4.values()):
        raise AssertionError("non-finite losses in the 4-phase step")
    log(f"  4-phase step, batch {b}: {four_ms:.3f} ms (one timed step), "
        f"losses finite")

    big = random_batch(torch, cfg, 64, gen, "cuda")
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step(state, big, gen)
    walls64 = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, m64, _ = step(state, big, gen)
        torch.cuda.synchronize()
        walls64.append(time.perf_counter() - t)
    ms64 = statistics.median(walls64) * 1e3
    peak64 = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(float(v)) for v in m64.values()):
        raise AssertionError("non-finite losses at batch 64")
    log(f"  merged step, batch 64: median {ms64:.3f} ms over 5 (min "
        f"{min(walls64) * 1e3:.3f}, max {max(walls64) * 1e3:.3f}) -> "
        f"{64 / (ms64 / 1e3):.1f} words/s; peak memory "
        f"{peak64 / 2**30:.3f} GiB")
    return {"step_ms": step_ms, "step_ms_min": min(timed) * 1e3,
            "step_ms_max": max(timed) * 1e3,
            "words_per_s": b / (step_ms / 1e3), "phase_ms": phases,
            "peak_gib": peak / 2**30, "four_phase_ms": four_ms,
            "batch64_ms": ms64, "batch64_words_per_s": 64 / (ms64 / 1e3),
            "batch64_peak_gib": peak64 / 2**30,
            "launches_13_train_steps": list(train_counts),
            "launches_eval_step": list(eval_counts),
            "step_kernel_ms": kernel_ms, "step_idle_share": idle,
            "step_launches": launches}


class _Timed:
    """Class-level wrappers that time every ``CheckpointManager`` save and
    load, and count the kernel launches and seconds of each trainer epoch
    and evaluation, for phase 7; ``restore()`` puts the methods back."""

    def __init__(self, counts):
        from affganwriting_torch.core.checkpoint import CheckpointManager
        from affganwriting_torch.train.loop import WordGanTrainer

        self.saves, self.loads, self.epochs, self.evals = [], [], [], []
        self._orig = []

        def wrap(cls, name, record, what):
            orig = getattr(cls, name)

            def timed(obj, *a, **k):
                import torch

                before = counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = orig(obj, *a, **k)
                torch.cuda.synchronize()
                record.append(what(obj, a, out, time.perf_counter() - t,
                                   tuple(x - y for x, y in
                                         zip(counts(), before))))
                return out

            self._orig.append((cls, name, orig))
            setattr(cls, name, timed)

        import os

        wrap(CheckpointManager, "_save_swap", self.saves,
             lambda o, a, out, s, n: (os.path.basename(a[0]), s,
                                      os.path.getsize(a[0])))
        wrap(CheckpointManager, "load", self.loads,
             lambda o, a, out, s, n: (a[0], s))
        wrap(WordGanTrainer, "train_epoch", self.epochs,
             lambda o, a, out, s, n: (s, n, out))
        wrap(WordGanTrainer, "evaluate", self.evals,
             lambda o, a, out, s, n: (
                 s, n, len(o.test_data) // o.config.batch_size))

    def restore(self):
        for cls, name, orig in self._orig:
            setattr(cls, name, orig)


def phase_trainer_runtime(torch, card: str, tmp: str):
    """The word trainer runtime at full width (default_config: resnet50,
    bf16 on f32 parameters, Adam, merged D+G, batch 8, synthetic images
    from the in-repo GT), in a temporary logdir under ``build/``:

    (a) ``cli/train_word`` for 2 epochs of 16 writers (2 train steps and 2
        eval batches an epoch), evaluating and saving every epoch;
    (b) a trainer built on the same logdir resumes at epoch 2 with every
        parameter, statistic and optimizer field of the last save, R's
        learning rate included, and trains one more epoch;
    (c) ``cli/generate_word`` from ``best``: the word ladder for one writer,
        greedily as a warm-up, then with a beam of 3, of 1 (which must read
        as the greedy path up to the first END) and greedily;
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
    timed = _Timed(counts)
    out = {}
    try:
        in_relu.launches = phase_head.launches_wgmma = phase_head.launches = 0
        t0 = time.perf_counter()
        trainer = train_word.main(argv)
        torch.cuda.synchronize()
        out["train_2_epochs_s"] = time.perf_counter() - t0
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
        if [(cnt, n) for _, cnt, n in timed.evals] != [((8, 4, 0), 2)] * 2:
            raise AssertionError(f"eval launches and batches {timed.evals}: "
                                 "not in_relu 4 and phase_head 2 a batch")
        if any(cnt != (0, 0, 0) for _, cnt, _ in timed.epochs):
            raise AssertionError(f"a train epoch launched a forward-only "
                                 f"kernel: {[c for _, c, _ in timed.epochs]}")
        for (s, cnt, m), (es, ecnt, nb) in zip(timed.epochs, timed.evals):
            log(f"  epoch: {s:.3f} s wall ({m['epoch_seconds']:.3f} s in "
                f"train_epoch's own clock, {m['steps_per_sec']:.3f} steps/s)"
                f", launches {cnt}; eval {es:.3f} s for {nb} batches "
                f"({es / nb:.3f} s a batch), launches {ecnt}; cer_tr "
                f"{m['cer_tr']:.2f}, l_total {m['l_total']:.4f}")
        out["epochs"] = [{"wall_s": s, "epoch_seconds": m["epoch_seconds"],
                          "steps_per_sec": m["steps_per_sec"]}
                         for s, _, m in timed.epochs]
        out["eval_s_per_batch"] = [s / nb for s, _, nb in timed.evals]
        _, ecnt, nb = timed.evals[-1]
        out["eval_launches_per_batch"] = [c // nb for c in ecnt]

        # the last save of (a), with R's rate moved as a plateau step would
        set_rec_lr(trainer.state, trainer.config.lr_rec * 0.1)
        trainer.ckpt.save_latest(trainer.state, trainer.config)
        saved = state_payload(trainer.state)
        cfg = trainer.config
        for name, s, size in timed.saves:
            log(f"  saved {name}: {s:.3f} s, {size / 2**30:.3f} GiB")
        out["saves"] = [{"name": n, "s": s, "bytes": b}
                        for n, s, b in timed.saves]

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
        out.update(_host_parts(torch, trainer_b))
        for what, data in (("train", trainer_b.train_data),
                           ("held-out", trainer_b.test_data)):
            t0 = time.perf_counter()
            n = sum(1 for _ in data.batches(epoch=9))
            s = time.perf_counter() - t0
            out[f"{what}_batches_s"] = s
            log(f"  data alone: {n} {what} batches of epoch 9 built in "
                f"{s:.3f} s ({s / n:.3f} s a batch, synthetic renders "
                "cached as the run left them)")
        del trainer_b
        torch.cuda.empty_cache()

        gen_out, reads = {}, {}
        # the first run renders the writer's style images and meets the
        # batch's shapes for the first time: a greedy warm-up takes that
        for tag, beam in (("warm-up", 0), (3, 3), (1, 1), (0, 0)):
            before = counts()
            t0 = time.perf_counter()
            res = generate_word.main([
                "--ckpt", f"{logdir}/ckpt", "--ckpt-name", "best",
                "--corpus", "ladder", "--max-writers", "1", "--beam",
                str(beam), "--out", os.path.join(tmp, f"gen{tag}")])
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            launched = tuple(a - b for a, b in zip(counts(), before))
            files = os.listdir(os.path.join(tmp, f"gen{tag}"))
            ids = res["pred_ids"]
            if len(files) != 17 or len(res["files"]) != 17 or not all(
                    f.endswith((".png", ".png.npy")) for f in files):
                raise AssertionError(f"generate_word wrote {len(files)} files")
            if ids.shape != (17, cfg.output_max_len - 1) or ids.min() < 0 \
                    or ids.max() >= VOCAB.size:
                raise AssertionError(f"beam ids {ids.shape} in "
                                     f"[{ids.min()}, {ids.max()}]")
            if launched != (2, 1, 0):
                raise AssertionError(f"a generate_word call launched "
                                     f"{launched}, not 2 + 1")
            reads[tag] = [_until_end(r, VOCAB.end) for r in ids.tolist()]
            loop = res["seconds"]
            key = "warm_up" if tag == "warm-up" else f"beam{beam}"
            gen_out[key] = {"s": s, "words_per_s": 17 / s, "loop_s": loop,
                            "loop_words_per_s": 17 / loop,
                            "launches": list(launched)}
            log(f"  generate_word --beam {beam}"
                f"{' (warm-up)' if tag == 'warm-up' else ''}: 17 files in "
                f"{s:.3f} s ({17 / s:.2f} words/s, checkpoint load and "
                f"model build included; the writer loop {loop:.3f} s, "
                f"{17 / loop:.1f} words/s), launches {launched}; first read "
                f"{VOCAB.decode(ids[0])!r}")
        if reads[1] != reads[0]:
            raise AssertionError("a width-1 beam read differently from the "
                                 "greedy path")
        out["generate_word"] = gen_out

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            shown = inspect_ckpt.main([f"{logdir}/ckpt"])
        if shown["param_counts"] != counts_b or not all(
                f'"{n}": {c}' in buf.getvalue() for n, c in counts_b.items()):
            raise AssertionError(f"inspect_ckpt printed {shown}, "
                                 f"param_count {counts_b}")
        log(f"  inspect_ckpt: step {shown['step']}, parameters "
            f"{shown['param_counts']}")
        for path, s in timed.loads:
            log(f"  loaded {os.path.basename(path)}: {s:.3f} s")
        out["loads"] = [{"name": os.path.basename(p), "s": s}
                        for p, s in timed.loads]
        torch.cuda.empty_cache()
    finally:
        timed.restore()
    log(f"  phase 7 on {card}")
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


def phase_encoders(torch, card: str, counts, zero):
    """(b) Each new encoder at full width (``default_config()`` with it,
    bf16, random weights from the seed): one request of 1 writer x 64
    words, then timed (median of 5 after a warm-up); parameters and peak
    memory; merged train steps at batch 8 (Adam): one checked, then 3
    timed (median; their peak memory is the train peak)."""
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
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = make_generate_and_read_fn(cfg, seed=SEED)
        build_s = time.perf_counter() - t0
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
        if launched != (2, 1, 0):
            raise AssertionError(f"{name}: a generate call launched "
                                 f"{launched}, not in_relu 2 and phase_head "
                                 "1 on its wgmma route")
        run(style, labels)
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run(style, labels)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        req_ms = statistics.median(walls) * 1e3
        serve_peak = torch.cuda.max_memory_allocated() / 2**30
        del run, images, ids
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = init_state(cfg, seed=SEED)
        state_s = time.perf_counter() - t0
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
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, metrics, _ = step(state, batch, gen)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            if not all(math.isfinite(float(v)) for v in metrics.values()):
                raise AssertionError(f"{name}: non-finite losses")
        step_ms = statistics.median(walls) * 1e3
        train_peak = torch.cuda.max_memory_allocated() / 2**30
        del state, batch, step
        torch.cuda.empty_cache()
        out[name] = {"encoder_params": n_enc, "gen_params": n_gen,
                     "build_s": build_s, "request_ms": req_ms,
                     "words_per_s": 64 / (req_ms / 1e3),
                     "serve_peak_gib": serve_peak,
                     "launches_generate_call": list(launched),
                     "state_build_s": state_s, "step_ms": step_ms,
                     "train_peak_gib": train_peak, "step0_losses": losses,
                     "enc_stats": len(enc_stats), "enc_stats_moved": moved}
        log(f"  {name}: encoder {n_enc / 1e6:.2f} M of G's {n_gen / 1e6:.2f}"
            f" M parameters, built in {build_s:.1f} s; 1 x 64 words "
            f"{req_ms:.3f} ms (median of 5, {64 / (req_ms / 1e3):.1f} "
            f"words/s), launches {launched}, peak {serve_peak:.3f} GiB; "
            f"train state {state_s:.1f} s, merged step at batch "
            f"{cfg.batch_size} {step_ms:.3f} ms (median of 3 after the "
            f"first), peak "
            f"{train_peak:.3f} GiB, encoder statistics moved {moved}/"
            f"{len(enc_stats)}; step 0 l_total {losses['l_total']:.4f}")
    log(f"  encoders on {card}")
    return out


def phase_quality_report(torch, tmp: str, counts, zero):
    """(c) ``cli/quality_report`` on phase 7's ``best`` with 4 writers and
    64 real words each; (d) ``cli/evaluate`` on its two folders, with and
    without ``--per-writer``."""
    import contextlib
    import io
    import os

    from affganwriting_torch.cli import evaluate, quality_report
    from affganwriting_torch.eval.generated import cer_of_folder

    out_dir = os.path.join(tmp, "quality")
    zero()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        report = quality_report.main([
            "--ckpt", os.path.join(tmp, "run", "ckpt"), "--ckpt-name",
            "best", "--max-writers", "4", "--words-per-writer", "64",
            "--out", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
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
    calls = report["cer"]["count"] // 4 // 64 + (
        report["cer"]["count"] // 4 % 64 > 0)
    if launched != (2 * 4 * calls, 4 * calls, 0):
        raise AssertionError(f"quality_report launched {launched} for "
                             f"{4 * calls} generate calls")
    n_real = len(os.listdir(real_dir))
    log(f"  quality_report: {wall:.3f} s wall; {report['cer']['count']} "
        f"generated and {n_real} real words; cer {report['cer']['cer']:.3f}"
        f" (= cer_of_folder), fid_random_features "
        f"{report['fid_random_features']:.6g}, wid "
        f"{report.get('wid_fid_random_features', report.get('wid_fid_error'))}"
        f"; seconds { {k: round(v, 3) for k, v in report['seconds'].items()} }"
        f"; launches {launched} over {4 * calls} generate calls")
    res = {"report": report, "wall_s": wall, "launches": list(launched),
           "generate_calls": 4 * calls, "real_words": n_real}
    # the activation pass alone: 512 crops, upload and download included
    import numpy as np

    from affganwriting_torch.eval.fid import FIDScorer, crop64_preprocess

    scorer = FIDScorer()
    crops = crop64_preprocess(np.random.default_rng(SEED).random(
        (512, 64, 216)).astype(np.float32))
    scorer.activations(crops[:64])
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scorer.activations(crops)
        walls.append(time.perf_counter() - t0)
    res["activations_ms_per_image"] = statistics.median(walls) * 1e3 / 512
    log(f"  FID activations alone: {res['activations_ms_per_image']:.4f} ms "
        f"an image (512 crops in batches of {scorer.batch_size}, f32, "
        "median of 3)")
    for extra, key in (([], "fid_random_features"),
                       (["--per-writer"], "wid_fid_random_features")):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            ev = evaluate.main([gen_dir, "--real", real_dir] + extra)
        s = time.perf_counter() - t0
        if json.loads(buf.getvalue()) != ev or set(ev) != {
                "cer", "fid_provenance", key}:
            raise AssertionError(f"evaluate {extra}: {ev}")
        if ev["cer"] != report["cer"] or not math.isfinite(ev[key]):
            raise AssertionError(f"evaluate {extra}: {ev}")
        if key in report and abs(ev[key] - report[key]) > 1e-3 * max(
                1.0, abs(report[key])):
            raise AssertionError(f"evaluate's {key} {ev[key]} is not the "
                                 f"report's {report[key]}")
        res[f"evaluate{''.join(extra)}"] = {"s": s, **ev}
        log(f"  evaluate {' '.join(extra)}: {key} {ev[key]:.6g} in {s:.3f} "
            "s, cer as the report's")
    return res


def _host_parts(torch, trainer) -> dict:
    """Two host-side parts of a trainer epoch, timed alone on the card: one
    batch's upload (``to_device_batch`` of the numpy batch, median of 5)
    and the post-epoch CER pass of a 2-step epoch (6 ``cer_counts`` calls
    on (B, T - 1) ids against (B, T) labels)."""
    from affganwriting_torch.eval.cer import CERAccumulator
    from affganwriting_torch.train.step import to_device_batch

    batch = next(trainer.train_data.batches(epoch=8))
    dev = trainer.device
    ups = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        to_device_batch(batch, dev)
        torch.cuda.synchronize()
        ups.append(time.perf_counter() - t)
    ids = torch.randint(0, 55, batch["label_xt"][:, 1:].shape, device=dev)
    gt = torch.as_tensor(batch["label_xt"], device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(6):
        CERAccumulator().add(ids, gt)
    torch.cuda.synchronize()
    cer_s = time.perf_counter() - t
    up = statistics.median(ups)
    log(f"  host parts: a batch's upload {up * 1e3:.3f} ms (median of 5), "
        f"the CER pass of a 2-step epoch {cer_s * 1e3:.3f} ms")
    return {"upload_ms": up * 1e3, "cer_pass_ms": cer_s * 1e3}


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card",
              file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from affganwriting_torch.ops import cuda_build

    t_start = time.perf_counter()

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 references in f32
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    part, peaks = card_peaks(name)
    log(f"[1] device: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi}; peaks of the H100 {part} "
        f"part: {peaks[0] / 1e12:.2f} TB/s, {peaks[1] / 1e12:.0f} TFLOP/s "
        f"bf16, {peaks[2] / 1e12:.0f} TFLOP/s f32")
    cached = cuda_build.library_path().is_file()
    t0 = time.perf_counter()
    lib_path, build_log = cuda_build.build()
    build_s = time.perf_counter() - t0
    log(f"    {'cached build found at' if cached else 'built'} {lib_path} in "
        f"{build_s:.1f} s")
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
    main_path = timed("4", phase_main_path, torch, launches, smi)
    log("[5] kernel times at batch 256, bf16")
    times = timed("5", phase_kernel_times, torch, F, peaks)

    times["phase_head"].update({
        "route": "wgmma+tma",
        "ptxas_wgmma": ptxas_info(build_log, "phase_head_wgmma_kernel"),
        "ptxas_from": "cached build.log" if cached else "this build",
        "f32_route_launches": launches["phase_head_f32"]})
    sources = {"in_relu": ("affganwriting_torch/csrc/in_relu.cu",
                           "affganwriting_tpu/ops/in_relu_pallas.py:51"),
               "phase_head": ("affganwriting_torch/csrc/phase_head.cu",
                              "affganwriting_tpu/ops/phase_head_pallas.py:72")}
    kernels = []
    for k, (src, replaces) in sources.items():
        t = times[k]
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[k], "max_abs_err": errs[k]["bf16"],
            "max_abs_err_f32": errs[k]["f32"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "detail": {kk: v for kk, v in t.items()
                       if kk not in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
        })
    log("[6] train: the merged step on the card vs on the CPU, small fp32 "
        "config")
    train_ref = timed("6a", phase_train_reference, torch)
    log("[6] train: full width (default_config, bf16, Adam, batch 8)")
    train = timed("6b", phase_train, torch, smi)
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
        runtime = timed("7", phase_trainer_runtime, torch, smi, tmp)
        runtime["phase_s"] = seconds["7"]
        log("[8] evaluation and the other style encoders")
        log("[8a] card vs CPU, small fp32 config")
        eval_ref = timed("8a", phase_eval_reference, torch)
        log("[8b] each new style encoder at full width (default_config, "
            "bf16)")
        encoders = timed("8b", phase_encoders, torch, smi, counts, zero)
        log("[8c,d] quality_report on phase 7's best; evaluate")
        quality = timed("8cd", phase_quality_report, torch, tmp, counts,
                        zero)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k, key in (("in_relu", 0), ("phase_head", 1)):
        kernels[[r["name"] for r in kernels].index(k)]["detail"].update({
            "launches_trainer_eval_batch":
                runtime["eval_launches_per_batch"][key],
            "launches_generate_word_call":
                runtime["generate_word"]["beam0"]["launches"][key],
            "launches_quality_report_call": quality["launches"][key],
            "launches_encoder_generate_call": {
                n: e["launches_generate_call"][key]
                for n, e in encoders.items()}})
    log(f"phase seconds: { {k: round(v, 1) for k, v in seconds.items()} }")
    log(json.dumps({"main_path": main_path, "train_reference": train_ref,
                    "train": train, "trainer_runtime": runtime,
                    "eval_reference": eval_ref, "encoders": encoders,
                    "quality_report": quality, "phase_s": seconds,
                    "build_s": build_s}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
