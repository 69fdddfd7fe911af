"""Where the bf16 train step's errors come from (not a test): the readings
that tests/test_torch_bf16_step.py's docstring rests on.

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/torch_bf16_readings.py

On the step's configuration, weights and batch, relative L2 (float64):
1. G's forward in train mode, stage by stage (style encoder, text encoder,
   mix, res blocks, upsample convs, head): JAX bf16 (XLA excess precision
   off) vs JAX f32, the port's bf16 vs JAX f32 and vs JAX bf16;
2. R's VGG trunk in train mode, BatchNorm by BatchNorm: JAX bf16 jitted
   with excess precision on (XLA's default) and off, and run eagerly,
   against each other, f32 and the port;
3. one bias gradient summed over 4 x 16 x 54 positions in bf16, against
   the exact sum: JAX and PyTorch;
4. each player's step delta split into weights (rank >= 2) and vectors,
   and the JAX bf16 step with excess precision on against off.
Takes about 8 minutes on 4 threads.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from affganwriting_tpu.models.recognizer.encoder import VGGTrunk as JTrunk
from affganwriting_tpu.train.state import build_models
from affganwriting_torch.models.recognizer.encoder import VGGTrunk
from affganwriting_torch.train.parity import STEP_BATCH, STEP_CONFIG, is_stat
from affganwriting_torch.train.state import PLAYERS, init_state
from affganwriting_torch.utils.from_flax import (
    convert_module,
    word_gan_from_flax,
)
from test_torch_support import (
    jax_merged_step,
    jax_word_gan_state,
    port_merged_step,
    small_jax_config,
    small_torch_config,
    to_numpy_tree,
    word_batch,
)

NO_EXCESS = {"xla_allow_excess_precision": False}
G_STAGES = ("enc_image", "text_encoder", "linear_mix", "dec/res0",
            "dec/res1", "dec/up0", "dec/up1", "dec/up2", "dec/head")


def rel(a, b) -> float:
    a, b = (np.asarray(t, np.float64) for t in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def flat(x, nchw: bool) -> np.ndarray:
    if isinstance(x, (tuple, list)):
        return np.concatenate([flat(t, nchw) for t in x])
    a = np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor)
                   else x, np.float64)
    return (a.transpose(0, 2, 3, 1) if nchw and a.ndim == 4 else a).ravel()


def g_stages(state, jcfg, tcfg, batch) -> None:
    style, lab = batch["style_imgs"], batch["label_xt"]
    out = {}
    for dt in ("float32", "bfloat16"):
        gen = build_models(jcfg.replace(compute_dtype=dt))[0]
        v = {"params": state.gen.params, "batch_stats": state.gen.stats}
        _, st = jax.jit(lambda v: gen.apply(
            v, jnp.asarray(style), jnp.asarray(lab), train=True,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=True), compiler_options=NO_EXCESS)(v)
        node = st["intermediates"]
        out[dt] = {}
        for name in G_STAGES:
            n = node
            for part in name.split("/"):
                n = n[part]
            out[dt][name] = flat(n["__call__"][0], False)
    weights = word_gan_from_flax(to_numpy_tree(state), tcfg)
    port = init_state(tcfg.replace(compute_dtype="bfloat16"), device="cpu",
                      weights=weights, rec_dropout=0.0).gen.model.train()
    got = {}
    for name in G_STAGES:
        m = port
        for part in name.split("/"):
            m = getattr(m, part)
        m.register_forward_hook(
            lambda mod, i, o, name=name: got.__setitem__(name, flat(o, True)))
    with torch.no_grad():
        port(torch.from_numpy(style), torch.from_numpy(lab).long())
    print("1. G train-mode stages: jax_bf16:f32 port_bf16:f32 "
          "port_bf16:jax_bf16")
    for name in G_STAGES:
        j32, j16 = out["float32"][name], out["bfloat16"][name]
        print(f"   {name:13s} {rel(j16, j32):.4f} {rel(got[name], j32):.4f} "
              f"{rel(got[name], j16):.4f}", flush=True)


def r_trunk(state, batch) -> None:
    v = {"params": state.rec.params["enc"]["vgg"],
         "batch_stats": state.rec.stats["enc"]["vgg"]}
    img = np.repeat(batch["style_imgs"][..., :1], 3, -1)

    def jax_run(dt, how):
        m = JTrunk(dtype=dt)

        def f(v):
            return m.apply(v, jnp.asarray(img), train=True,
                           mutable=["batch_stats", "intermediates"],
                           capture_intermediates=True)[1]

        if how == "eager":
            with jax.disable_jit():
                st = f(v)
        else:
            st = jax.jit(f, compiler_options=None if how == "jit"
                         else NO_EXCESS)(v)
        return [np.asarray(st["intermediates"][f"bn{i}"]["__call__"][0],
                           np.float32) for i in range(16)]

    def port_run(dt):
        m = VGGTrunk(dt)
        m.load_state_dict(convert_module(to_numpy_tree(v), m))
        outs = []
        for i in range(16):
            getattr(m, f"bn{i}").register_forward_hook(
                lambda mod, a, o: outs.append(
                    o.detach().float().numpy().transpose(0, 2, 3, 1)))
        with torch.no_grad():
            m.train()(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()))
        return outs

    r = {"j32": jax_run(jnp.float32, "jit"),
         "j16": jax_run(jnp.bfloat16, "jit"),
         "j16x": jax_run(jnp.bfloat16, "no-excess"),
         "j16e": jax_run(jnp.bfloat16, "eager"),
         "p16": port_run(torch.bfloat16)}
    pairs = (("j16", "j32"), ("j16x", "j32"), ("j16e", "j16"),
             ("j16x", "j16e"), ("p16", "j32"), ("p16", "j16x"))
    print("2. R trunk BatchNorms; j16: jit (excess precision on), j16x: "
          "off, j16e: eager, p16: the port\n   layer " +
          " ".join(f"{a}:{b}" for a, b in pairs))
    for i in range(16):
        print(f"   {i:5d} " + " ".join(f"{rel(r[a][i], r[b][i]):.4f}"
                                      for a, b in pairs), flush=True)


def bias_gradient() -> None:
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 16, 54, 64)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    exact = g.astype(np.float64).sum(axis=(0, 1, 2))

    def f(b, x, g):
        y = x.astype(jnp.bfloat16) + b.astype(jnp.bfloat16)
        return jnp.sum(y.astype(jnp.float32) * g)

    db = jax.jit(jax.grad(f), compiler_options=NO_EXCESS)(b, x, g)
    bt = torch.from_numpy(b).requires_grad_()
    y = torch.from_numpy(x).to(torch.bfloat16) + bt.to(torch.bfloat16)
    (y.float() * torch.from_numpy(g)).sum().backward()
    print(f"3. a bf16 bias gradient over 4 x 16 x 54 positions, relative L2 "
          f"from exact: JAX {rel(np.asarray(db), exact):.3g}, PyTorch "
          f"{rel(bt.grad.numpy(), exact):.3g}", flush=True)


def step_deltas(jcfg, tcfg, batch) -> None:
    j32 = jax_merged_step(jcfg, tcfg, batch)
    bf = jcfg.replace(compute_dtype="bfloat16")
    j16 = jax_merged_step(bf, tcfg, batch, compiler_options=NO_EXCESS)
    j16x = jax_merged_step(bf, tcfg, batch)
    p16 = port_merged_step(tcfg.replace(compute_dtype="bfloat16"),
                           j32["before"], batch)
    print("4. step deltas: jax_bf16:f32 port_bf16:f32 port_bf16:jax_bf16 "
          "jax_bf16(excess on):jax_bf16")
    for n in PLAYERS:
        before = j32["before"][n]
        keys = [k for k in before if not is_stat(k)]
        for part, sel in (("all", keys),
                          ("weights", [k for k in keys
                                       if before[k].dim() >= 2]),
                          ("vectors", [k for k in keys
                                       if before[k].dim() < 2])):
            def d(run):
                return np.concatenate([(run["after"][n][k].double()
                                        - before[k].double()).numpy().ravel()
                                       for k in sel])
            print(f"   {n} {part:7s} {rel(d(j16), d(j32)):.4g} "
                  f"{rel(d(p16), d(j32)):.4g} {rel(d(p16), d(j16)):.4g} "
                  f"{rel(d(j16x), d(j16)):.4g}", flush=True)


def main() -> None:
    torch.set_num_threads(4)
    jcfg = small_jax_config(**STEP_CONFIG)
    tcfg = small_torch_config(**STEP_CONFIG)
    batch = word_batch(tcfg, STEP_BATCH, 11)
    state, _ = jax_word_gan_state(jcfg, batch)
    g_stages(state, jcfg, tcfg, batch)
    r_trunk(state, batch)
    bias_gradient()
    step_deltas(jcfg, tcfg, batch)


if __name__ == "__main__":
    main()
