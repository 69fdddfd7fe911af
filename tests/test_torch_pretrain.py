"""The port's line pretraining against the JAX package's, f32 on the CPU:
``train/auto_trainer.AutoTrainer``'s step (L1 only, and L1 + CTC through
the E_HWR head), ``cli/train_hwr``'s step (``CNNOnlyHWR`` and ``CRNN``
with BatchNorm), and the two splices of ``train/line_trainer``
(``splice_pretrained_hwr``, ``splice_pretrained_ae``) against
``_splice_pretrained_hwr``/``_splice_pretrained_ae``, through the
converters ``utils/from_flax.hwr_final_from_flax`` and
``ae_final_from_flax``.

Setup: 12 classes; the AE at dim 8 on 2 lines of 64 x 128 (an E_HWR
sequence of 8 steps), the HWRs at their fixed widths on 2 lines of 64 x
96; labels of 3 distinct classes, which every sequence can align (an
impossible label is floored at ~1e5 by ``optax.ctc_loss`` and zeroed by
the port, ROADMAP Queue 3).  Every flax leaf is drawn from numpy and
carried over; both Adam states are warmed (moments drawn, count 3, so a
step is smooth in its gradient: a fresh Adam's first step is lr *
sign(g)).  The JAX HWR step is ``cli/train_hwr.py``'s own (lines 66-80:
train mode, batch statistics updated), run at f32 here (the CLI computes
in bf16 in both packages); neither arch has dropout.

Limits: the losses 1e-5 relative; parameters and BatchNorm statistics
after the step 1e-6 absolute; the HWR's gradients per leaf in relative
L2, against f64 on both sides and against the JAX package's f32
(``test_train_hwr_step_matches_jax`` gives the readings); a splice bit
for bit.
"""

import functools
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_support import (
    LINE_CLASSES,
    LINE_GAN,
    _warm_opt,
    line_variables,
    port_in_f64,
    to_numpy_tree,
)
from affganwriting_tpu.models.line import hwr as jhwr
from affganwriting_tpu.models.line.autoencoder import Autoencoder as JAE
from affganwriting_tpu.models.line.hwr import CNNOnlyHWR as JCNN
from affganwriting_tpu.models.line.hwr import CRNN as JCRNN
from affganwriting_tpu.train import line_trainer as jlt
from affganwriting_tpu.train.auto_trainer import AutoTrainer as JAuto
from affganwriting_torch.cli.train_hwr import build_hwr, hwr_step
from affganwriting_torch.core.checkpoint import save_swap
from affganwriting_torch.models.line.autoencoder import Autoencoder
from affganwriting_torch.train.auto_trainer import AutoTrainer
from affganwriting_torch.train.line_trainer import (
    LineGanTrainer,
    ctc_loss,
    splice_pretrained_ae,
    splice_pretrained_hwr,
)
from affganwriting_torch.utils.from_flax import (
    ae_final_from_flax,
    convert_module,
    hwr_final_from_flax,
    line_from_flax,
    optimizer_from_flax,
)

torch.set_num_threads(2)   # tier-1 runs six xdist workers

LOSS_TOL, STATE_TOL = 1e-5, 1e-6
# per leaf, relative L2, of the HWR's f32 gradient: the port against the
# JAX package in f64 and the port's own modules in f64 (``F64_GRAD_TOL``),
# the port against the JAX package in f32 (``HWR_GRAD_TOL``)
F64_GRAD_TOL = 1e-4
HWR_GRAD_TOL = {"cnn_only": 5e-2, "crnn": 1e-4}


def _batch(width: int, seed: int):
    rng = np.random.default_rng(seed)
    img = np.tanh(rng.normal(size=(2, 64, width, 1))).astype(np.float32)
    label = np.zeros((2, 5), np.int32)
    for i in range(2):
        label[i, :3] = rng.choice(np.arange(1, LINE_CLASSES), 3,
                                  replace=False)
    return img, label, np.full((2,), 3, np.int32)


def _nchw(img) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2)))


def _max_err(port_sd: dict, want: dict) -> float:
    assert set(port_sd) == set(want)
    return max(float((port_sd[k].float() - want[k].float()).abs().max())
               for k in want)


def _orbax_save(path: str, tree) -> None:
    import orbax.checkpoint as ocp

    ck = ocp.StandardCheckpointer()
    ck.save(path, jax.tree.map(jnp.asarray, tree))
    ck.wait_until_finished()


@pytest.mark.parametrize("ctc_weight", [0.0, 1.0], ids=["l1", "l1_ctc"])
def test_auto_trainer_step_matches_jax(ctc_weight):
    img, label, lengths = _batch(128, seed=1)
    hwr = LINE_CLASSES if ctc_weight > 0 else None
    jt = JAuto(ctc_weight=ctc_weight, n_class=LINE_CLASSES)
    jt.ae = JAE(dim=8, hwr_classes=hwr)
    jt._build()
    params = line_variables(jt.ae, img, seed=2)["params"]
    js = {"params": params,
          "opt": _warm_opt(jt.opt.init(params), seed=3),
          "step": jnp.asarray(3, jnp.int32)}
    tt = AutoTrainer(ctc_weight=ctc_weight, n_class=LINE_CLASSES,
                     device="cpu")
    tt.ae = Autoencoder(dim=8, hwr_classes=hwr)
    ts = tt.init_state()
    np_params = to_numpy_tree(params)
    ts.ae.load_state_dict(convert_module({"params": np_params}, ts.ae))
    ts.opt.load_state_dict(optimizer_from_flax(
        to_numpy_tree(js["opt"]), ts.ae, ts.opt))

    js, jloss, jl1 = jt._step(js, jnp.asarray(img), jnp.asarray(label),
                              jnp.asarray(lengths))
    ts, tloss, tl1 = tt.step(ts, img, label, lengths)
    for got, want in ((tloss, jloss), (tl1, jl1)):
        want = float(want)
        assert abs(float(got) - want) <= LOSS_TOL * max(1.0, abs(want))
    if ctc_weight:
        assert float(jloss) - float(jl1) > 1.0     # the CTC term counts
    want = convert_module({"params": to_numpy_tree(js["params"])}, ts.ae)
    assert _max_err(ts.ae.state_dict(), want) <= STATE_TOL
    assert ts.step == 1


def _grad_errors(got: dict, want: dict) -> tuple[dict, float]:
    """({leaf: relative L2 of got against want} over the leaves with a
    gradient, the largest norm of a null leaf in either, over the largest
    leaf's norm).  The null leaves are the conv biases before a train-mode
    BatchNorm (its batch mean cancels them) and the LSTM's input-side
    bias: 0 but for rounding."""
    scale = max(float(g.norm()) for g in want.values())
    null = {k for k, g in want.items() if float(g.norm()) <= 1e-6 * scale}
    errs = {k: float((got[k] - want[k]).norm() / want[k].norm())
            for k in want if k not in null}
    return errs, max([float(t[k].norm()) / scale for k in null
                      for t in (got, want)], default=0.0)


class _JnpF64(types.ModuleType):
    """``jax.numpy`` with ``float32`` read as ``float64``: put in place of
    ``affganwriting_tpu.models.line.hwr``'s ``jnp``, it lifts the
    module's fixed f32 (its norms' compute dtype, the casts) to f64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


class _NnF64(types.ModuleType):
    """``flax.linen`` whose LSTM cell keeps its parameters and carry in
    f64 (the CRNN's BiLSTM), in place of the same module's ``nn``."""

    def __getattr__(self, name):
        if name == "OptimizedLSTMCell":
            return functools.partial(fnn.OptimizedLSTMCell,
                                     param_dtype=jnp.float64)
        return getattr(fnn, name)


def _jax_f64_grads(arch, variables, img, label, lengths) -> dict:
    """The gradient of ``cli/train_hwr.py``'s loss (train mode) in the JAX
    package's own recognizer, computed in f64 under x64: a witness from
    the reference's side."""
    to64 = lambda tree: jax.tree.map(  # noqa: E731
        lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jhwr, "jnp", _JnpF64("jnp"))
        mp.setattr(jhwr, "nn", _NnF64("nn"))
        model = (JCNN if arch == "cnn_only" else JCRNN)(
            LINE_CLASSES, norm="batch", dtype=jnp.float64)
        stats = to64(variables["batch_stats"])

        def loss_fn(params):
            logp, _ = model.apply(
                {"params": params, "batch_stats": stats},
                jnp.asarray(img, jnp.float64), train=True,
                mutable=["batch_stats"])
            assert logp.dtype == jnp.float64
            return jlt.ctc_loss(logp, jnp.asarray(label),
                                jnp.asarray(lengths))

        return to_numpy_tree(jax.grad(loss_fn)(to64(variables["params"])))


@pytest.mark.parametrize("arch", ["cnn_only", "crnn"])
def test_train_hwr_step_matches_jax(arch):
    """The gradient that reaches Adam, per leaf in relative L2: the port's
    f32 against the JAX package's recognizer in f64 (x64) and against the
    port's own modules in f64, each within ``F64_GRAD_TOL`` [readings
    2.3e-5 cnn_only, 1.0e-5 crnn, against either], and against the JAX
    package's f32 within ``HWR_GRAD_TOL`` [1.4e-2, 1.3e-5]: the JAX
    package's f32 CNNOnly gradient lies 1.4e-2 from its own f64
    (``n1d_0.bias``, ``cnn.conv0.weight``), so that gap is the
    reference's.  Adam's
    moments are warmed at the gradients' scale (mu N(0, 0.1), nu U(0.1,
    1); at the default warm state the step is near lr * sign(g), where a
    1e-2 gradient error moves a parameter by 2e-5), so the state after the
    step holds Adam's arithmetic and the BatchNorm statistics."""
    img, label, lengths = _batch(96, seed=4)
    jmodel = (JCNN if arch == "cnn_only" else JCRNN)(
        LINE_CLASSES, norm="batch", dtype=jnp.float32)
    opt = optax.adam(2e-4)
    variables = line_variables(jmodel, img, seed=5)
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = _warm_opt(opt.init(params), seed=6, mu_std=0.1,
                          nu_range=(0.1, 1.0))

    @jax.jit
    def step(params, stats, opt_state, img, labels, lengths, rng):
        # cli/train_hwr.py's step, returning its gradients too
        def loss_fn(params):
            out = jmodel.apply(
                {"params": params, "batch_stats": stats}, img, train=True,
                mutable=["batch_stats"], rngs={"dropout": rng})
            logp, upd = out
            return jlt.ctc_loss(logp, labels, lengths), upd["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, new_opt = opt.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        return params, new_stats, new_opt, loss, grads

    jp, jstats, _, jloss, jgrads = step(
        params, stats, opt_state, jnp.asarray(img), jnp.asarray(label),
        jnp.asarray(lengths), jax.random.key(0))

    def port_model():
        model = build_hwr(arch, "batch", LINE_CLASSES, 0, "cpu",
                          dtype=torch.float32)
        model.load_state_dict(line_from_flax(to_numpy_tree(variables),
                                             model))
        return model

    x, lab, lens = (_nchw(img), torch.from_numpy(label).long(),
                    torch.from_numpy(lengths).long())
    model = port_model()
    topt = torch.optim.Adam(model.parameters(), lr=2e-4, betas=(0.9, 0.999),
                            eps=1e-8)
    topt.load_state_dict(optimizer_from_flax(to_numpy_tree(opt_state),
                                             model, topt))
    tloss = hwr_step(model, topt, x, lab, lens)
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))

    f64 = port_model().train()
    with port_in_f64(f64):
        ctc_loss(f64(x.double()), lab, lens).backward()
    ref = {n: p.grad for n, p in f64.named_parameters()}
    got = {n: p.grad.double() for n, p in model.named_parameters()}

    def as_port(grads):
        return {k: torch.from_numpy(np.asarray(v, np.float64)) for k, v in
                convert_module({"params": to_numpy_tree(grads)}, model,
                               params_only=True).items()}

    jax64 = as_port(_jax_f64_grads(arch, variables, img, label, lengths))
    for what, want in (("JAX f64", jax64), ("port f64", ref)):
        errs, null = _grad_errors(got, want)
        assert max(errs.values()) <= F64_GRAD_TOL and null <= 1e-6, \
            (what, sorted(errs.items(), key=lambda kv: -kv[1])[:3], null)
    want = as_port(jgrads)
    errs, null = _grad_errors(got, want)
    assert max(errs.values()) <= HWR_GRAD_TOL[arch] and null <= 1e-6, \
        (sorted(errs.items(), key=lambda kv: -kv[1])[:3], null)

    want = line_from_flax(to_numpy_tree({"params": jp,
                                         "batch_stats": jstats}), model)
    assert _max_err(model.state_dict(), want) <= STATE_TOL
    moved = line_from_flax(to_numpy_tree(variables), model)
    assert _max_err(model.state_dict(), moved) > 10 * STATE_TOL


def test_hwr_splice_matches_jax(tmp_path):
    """A JAX ``hwr_final`` (orbax) and the port's (the converter's
    payload) splice to the same recognizer; through ``LineGanTrainer``'s
    ``init_state`` too."""
    from affganwriting_torch.models.line.container import HWWithStyle

    img, _, _ = _batch(96, seed=7)
    jmodel = JCNN(LINE_CLASSES, norm="batch", dtype=jnp.float32)
    saved = line_variables(jmodel, img, seed=8)
    init = line_variables(jmodel, img, seed=9)
    _orbax_save(str(tmp_path / "jax_hwr_final"), saved)
    jparams, jstats = jlt._splice_pretrained_hwr(
        str(tmp_path / "jax_hwr_final"), init["params"],
        {"hwr": init["batch_stats"], "other": {}})
    port = build_hwr("cnn_only", "batch", LINE_CLASSES, 0, "cpu",
                     dtype=torch.float32)
    path = str(tmp_path / "hwr_final")
    save_swap(path, hwr_final_from_flax(to_numpy_tree(saved), port))
    splice_pretrained_hwr(path, port)
    want = line_from_flax(to_numpy_tree(
        {"params": jparams, "batch_stats": jstats["hwr"]}), port)
    assert _max_err(port.state_dict(), want) == 0.0
    assert set(jstats) == {"hwr", "other"}

    tr = LineGanTrainer(**LINE_GAN, pretrained_hwr=path, device="cpu")
    tr.model = HWWithStyle(gen_dim=32, **LINE_GAN)
    state = tr.init_state()
    assert _max_err(state.model.hwr.state_dict(), want) == 0.0
    assert _max_err(tr.model.hwr.state_dict(), want) > 0.0


def test_ae_splice_matches_jax_and_drops_the_e_hwr_head(tmp_path):
    img, _, _ = _batch(128, seed=10)
    saved = line_variables(JAE(dim=8, hwr_classes=LINE_CLASSES), img,
                           seed=11)
    init = line_variables(JAE(dim=8), img, seed=12)["params"]
    assert "e_hwr" in saved["params"] and "e_hwr" not in init
    _orbax_save(str(tmp_path / "jax_ae_final"), saved)
    jparams = jlt._splice_pretrained_ae(str(tmp_path / "jax_ae_final"),
                                        init)
    path = str(tmp_path / "ae_final")
    save_swap(path, ae_final_from_flax(
        to_numpy_tree(saved), Autoencoder(dim=8, hwr_classes=LINE_CLASSES)))
    port = Autoencoder(dim=8)
    splice_pretrained_ae(path, port)
    want = convert_module({"params": to_numpy_tree(jparams)}, port)
    assert _max_err(port.state_dict(), want) == 0.0

    tr = LineGanTrainer(**LINE_GAN, pretrained_ae=path, device="cpu")
    tr.ae = Autoencoder(dim=8)
    assert _max_err(tr.init_state().ae.state_dict(), want) == 0.0


@pytest.mark.parametrize("fault", ["missing_group", "shape"])
def test_ae_splice_refusals_match_jax(tmp_path, fault):
    """A group missing from the file, or a shape that differs (a
    checkpoint of variant '2', bottleneck 256, into the 2tight AE), raises
    ``ValueError`` in both packages, naming the same groups."""
    img, _, _ = _batch(128, seed=13)
    variant = "2" if fault == "shape" else "2tight"
    saved = line_variables(JAE(variant=variant, dim=8,
                               hwr_classes=LINE_CLASSES), img, seed=14)
    port_src = Autoencoder(variant=variant, dim=8, hwr_classes=LINE_CLASSES)
    payload = ae_final_from_flax(to_numpy_tree(saved), port_src)
    if fault == "missing_group":
        saved = {"params": {k: v for k, v in saved["params"].items()
                            if k != "to_z"}}
        payload = {"params": {k: v for k, v in payload["params"].items()
                              if not k.startswith("to_z.")}}
    init = line_variables(JAE(dim=8), img, seed=15)["params"]
    _orbax_save(str(tmp_path / "jax_ae_final"), saved)
    path = str(tmp_path / "ae_final")
    save_swap(path, payload)
    match = "lacks param groups" if fault == "missing_group" else "shape"
    with pytest.raises(ValueError, match=match) as want:
        jlt._splice_pretrained_ae(str(tmp_path / "jax_ae_final"), init)
    with pytest.raises(ValueError, match=match) as got:
        splice_pretrained_ae(path, Autoencoder(dim=8))
    if fault == "missing_group":
        assert "['to_z']" in str(want.value) and "['to_z']" in str(got.value)
        assert "--variant" in str(got.value)
