"""The port's w8a8 serving path (``ops/quant.py``, the decoder's quant
modes, ``Recognizer.read_features`` and ``make_generate_and_read_quant_fn``)
vs the JAX package's ``ops/quant.py``, ``models/decoder.py`` and
``gen/inference.py``, f32 on the CPU.

- ``quantize_weight`` and ``quantize_act``: codes equal, scales within 1
  ulp (the scales are one f32 max and one division in both);
- ``int8_conv``, ``dyn_int8_conv`` and ``static_int8_conv`` on the same
  int8 codes: int32 accumulators equal (integer sums, exact), outputs
  within 1e-6 relative (the same f32 epilogue, in the same association);
- ``prepare_vgg_quant``'s folded weights within 1e-6 (the BatchNorm factor
  is rounded from f64 on both sides; the JAX package divides in f32 when
  its leaves are jax arrays, one ulp apart);
- ``vgg_quant_apply`` with the JAX qparams carried across
  (``utils/from_flax.vgg_qparams_from_flax``), layer by layer on the JAX
  package's own input codes: every code equal but where the f32 value
  before rounding lies within 1e-3 of a rounding tie, and there one step
  apart;
- ``read_features`` against the JAX ``read_features`` within 1e-5 (as
  ``tests/test_quant.py``'s tail check);
- the decoder (dim 64) in ``calib`` mode: the float output within 1e-4
  (``test_torch_models.py``'s decoder limit) and each site's amax, the
  max of a float input that carries that summation-order noise, within
  1e-5 relative;
  in ``static`` mode with the JAX ``"quant"`` collection carried across
  (``gen_quant_from_flax``) and in ``dynamic`` mode: each int8 site on the
  JAX package's own input within 1e-6 of its largest output, and the whole
  decoder correlated above 0.999 with the JAX one (a code one step apart
  at a near-tie, from f32 noise before a quantize, travels on).

``tests/test_torch_quant_pipeline.py`` holds the whole pipeline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import affganwriting_tpu.ops.quant as jq
from affganwriting_tpu.models.decoder import Decoder as JDecoder
from affganwriting_tpu.models.recognizer.seq2seq import (
    Recognizer as JRecognizer,
)
from affganwriting_torch.models.decoder import Decoder
from affganwriting_torch.models.recognizer.seq2seq import Recognizer
from affganwriting_torch.ops import quant as tq
from affganwriting_torch.utils.from_flax import (
    gen_quant_from_flax,
    vgg_qparams_from_flax,
)
from test_torch_support import (
    close,
    load_port,
    nchw,
    nhwc,
    random_variables,
    to_numpy_tree,
)

torch.set_num_threads(2)   # tier-1 runs six xdist workers

F32 = torch.float32
RNG = np.random.default_rng(0)
LABELS = np.asarray([[0, 5, 9, 13, 1, 2, 2, 2], [0, 30, 31, 40, 41, 50, 1, 2]],
                    np.int32)


def hwio(w: torch.Tensor) -> np.ndarray:
    return w.permute(2, 3, 1, 0).numpy()


def test_quantize_weight_and_act_match_jax():
    w = RNG.normal(size=(3, 3, 32, 64)).astype(np.float32)
    wq_j, sw_j = jq.quantize_weight(jnp.asarray(w))
    wq, sw = tq.quantize_weight(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(hwio(wq), np.asarray(wq_j))
    np.testing.assert_array_max_ulp(sw.numpy(), np.asarray(sw_j), maxulp=1)
    x = (RNG.normal(size=(2, 5, 7, 8)) * 3).astype(np.float32)
    for amax in (1.7, 4.2):
        np.testing.assert_array_equal(
            tq.quantize_act(nchw(x), amax).permute(0, 2, 3, 1).numpy(),
            np.asarray(jq.quantize_act(jnp.asarray(x), amax)))


def _int8(shape):
    return RNG.integers(-127, 128, size=shape).astype(np.int8)


@pytest.mark.parametrize("ci,k", [(1, 3), (3, 3), (32, 3), (16, 5)])
@pytest.mark.parametrize("which", ["int8_conv", "dyn_int8_conv",
                                   "static_int8_conv"])
def test_int8_convs_match_jax(which, ci, k):
    co = 24
    w = RNG.normal(size=(k, k, ci, co)).astype(np.float32) * 0.2
    bias = RNG.normal(size=(co,)).astype(np.float32)
    tw = torch.from_numpy(w.transpose(3, 2, 0, 1))
    if which == "int8_conv":
        x_q = _int8((2, 6, 9, ci))
        w_q, sw = jq.quantize_weight(jnp.asarray(w))
        want = jq.int8_conv(jnp.asarray(x_q), w_q, 0.03, sw, bias,
                            out_dtype=jnp.float32)
        got = tq.int8_conv(nchw(x_q).to(torch.int8),
                           torch.from_numpy(np.asarray(w_q).transpose(
                               3, 2, 0, 1)), 0.03,
                           torch.from_numpy(np.asarray(sw)),
                           torch.from_numpy(bias), out_dtype=F32)
        xp = np.pad(x_q, ((0, 0), (k // 2,) * 2, (k // 2,) * 2, (0, 0)))
    else:
        x = (RNG.normal(size=(2, 6, 9, ci)) * 2).astype(np.float32)
        if which == "dyn_int8_conv":
            want = jq.dyn_int8_conv(jnp.asarray(x), jnp.asarray(w), bias,
                                    out_dtype=jnp.float32)
            got = tq.dyn_int8_conv(nchw(x), tw, torch.from_numpy(bias),
                                   out_dtype=F32)
            sx = np.abs(x).max(axis=(1, 2, 3), keepdims=True)
            xp = np.clip(np.round(x * (np.float32(127.0) / sx)), -127, 127)
        else:
            want = jq.static_int8_conv(jnp.asarray(x), jnp.asarray(w), 2.5,
                                       bias, out_dtype=jnp.float32, pad=1)
            got = tq.static_int8_conv(nchw(x), tw, 2.5,
                                      torch.from_numpy(bias), out_dtype=F32,
                                      pad=1)
            xp = np.pad(np.asarray(jq.quantize_act(jnp.asarray(x), 2.5)),
                        ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect")
        xp = xp.astype(np.int8)
    # the accumulators on the same codes: the JAX package's int32 conv
    w_q, _ = jq.quantize_weight(jnp.asarray(w))
    acc_j = jax.lax.conv_general_dilated(
        jnp.asarray(xp), w_q, (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    acc = tq.int8_conv_acc(torch.from_numpy(xp), torch.from_numpy(
        np.asarray(w_q).transpose(3, 2, 0, 1)))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-6,
                               atol=0)


@pytest.fixture(scope="module")
def rec_pair():
    """The small seq2seq R (f32, 32x104) from random flax leaves, the
    port's loaded from them, and a batch of images."""
    img = np.tanh(RNG.normal(size=(2, 32, 104, 1))).astype(np.float32)
    jr = JRecognizer(55, 64, 16, 8, dtype=jnp.float32)
    v = random_variables(jr, img, LABELS)
    tr = load_port(Recognizer(55, 64, 16, 8, img_height=32, dtype=F32), v)
    return jr, v, tr, img


def test_prepare_vgg_quant_folds_like_jax(rec_pair):
    _, v, tr, img = rec_pair
    want = jq._vgg_layers(jax.tree.map(jnp.asarray, v))
    got = tq._vgg_layers(tr)
    assert len(got) == len(want) == 16
    for i, (g, w) in enumerate(zip(got, want)):
        close(hwio(g["w"]), w["w"], 1e-6, f"folded kernel {i}")
        close(g["b"], w["b"], 1e-6, f"folded bias {i}")
    q = tq.prepare_vgg_quant(tr, nchw(img))
    assert set(q["layers"][0]) == {"wq", "sw", "b", "amax", "wq_gray",
                                   "sw_gray"}
    assert q["layers"][0]["wq_gray"].shape == (64, 1, 3, 3)


def _tie_steps(y_scaled: np.ndarray, got: np.ndarray, want: np.ndarray):
    """Entries where two code arrays differ: each must be one step apart,
    at a value before rounding within 1e-3 of a tie."""
    diff = got.astype(np.int32) - want.astype(np.int32)
    where = diff != 0
    assert np.abs(diff[where]).max(initial=0) <= 1
    frac = np.abs(np.abs(y_scaled[where]) % 1.0 - 0.5)
    assert (frac < 1e-3).all(), frac.max()
    return int(where.sum())


def test_vgg_quant_apply_layer_codes_match_jax(rec_pair):
    """The JAX int8 trunk layer by layer, each of the port's layers fed the
    JAX codes of its input, with the JAX qparams carried across."""
    _, v, _, img = rec_pair
    jqp = jq.prepare_vgg_quant(jax.tree.map(jnp.asarray, v), img)
    q = vgg_qparams_from_flax(to_numpy_tree(jqp))
    layers = jqp["layers"]
    x_q = jq.quantize_act(jnp.asarray(img), layers[0]["amax"])
    ci, differing = 0, []
    for c in jq._trunk_plan():
        if c == "M":
            got = tq.nn_max_pool(torch.from_numpy(np.asarray(x_q)))
            x_q = jq.nn_max_pool(x_q)
            np.testing.assert_array_equal(got.numpy(), np.asarray(x_q))
            continue
        layer = layers[ci]
        gray = ci == 0
        wq = layer["wq_gray"] if gray else layer["wq"]
        sw = layer["sw_gray"] if gray else layer["sw"]
        acc = jax.lax.conv_general_dilated(
            x_q, wq, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        y = jax.nn.relu(acc.astype(jnp.float32)
                        * ((layer["amax"] / 127.0) * sw) + layer["b"])
        last = ci + 1 == len(layers)
        nxt = None if last else q["layers"][ci + 1]["amax"]
        got = tq.vgg_quant_layer(q["layers"][ci],
                                 torch.from_numpy(np.asarray(x_q)), gray,
                                 nxt).numpy()
        if last:
            close(got, y, 1e-6, "last layer, f32")
            break
        want = np.asarray(jq.quantize_act(y, layers[ci + 1]["amax"]))
        scaled = np.asarray(y) * np.float32(
            127.0 / np.float32(layers[ci + 1]["amax"]))
        differing.append(_tie_steps(scaled, got, want))
        x_q = jnp.asarray(want)
        ci += 1
    assert len(differing) == 15
    # the whole port trunk on the same qparams stays with the JAX one
    feat_j = np.asarray(jq.vgg_quant_apply(jqp, img, dtype=jnp.float32))
    feat = nhwc(tq.vgg_quant_apply(q, nchw(img), dtype=F32))
    corr = np.corrcoef(feat.ravel(), feat_j.ravel())[0, 1]
    assert corr > 0.999, (corr, differing)


def test_read_features_matches_jax(rec_pair):
    jr, v, tr, img = rec_pair
    feat = RNG.normal(size=(2, 2, 6, 512)).astype(np.float32)
    want_logits, want_attn = jr.apply(v, feat, LABELS,
                                      method=jr.read_features)
    logits, attn = tr.read_features(nchw(feat),
                                    torch.from_numpy(LABELS).long())
    close(logits, want_logits, 1e-5, "logits")
    close(attn, want_attn, 1e-5, "attention")
    # the float tail of the full forward: the trunk's own features
    full, _ = tr(nchw(img), torch.from_numpy(LABELS).long())
    tail, _ = tr.read_features(tr.enc.vgg(nchw(img).expand(-1, 3, -1, -1)),
                               torch.from_numpy(LABELS).long())
    torch.testing.assert_close(tail, full, rtol=0, atol=0)


@pytest.fixture(scope="module")
def decoder_pair():
    dim = 64
    rng = np.random.default_rng(5)
    content = rng.normal(size=(2, 8, 12, dim)).astype(np.float32)
    adain = rng.normal(size=(2, 8 * dim)).astype(np.float32)
    pyr = [None, None, None,
           rng.normal(size=(2, 4, 6, dim)).astype(np.float32),
           rng.normal(size=(2, 8, 12, dim)).astype(np.float32)]
    base = JDecoder(dim=dim, dtype=jnp.float32)
    v = random_variables(base, content, adain, pyr)
    td = load_port(Decoder(dim, dtype=F32), v)
    targs = (nchw(content), torch.from_numpy(adain),
             [None, None, None, nchw(pyr[3]), nchw(pyr[4])])
    return dim, v, (content, adain, pyr), td, targs


def _jax_decoder(dim, mode):
    return JDecoder(dim=dim, dtype=jnp.float32, quant=True, quant_mode=mode)


def test_decoder_calib_records_the_jax_amaxes(decoder_pair):
    dim, v, jargs, td, targs = decoder_pair
    want, mut = _jax_decoder(dim, "calib").apply(v, *jargs,
                                                 mutable=["quant"])
    for site in td.quant_sites().values():
        site.amax.zero_()
    td.set_quant_mode("calib")
    try:
        got = td(*targs)
    finally:
        td.set_quant_mode(None)
    close(nhwc(got), want, 1e-4, "calib output (the float path)")
    want_amax = {k: float(a) for k, a in gen_quant_from_flax(
        to_numpy_tree({"dec": mut["quant"]})).items()}
    got_amax = {k: float(s.amax) for k, s in td.quant_sites().items()}
    assert set(got_amax) == set(want_amax) and len(got_amax) == 7
    for k in want_amax:
        assert got_amax[k] == pytest.approx(want_amax[k], rel=1e-5), k


def _out(tree, *path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree["__call__"][0])


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_decoder_int8_modes_match_jax(decoder_pair, mode):
    """Each of the seven int8 sites on the JAX package's own input to it
    (rebuilt from the JAX decoder's intermediates): outputs within 1e-6 of
    the JAX site's largest output.  The whole decoder: correlation above
    0.999 with the JAX int8 decoder (float noise before a quantize moves a
    code one step at a near-tie, and the step travels on: 0.99978 to
    0.999999 over seeds 0-5; the per-site check holds the rest) and above
    0.99 with the float decoder (``tests/test_quant.py``'s gate)."""
    from affganwriting_tpu.ops.norms import instance_norm as jax_in

    dim, v, jargs, td, targs = decoder_pair
    _, mut = _jax_decoder(dim, "calib").apply(v, *jargs, mutable=["quant"])
    want, st = _jax_decoder(dim, mode).apply(
        {**v, **mut}, *jargs, capture_intermediates=True,
        mutable=["intermediates"])
    it = st["intermediates"]
    relu = jax.nn.relu
    sites = {
        "res0/conv0": (jargs[0], _out(it, "res0", "conv0")),
        "res0/conv1": (relu(_out(it, "res0", "adain0")),
                       _out(it, "res0", "conv1")),
        "res1/conv0": (_out(it, "res0"), _out(it, "res1", "conv0")),
        "res1/conv1": (relu(_out(it, "res1", "adain0")),
                       _out(it, "res1", "conv1")),
        "up0": (_out(it, "res1"), _out(it, "up0")),
        "up1": (relu(jax_in(_out(it, "up0"))), _out(it, "up1")),
        "up2": (relu(jax_in(_out(it, "up1"))), _out(it, "up2")),
    }
    amax = gen_quant_from_flax(to_numpy_tree({"dec": mut["quant"]}))
    with torch.no_grad():
        for k, site in td.quant_sites().items():
            site.amax.copy_(amax[k])
    td.set_quant_mode(mode)
    try:
        for name, (x, site_want) in sites.items():
            x = nchw(np.asarray(x))
            if name.startswith("res"):
                block = getattr(td, name[:4])
                got = block._conv(getattr(block, name[5:]), x)
            else:
                got = getattr(td, name)(x)
            np.testing.assert_allclose(
                nhwc(got), site_want, rtol=0,
                atol=1e-6 * np.abs(site_want).max(), err_msg=name)
        got = nhwc(td(*targs))
    finally:
        td.set_quant_mode(None)
    assert np.corrcoef(got.ravel(), np.asarray(want).ravel())[0, 1] > 0.999
    base = _jax_decoder(dim, "calib").apply(v, *jargs, mutable=["quant"])[0]
    assert np.corrcoef(got.ravel(), np.asarray(base).ravel())[0, 1] > 0.99
