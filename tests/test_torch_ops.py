"""Port primitives and the two kernels' plain versions vs the JAX package.

On the CPU each kernel wrapper runs its plain version; the tests hold it
against the Pallas kernel in interpret mode and against the jnp path it
stands beside, and check that a CPU call leaves the launch counter at 0.
Tolerances: 1e-5 where the arithmetic is the same up to f32 summation
order, 1e-4 where a product's reduction order differs (einsum vs the
Pallas dot).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

import affganwriting_tpu.ops.in_relu_pallas as jin
from affganwriting_tpu.models import blocks as jblocks
from affganwriting_tpu.models import decoder as jdec
from affganwriting_tpu.ops import norms as jnorms
from affganwriting_tpu.ops.phase_head_pallas import phase_head_fold
from affganwriting_torch.models import blocks as tblocks
from affganwriting_torch.models import decoder as tdec
from affganwriting_torch.ops import norms as tnorms
from affganwriting_torch.ops.in_relu_cuda import (
    in_relu,
    in_relu_plain,
    instance_norm_relu,
)
from affganwriting_torch.ops.phase_head_cuda import (
    phase_head,
    phase_head_fold as port_phase_head_fold,
    phase_head_plain,
)
from test_torch_support import close, nchw, nhwc

torch.set_num_threads(2)   # tier-1 runs six xdist workers


def _x(shape, seed, scale=3.0, shift=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


@pytest.mark.parametrize("fn", ["instance_norm", "mean_variance_norm"])
def test_norms(fn):
    x = _x((2, 6, 10, 16), 0)
    got = getattr(tnorms, fn)(nchw(x))
    want = getattr(jnorms, fn)(jnp.asarray(x))
    close(nhwc(got), want, 1e-5, fn)


def test_adain_and_calc_mean_std():
    x = _x((2, 6, 10, 16), 1)
    rng = np.random.default_rng(2)
    mean = rng.normal(size=(2, 16)).astype(np.float32)
    std = rng.uniform(0.5, 2, size=(2, 16)).astype(np.float32)
    got = tnorms.adain(nchw(x), torch.from_numpy(mean), torch.from_numpy(std))
    close(nhwc(got), jnorms.adain(jnp.asarray(x), mean, std), 1e-5)
    tm, ts = tnorms.calc_mean_std(nchw(x))
    jm, js = jnorms.calc_mean_std(jnp.asarray(x))
    close(nhwc(tm), jm, 1e-5)
    close(nhwc(ts), js, 1e-5)


@pytest.mark.parametrize("pad_type", ["reflect", "replicate", "zero"])
@pytest.mark.parametrize("padding", [0, 1, 3])
def test_pad2d(pad_type, padding):
    x = _x((2, 5, 7, 3), 3)
    got = tblocks.pad2d(nchw(x), padding, pad_type)
    want = jblocks.pad2d(jnp.asarray(x), padding, pad_type)
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))


@pytest.mark.parametrize("src,dst", [((2, 7), (8, 27)), ((1, 3), (4, 13))])
def test_nearest_resize_is_nearest_exact(src, dst):
    """jax.image.resize(method='nearest') == torch 'nearest-exact' (the
    iAFF skip resize); torch's default 'nearest' picks other columns."""
    x = _x((1, *src, 4), 4)
    want = jax.image.resize(jnp.asarray(x), (1, *dst, 4), method="nearest")
    got = F.interpolate(nchw(x), size=dst, mode="nearest-exact")
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))


def test_bilinear_resize_matches():
    x = _x((1, 2, 7, 4), 5)
    want = jax.image.resize(jnp.asarray(x), (1, 8, 27, 4), method="bilinear")
    got = F.interpolate(nchw(x), size=(8, 27), mode="bilinear",
                        align_corners=False)
    close(nhwc(got), want, 1e-6)


def test_depth_to_space_matches_jax_packing():
    x4 = _x((2, 3, 5, 4 * 6), 6)
    b, h, w, c4 = x4.shape
    want = x4.reshape(b, h, w, 2, 2, c4 // 4).transpose(0, 1, 3, 2, 4, 5) \
        .reshape(b, 2 * h, 2 * w, c4 // 4)
    np.testing.assert_array_equal(nhwc(tblocks.depth_to_space(nchw(x4))),
                                  want)


def test_fold_kernels_match_jax():
    rng = np.random.default_rng(7)
    k7 = rng.normal(size=(7, 7, 8, 1)).astype(np.float32)
    want = np.asarray(jdec.fold_head_kernel(jnp.asarray(k7)))
    got = tdec.fold_head_kernel(torch.from_numpy(k7.transpose(3, 2, 0, 1)))
    close(got, want, 1e-6)


def test_instance_norm_phase_matches_jax():
    x4 = _x((2, 4, 6, 4 * 8), 8)
    got = tdec.instance_norm_phase(nchw(x4))
    close(nhwc(got), jdec.instance_norm_phase(jnp.asarray(x4)), 1e-5)


def _pallas_in_relu(x, relu):
    n, h, w, c = x.shape
    return pl.pallas_call(
        functools.partial(jin._kernel, eps=1e-5, relu=relu),
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        grid=(n, c // jin.LANE),
        in_specs=[pl.BlockSpec((1, h, w, jin.LANE), lambda i, j: (i, 0, 0, j))],
        out_specs=pl.BlockSpec((1, h, w, jin.LANE), lambda i, j: (i, 0, 0, j)),
        interpret=True,
    )(jnp.asarray(x))


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("c", [128, 256])
def test_in_relu_plain_matches_pallas_and_jnp(relu, c):
    x = _x((2, 8, 12, c), 10 + c)
    before = in_relu.launches
    got = nhwc(in_relu(nchw(x), relu=relu))
    assert in_relu.launches == before          # CPU: plain version only
    close(got, _pallas_in_relu(x, relu), 1e-5, "vs Pallas interpret")
    ref = jnorms.instance_norm(jnp.asarray(x))
    close(got, jnp.maximum(ref, 0) if relu else ref, 1e-5, "vs jnp")
    np.testing.assert_array_equal(got, nhwc(in_relu_plain(nchw(x), relu=relu)))


@pytest.mark.parametrize("relu", [True, False])
def test_instance_norm_relu_takes_the_jax_layout(relu):
    """The port's ``instance_norm_relu`` has the JAX entry's signature and
    NHWC layout: the Pallas kernel in interpret mode on the same x."""
    x = _x((2, 8, 12, 128), 12)
    got = instance_norm_relu(torch.from_numpy(x), relu=relu)
    assert got.shape == x.shape
    close(got, _pallas_in_relu(x, relu), 1e-5, "vs Pallas interpret")


def test_in_relu_channels_are_independent():
    a = _x((1, 4, 6, 128), 11)
    out = nhwc(in_relu(nchw(np.concatenate([a, a], axis=-1))))
    np.testing.assert_array_equal(out[..., :128], out[..., 128:])


@pytest.mark.parametrize("c", [16, 64])
def test_phase_head_plain_matches_pallas_and_jnp(c):
    rng = np.random.default_rng(20 + c)
    b, h, w = 2, 8, 12
    x4 = (rng.normal(size=(b, h, w, 4 * c)) * 0.5).astype(np.float32)
    k7 = (rng.normal(size=(7, 7, c, 1)) / np.sqrt(49 * c)).astype(np.float32)
    bias = rng.normal(size=(1,)).astype(np.float32) * 0.1

    head = jdec.PhaseHead(1, jnp.float32)
    v = {"params": {"kernel": jnp.asarray(k7), "bias": jnp.asarray(bias)}}
    want_jnp = np.asarray(head.apply(v, jnp.asarray(x4)))          # (b,2h,2w,1)
    kc = jdec.fold_head_kernel(jnp.asarray(k7))
    xp = jblocks.pad2d(jnp.asarray(x4), 2, "reflect")
    want_pallas = np.asarray(phase_head_fold(
        xp, kc, jnp.tile(jnp.asarray(bias), (4,)), interpret=True))

    before = phase_head.launches
    got = phase_head(nchw(np.asarray(xp)), torch.from_numpy(np.array(kc)),
                     torch.from_numpy(np.tile(bias, 4)))
    assert phase_head.launches == before
    assert got.shape == (b, 1, 2 * h, 2 * w)
    close(got[:, 0], want_pallas, 1e-4, "vs Pallas interpret")
    close(nhwc(got), want_jnp, 1e-4, "vs jnp PhaseHead")
    np.testing.assert_array_equal(
        got, phase_head_plain(nchw(np.asarray(xp)),
                              torch.from_numpy(np.array(kc)),
                              torch.from_numpy(np.tile(bias, 4))))

    # the port's PhaseHead module: fold + reflect pad + the wrapper
    mod = tdec.PhaseHead(c, torch.float32)
    mod.load_state_dict({"weight": torch.from_numpy(k7.transpose(3, 2, 0, 1)),
                         "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        close(nhwc(mod(nchw(x4))), want_jnp, 1e-4, "PhaseHead module")


def test_phase_head_fold_takes_the_jax_layout():
    """The port's ``phase_head_fold`` has the JAX entry's signature and
    layouts: xp (B, h+4, w+4, 4C) in, (B, 2h, 2w) out, against the Pallas
    kernel in interpret mode (1e-4: the product's reduction order)."""
    rng = np.random.default_rng(30)
    c, b, h, w = 16, 2, 8, 12
    xp = (rng.normal(size=(b, h + 4, w + 4, 4 * c)) * 0.5).astype(np.float32)
    kc = (rng.normal(size=(4 * c, 100)) / np.sqrt(49 * c)).astype(np.float32)
    bias4 = (rng.normal(size=(4,)) * 0.1).astype(np.float32)
    want = np.asarray(phase_head_fold(jnp.asarray(xp), jnp.asarray(kc),
                                      jnp.asarray(bias4), interpret=True))
    got = port_phase_head_fold(*map(torch.from_numpy, (xp, kc, bias4)))
    assert got.shape == want.shape == (b, 2 * h, 2 * w)
    close(got, want, 1e-4, "vs Pallas interpret")


def test_wrappers_reject_other_devices():
    x = torch.zeros(1, 1, 4, 4, device="meta")
    with pytest.raises(ValueError):
        in_relu(x)
    with pytest.raises(ValueError):
        phase_head(torch.zeros(1, 4, 8, 8, device="meta"),
                   torch.zeros(4, 100, device="meta"), torch.zeros(4))
