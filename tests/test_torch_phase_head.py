"""The bf16 ``phase_head`` route's host side, on the CPU.

The wgmma kernel itself runs only on the card (``chip_smoke.py`` holds it
against ``phase_head_plain``).  Here: the wrapper's shape and dtype rule,
the strip height, the packing of kc into the layout the kernel's B operand
reads, and that the packed-then-unpacked kc still gives the JAX package's
answer through the plain version.  Tolerance 1e-4, as in
``test_torch_ops.py``: the product's reduction order differs (einsum vs
the Pallas dot).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affganwriting_tpu.models import blocks as jblocks
from affganwriting_tpu.models import decoder as jdec
from affganwriting_tpu.ops.phase_head_pallas import phase_head_fold
from affganwriting_torch.ops.phase_head_cuda import (
    KCHUNK,
    NPAD,
    _pack_index,
    pack_kc,
    phase_head,
    phase_head_plain,
    strip_rows,
    wgmma_shape_error,
)
from test_torch_support import close, nchw, nhwc

torch.set_num_threads(2)   # tier-1 runs six xdist workers

BF16 = torch.bfloat16


def unpack_kc(packed):
    """The inverse of ``pack_kc``: (4C/64, 104, 64) -> (4C, 100)."""
    c4 = packed.shape[0] * KCHUNK
    padded = torch.empty(c4 * NPAD, dtype=packed.dtype)
    padded[_pack_index(c4, packed.device)] = packed.reshape(-1)
    return padded.view(c4, NPAD)[:, :100]


@pytest.mark.parametrize("shape", [
    (256, 256, 36, 112),   # the main path at batch 256
    (8, 256, 36, 112),     # a small request
    (1, 64, 5, 8),         # smallest 4C and plane
    (3, 192, 20, 64),      # one 64-pixel half
    (65535, 128, 36, 128), # largest batch and row
])
def test_wgmma_shape_rule_accepts(shape):
    assert wgmma_shape_error(shape, BF16) is None


@pytest.mark.parametrize("shape,dtype,why", [
    ((256, 256, 36, 112), torch.float32, "bfloat16"),
    ((256, 36, 112), BF16, "(B, 4C, h+4, w+4)"),
    ((0, 256, 36, 112), BF16, "batch"),
    ((65536, 256, 36, 112), BF16, "batch"),
    ((8, 96, 36, 112), BF16, "4C"),
    ((8, 320, 36, 112), BF16, "4C"),
    ((8, 256, 4, 112), BF16, "no output pixel"),
    ((8, 256, 36, 4), BF16, "no output pixel"),
    ((8, 256, 36, 60), BF16, "multiple of 8"),
    ((8, 256, 36, 136), BF16, "row tile"),
])
def test_wgmma_shape_rule_rejects(shape, dtype, why):
    err = wgmma_shape_error(shape, dtype)
    assert err is not None and why in err


def test_strip_rows():
    # batch 256 fills the card alone: xp read once
    assert strip_rows(256, 32, 132) == 32
    # small batches split h into strips, at most one wave of CTAs
    assert strip_rows(8, 32, 132) == 2
    assert strip_rows(64, 32, 132) == 16
    for b in (1, 3, 8, 64, 133, 256, 1000):
        r = strip_rows(b, 32, 132)
        assert 1 <= r <= 32


@pytest.mark.parametrize("c4", [64, 256])
def test_pack_kc_round_trips(c4):
    rng = np.random.default_rng(c4)
    kc = torch.from_numpy(rng.normal(size=(c4, 100)).astype(np.float32)) \
        .to(BF16)
    packed = pack_kc(kc)
    assert packed.shape == (c4 // KCHUNK, NPAD, KCHUNK)
    assert packed.dtype == BF16 and packed.is_contiguous()
    assert torch.equal(unpack_kc(packed), kc)
    # zero padding: columns 100..103 are rows of zeros
    assert not packed[:, 100:].any()
    # 128-byte swizzle: channel k*64 + 8u + e of column n sits in 16-byte
    # group u ^ (n % 8) of row n
    for k, n, u, e in ((0, 0, 0, 0), (0, 13, 4, 5), (c4 // 64 - 1, 99, 7, 7),
                       (c4 // 64 - 1, 42, 1, 3)):
        assert packed[k, n, 8 * (u ^ (n % 8)) + e] == kc[k * 64 + 8 * u + e, n]


@pytest.mark.parametrize("c", [16, 64])
def test_plain_with_unpacked_kc_matches_pallas_and_jnp(c):
    rng = np.random.default_rng(40 + c)
    b, h, w = 2, 8, 12
    x4 = (rng.normal(size=(b, h, w, 4 * c)) * 0.5).astype(np.float32)
    k7 = (rng.normal(size=(7, 7, c, 1)) / np.sqrt(49 * c)).astype(np.float32)
    bias = rng.normal(size=(1,)).astype(np.float32) * 0.1

    head = jdec.PhaseHead(1, jnp.float32)
    v = {"params": {"kernel": jnp.asarray(k7), "bias": jnp.asarray(bias)}}
    want_jnp = np.asarray(head.apply(v, jnp.asarray(x4)))          # (b,2h,2w,1)
    kc = jdec.fold_head_kernel(jnp.asarray(k7))
    xp = jblocks.pad2d(jnp.asarray(x4), 2, "reflect")
    bias4 = np.tile(bias, 4)
    want_pallas = np.asarray(phase_head_fold(xp, kc, jnp.asarray(bias4),
                                             interpret=True))

    kc_t = torch.from_numpy(np.array(kc))
    round_trip = unpack_kc(pack_kc(kc_t))
    assert torch.equal(round_trip, kc_t)
    got = phase_head_plain(nchw(np.asarray(xp)), round_trip,
                           torch.from_numpy(bias4))
    assert got.shape == (b, 1, 2 * h, 2 * w)
    close(got[:, 0], want_pallas, 1e-4, "vs Pallas interpret")
    close(nhwc(got), want_jnp, 1e-4, "vs jnp PhaseHead")


def test_cpu_bf16_takes_plain_version():
    rng = np.random.default_rng(7)
    xp = torch.from_numpy(rng.normal(size=(2, 64, 12, 16))
                          .astype(np.float32)).to(BF16)
    kc = torch.from_numpy((rng.normal(size=(64, 100)) / 40)
                          .astype(np.float32)).to(BF16)
    bias4 = torch.from_numpy(rng.normal(size=(4,)).astype(np.float32))
    before = (phase_head.launches, phase_head.launches_wgmma)
    got = phase_head(xp, kc, bias4)
    assert (phase_head.launches, phase_head.launches_wgmma) == before
    assert got.dtype == BF16 and got.shape == (2, 1, 16, 24)
    assert torch.equal(got, phase_head_plain(xp, kc, bias4))
