"""Port modules vs their JAX counterparts, fp32 on the CPU, small config.

Every flax leaf is random (tests/test_torch_support.py), converted by
``utils/from_flax`` and loaded strictly.  Tolerance 1e-4 (atol and rtol)
per module: the same f32 arithmetic up to the summation order of the
convolutions and products; 2e-3 on the images and logits of the stacked
generator and recognizer, where those differences pass through ~60
layers.  Greedy ids must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affganwriting_tpu.models.aff import AdaINFusion as JAdaINFusion
from affganwriting_tpu.models.decoder import Decoder as JDecoder
from affganwriting_tpu.models.generator import Generator as JGenerator
from affganwriting_tpu.models.recognizer.attention import (
    LocationAttention as JAttention,
)
from affganwriting_tpu.models.recognizer.encoder import BiGRU as JBiGRU
from affganwriting_tpu.models.recognizer.encoder import VGGTrunk as JVGG
from affganwriting_tpu.models.recognizer.seq2seq import (
    Recognizer as JRecognizer,
)
from affganwriting_tpu.models.style_encoders import get_style_encoder as jget
from affganwriting_tpu.models.text_encoder import TextEncoderFC as JText
from affganwriting_torch.models.aff import AdaINFusion
from affganwriting_torch.models.decoder import Decoder
from affganwriting_torch.models.generator import Generator
from affganwriting_torch.models.recognizer.attention import LocationAttention
from affganwriting_torch.models.recognizer.encoder import BiGRU, VGGTrunk
from affganwriting_torch.models.recognizer.seq2seq import Recognizer
from affganwriting_torch.models.style_encoders import get_style_encoder
from affganwriting_torch.models.text_encoder import TextEncoderFC
from test_torch_support import (
    close,
    load_port,
    nchw,
    nhwc,
    random_variables,
    small_jax_config,
    small_torch_config,
)

torch.set_num_threads(2)   # tier-1 runs six xdist workers

F32 = torch.float32
RNG = np.random.default_rng(0)
STYLE = RNG.normal(size=(1, 32, 104, 50)).astype(np.float32)
LABELS = np.asarray([[0, 5, 9, 13, 1, 2, 2, 2], [0, 30, 31, 40, 41, 50, 1, 2]],
                    np.int32)


def test_resnet50_taps():
    jenc = jget("resnet50", dtype=jnp.float32, final_hw=(4, 13), style_dim=64)
    v = random_variables(jenc, STYLE)
    want = jenc.apply(v, STYLE)
    tenc = load_port(get_style_encoder("resnet50", in_channels=50,
                                       style_dim=64, final_hw=(4, 13),
                                       dtype=F32), v)
    got = tenc(nchw(STYLE))
    assert [tuple(t.shape) for t in got] == [
        (1, 64, 16, 52), (1, 64, 8, 26), (1, 64, 4, 13), (1, 64, 2, 7),
        (1, 64, 4, 13)]
    for i, (g, w) in enumerate(zip(got, want)):
        close(nhwc(g), w, 1e-4, f"tap {i}")


def test_text_encoder():
    jte = JText(max_len=8, embed_dim=16, content_dim=64, adain_dim=512,
                dtype=jnp.float32)
    v = random_variables(jte, LABELS, (4, 13))
    want_out, want_content = jte.apply(v, LABELS, (4, 13))
    tte = load_port(TextEncoderFC(8, 55, 16, 64, 512, F32), v)
    out, content = tte(torch.from_numpy(LABELS).long(), (4, 13))
    close(out, want_out, 1e-4, "adain params")
    close(nhwc(content), want_content, 1e-4, "content map")


def test_adain_fusion_with_skip():
    """(2, 7) -> (8, 27) skip resize: the nearest-exact trap at the main
    path's geometry, then iAFF with a batch-1 skip against batch 2."""
    x = RNG.normal(size=(2, 8, 27, 64)).astype(np.float32)
    skip = RNG.normal(size=(1, 2, 7, 64)).astype(np.float32)
    mean = RNG.normal(size=(2, 64)).astype(np.float32)
    std = RNG.uniform(0.5, 1.5, size=(2, 64)).astype(np.float32)
    jm = JAdaINFusion(64, jnp.float32)
    v = random_variables(jm, x, mean, std, skip=skip)
    want = jm.apply(v, x, mean, std, skip=skip)
    tm = load_port(AdaINFusion(64, F32, fuse_skip=True), v)
    got = tm(nchw(x), torch.from_numpy(mean), torch.from_numpy(std),
             skip=nchw(skip))
    close(nhwc(got), want, 1e-4)


@pytest.mark.parametrize("subpixel", [True, False])
def test_decoder(subpixel):
    content = RNG.normal(size=(2, 4, 13, 64)).astype(np.float32)
    adain = RNG.normal(size=(2, 512)).astype(np.float32)
    pyr = [None, None, None,
           RNG.normal(size=(1, 2, 7, 64)).astype(np.float32),
           RNG.normal(size=(1, 4, 13, 64)).astype(np.float32)]
    jd = JDecoder(dim=64, subpixel_upsample=subpixel, dtype=jnp.float32)
    v = random_variables(jd, content, adain, pyr)
    want = jd.apply(v, content, adain, pyr)
    td = load_port(Decoder(64, subpixel_upsample=subpixel, dtype=F32), v)
    got = td(nchw(content), torch.from_numpy(adain),
             [None, None, None, nchw(pyr[3]), nchw(pyr[4])])
    assert got.shape == (2, 1, 32, 104)
    close(nhwc(got), want, 1e-4)


def test_encode_style_and_generate():
    jcfg, tcfg = small_jax_config(), small_torch_config()
    jg = JGenerator(jcfg)
    v = random_variables(jg, STYLE, LABELS)
    jpyr = jg.apply(v, STYLE, method=jg.encode_style)
    want = jg.apply(v, jpyr, LABELS, method=jg.generate)
    tg = load_port(Generator(tcfg), v)
    pyr = tg.encode_style(torch.from_numpy(STYLE))
    for i, (g, w) in enumerate(zip(pyr, jpyr)):
        close(nhwc(g), w, 1e-4, f"pyramid tap {i}")
    got = tg.generate(pyr, torch.from_numpy(LABELS).long())
    assert got.shape == (2, 1, 32, 104)
    close(nhwc(got), want, 2e-3, "images")


def test_vgg_trunk():
    img = RNG.normal(size=(2, 32, 104, 3)).astype(np.float32)
    jm = JVGG(jnp.float32)
    v = random_variables(jm, img)
    want = jm.apply(v, img)
    got = load_port(VGGTrunk(F32), v)(nchw(img))
    assert got.shape == (2, 512, 2, 6)
    close(nhwc(got), want, 1e-4)


def test_bigru_outputs_and_h0():
    x = RNG.normal(size=(2, 6, 1024)).astype(np.float32)
    jm = JBiGRU(64, dtype=jnp.float32)
    v = random_variables(jm, x)
    want_out, want_h0 = jm.apply(v, x)
    out, h0 = load_port(BiGRU(1024, 64), v)(torch.from_numpy(x))
    close(out, want_out, 1e-4, "outputs")
    close(h0, want_h0, 1e-4, "decoder h0 (backward finals)")


def test_location_attention():
    hidden = RNG.normal(size=(2, 3, 64)).astype(np.float32)
    enc = RNG.normal(size=(3, 6, 64)).astype(np.float32)
    prev = RNG.dirichlet(np.ones(6), size=3).astype(np.float32)
    jm = JAttention(64)
    v = random_variables(jm, hidden, enc, prev)
    want = jm.apply(v, hidden, enc, prev)
    got = load_port(LocationAttention(64), v)(
        torch.from_numpy(hidden), torch.from_numpy(enc),
        torch.from_numpy(prev))
    close(got, want, 1e-4)


def test_recognizer_logits_and_greedy_ids():
    img = np.tanh(RNG.normal(size=(2, 32, 104, 1))).astype(np.float32)
    jr = JRecognizer(55, 64, 16, 8, dtype=jnp.float32)
    v = random_variables(jr, img, LABELS)
    want_logits, want_attn = jr.apply(v, img, LABELS)
    tr = load_port(Recognizer(55, 64, 16, 8, img_height=32, dtype=F32), v)
    logits, attn = tr(nchw(img), torch.from_numpy(LABELS).long())
    assert logits.shape == (2, 7, 55)
    close(logits, want_logits, 2e-3, "logits")
    close(attn, want_attn, 1e-4, "attention")
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  np.argmax(np.asarray(want_logits), -1))
