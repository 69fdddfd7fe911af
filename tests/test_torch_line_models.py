"""The port's line-generation models (``affganwriting_torch/models/line/``,
``core/line_config.py``) vs the JAX package's, f32 on the CPU, eval mode.

Every flax leaf is random (tests/test_torch_support.py's fill), converted
by ``utils/from_flax.line_from_flax`` and loaded strictly.  Limits:

- 1e-4 (atol and rtol) on log-probabilities, counts, styles and strips:
  the same f32 arithmetic up to the summation order of convolutions,
  products and the GroupNorm statistics (flax takes E[x^2] - E[x]^2,
  torch a two-pass variance);
- 1e-4 on generated lines (``test_torch_line_container.py`` holds
  ``HWWithStyle``), with every ``NoiseInjection`` weight set to 0
  in both trees: flax draws the noise from ``make_rng("noise")``, which
  no torch generator reproduces.  ``NoiseInjection`` alone is compared on
  the same noise array (its JAX ``__call__`` takes the noise);
- spaced lines and the column choice of the char-style encoders equal:
  ``insert_spaces`` is handed the JAX package's own two normal draws, and
  the columns' top-k is held on recognition scores with exact ties, where
  ``lax.top_k`` takes the lower column first.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affganwriting_tpu.core import line_config as jlc
from affganwriting_tpu.models.line import hwr as jhwr
from affganwriting_tpu.models.line.char_style import (
    CharStyleEncoder as JCharStyleEncoder,
)
from affganwriting_tpu.models.line.char_style_multi import (
    MultiCharStyleEncoder as JMulti,
)
from affganwriting_tpu.models.line.char_style_multi import (
    space_style as jspace_style,
)
from affganwriting_tpu.models.line.char_style_vgg import (
    VGG19Backbone1D as JVGG1D,
)
from affganwriting_tpu.models.line.container import (
    insert_spaces as jinsert_spaces,
)
from affganwriting_tpu.models.line.count_cnn import CountCNN as JCountCNN
from affganwriting_tpu.models.line.spaced_gen import (
    NoiseInjection as JNoise,
)
from affganwriting_tpu.models.line.spaced_gen import (
    SpacedGenerator as JSpacedGenerator,
)
from affganwriting_torch.core import line_config as tlc
from affganwriting_torch.models.line import hwr as thwr
from affganwriting_torch.models.line.char_style import CharStyleEncoder
from affganwriting_torch.models.line.char_style_multi import (
    MultiCharStyleEncoder,
    space_style,
)
from affganwriting_torch.models.line.char_style_vgg import VGG19Backbone1D
from affganwriting_torch.models.line.container import insert_spaces
from affganwriting_torch.models.line.count_cnn import CountCNN
from affganwriting_torch.models.line.spaced_gen import (
    NoiseInjection,
    SpacedGenerator,
)
from test_torch_support import (
    LINE_CLASSES as K,
    close,
    japply,
    line_variables,
    load_line,
    nchw,
)

torch.set_num_threads(2)   # tier-1 runs six xdist workers

CONFIG = "configs/cf_synth_charSpecMulti.json"
RNG = np.random.default_rng(0)


def log_probs(b: int, t: int, k: int = K, seed: int = 1) -> np.ndarray:
    """Recognition log-probs with exact ties: columns 3 and 5 repeat
    column 1, so their confidences are equal."""
    z = np.random.default_rng(seed).normal(size=(b, t, k)) * 3
    z[:, 3] = z[:, 5] = z[:, 1]
    return np.asarray(jax.nn.log_softmax(jnp.asarray(z, jnp.float32), -1))


def test_line_config_matches_jax(tmp_path):
    ov = ["model.style_dim=64", "trainer.curriculum.0=[\"gen\"]",
          "optimizer.name=adam"]
    got, want = tlc.load_config(CONFIG, ov), jlc.load_config(CONFIG, ov)
    assert got == want
    assert got["model"]["char_style_dim"] == 16
    assert got["model"]["max_gen_length"] == 128
    assert got["data_loader"]["a_batch_size"] == 2
    assert got["trainer"]["curriculum"] == {"0": ["gen"]}
    assert got["optimizer"]["name"] == "adam"
    ckpt = {"name": "x", "model": {"style_dim": 3}}
    for cfg in (got, {**got, "override": True}):
        assert tlc.merge_resume(cfg, ckpt) == jlc.merge_resume(cfg, ckpt)
    bad = tmp_path / "cf_other.json"
    shutil.copy(CONFIG, bad)
    for lc in (tlc, jlc):
        with pytest.raises(ValueError, match="filename"):
            lc.load_config(str(bad))
        assert lc.load_config(str(bad), check_name=False)["name"] == \
            "synth_charSpecMulti"
    with pytest.raises(KeyError, match="unknown arch"):
        tlc.build_arch({"arch": "no_such_arch"})
    tlc.register_arch("test_arch")(lambda cfg: ("built", cfg["arch"]))
    try:
        assert tlc.build_arch({"model": {"arch": "test_arch"},
                               "arch": "test_arch"}) == ("built",
                                                         "test_arch")
    finally:
        del tlc.ARCH_REGISTRY["test_arch"]
    assert json.loads(bad.read_text())["name"] == "synth_charSpecMulti"


@pytest.mark.parametrize("norm", ["batch", "group"])
@pytest.mark.parametrize("kind", ["CNNOnlyHWR", "CRNN", "SmallCRNN"])
def test_hwr_matches_jax(kind, norm):
    h = 24 if kind == "SmallCRNN" else 64
    img = RNG.normal(size=(2, h, 48, 1)).astype(np.float32)
    jm = getattr(jhwr, kind)(nclass=K, norm=norm, dtype=jnp.float32)
    if kind != "CNNOnlyHWR":
        jm = jm.clone(hidden=32)
    v = line_variables(jm, img)
    want = japply(jm, v, img)
    kw = {} if kind == "CNNOnlyHWR" else {"hidden": 32}
    tm = load_line(getattr(thwr, kind)(K, norm=norm, **kw), v)
    got = tm(nchw(img))
    assert got.shape == want.shape
    close(got, want, 1e-4)
    if kind != "CNNOnlyHWR":
        assert not tm.lstm.bias_ih_l0.any()


def test_count_cnn_matches_jax():
    onehot = np.eye(K, dtype=np.float32)[RNG.integers(0, K, (2, 9))]
    style = RNG.normal(size=(2, 16)).astype(np.float32)
    jm = JCountCNN(K, 16, hidden=32)
    v = line_variables(jm, onehot, style)
    want = japply(jm, v, onehot, style)
    got = load_line(CountCNN(K, 16, hidden=32), v)(
        torch.from_numpy(onehot), torch.from_numpy(style))
    assert got.shape == (2, 9, 2)
    close(got, want, 1e-4)


@pytest.mark.parametrize("t_recog", [10, 14, 20])
def test_char_style_encoder_matches_jax(t_recog):
    """A 64 x 64 line gives a strip of 14 steps; recognition of 10 steps is
    padded with its last, of 20 cropped.  max_chars 5 of 14 columns, with
    exact ties among them."""
    img = RNG.normal(size=(2, 64, 64, 1)).astype(np.float32)
    recog = log_probs(2, t_recog)
    kw = dict(n_class=K, dim=8, style_dim=16, char_dim=8, window=2,
              max_chars=5)
    jm = JCharStyleEncoder(**kw)
    v = line_variables(jm, img, recog)
    want = japply(jm, v, img, recog)
    tm = load_line(CharStyleEncoder(**kw), v)
    got = tm(nchw(img), torch.from_numpy(recog))
    assert got.shape == (2, 16)
    close(got, want, 1e-4)


def test_multi_char_style_encoder_and_space_style_match_jax():
    img = RNG.normal(size=(2, 64, 64, 1)).astype(np.float32)
    recog = log_probs(2, 14, seed=3)
    kw = dict(n_class=K, dim=8, style_dim=16, char_style_dim=4,
              char_dim=8, max_chars=6, average_found_char_style=0.7)
    jm = JMulti(**kw)
    v = line_variables(jm, img, recog)
    want = japply(jm, v, img, recog)
    got = load_line(MultiCharStyleEncoder(**kw), v)(
        nchw(img), torch.from_numpy(recog))
    for g, w, what in zip(got, want, ("g_style", "spacing", "char_style")):
        close(g, w, 1e-4, what)
    assert got[2].shape == (2, K, 4)
    spaced = np.eye(K, dtype=np.float32)[RNG.integers(0, K, (2, 11))]
    spaced[:, :3] = np.eye(K, dtype=np.float32)[0]       # blanks
    close(space_style(torch.from_numpy(spaced), got[2], got[1]),
          jspace_style(spaced, np.asarray(want[2]), np.asarray(want[1])),
          1e-4, "space_style")


def test_noise_injection_matches_jax():
    x = RNG.normal(size=(2, 5, 7, 6)).astype(np.float32)
    noise = RNG.normal(size=x.shape).astype(np.float32)
    jm = JNoise()
    v = {"params": {"weight": RNG.normal(size=(6,)).astype(np.float32)}}
    want = japply(jm, v, x, noise)
    tm = load_line(NoiseInjection(6), v)
    close(tm(nchw(x), nchw(noise)).permute(0, 2, 3, 1), want, 1e-6)


@pytest.mark.parametrize("char_style_dim", [0, 4])
def test_spaced_generator_matches_jax(char_style_dim):
    b, length = 2, 6
    spaced = np.eye(K, dtype=np.float32)[RNG.integers(0, K, (b, length))]
    style = RNG.normal(size=(b, 16)).astype(np.float32)
    pos = RNG.normal(size=(b, length, char_style_dim)).astype(np.float32)
    jm = JSpacedGenerator(K, 16, 32, char_style_dim=char_style_dim)
    args = (spaced, style, pos if char_style_dim else None)
    v = line_variables(jm, *args, zero_noise=True)
    want = japply(jm, v, *args, rngs={"noise": jax.random.key(3)})
    tm = load_line(SpacedGenerator(K, 16, 32, char_style_dim=char_style_dim),
                   v)
    got = tm(*(None if a is None else torch.from_numpy(a) for a in args),
             generator=torch.Generator().manual_seed(3))
    assert got.shape == (b, 1, 64, 4 * length)
    close(got.permute(0, 2, 3, 1), want, 1e-4)


def test_insert_spaces_matches_jax():
    b, t, max_len = 3, 7, 24
    label = RNG.integers(1, K, (b, t)).astype(np.int32)
    lengths = np.asarray([7, 4, 1], np.int32)
    counts = RNG.uniform(-0.4, 3.4, (b, t, 2)).astype(np.float32)
    counts[0, :, 0] += 3.0          # a line that overflows max_len
    key = jax.random.key(5)
    want = jinsert_spaces(label, lengths, counts, key, K, max_len)
    k1, k2 = jax.random.split(key)
    noise = tuple(torch.from_numpy(np.asarray(jax.random.normal(k, (b, t))))
                  for k in (k1, k2))
    got = insert_spaces(torch.from_numpy(label), torch.from_numpy(lengths),
                        torch.from_numpy(counts), K, max_len, noise=noise)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # a draw from a generator gives the same lines: the noise (std 1e-8)
    # moves no count that is not at a rounding tie
    drawn = insert_spaces(torch.from_numpy(label),
                          torch.from_numpy(lengths),
                          torch.from_numpy(counts), K, max_len,
                          generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(drawn[0], got[0], rtol=0, atol=0)


def test_char_style_vgg_matches_jax():
    img = RNG.normal(size=(2, 32, 48, 1)).astype(np.float32)
    jm = JVGG1D(out_dim=24)
    v = line_variables(jm, img)
    want = japply(jm, v, img)
    got = load_line(VGG19Backbone1D(24), v)(nchw(img))
    assert got.shape == (2, 3, 24)
    close(got, want, 1e-4)
