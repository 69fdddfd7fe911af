"""The port's evaluation modules against the JAX package's, on the CPU:
folder CER, the MTurk preference statistics, the line sheet, FID's crop-64
preprocessing, InceptionV3 pool3, the Fréchet distance, the folder reader,
the ``evaluate`` CLI's JSON and the pretrained-weights path.

Limits.  CER, preference statistics, sheets and the Fréchet distance of
given activations are the same numpy code: exactly equal.  Resizes: 1e-5
absolute on [0, 1] images (float summation order of the bilinear and
antialiased filters).  InceptionV3 activations with converted random
weights: 1e-4 of max(1, |reference|) (largest reading ~1e-6 relative).
The evaluate JSON: CER exact, FID within 1e-3 relative.

FID here runs on the first 64 pool3 features of both packages' scorers
(their ``activations`` are patched in the test): scipy's sqrtm of a
2048x2048 matrix takes ~28 s on two CPU threads, and the feature width does
not change the code under test.  The JAX scorer is built with batch 8 for
the same reason (its default 64 pads every call to 64 images).
"""

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import affganwriting_tpu.eval.fid as jfid
import affganwriting_torch.eval.fid as tfid
from affganwriting_tpu.eval import generated as jgen
from affganwriting_tpu.eval import mturk as jmturk
from affganwriting_tpu.eval import sheets as jsheets
from affganwriting_tpu.eval.inception_v3 import (
    InceptionV3Pool3 as JInception,
)
from affganwriting_torch.eval import generated as tgen
from affganwriting_torch.eval import mturk as tmturk
from affganwriting_torch.eval import sheets as tsheets
from affganwriting_torch.eval.inception_v3 import InceptionV3Pool3
from affganwriting_torch.models.blocks import resize_bilinear
from affganwriting_torch.utils.from_flax import convert_module
from test_torch_support import nchw, random_variables, to_numpy_tree

torch.set_num_threads(2)   # tier-1 runs six xdist workers

FEATURES = 64          # pool3 features FID keeps here (module docstring)
RESIZE_TOL = 1e-5
ACT_TOL = 1e-4
FID_RTOL = 1e-3

WORDS = ["three", "threw", "shrew", "Shred", "sIred", "a", "Zebra-crossing",
         "don't", "x", ""]


def _pairs(seed):
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(40):
        gt = WORDS[rng.integers(len(WORDS) - 1)]
        pred = "".join(rng.choice(list("abcdeSTR-'z"), rng.integers(0, 9)))
        pairs.append((gt, pred))
    return pairs


def _write_generated(folder, pairs, npy: bool):
    os.makedirs(folder, exist_ok=True)
    for i, (g, p) in enumerate(pairs):
        name = f"{100 + i % 3}-{i}.{g}-{p}.png"
        path = os.path.join(folder, name + (".npy" if npy else ""))
        if npy:
            np.save(path, np.zeros((4, 4), np.uint8))
        else:
            open(path, "wb").close()
    open(os.path.join(folder, "notes.txt"), "w").close()
    open(os.path.join(folder, "049-1.nodash.png"), "wb").close()


def test_cer_of_pairs_and_folders_equal_the_jax_packages(tmp_path):
    """``cer_of_pairs`` equals the JAX package's exactly, and so does
    ``cer_of_folder`` on a folder of ``.png`` names; on the same names as
    ``.png.npy`` (what ``generate_word`` writes without PIL) the port
    counts the same words, where the JAX parser counts none."""
    pairs = _pairs(0)
    assert tgen.cer_of_pairs(pairs) == jgen.cer_of_pairs(pairs)
    assert tgen.cer_of_pairs([]) == jgen.cer_of_pairs([])
    _write_generated(tmp_path / "png", pairs, npy=False)
    _write_generated(tmp_path / "npy", pairs, npy=True)
    want = jgen.cer_of_folder(str(tmp_path / "png"))
    assert want["count"] == len(pairs)
    assert tgen.cer_of_folder(str(tmp_path / "png")) == want
    assert tgen.cer_of_folder(str(tmp_path / "npy")) == want
    assert jgen.cer_of_folder(str(tmp_path / "npy"))["count"] == 0
    for name in ("049-3.three-threw.png", "049-3.three-threw.png.npy",
                 "049-3.a-b-c.jpg", "x.png", "049-3.three.png",
                 "049-3.three-threw.npy", "049-3.three-threw.gif"):
        want = jgen.parse_generated_name(name.removesuffix(".npy")) \
            if name.endswith(".png.npy") else jgen.parse_generated_name(name)
        assert tgen.parse_generated_name(name) == want, name


def test_preference_stats_equal_the_jax_packages(tmp_path):
    rng = np.random.default_rng(0)
    rows = [{"worker": str(i % 7), "item": f"i{rng.integers(5)}",
             "choice": rng.choice(["real", "generated"])}
            for i in range(57)]
    for positive in ("generated", "real"):
        assert tmturk.preference_stats(rows, positive) == \
            jmturk.preference_stats(rows, positive)
    assert tmturk.preference_stats([]) == jmturk.preference_stats([])
    path = tmp_path / "c.csv"
    path.write_text("worker,item,choice\n" + "".join(
        f"{r['worker']},{r['item']},{r['choice']}\n" for r in rows))
    assert tmturk.parse_choices(str(path)) == jmturk.parse_choices(str(path))


def test_write_line_sheet_is_byte_equal(tmp_path):
    rng = np.random.default_rng(0)
    real = rng.normal(size=(3, 24, 60, 1))
    recon = rng.normal(size=(3, 24, 44, 1))
    gen = rng.normal(size=(3, 24, 71, 1))
    args = ("lines", real, recon, gen, ["the quick", "brown fox"],
            {"real": 0.25, "gen": -1.5})
    a = tsheets.write_line_sheet(str(tmp_path / "port"), *args)
    b = jsheets.write_line_sheet(str(tmp_path / "jax"), *args)
    assert os.path.basename(a) == os.path.basename(b) == "lines.png"
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("h,w", [(64, 216), (48, 40), (100, 216)])
def test_crop64_preprocess(h, w):
    """Heights 64 (kept), 48 (stretched) and 100 (shrunk: jax antialiases,
    so must the port); width 40 stretches the crop."""
    rng = np.random.default_rng(h)
    imgs = (rng.random((3, h, w)) * 255).astype(np.uint8)
    got = tfid.crop64_preprocess(imgs)
    want = jfid.crop64_preprocess(imgs)
    assert got.shape == want.shape == (3, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL)


def test_inception_front_end_resize():
    x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), "bilinear")
    got = resize_bilinear(nchw(x), (299, 299)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=RESIZE_TOL)


def _close_acts(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(1.0, float(np.abs(want).max()))
    assert err <= ACT_TOL, err


def test_inception_v3_pool3_with_converted_weights():
    """75x75, the smallest input the VALID stem takes, without the resize
    front end; every flax leaf (BatchNorm statistics too) random."""
    x = np.random.default_rng(1).random((2, 75, 75, 3)).astype(np.float32)
    jm = JInception(resize_input=False)
    v = random_variables(jm, x[:1])
    want = jax.jit(jm.apply)(v, x)
    port = InceptionV3Pool3(resize_input=False)
    port.load_state_dict(convert_module(to_numpy_tree(v), port))
    with torch.no_grad():
        got = port.eval()(nchw(x))
    assert got.shape == (2, 2048)
    _close_acts(got, want)


def test_frechet_distance_equals_the_jax_packages():
    rng = np.random.default_rng(0)
    a = np.maximum(rng.normal(size=(40, FEATURES)), 0)
    b = np.maximum(rng.normal(size=(30, FEATURES)) + 0.3, 0)
    for x, y in ((a, b), (a, a), (a[:20], b[:3])):
        sa, sb = tfid.gaussian_stats(x), tfid.gaussian_stats(y)
        for s, j in zip(sa + sb, jfid.gaussian_stats(x) + jfid.gaussian_stats(
                y)):
            np.testing.assert_array_equal(s, j)
        assert tfid.frechet_distance(*sa, *sb) == \
            jfid.frechet_distance(*sa, *sb)


def _images_folder(folder, n_writers=2, per=6, seed=0, npy=False):
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    for i in range(n_writers * per):
        arr = (rng.random((64, 96)) * 255).astype(np.uint8)
        name = os.path.join(folder, f"{200 + i % n_writers}-{i}.ab-ac.png")
        if npy:
            np.save(name + ".npy", arr)
        else:
            Image.fromarray(arr, mode="L").save(name)


def test_load_folder_images(tmp_path, monkeypatch):
    """``.png.npy`` reads as PIL reads the same ``.png`` (gray replicated
    to RGB), with the same writer ids; without PIL a ``.png`` raises."""
    _images_folder(tmp_path / "png")
    _images_folder(tmp_path / "npy", npy=True)
    want, wids = jfid.load_folder_images(str(tmp_path / "png"))
    for folder in ("png", "npy"):
        got, gw = tfid.load_folder_images(str(tmp_path / folder))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(gw, wids)
    assert set(wids.tolist()) == {"200", "201"}
    monkeypatch.setitem(sys.modules, "PIL", None)
    got, _ = tfid.load_folder_images(str(tmp_path / "npy"))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="needs PIL"):
        tfid.load_folder_images(str(tmp_path / "png"))


def _first_features(cls, monkeypatch):
    orig = cls.activations
    monkeypatch.setattr(cls, "activations",
                        lambda self, x: orig(self, x)[:, :FEATURES])


def test_evaluate_json_matches_the_jax_clis(tmp_path, monkeypatch, capsys):
    """``cli/evaluate`` of both packages on one folder pair, with and
    without ``--per-writer``: the JAX scorer with random flax variables,
    the port's with the same converted, both ``caller_weights``."""
    from affganwriting_tpu.cli import evaluate as jevaluate
    from affganwriting_torch.cli import evaluate as tevaluate

    monkeypatch.delenv("AFFGAN_INCEPTION_PTH", raising=False)
    monkeypatch.setattr(jfid, "find_inception_weights", lambda: None)
    monkeypatch.setattr(tfid, "find_inception_weights", lambda: None)
    _first_features(jfid.FIDScorer, monkeypatch)
    _first_features(tfid.FIDScorer, monkeypatch)
    variables = random_variables(JInception(),
                                 np.zeros((1, 64, 64, 3), np.float32))
    jscorer = jfid.FIDScorer(weights=variables, batch_size=8)
    weights = convert_module(to_numpy_tree(variables), InceptionV3Pool3())
    monkeypatch.setattr(jfid, "FIDScorer", lambda: jscorer)
    monkeypatch.setattr(tfid, "FIDScorer", functools.partial(
        tfid.FIDScorer, weights=weights, batch_size=8))
    gen_dir, real_dir = tmp_path / "gen", tmp_path / "real"
    _images_folder(gen_dir, per=3, seed=1)
    _images_folder(real_dir, per=3, seed=2)
    for extra in ([], ["--per-writer"]):
        argv = [str(gen_dir), "--real", str(real_dir)] + extra
        jevaluate.main(argv)
        want = json.loads(capsys.readouterr().out)
        got = tevaluate.main(argv + ["--device", "cpu"])
        assert json.loads(capsys.readouterr().out) == got
        assert got.keys() == want.keys()
        assert got["cer"] == want["cer"] and got["cer"]["count"] == 6
        assert got["fid_provenance"] == want["fid_provenance"] == \
            "caller_weights"
        key = "wid_fid_random_features" if extra else "fid_random_features"
        assert np.isfinite(want[key])
        assert got[key] == pytest.approx(want[key], rel=FID_RTOL)


def test_pretrained_weights_load_in_both_packages(tmp_path, monkeypatch):
    """A random state dict with torchvision's InceptionV3 names (and its
    AuxLogits, fc and num_batches_tracked entries), saved with
    ``torch.save`` and named by ``AFFGAN_INCEPTION_PTH``: both scorers
    say ``pretrained:<path>`` and give the same activations."""
    rng = np.random.default_rng(5)
    sd = {}
    for k, v in InceptionV3Pool3().state_dict().items():
        if k.endswith("running_var") or k.endswith("bn.weight"):
            a = rng.uniform(0.5, 1.5, tuple(v.shape))
        elif k.endswith("conv.weight"):
            a = rng.normal(size=tuple(v.shape)) / np.sqrt(v[0].numel())
        else:
            a = rng.normal(0, 0.1, tuple(v.shape))
        sd[k] = torch.tensor(a, dtype=torch.float32)
        if k.endswith("running_var"):
            sd[k[: -len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(3)
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(10, 2048), torch.zeros(10)
    path = tmp_path / "inception_v3.pth"
    torch.save({"state_dict": sd}, path)
    monkeypatch.setenv("AFFGAN_INCEPTION_PTH", str(path))
    jscorer = jfid.FIDScorer(batch_size=4)
    tscorer = tfid.FIDScorer(batch_size=4, device="cpu")
    assert jscorer.provenance == tscorer.provenance == f"pretrained:{path}"
    imgs = jfid.crop64_preprocess(
        np.random.default_rng(0).random((4, 64, 216)).astype(np.float32))
    _close_acts(tscorer.activations(imgs), jscorer.activations(imgs))


def test_random_features_are_the_ports_own_and_fixed(monkeypatch,
                                                      tmp_path):
    """Without weights: ``random_features:torch:seed=N``, the same features
    from the same seed, others from another; a named ``.pth`` that does
    not exist is ignored."""
    monkeypatch.setenv("AFFGAN_INCEPTION_PTH", str(tmp_path / "none.pth"))
    assert tfid.find_inception_weights() is None
    a = tfid.FIDScorer(batch_size=4, device="cpu")
    b = tfid.FIDScorer(batch_size=4, device="cpu")
    c = tfid.FIDScorer(seed=1, batch_size=4, device="cpu")
    assert a.provenance == "random_features:torch:seed=0"
    assert c.provenance == "random_features:torch:seed=1"
    imgs = tfid.crop64_preprocess(
        np.random.default_rng(0).random((2, 64, 216)).astype(np.float32))
    np.testing.assert_array_equal(a.activations(imgs), b.activations(imgs))
    assert not np.array_equal(a.activations(imgs), c.activations(imgs))
    assert a.activations(imgs[:0]).shape == (0, 2048)
