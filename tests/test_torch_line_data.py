"""The port's numpy-side line modules against the JAX package's, bit for
bit: DTW (``ops/dtw.py``), line augmentation (``data/line_augment.py``,
the scipy route and the native route), the line data (``data/lines.py``),
the curriculum, the style bank, the schedules (``make_schedule``,
``partition_labels`` on JAX path strings), SWA and EMA, the style
library's pickles both ways and the numpy actions of
``gen/line_inference.py``, ``eval/style_viz.project_2d``, and the PNG
writer (``utils/png.py``) decoded by PIL.

Tolerances: none (bit-equal) but two, each stated where it is used: the
two schedules that take an f32 ``pow`` (XLA's own approximation; within
1 ulp over a dense sweep, bit-equal at the sampled steps), and
``ema_update`` (1 ulp: jnp and torch round ``(1 - decay) * p`` the same
way, but order the scalar products as their own kernels do).

The native route compares the port's ctypes bindings with the JAX
package's loaded from the same library (the port's build of
``native/preprocess.cpp``), so it holds the bindings and the dispatch.
"""

import pickle
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import affganwriting_tpu.utils.native as jnative
from affganwriting_tpu.data import line_augment as jaug
from affganwriting_tpu.data import lines as jlines
from affganwriting_tpu.gen import line_inference as jinf
from affganwriting_tpu.ops.dtw import correct_pred as jcorrect
from affganwriting_tpu.ops.dtw import interleave_blanks as jinterleave
from affganwriting_tpu.train import schedules as jsched
from affganwriting_tpu.train import swa as jswa
from affganwriting_tpu.train.curriculum import Curriculum as JCurriculum
from affganwriting_tpu.train.line_trainer import StyleBank as JStyleBank
from affganwriting_torch.data import line_augment as aug
from affganwriting_torch.data import lines
from affganwriting_torch.eval.style_viz import project_2d
from affganwriting_torch.gen import line_inference as inf
from affganwriting_torch.ops.dtw import correct_pred, interleave_blanks
from affganwriting_torch.train import schedules, swa
from affganwriting_torch.train.curriculum import Curriculum
from affganwriting_torch.train.line_trainer import StyleBank
from affganwriting_torch.utils import native
from affganwriting_torch.utils.png import decode_gray_png, encode_gray_png

torch.set_num_threads(2)   # tier-1 runs six xdist workers


@pytest.mark.parametrize("seed,t_pred,t_lab,batch",
                         [(0, 16, 5, 3), (1, 32, 12, 4), (2, 9, 8, 2),
                          (3, 40, 1, 5)])
def test_dtw_is_bit_equal(seed, t_pred, t_lab, batch):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(t_pred, batch, 12)).astype(np.float32)
    pred = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    label = rng.integers(1, 12, (t_lab, batch)).astype(np.int32)
    np.testing.assert_array_equal(interleave_blanks(label),
                                  jinterleave(label))
    got, want = correct_pred(pred, label), jcorrect(pred, label)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def pages():
    """Three [0, 1] pages, ink dark: synthetic lines at 64 x 96."""
    imgs = [jlines.synthetic_line_image(t, 7 + i, width=96)
            for i, t in enumerate(("ab cd", "hello", "x y z"))]
    return [((1.0 - im) * 0.5).astype(np.float32) for im in imgs]


def _augment_all(mod, page, seed):
    rng = np.random.default_rng(seed)
    return [mod.otsu_threshold(page), mod.foreground_mask(page),
            mod.foreground_mask(page, dilate=3),
            mod.tensmeyer_brightness(page, rng),
            mod.affine_skew_stretch(page, 0.07, 1.05),
            mod.grid_warp_line(page, rng),
            mod.augment_line(page, rng)]


@pytest.fixture(scope="module")
def port_native():
    """The port's build of native/preprocess.cpp; None without a g++."""
    try:
        native.build(verbose=False)
    except (OSError, subprocess.CalledProcessError):
        return None
    return native.SO if native.available() else None


@pytest.mark.parametrize("route", ["scipy", "native"])
def test_line_augmentation_is_bit_equal(pages, port_native, route,
                                        monkeypatch):
    if route == "scipy":
        monkeypatch.setattr(native, "load", lambda: None)
        monkeypatch.setattr(jnative, "load", lambda: None)
    else:
        assert port_native is not None, "g++ could not build the library"
        monkeypatch.setattr(jnative, "_SO", str(port_native))
        monkeypatch.setattr(jnative, "_lib", None)
        lib = native.load()
        assert lib is not None
        # the JAX loader sets the argtypes of its own functions only; the
        # line routines take numpy pointers and ints, as the port passes
        assert native.otsu_fg_mask_native(pages[0][None]) is not None
    for i, page in enumerate(pages):
        for k, (got, want) in enumerate(zip(_augment_all(aug, page, i),
                                            _augment_all(jaug, page, i))):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                          err_msg=f"page {i}, output {k}")


def test_line_data_is_bit_equal():
    cs, jcs = lines.LineCharset(), jlines.LineCharset()
    assert cs.n_class == jcs.n_class == 80
    assert cs.char_to_idx == jcs.char_to_idx
    text = "Hello, World! 42"
    assert cs.encode(text) == jcs.encode(text)
    ids = cs.encode(text) + [0, 0, 5, 5]
    assert cs.decode(ids) == jcs.decode(ids)
    assert cs.ctc_collapse(ids) == jcs.ctc_collapse(ids)
    assert lines.load_sets() == jlines.load_sets()
    td, jtd = lines.TextData(cs, seed=3), jlines.TextData(jcs, seed=3)
    for k in ("label", "label_lengths"):
        np.testing.assert_array_equal(td.batch(4, 20)[k],
                                      jtd.batch(4, 20)[k])
    for kw in ({}, {"a_batch_size": 1, "width": 256, "label_len": 24,
                    "authors": ["x", "y", "z", "w"]}):
        ds, jds = lines.LineDataset(cs, seed=5, **kw), \
            jlines.LineDataset(jcs, seed=5, **kw)
        n = 0
        for epoch in (0, 1):
            for got, want in zip(ds.batches(2, epoch=epoch),
                                 jds.batches(2, epoch=epoch)):
                assert got.keys() == want.keys()
                for k, v in want.items():
                    if isinstance(v, np.ndarray):
                        assert got[k].dtype == v.dtype
                        np.testing.assert_array_equal(got[k], v)
                    else:
                        assert got[k] == v
                n += 1
        assert n >= 4
    items = [{"image": np.full((8, w, 1), i, np.float32), "id": i}
             for i, w in enumerate((100, 130, 60, 250, 129))]
    for got, want in zip(lines.bucketize(items, batch_size=2),
                         jlines.bucketize(items, batch_size=2),
                         strict=True):
        np.testing.assert_array_equal(got["image"], want["image"])
        np.testing.assert_array_equal(got["width"], want["width"])
        assert got["id"] == want["id"]


def test_curriculum_matches():
    spec = {0: [["count"], [2, "no-step", "gen"], ["auto", "auto-gen"],
                ["disc"]],
            "5": [["auto"], ["gen", "disc"]],
            12: [[3, "valid"]]}
    for sp in (None, spec):
        c, jc = Curriculum(sp), JCurriculum(sp)
        assert [c.get_lesson(i) for i in range(30)] == \
            [jc.get_lesson(i) for i in range(30)]
        assert c.all_lessons == jc.all_lessons
        assert c.get_valid() == jc.get_valid()
        assert c.get_eval() == jc.get_eval()


def test_style_bank_is_bit_equal():
    rng = np.random.default_rng(0)
    bank, jbank = StyleBank(size=5, seed=3), JStyleBank(size=5, seed=3)
    assert bank.sample(2) is None and jbank.sample(2) is None
    for _ in range(4):
        styles = rng.normal(size=(3, 6)).astype(np.float32)
        bank.add(styles)
        jbank.add(styles)
        got, want = bank.sample(4), jbank.sample(4)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert len(bank.bank) == len(jbank.bank) == 5


SCHEDULES = ["none", "LR_test", "cyclic", "cyclic-full", "1cycle",
             "detector", "rampup", "custom", True]


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedules_match_at_several_steps(name):
    """Bit-equal at the sampled steps (cycle and warm-up edges among them);
    ``detector`` and ``custom`` take an f32 ``pow``, which XLA computes
    its own way: within 1 ulp over every step of 0..3000."""
    kw = dict(cycle_size=100, warmup_steps=50)
    got, want = schedules.make_schedule(name, 1000, **kw), \
        jsched.make_schedule(name, 1000, **kw)
    for step in (0, 1, 2, 3, 47, 48, 49, 50, 51, 99, 100, 101, 150, 199,
                 200, 201, 500, 999, 1000, 1500):
        w = np.float32(np.asarray(want(jnp.asarray(step, jnp.int32))))
        assert np.float32(got(step)) == w, (name, step)
    if name in ("detector", "custom"):
        steps = np.arange(3000, dtype=np.int32)
        w = np.asarray(jax.vmap(want)(jnp.asarray(steps)), np.float32)
        g = np.asarray([got(int(s)) for s in steps], np.float32)
        ulp = np.abs(g.view(np.int32).astype(np.int64)
                     - w.view(np.int32).astype(np.int64))
        assert ulp.max() <= 1, (name, int(ulp.max()))


def test_partition_labels_select_the_jax_leaves():
    """The port's labels, keyed by parameter name and computed on
    ``utils/from_flax.flax_paths``, equal the JAX package's labels of the
    same flax leaves."""
    from affganwriting_tpu.models.line.container import HWWithStyle as JHW
    from affganwriting_torch.models.line.container import HWWithStyle
    from affganwriting_torch.utils.from_flax import flax_paths
    from test_torch_support import LINE_CLASSES as K

    kw = dict(n_class=K, style_dim=16, gen_dim=32, max_gen_length=12,
              char_style_dim=4)
    jm = JHW(**kw)
    img = np.zeros((2, 64, 64, 1), np.float32)
    label = np.ones((2, 3), np.int32)
    shapes = jax.eval_shape(lambda k: jm.init(
        {"params": k, "noise": k, "spacing": k}, img, label,
        np.array([3, 2], np.int32), method=jm.init_all), jax.random.key(0))
    main = {k: v for k, v in shapes["params"].items() if k != "hwr"}
    model = HWWithStyle(**kw)
    names = [n for n, _ in model.named_parameters()
             if not n.startswith("hwr.")]
    paths = flax_paths(model, names)
    for slow, freeze in ((("style_extractor",), ()),
                         (("generator/block1", "spacer/mean"),
                          ("kernel", "char_extractor/w"))):
        jl = jsched.partition_labels(main, slow, freeze)
        want = {jsched._path_str(p): leaf for p, leaf in
                jax.tree_util.tree_flatten_with_path(jl)[0]}
        got = schedules.partition_labels(paths, slow, freeze)
        assert {paths[n]: lab for n, lab in got.items()} == want
        assert len(set(got.values())) == 3 if freeze else True


def test_swa_and_ema_match():
    rng = np.random.default_rng(0)
    names = ("a", "b.c")
    params = [{n: rng.normal(size=(3, 4)).astype(np.float32) for n in names}
              for _ in range(4)]
    s = swa.swa_init({n: torch.from_numpy(v) for n, v in params[0].items()})
    js = jswa.swa_init(params[0])
    for p in params[1:]:
        s = swa.swa_update(s, {n: torch.from_numpy(v) for n, v in p.items()})
        js = jswa.swa_update(js, p)
    assert s["count"] == int(js["count"]) == 3
    for n in names:
        np.testing.assert_array_equal(s["avg"][n].numpy(),
                                      np.asarray(js["avg"][n]))
    e = swa.ema_update({n: torch.from_numpy(v) for n, v in
                        params[0].items()},
                       {n: torch.from_numpy(v) for n, v in
                        params[1].items()}, decay=0.9)
    je = jswa.ema_update(params[0], params[1], decay=0.9)
    for n in names:
        np.testing.assert_allclose(e[n].numpy(), np.asarray(je[n]),
                                   rtol=2 ** -23, atol=0)


def test_style_library_pickles_load_across_packages(tmp_path):
    rng = np.random.default_rng(1)
    styles = rng.normal(size=(6, 5)).astype(np.float32)
    authors = ["a", "b", "a", "c", "b", "a"]
    ids = list(range(10, 16))
    inf.StyleLibrary(styles, authors, ids).save(tmp_path / "port.pkl")
    jinf.StyleLibrary(styles, authors, ids).save(tmp_path / "jax.pkl")
    assert (tmp_path / "port.pkl").read_bytes() == \
        (tmp_path / "jax.pkl").read_bytes()
    for src, cls in (("port.pkl", jinf.StyleLibrary),
                     ("jax.pkl", inf.StyleLibrary)):
        lib = cls.load(str(tmp_path / src))
        np.testing.assert_array_equal(lib.styles, styles)
        assert lib.authors == authors and lib.ids == ids
        assert lib.by_author == {"a": [0, 2, 5], "b": [1, 4], "c": [3]}
        np.testing.assert_array_equal(lib.author_average("a"),
                                      styles[[0, 2, 5]].mean(0))
    with open(tmp_path / "port.pkl", "rb") as f:
        raw = pickle.load(f)
    assert set(raw) == {"styles", "authors", "ids"}


def test_line_inference_numpy_actions_are_bit_equal():
    rng = np.random.default_rng(2)
    styles = rng.normal(size=(8, 6)).astype(np.float32)
    authors = ["a", "b"] * 4
    lib, jlib = inf.StyleLibrary(styles, authors, list(range(8))), \
        jinf.StyleLibrary(styles, authors, list(range(8)))
    for got, want in (
            (inf.interpolate(styles[0], styles[1], 5),
             jinf.interpolate(styles[0], styles[1], 5)),
            (inf.style_math(styles[0], styles[1], styles[2], 0.7),
             jinf.style_math(styles[0], styles[1], styles[2], 0.7)),
            (inf.random_styles(lib, 5, seed=4),
             jinf.random_styles(jlib, 5, seed=4)),
            (inf.gaussian_styles(3, 6, seed=1),
             jinf.gaussian_styles(3, 6, seed=1)),
            (project_2d(styles), _jax_project_2d(styles))):
        np.testing.assert_array_equal(got, want)
    onehot = np.eye(12, dtype=np.float32)[rng.integers(0, 12, (2, 20))]
    for f in (0.9, 1.0, 1.07, 1.1):
        np.testing.assert_array_equal(inf._resample_time(onehot, f, 24),
                                      jinf._resample_time(onehot, f, 24))
    assert inf.stretch_factors(0.02) == jinf.stretch_factors(0.02)
    for metric in ("l1", "l2"):
        assert inf.writer_retrieval(lib, metric, (1, 3)) == \
            jinf.writer_retrieval(jlib, metric, (1, 3))
    for sent in ("a b", "one two three", "the quick brown fox jumps over"):
        assert inf.permute_false(sent, np.random.default_rng(0)) == \
            jinf.permute_false(sent, np.random.default_rng(0))


def _jax_project_2d(styles):
    from affganwriting_tpu.eval.style_viz import project_2d as jproject

    return jproject(styles)


def test_png_writer_decodes_in_pil(tmp_path):
    """``utils/png``'s standard-library PNG (no PIL needed to write it)
    reads back in PIL, and its own reader decodes PIL's (filtered) PNGs;
    ``save_line_png`` writes the JAX package's (1 - img) * 127.5 page."""
    import io

    from PIL import Image

    rng = np.random.default_rng(3)
    for h, w in ((1, 1), (7, 13), (64, 512)):
        gray = rng.integers(0, 256, (h, w)).astype(np.uint8)
        data = encode_gray_png(gray)
        with Image.open(io.BytesIO(data)) as im:
            assert im.mode == "L"
            np.testing.assert_array_equal(np.asarray(im), gray)
        buf = io.BytesIO()
        Image.fromarray(gray, mode="L").save(buf, format="PNG")
        np.testing.assert_array_equal(decode_gray_png(buf.getvalue()), gray)
    img = np.tanh(rng.normal(size=(64, 96, 1))).astype(np.float32)
    inf.save_line_png(img, str(tmp_path / "port.png"))
    jinf.save_line_png(img, str(tmp_path / "jax.png"))
    with Image.open(tmp_path / "port.png") as a, \
            Image.open(tmp_path / "jax.png") as b:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
