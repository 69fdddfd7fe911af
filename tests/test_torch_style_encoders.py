"""The eight style encoders ported in the fifth slice, the generator built
around them, their torchvision importers and one train step, against the
JAX package, fp32 on the CPU.

Every flax leaf is random (tests/test_torch_support.py), converted by
``utils/from_flax`` and loaded strictly; inputs come from numpy seeds.  The
JAX side is jitted: at these sizes its compiles take seconds here.
dinov2_l and dinov2_g run at their real width and head count with the
depth cut to 4 blocks (tapped at each): the blocks are one module in a
loop, and 315 M and 1.15 B random leaves would not fit a test.  The train
cases take efficientnet with a tiny ``stages`` and dinov2 with a tiny arch
added to both packages' ``_ARCHS`` in the test (the JAX module is patched,
never edited).

Limits.  The pyramids and the new running statistics: 1e-4 of max(1, the
largest reference entry) of each tap or statistic (largest reading 2.6e-5,
vgg19's last tap).  Gradients, for a random cotangent on every tap: the
same 1e-4 on the input gradient and on each parameter's for inception_v3,
efficientnet and dinov2 (largest reading 5.5e-6).  cnn and vgg19 instance-
normalize every conv output, and their f32 gradients are ill-conditioned
at random weights: against the port's f64 gradient the JAX package's f32
one lies 1.1e-3 (cnn) and 2.3e-3 (vgg19) in relative L2 on the input
gradient and 7.7e-4 and 2.4e-3 over all parameters (9e-2 of the largest
entry on vgg19's conv9 kernel), the port's f32 one 6.8e-4 / 4.9e-4 and
3e-6 / 3.5e-6.  For those two the limit is 5e-3 relative L2 on the input
gradient and over all parameters, about twice the reference's own f32
error.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import affganwriting_tpu.models.style_encoders.vit as jvit
import affganwriting_torch.models.style_encoders.vit as tvit
from affganwriting_tpu.models.generator import Generator as JGenerator
from affganwriting_tpu.models.style_encoders import available as javailable
from affganwriting_tpu.models.style_encoders import get_style_encoder as jget
from affganwriting_torch.models.blocks import resize_bilinear
from affganwriting_torch.models.generator import Generator
from affganwriting_torch.models.style_encoders import (
    available,
    get_style_encoder,
)
from affganwriting_torch.utils.from_flax import convert_module
from test_torch_support import (
    load_port,
    nchw,
    nhwc,
    random_variables,
    small_jax_config,
    small_torch_config,
    to_numpy_tree,
)

torch.set_num_threads(2)   # tier-1 runs six xdist workers

F32 = torch.float32
HW = (32, 104)
FINAL = (4, 13)
NEW = ("cnn", "vgg19", "inception_v3", "efficientnet_v2_l", "dinov2_s",
       "dinov2_b", "dinov2_l", "dinov2_g")
# depth cut for the two largest ViTs (see the module docstring)
CUT = {"l": dict(embed=1024, depth=4, heads=16, taps=(0, 1, 2, 3)),
       "g": dict(embed=1536, depth=4, heads=24, taps=(0, 1, 2, 3))}
TINY_VIT = dict(embed=64, depth=4, heads=4, taps=(0, 1, 2, 3))
TINY_EFFNET = dict(stem_ch=8, stages=(
    (1, "fused", 3, 1, 1, 8, None), (2, "fused", 3, 2, 2, 16, None),
    (1, "fused", 3, 2, 2, 16, None), (2, "mb", 3, 2, 2, 24, 0.25),
    (1, "mb", 3, 1, 3, 32, 0.25)))
TAP_TOL, GRAD_TOL = 1e-4, 1e-4
IN_L2_TOL = 5e-3           # cnn and vgg19, relative L2 (module docstring)
X = np.random.default_rng(0).normal(size=(2, *HW, 50)).astype(np.float32)


def rel_l2(got, want) -> float:
    got, want = (np.concatenate([np.asarray(a, np.float64).ravel()
                                 for a in t]) for t in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.fixture
def vit_archs(monkeypatch):
    """Both packages' ``_ARCHS`` with l and g cut in depth and s tiny."""
    for archs in (jvit._ARCHS, tvit._ARCHS):
        for k, v in CUT.items():
            monkeypatch.setitem(archs, k, v)
    return monkeypatch


def encoders(name, **kw):
    return (jget(name, dtype=jnp.float32, final_hw=FINAL, **kw),
            get_style_encoder(name, final_hw=FINAL, dtype=F32, **kw))


def test_registry_has_the_jax_packages_ten_keys():
    assert available() == javailable()
    assert len(available()) == 10 and set(NEW) < set(available())


@pytest.mark.parametrize("name", NEW)
def test_eval_pyramid(name, vit_archs):
    """At 32x104 the last tap's resize to (4, 13) is an upsample for every
    encoder, as at 64x216 (``resize_bilinear`` would antialias a shrink as
    jax does)."""
    jenc, tenc = encoders(name)
    v = random_variables(jenc, X[:1])
    want = jax.jit(jenc.apply)(v, X)
    module = sys.modules[type(tenc).__module__]
    sizes = []

    def resize(x, size):
        sizes.append(tuple(x.shape[2:]))
        return resize_bilinear(x, size)

    vit_archs.setattr(module, "resize_bilinear", resize)
    got = load_port(tenc, v)(nchw(X))
    assert len(sizes) == 1 and sizes[0][0] <= FINAL[0] \
        and sizes[0][1] <= FINAL[1], sizes
    assert len(got) == len(want) >= 5
    assert tuple(got[-1].shape) == (2, 512, *FINAL)
    for i, (g, w) in enumerate(zip(got, want)):
        assert rel_err(nhwc(g), w) <= TAP_TOL, (name, i, rel_err(nhwc(g), w))


def _jax_train(jenc, v, x, cots):
    def loss(params, x):
        taps, upd = jenc.apply({**v, "params": params}, x, train=True,
                               mutable=["batch_stats"])
        return sum((t * c).sum() for t, c in zip(taps, cots)), (taps, upd)

    (_, (taps, upd)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(v["params"], x)
    return to_numpy_tree((taps, upd.get("batch_stats", {}), gp, gx))


@pytest.mark.parametrize("name,kw", [
    ("cnn", {}), ("vgg19", {}), ("inception_v3", {}),
    ("efficientnet_v2_l", TINY_EFFNET), ("dinov2_s", {})],
    ids=["cnn", "vgg19", "inception_v3", "efficientnet_v2_l-tiny",
         "dinov2-tiny"])
def test_train_pyramid_gradients_and_statistics(name, kw, vit_archs):
    """Train mode: the pyramid, the input gradient, every parameter's
    gradient and the new running statistics, for a random cotangent on
    each tap.  efficientnet's statistics move; inception's BatchNorms
    normalize with their running statistics and leave them bit-unchanged
    on both sides."""
    for archs in (jvit._ARCHS, tvit._ARCHS):
        vit_archs.setitem(archs, "s", TINY_VIT)
    jenc, tenc = encoders(name, **kw)
    v = random_variables(jenc, X[:1])
    shapes = [t.shape for t in jax.eval_shape(jenc.apply, v, X)]
    rng = np.random.default_rng(1)
    cots = [rng.normal(size=s).astype(np.float32) for s in shapes]
    taps, stats, gp, gx = _jax_train(jenc, v, X, cots)

    tenc.load_state_dict(convert_module(to_numpy_tree(v), tenc))
    before = {k: t.clone() for k, t in tenc.state_dict().items()}
    x = nchw(X).requires_grad_(True)
    got = tenc.train()(x)
    sum((t * nchw(c)).sum() for t, c in zip(got, cots)).backward()

    for i, (g, w) in enumerate(zip(got, taps)):
        assert rel_err(nhwc(g), w) <= TAP_TOL, ("tap", i, rel_err(nhwc(g), w))
    want_grads = convert_module({"params": gp}, tenc, params_only=True)
    names = [k for k, _ in tenc.named_parameters()]
    grads = [p.grad for _, p in tenc.named_parameters()]
    if name in ("cnn", "vgg19"):
        assert rel_l2([nhwc(x.grad)], [gx]) <= IN_L2_TOL
        assert rel_l2(grads, [want_grads[k] for k in names]) <= IN_L2_TOL
    else:
        assert rel_err(nhwc(x.grad), gx) <= GRAD_TOL
        for k, g in zip(names, grads):
            assert rel_err(g, want_grads[k]) <= GRAD_TOL, k
    now = tenc.state_dict()
    stat_keys = [k for k in now if k.endswith(("running_mean",
                                               "running_var"))]
    if name == "inception_v3":
        assert stat_keys
        assert all(torch.equal(now[k], before[k]) for k in stat_keys)
        jax.tree.map(np.testing.assert_array_equal, stats,
                     to_numpy_tree(v["batch_stats"]))
    elif name == "efficientnet_v2_l":
        want = convert_module({"params": v["params"], "batch_stats": stats},
                              tenc)
        assert not any(torch.equal(now[k], before[k]) for k in stat_keys)
        for k in stat_keys:
            assert rel_err(now[k], want[k]) <= TAP_TOL, k
    else:
        assert not stat_keys and not stats


def test_generator_builds_each_encoder_as_the_jax_one_does():
    """``style_dim`` reaches the encoder only when it is not 512: cnn at
    style_dim 64 gives the JAX generator's images, and vgg19, which has no
    reducers, refuses style_dim 64 in both packages."""
    jcfg, tcfg = (small_jax_config(style_encoder="cnn"),
                  small_torch_config(style_encoder="cnn"))
    labels = np.asarray([[0, 5, 9, 13, 1, 2, 2, 2]], np.int32)
    jgen = JGenerator(jcfg, subpixel=True)
    v = random_variables(jgen, X[:1], labels)
    want = jax.jit(jgen.apply)(v, X[:1], labels)
    gen = load_port(Generator(tcfg), v)
    got = gen.generate(gen.encode_style(torch.from_numpy(X[:1])),
                       torch.from_numpy(labels).long())
    assert rel_err(nhwc(got), want) <= 2e-3
    with pytest.raises(TypeError, match="style_dim"):
        jax.eval_shape(lambda: JGenerator(
            jcfg.replace(style_encoder="vgg19")).init(
                jax.random.key(0), X[:1], labels))
    with pytest.raises(TypeError, match="style_dim"):
        Generator(tcfg.replace(style_encoder="vgg19"))


def _tv_resnet50(rng):
    """A state dict with torchvision resnet50's names and shapes."""
    sd = {}

    def conv(name, o, i, k):
        sd[f"{name}.weight"] = rng.normal(size=(o, i, k, k))

    def bn(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, c)
        sd[f"{name}.bias"] = rng.normal(0, 0.1, c)
        sd[f"{name}.running_mean"] = rng.normal(0, 0.1, c)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, c)
        sd[f"{name}.num_batches_tracked"] = np.asarray(7)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    for layer, n, cin, w in (("layer1", 3, 64, 64), ("layer2", 4, 256, 128),
                             ("layer3", 6, 512, 256),
                             ("layer4", 3, 1024, 512)):
        for bi in range(n):
            b_in = cin if bi == 0 else w * 4
            for ci, (o, i, k) in enumerate(((w, b_in, 1), (w, w, 3),
                                            (w * 4, w, 1)), start=1):
                conv(f"{layer}.{bi}.conv{ci}", o, i, k)
                bn(f"{layer}.{bi}.bn{ci}", o)
            if bi == 0:
                conv(f"{layer}.{bi}.downsample.0", w * 4, b_in, 1)
                bn(f"{layer}.{bi}.downsample.1", w * 4)
    sd["fc.weight"], sd["fc.bias"] = rng.normal(size=(10, 2048)), np.zeros(10)
    return sd


def _tv_efficientnet(rng, stages, stem_ch):
    """torchvision efficientnet_v2's names and shapes for ``stages``, plus
    a later stage and the classifier, which the importers drop."""
    sd = {}

    def conv(name, o, i, k, bias=False):
        sd[f"{name}.weight"] = rng.normal(size=(o, i, k, k))
        if bias:
            sd[f"{name}.bias"] = rng.normal(0, 0.1, o)

    def bn(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, c)
        sd[f"{name}.bias"] = rng.normal(0, 0.1, c)
        sd[f"{name}.running_mean"] = rng.normal(0, 0.1, c)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, c)
        sd[f"{name}.num_batches_tracked"] = np.asarray(7)

    conv("features.0.0", stem_ch, 3, 3)
    bn("features.0.1", stem_ch)
    cin = stem_ch
    for si, (n, kind, k, _s, e, out, se) in enumerate(stages):
        for bi in range(n):
            p, mid = f"features.{si + 1}.{bi}.block", cin * e
            if kind == "fused" and e == 1:
                conv(f"{p}.0.0", out, cin, k)
                bn(f"{p}.0.1", out)
            elif kind == "fused":
                conv(f"{p}.0.0", mid, cin, k)
                bn(f"{p}.0.1", mid)
                conv(f"{p}.1.0", out, mid, 1)
                bn(f"{p}.1.1", out)
            else:
                se_ch = max(1, int(cin * se))
                conv(f"{p}.0.0", mid, cin, 1)
                bn(f"{p}.0.1", mid)
                sd[f"{p}.1.0.weight"] = rng.normal(size=(mid, 1, k, k))
                bn(f"{p}.1.1", mid)
                conv(f"{p}.2.fc1", se_ch, mid, 1, bias=True)
                conv(f"{p}.2.fc2", mid, se_ch, 1, bias=True)
                conv(f"{p}.3.0", out, mid, 1)
                bn(f"{p}.3.1", out)
            cin = out
    conv(f"features.{len(stages) + 1}.0.block.0.0", 8, cin, 1)
    sd["classifier.1.weight"] = rng.normal(size=(10, 8))
    return sd


def _tv_inception(rng):
    """torchvision inception_v3's names (the port's, plus the heads)."""
    from affganwriting_torch.eval.inception_v3 import InceptionV3Pool3

    sd = {k: rng.normal(size=tuple(v.shape)) if k.endswith("weight")
          else rng.uniform(0.5, 1.5, tuple(v.shape))
          for k, v in InceptionV3Pool3().state_dict().items()}
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k[: -len("running_var")] + "num_batches_tracked"] = np.asarray(7)
    sd["AuxLogits.conv0.conv.weight"] = rng.normal(size=(128, 768, 1, 1))
    sd["fc.weight"], sd["fc.bias"] = rng.normal(size=(10, 2048)), np.zeros(10)
    return sd


@pytest.mark.parametrize("name", ["resnet50", "efficientnet_v2_l",
                                  "inception_v3"])
def test_torchvision_importers_match_the_jax_packages(name):
    """One synthetic torchvision state dict through both importers: the
    JAX package's, overlaid on random flax variables and converted, equals
    the port's loaded over the same variables, bit for bit; only the 1x1
    reducers are left to their init."""
    from affganwriting_tpu.eval.inception_v3 import (
        InceptionV3Pool3 as JInception,
    )
    from affganwriting_tpu.models.style_encoders.efficientnet import (
        efficientnet_v2_l_to_flax,
    )
    from affganwriting_tpu.utils import torch_import as jimport
    from affganwriting_torch.eval.inception_v3 import InceptionV3Pool3
    from affganwriting_torch.utils import torchvision_import as timport

    rng = np.random.default_rng(3)
    if name == "resnet50":
        sd = _tv_resnet50(rng)
        jenc, tenc = encoders(name)
        x = X[:1]
        jconv, tconv = jimport.resnet50_to_flax, timport.resnet50_state_dict
    elif name == "efficientnet_v2_l":
        sd = _tv_efficientnet(rng, TINY_EFFNET["stages"],
                              TINY_EFFNET["stem_ch"])
        jenc, tenc = encoders(name, **TINY_EFFNET)
        x = X[:1]

        def jconv(s):
            return efficientnet_v2_l_to_flax(
                s, stages=TINY_EFFNET["stages"])

        def tconv(s):
            return timport.efficientnet_v2_l_state_dict(
                s, stages=TINY_EFFNET["stages"])
    else:
        sd = _tv_inception(rng)
        jenc, tenc = JInception(), InceptionV3Pool3()
        x = np.zeros((1, 75, 75, 3), np.float32)
        jconv, tconv = jimport.inception_v3_to_flax, \
            timport.inception_v3_state_dict
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    v = random_variables(jenc, x)
    want = convert_module(
        to_numpy_tree(jimport.merge_pretrained(v, *jconv(sd))), tenc)
    tenc.load_state_dict(convert_module(to_numpy_tree(v), tenc))
    res = tenc.load_state_dict(
        tconv({k: torch.from_numpy(a) for k, a in sd.items()}), strict=False)
    assert not res.unexpected_keys
    assert all(k.startswith("reduce") for k in res.missing_keys)
    assert (name == "inception_v3") == (not res.missing_keys)
    got = tenc.state_dict()
    assert got.keys() == want.keys()
    blocks_bn = {}
    if name == "efficientnet_v2_l":
        # the JAX importer loses every block BatchNorm's scale and bias:
        # it nests each block's dict over its "name/bn" entries
        # (efficientnet.py:352-365; ROADMAP Queue 3), so those keep their
        # init there; the port takes torchvision's
        for si, (n, kind, _k, _s, e, _o, _se) in enumerate(
                TINY_EFFNET["stages"]):
            idx = ({"project": 0} if kind == "fused" and e == 1 else
                   {"expand": 0, "project": 1} if kind == "fused" else
                   {"expand": 0, "dw": 1, "project": 3})
            for bi in range(n):
                for layer, i in idx.items():
                    for leaf in ("weight", "bias"):
                        blocks_bn[f"stage{si + 1}_{bi}.{layer}_bn.{leaf}"] = \
                            torch.from_numpy(sd[f"features.{si + 1}.{bi}"
                                                f".block.{i}.1.{leaf}"])
        assert len(blocks_bn) == 32
    for k in want:
        assert torch.equal(got[k], blocks_bn.get(k, want[k])), k
