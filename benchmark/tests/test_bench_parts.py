"""A configuration's style encoder and recognizer are reference parts found
by name, so that a new one is new files: a configuration, a cell and the
part's file, added to a copy of the benchmark, run and read correct with no
file edited; the control's rounding reaches every layer of a part; and a
name with no file stops the run, naming the path it looked for."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.harness import spec
from benchmark.reference import models as ref

ROOT = Path(__file__).resolve().parents[2]
REFERENCE = ROOT / "benchmark" / "reference"

DINOV2_S = '''"""DINOv2 ViT-S/14 (facebook/dinov2-small's widths): hidden 384, 12
blocks, 6 heads, tapped after blocks 2, 5, 8 and 11."""

from benchmark.reference.models import ViTEncoder, style_args


def build(cfg):
    return ViTEncoder(384, 12, 6, (2, 5, 8, 11), **style_args(cfg))
'''

RUN = '''
import json, sys
sys.path[:0] = sys.argv[1:3]
import torch
from benchmark.harness.checks import checks_of, is_correct
from benchmark.harness.serve import serve
from benchmark.reference import models as ref
from benchmark.tests import tiny

torch.set_num_threads(1)  # a request in well under the window on a busy host
c = tiny.tiny_cell("word-dinov2s.synth-bulk", writers=3, words_min=4,
                   words_max=4)
numbers = serve(c, 37, 10.0, None, torch.device("cpu"), 0.0)["numbers"]
enc = ref.part("style", "dinov2_s").build(c["config_file"]["config"])
ref.set_cast(enc, ref.fp8_round)
layers = [m for m in enc.modules() if isinstance(m, ref.Layer)]
print(json.dumps({
    "file": ref.part("style", "dinov2_s").__file__, "numbers": numbers,
    "correct": is_correct(checks_of(numbers, c["check"]["limits"])),
    "layers": len(layers),
    "cast": sum(m.cast is ref.fp8_round for m in layers)}))
'''


def files(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_style_encoder_is_new_files(tmp_path):
    copy = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = files(copy)
    cfg = json.loads((copy / "configs" / "affgan-word-dinov2l.json")
                     .read_text())
    cfg["source"] = "https://huggingface.co/facebook/dinov2-small"
    cfg["config"]["style_encoder"] = "dinov2_s"
    (copy / "configs" / "affgan-word-dinov2s.json").write_text(
        json.dumps(cfg))
    cell = json.loads((copy / "workloads" / "word-resnet50.synth-bulk.json")
                      .read_text())
    cell["config"] = "affgan-word-dinov2s"
    (copy / "workloads" / "word-dinov2s.synth-bulk.json").write_text(
        json.dumps(cell))
    (copy / "reference" / "style_dinov2_s.py").write_text(DINOV2_S)
    out = subprocess.run(
        [sys.executable, "-c", RUN, str(tmp_path), str(ROOT)],
        capture_output=True, text=True, check=True).stdout
    got = json.loads(out.strip().splitlines()[-1])
    assert got["file"] == str(copy / "reference" / "style_dinov2_s.py")
    assert got["correct"] is True, got["numbers"]
    # the patch embedding, 12 blocks of 4 attention and 2 MLP layers, and
    # the 5 reductions, every one rounded
    assert got["layers"] == got["cast"] == 1 + 12 * 6 + 5
    after = files(copy)
    assert {k: after[k] for k in before} == before


@pytest.mark.parametrize("kind,key", [("rec", "recognizer"),
                                      ("style", "style_encoder")])
def test_a_part_with_no_file_names_its_path(kind, key):
    cfg = dict(spec.config("affgan-word-resnet50")["config"],
               **{key: "absent"})
    path = REFERENCE / f"{kind}_absent.py"
    with pytest.raises(SystemExit, match=re.escape(str(path))):
        with torch.device("meta"):
            ref.build(cfg, "rec" if kind == "rec" else "gen")


@pytest.mark.parametrize("name", spec.names("configs"))
def test_every_configuration_has_its_parts(name):
    cfg = spec.config(name)["config"]
    assert (REFERENCE / f"style_{cfg['style_encoder']}.py").is_file()
    assert (REFERENCE / f"rec_{cfg['recognizer']}.py").is_file()
    assert hasattr(ref.part("rec", cfg["recognizer"]), "Tap")


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("[rs]*_*.py")),
                         ids=lambda p: p.stem)
def test_the_control_rounds_every_layer_of_a_part(path):
    kind, name = path.stem.split("_", 1)
    cfg = dict(spec.config("affgan-word-resnet50")["config"],
               **{"style_encoder" if kind == "style" else "recognizer": name})
    with torch.device("meta"):
        model = ref.build(cfg, "gen" if kind == "style" else "rec")
    if kind == "style":
        model = model.enc_image
    ref.set_cast(model, ref.fp8_round)
    layers = [m for m in model.modules() if isinstance(m, ref.Layer)]
    assert layers and all(m.cast is ref.fp8_round for m in layers)
