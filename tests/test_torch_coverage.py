"""The port does all that the JAX package does, module by module, name by
name and flag by flag, read from both packages' sources with ``ast`` (no
module of either is imported).

- Every module of ``affganwriting_tpu/`` has its module in
  ``affganwriting_torch/`` at the same path, but for two renames:
  ``ops/<kernel>_pallas.py`` -> ``ops/<kernel>_cuda.py`` (the Pallas
  kernels' Hopper ports) and ``utils/torch_import.py`` ->
  ``utils/torchvision_import.py``.
- Every public top-level ``def`` and ``class`` of a JAX module is defined,
  or assigned, at the top level of its port module.
- Every ``--flag`` a JAX CLI's parser adds (``add_argument``) is added by
  its port CLI.

``ALLOWED`` lists what the port covers another way, and nothing else.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "affganwriting_tpu", ROOT / "affganwriting_torch"

ALLOWED = {
    # the XLA compile cache; eager PyTorch has no counterpart
    "core/cache.py": None,
    # a flax helper: the port's models are nn.Modules holding their state
    "gen/inference.py": {"variables_of"},
    # the host TrOCR teacher is the port's train/teacher.py:TrOCRTeacher
    "train/teacher.py": {"FlaxTrOCRTeacher"},
    # optax multi_transform; the port's optimizer is PartitionedAdam
    "train/schedules.py": {"partitioned_optimizer"},
    # the port loads torchvision into its own layout:
    # utils/torchvision_import.py:efficientnet_v2_l_state_dict
    "models/style_encoders/efficientnet.py": {"efficientnet_v2_l_to_flax"},
    # a flax module wrapping one function: spaced_gen.pixel_norm
    "models/line/spaced_gen.py": {"PixelNorm"},
    # the port builds R in gen/inference.py:build_recognizer
    "train/state.py": {"build_recognizer"},
    # the step's time is its span, train.step (utils/profiling.span),
    # read from the profiler's trace; no timer object holds it
    "utils/profiling.py": {"StepTimer"},
}


def port_path(rel: Path) -> Path:
    s = rel.as_posix()
    if s.startswith("ops/") and s.endswith("_pallas.py"):
        s = s[:-len("_pallas.py")] + "_cuda.py"
    elif s == "utils/torch_import.py":
        s = "utils/torchvision_import.py"
    return PORT / s


def jax_modules() -> list[Path]:
    return sorted(p.relative_to(JAX) for p in JAX.rglob("*.py"))


def public_names(path: Path) -> set[str]:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.startswith("_")}


def defined_names(path: Path) -> set[str]:
    """Public top-level defs and classes only: what a module adds."""
    return {n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}


def flags(path: Path) -> set[str]:
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "add_argument":
            found |= {a.value for a in node.args
                      if isinstance(a, ast.Constant)
                      and isinstance(a.value, str) and a.value.startswith("--")}
    return found


def test_every_jax_module_has_its_port_module():
    missing = [rel.as_posix() for rel in jax_modules()
               if not port_path(rel).is_file()
               and ALLOWED.get(rel.as_posix(), ()) is not None]
    assert not missing, missing


def test_every_public_jax_name_is_in_its_port_module():
    gaps = {}
    for rel in jax_modules():
        allowed = ALLOWED.get(rel.as_posix(), set())
        if allowed is None:
            continue
        lost = defined_names(JAX / rel) - public_names(port_path(rel)) \
            - allowed
        if lost:
            gaps[rel.as_posix()] = sorted(lost)
    assert not gaps, gaps


def test_every_jax_cli_flag_is_in_its_port_cli():
    gaps = {}
    for rel in jax_modules():
        if rel.parts[0] != "cli":
            continue
        lost = flags(JAX / rel) - flags(port_path(rel))
        if lost:
            gaps[rel.as_posix()] = sorted(lost)
    assert not gaps, gaps


@pytest.mark.parametrize("module", sorted(ALLOWED))
def test_the_allow_list_names_real_gaps(module):
    """Each allowed module or name exists in the JAX package and is absent
    from the port, so the list cannot outlive a port of it."""
    allowed = ALLOWED[module]
    assert (JAX / module).is_file()
    if allowed is None:
        assert not port_path(Path(module)).exists()
        return
    assert allowed <= defined_names(JAX / module)
    assert not allowed & public_names(port_path(Path(module)))
