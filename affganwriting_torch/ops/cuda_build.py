"""Builds the port's CUDA kernels and loads them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, started together) and linked into one shared library with a plain C
interface, cached under ``build/kernels/<hash of the sources and flags>/``
at the root of the checkout.  Nothing here runs at import: the first kernel
launch builds, and an ``nvcc`` failure raises.

The kernels launch through ``ctypes``, where no torch dispatch mode sees
them, so each wrapper reports its launch's work to ``count_work``;
``work_counter`` sums it (``utils/profiling.op_counts``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libaffg_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_build_lock = threading.Lock()
_work_counters: list[dict] = []


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "port's CUDA kernels are built from csrc/ at first use")
    return found


def _source_hash(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where ``build`` puts the library of the sources as they are now."""
    key = _source_hash(sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")))
    return BUILD_ROOT / key / LIB_NAME


def build() -> tuple[Path, str]:
    """Compile (if not cached) and return (library path, compiler log)."""
    units = sorted(CSRC.glob("*.cu"))
    lib = library_path()
    out_dir = lib.parent
    log_path = out_dir / "build.log"
    with _build_lock:
        if lib.is_file():
            return lib, log_path.read_text() if log_path.is_file() else ""
        nvcc = nvcc_path()
        BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT))
        try:
            procs = []
            for src in units:
                obj = tmp / f"{src.stem}.o"
                cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                procs.append((src, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            logs = []
            for src, _, proc in procs:
                text, _ = proc.communicate()
                logs.append(f"== {src.name}\n{text}")
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {src.name} (rc {proc.returncode}):"
                        f"\n{text}")
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp / LIB_NAME),
                 *(str(o) for _, o, _ in procs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
            log = "\n".join(logs)
            (tmp / "build.log").write_text(log)
            out_dir.mkdir(parents=True, exist_ok=True)
            os.replace(tmp / "build.log", log_path)
            os.replace(tmp / LIB_NAME, lib)   # atomic: readers see all or none
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return lib, log


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    lib.affg_error_string.argtypes = [ctypes.c_int]
    lib.affg_error_string.restype = ctypes.c_char_p
    return lib


def kernel(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``name`` with its argument types declared; it
    returns a cudaError_t as int."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        msg = library().affg_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def require_cuda_tensor(t: torch.Tensor, what: str) -> None:
    """The checks every kernel wrapper makes on a CUDA input."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got "
                         f"{t.device}")
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {t.dtype} not supported "
                        "(float32, bfloat16)")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def refuse_autograd(what: str, *tensors: torch.Tensor) -> None:
    """The kernels are forward-only and launch outside autograd, so with
    grad mode on an input that requires grad would give an output with no
    ``grad_fn``, and every loss behind it would silently give no gradient.
    Raise instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the kernel is forward-only and an input requires "
            "grad; call it under torch.no_grad() or torch.inference_mode(), "
            "or use the model's train mode, which does not call it")


def count_work(flops: float, nbytes: float) -> None:
    """Add one launch's work (matmul FLOPs; bytes, each input read once and
    each output written once) to every open ``work_counter``.  A launch is
    a host call: an eager call or one inside a CUDA graph's warm-up and
    capture, never a replay of the graph (``utils/cuda_graphs.py``)."""
    for c in _work_counters:
        c["flops"] += flops
        c["bytes"] += nbytes


@contextlib.contextmanager
def work_counter():
    """Yields {"flops", "bytes"}: the sums of the kernels launched inside
    the block."""
    c = {"flops": 0.0, "bytes": 0.0}
    _work_counters.append(c)
    try:
        yield c
    finally:
        _work_counters.remove(c)
