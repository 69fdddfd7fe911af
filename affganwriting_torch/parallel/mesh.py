"""The ('data', 'model') mesh over ``torch.distributed`` and the sharding
rules, one process per device.

Port of ``affganwriting_tpu/parallel/mesh.py``.  The JAX package builds a
``Mesh`` of devices and lets GSPMD partition one global program; here every
rank is a process, the mesh is a ``DeviceMesh`` over the initialized
process group (rank ``d * model + m`` at data index ``d``, model index
``m``, as the JAX mesh reshapes its device list), and the program each
rank runs on its slice calls the collectives of ``parallel/ops.py``:

* the 'data' axis carries the batch: dim 0 is split over it
  (``shard_batch``), train-mode BatchNorm statistics are summed over its
  group (``models/blocks.py``), and each player's gradients are summed over
  it before its optimizer step (``train/step.py``);
* the 'model' axis carries the tensor-parallel shards of ``_TP_RULES``,
  the same leaves the JAX rules shard: the text encoder's FC pyramid on its
  output features (the port's weights are (out, in), so dim 0) and the
  mix's kernel on its input rows (``SplitMix.weight`` is (features,
  ds + dc), so dim 1: at model=2 with ds = dc one rank holds the style
  half and the other the content half).  Everything else replicates.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any

import numpy as np
import torch
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``DeviceMesh`` with dims ('data', 'model') and the device this
    rank's tensors live on."""

    device_mesh: Any
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.device_mesh.mesh_dim_names,
                        self.device_mesh.shape))

    @property
    def data(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def model(self) -> int:
        return self.shape[MODEL_AXIS]

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def rank(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    @property
    def data_group(self):
        return self.group(DATA_AXIS)

    @property
    def data_rank(self) -> int:
        return self.rank(DATA_AXIS)


def make_mesh(data: int | None = None, model: int = 1, *,
              device=None) -> Mesh:
    """The (data, model) mesh over every rank of the initialized process
    group; ``data`` defaults to world // model.  ``device`` is this rank's
    (``None``: the CUDA card of ``torch.cuda.current_device()``; pass
    ``device="cpu"`` for the CPU)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from affganwriting_torch.gen.inference import resolve_device

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group: "
                           "call parallel/multihost.init_distributed first")
    n = dist.get_world_size()
    if data is None:
        if n % model:
            raise ValueError(f"{n} ranks not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    grid = torch.arange(n, dtype=torch.int).reshape(data, model)
    return Mesh(DeviceMesh(dev.type, grid,
                           mesh_dim_names=(DATA_AXIS, MODEL_AXIS)), dev)


def mesh_dims(spec: str, world_size: int) -> tuple[int, int] | None:
    """CLI mesh spec -> (data, model): ``'none'``/'' -> None (one
    device), ``'auto'`` -> (world, 1), ``'8'`` -> (8, 1), ``'4x2'`` ->
    (4, 2).  A spec that does not match ``world_size`` raises."""
    if not spec or spec == "none":
        return None
    if spec == "auto":
        return world_size, 1
    try:
        d, m = spec.split("x") if "x" in spec else (spec, "1")
        data, model = int(d), int(m)
    except ValueError:
        raise ValueError(f"mesh spec {spec!r}: expected 'none', 'auto', "
                         "'N' or 'DxM'") from None
    if data * model != world_size:
        raise ValueError(
            f"mesh spec {spec!r} needs {data * model} processes, but "
            f"WORLD_SIZE is {world_size}")
    return data, model


def parse_mesh_spec(spec: str, *, device=None) -> Mesh | None:
    """CLI mesh spec -> Mesh over the initialized process group (see
    ``mesh_dims``)."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    dims = mesh_dims(spec, world)
    if dims is None:
        return None
    return make_mesh(*dims, device=device)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _rows(mesh: Mesh, n: int) -> tuple[int, int]:
    if n % mesh.data:
        raise ValueError(
            f"batch {n} does not divide over the {mesh.data}-way data "
            "axis; pad or trim it")
    k = n // mesh.data
    return mesh.data_rank * k, k


def _place(mesh: Mesh, x):
    if isinstance(x, torch.Tensor):
        return x.to(mesh.device)
    return x


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """The global batch (a tree of numpy arrays or tensors) -> this rank's
    slice of dim 0 (tensors on the mesh's device, numpy stays on the
    host).  A leading size that does not divide over 'data' raises."""
    def one(x):
        if not isinstance(x, (np.ndarray, torch.Tensor)):
            return x
        lo, k = _rows(mesh, x.shape[0])
        return _place(mesh, x[lo: lo + k])

    return _tree_map(one, batch)


def batch_sharding(mesh: Mesh) -> tuple:
    """The layout ``shard_batch`` gives, in DTensor's spelling over the
    mesh's (data, model) dims: dim 0 split over 'data', whole on every
    model rank."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Replicate())


def replicated(mesh: Mesh, tree: Any) -> Any:
    """A value every rank holds whole: its tensors on the mesh's device."""
    return _tree_map(lambda x: _place(mesh, x), tree)


# --- tensor-parallel rules -------------------------------------------------
# parameter-name regex -> the dim split over 'model'.  The JAX rules on
# flax's (in, out) kernels, written on the port's (out, in) weights.
_TP_RULES: list[tuple[str, int]] = [
    # TextEncoderFC pyramid: the output features
    (r"(^|\.)text_encoder\.fc\d\.weight$", 0),
    (r"(^|\.)text_encoder\.fc\d\.bias$", 0),
    # the mix: the input rows (style rows then content rows)
    (r"(^|\.)linear_mix\.weight$", 1),
]


@dataclasses.dataclass(frozen=True)
class TPShard:
    """Set as ``module.tp`` on a module whose parameters hold this rank's
    shard: the model group, this rank's index in it and its size."""

    group: Any
    rank: int
    size: int


def _spec_for(name: str) -> int | None:
    for pat, dim in _TP_RULES:
        if re.search(pat, name):
            return dim
    return None


def _named(params) -> dict:
    return (dict(params.named_parameters()) if isinstance(params, nn.Module)
            else dict(params))


def param_shardings(mesh: Mesh, params, *,
                    expect_tp: bool = False) -> dict[str, int | None]:
    """{parameter name: the dim split over 'model', or None (replicated)}
    for a module or a {name: tensor} dict.

    With ``expect_tp`` on a mesh whose model axis is >1, at least one
    parameter must match a TP rule: a regex that silently stops matching
    would otherwise degrade tensor parallelism to replication with nothing
    failing.  Leave it off for modules that legitimately replicate (the
    recognizer in the serving pipeline)."""
    out = {}
    for name, p in _named(params).items():
        dim = _spec_for(name)
        out[name] = dim if dim is not None and dim < p.dim() else None
    if (expect_tp and mesh.model > 1
            and all(d is None for d in out.values())):
        raise ValueError(
            "mesh has a model axis >1 but no parameter name matched "
            "_TP_RULES: tensor parallelism would silently degrade to "
            "replication (parameter-name regex drift?)")
    return out


def _owner(module: nn.Module, name: str):
    path, _, leaf = name.rpartition(".")
    return (module.get_submodule(path) if path else module), leaf


def shard_params(mesh: Mesh, module: nn.Module, *,
                 expect_tp: bool = False) -> nn.Module:
    """Place ``module`` on the mesh in place: each TP-ruled parameter keeps
    this rank's block of its split dim (``p.tp_dim``, ``p.tp_full`` and
    ``p.tp_shard`` record it; the owning module gets ``tp``), and every
    train-mode ``BatchNorm`` sums its statistics over the 'data' group.
    Placing a placed module again changes nothing."""
    from affganwriting_torch.models.blocks import BatchNorm

    specs = param_shardings(mesh, module, expect_tp=expect_tp)
    m, r = mesh.model, mesh.rank(MODEL_AXIS)
    for name, dim in specs.items():
        if dim is None or m == 1:
            continue
        owner, leaf = _owner(module, name)
        p = getattr(owner, leaf)
        if hasattr(p, "tp_dim"):
            continue
        full = p.shape[dim]
        if full % m:
            raise ValueError(f"{name}: dim {dim} of {tuple(p.shape)} does "
                             f"not divide over the {m}-way model axis")
        k = full // m
        with torch.no_grad():
            p.data = p.data.narrow(dim, r * k, k).clone()
        owner.tp = TPShard(mesh.group(MODEL_AXIS), r, m)
        p.tp_dim, p.tp_full, p.tp_shard = dim, full, owner.tp
    group = mesh.data_group if mesh.data > 1 else None
    for bn in module.modules():
        if isinstance(bn, BatchNorm):
            bn.group = group
    return module


def _modules_and_optimizers(state) -> tuple[list, list]:
    """The modules and the ``torch.optim`` optimizers of a trainer state
    (a dataclass of modules, optimizers and dataclasses of them)."""
    mods, opts = [], []

    def walk(x):
        if isinstance(x, nn.Module):
            mods.append(x)
        elif isinstance(x, torch.optim.Optimizer):
            opts.append(x)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(getattr(x, "opt", None), torch.optim.Optimizer):
            opts.append(x.opt)    # train/schedules.PartitionedAdam

    walk(state)
    return mods, opts


def shard_state(mesh: Mesh, state):
    """Place a whole trainer state on the mesh in place: the TP rules on
    its modules' parameters AND on the optimizer moments that track them
    (a moment shaped like the full parameter keeps the same block), the
    BatchNorm groups, everything else replicated.  A whole state always
    holds the TP-ruled layers when a model axis is in use, so the rules'
    coverage is asserted here (see ``param_shardings``)."""
    mods, opts = _modules_and_optimizers(state)
    if mesh.model > 1 and not any(
            d is not None for mod in mods
            for d in param_shardings(mesh, mod).values()):
        param_shardings(mesh, {}, expect_tp=True)     # raises
    for mod in mods:
        shard_params(mesh, mod)
    _narrow_moments(opts)
    return state


def _block(p, v: torch.Tensor) -> torch.Tensor:
    """This rank's block of ``v``, a full-size value of sharded ``p``."""
    k = p.tp_full // p.tp_shard.size
    return v.narrow(p.tp_dim, p.tp_shard.rank * k, k).clone()


def _tracks(p, v) -> bool:
    return isinstance(v, torch.Tensor) and v.dim() == p.dim()


def _moments(opts):
    """(parameter, its optimizer state) of every sharded parameter."""
    for opt in opts:
        for p, st in opt.state.items():
            if hasattr(p, "tp_dim"):
                yield p, st


def _narrow_moments(opts) -> None:
    for p, st in _moments(opts):
        for name, v in list(st.items()):
            if _tracks(p, v) and v.shape[p.tp_dim] == p.tp_full:
                st[name] = _block(p, v)


@contextlib.contextmanager
def unsharded(state):
    """Inside the block the state's sharded parameters and their moments
    hold their full values, gathered over the model group (every rank of
    it must enter); on leaving, each keeps its block of whatever full value
    it then holds.  A checkpoint saved inside holds the unsharded state, as
    the JAX package's holds its global arrays, and one loaded inside is
    sharded again on the way out."""
    from affganwriting_torch.parallel.ops import gather_cat

    mods, opts = _modules_and_optimizers(state)
    params = [p for mod in mods for p in mod.parameters()
              if hasattr(p, "tp_dim")]

    def full(p, v):
        t = p.tp_shard
        return gather_cat(v.detach(), t.group, t.rank, t.size, p.tp_dim)

    with torch.no_grad():
        for p, st in _moments(opts):
            for name, v in list(st.items()):
                if _tracks(p, v):
                    st[name] = full(p, v)
        for p in params:
            p.data = full(p, p.data)
    try:
        yield state
    finally:
        with torch.no_grad():
            for p in params:
                p.data = _block(p, p.data)
            # afresh: a restore inside replaces the optimizers' states
            _narrow_moments(opts)
