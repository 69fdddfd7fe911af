"""The collectives a sharded program calls, and its random draws.

GSPMD partitions one global program and inserts its collectives itself;
here each device is a process running the same eager program on its slice,
and the collectives are written out.  Every one of them is a sum
all-reduce: gloo carries only ``broadcast``, ``all_reduce`` and ``barrier``
for CUDA tensors, so an all-gather is the all-reduce of a zero-padded
buffer, on every backend alike.  Floats travel in f32 (a bf16 value plus
zeros is exact there), integers in int64.  A group of one process is no
collective at all: the value passes through untouched.

The autograd rules follow from how the sharded step forms its loss: each
data rank computes its part of the global loss, and the ranks of one
model group compute the same part.

* ``all_reduce_sum`` (batch statistics over the data group): the global
  loss is the sum of the ranks' parts, so the gradient of the sum is the
  sum of the ranks' gradients: backward is the same all-reduce.
* ``gather_cat`` (tensor-parallel outputs over the model group): every
  model rank holds the same loss, so each shard's gradient is its own
  slice of the full one: backward is the slice.
* ``all_reduce_model`` (tensor-parallel partial sums over the model
  group): backward passes the gradient through, for the same reason.
* ``model_input`` (the replicated input of a tensor-parallel layer):
  forward passes it through; each model rank's layer reads only its
  block of the weight, so the input's gradient is a partial sum, and
  backward sums it over the model group.

``batch_shard`` makes every random draw of a batch-shaped tensor draw the
global batch's values and keep this rank's rows, so the sharded step draws
what the single-process step draws from the same-seeded generator (the JAX
step draws the global batch's masks from one key).
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

# (data rank, data size) while a data-sharded program runs, else None
_BATCH_SHARD: tuple[int, int] | None = None


@contextlib.contextmanager
def batch_shard(rank: int, size: int):
    """Inside the block, ``batch_random`` draws the global batch's values
    (``size`` times this rank's rows) and keeps rank ``rank``'s rows."""
    global _BATCH_SHARD
    before, _BATCH_SHARD = _BATCH_SHARD, (rank, size) if size > 1 else None
    try:
        yield
    finally:
        _BATCH_SHARD = before


def batch_random(fn, shape, generator, device, batch_dim: int = 0,
                 dtype=None) -> torch.Tensor:
    """``fn(shape, generator=..., device=...)`` (``torch.rand`` or
    ``torch.randn``) of a tensor whose ``batch_dim`` runs over the batch;
    under ``batch_shard`` the draw covers the global batch and this rank's
    rows are returned."""
    kw = {"generator": generator, "device": device}
    if dtype is not None:
        kw["dtype"] = dtype
    if _BATCH_SHARD is None:
        return fn(tuple(shape), **kw)
    rank, size = _BATCH_SHARD
    full = list(shape)
    n = full[batch_dim]
    full[batch_dim] = n * size
    return fn(tuple(full), **kw).narrow(batch_dim, rank * n, n)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` in the dtype it is reduced in."""
    if x.is_floating_point():
        return x.detach().float().clone()
    return x.detach().long().clone()


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, outside autograd, in ``x``'s
    dtype."""
    if group_size(group) == 1:
        return x
    y = _wire(x)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of a float tensor over ``group``; backward sums
    the gradients the same way."""
    if group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


class _AllReduceModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = _wire(x)
        dist.all_reduce(y, group=group)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_model(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of the model ranks' partial results; backward passes the
    (replicated) gradient through."""
    if group_size(group) == 1:
        return x
    return _AllReduceModel.apply(x, group)


class _ModelInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = _wire(grad)
        dist.all_reduce(g, group=ctx.group)
        return g.to(grad.dtype), None


def model_input(x: torch.Tensor, group) -> torch.Tensor:
    """The replicated input of a tensor-parallel layer: itself forward,
    its gradient summed over the model group backward."""
    if group_size(group) == 1:
        return x
    return _ModelInput.apply(x, group)


def _padded(x: torch.Tensor, rank: int, size: int, dim: int) -> torch.Tensor:
    """``x`` at block ``rank`` of ``size`` along ``dim``, zeros elsewhere,
    in its wire dtype."""
    shape = list(x.shape)
    n = shape[dim]
    shape[dim] = n * size
    w = _wire(x)
    buf = torch.zeros(shape, dtype=w.dtype, device=x.device)
    buf.narrow(dim, rank * n, n).copy_(w)
    return buf


class _GatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size, dim):
        ctx.rank, ctx.n, ctx.dim = rank, x.shape[dim], dim
        buf = _padded(x, rank, size, dim)
        dist.all_reduce(buf, group=group)
        return buf.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None,
                None, None)


def gather_cat(x: torch.Tensor, group, rank: int, size: int,
               dim: int) -> torch.Tensor:
    """The ``size`` ranks' equal blocks of ``x`` concatenated along
    ``dim`` in rank order, on every rank; backward keeps this rank's
    block of the gradient."""
    if size == 1:
        return x
    return _GatherCat.apply(x, group, rank, size, dim)


@torch.no_grad()
def gather_rows(x: torch.Tensor, group, rank: int, size: int) -> torch.Tensor:
    """The ``size`` ranks' rows of ``x`` (equal counts) stacked along dim
    0 in rank order, on every rank, outside autograd."""
    if size == 1:
        return x
    buf = _padded(x, rank, size, 0)
    dist.all_reduce(buf, group=group)
    return buf.to(x.dtype)


@torch.no_grad()
def reduce_tensors(tensors, group) -> None:
    """Sum float ``tensors`` over ``group`` in place, in one coalesced
    all-reduce."""
    tensors = list(tensors)
    if group_size(group) == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    i = 0
    for t in tensors:
        t.copy_(flat[i: i + t.numel()].view_as(t))
        i += t.numel()


def reduce_grads(params, group) -> None:
    """Sum the ``.grad`` of ``params`` over ``group`` in place
    (``reduce_tensors``).  A parameter without a gradient keeps none: the
    same graph runs on every rank, so they agree on which."""
    reduce_tensors((p.grad for p in params if p.grad is not None), group)


@torch.no_grad()
def reduce_values(values: dict, group) -> dict:
    """A dict of scalar tensors summed over ``group`` in one all-reduce,
    as f32 tensors on their device."""
    if group_size(group) == 1 or not values:
        return values
    keys = list(values)
    flat = torch.stack([torch.as_tensor(values[k]).float().reshape(())
                        for k in keys])
    dist.all_reduce(flat, group=group)
    return dict(zip(keys, flat.unbind()))
