"""Replay of a module's eval-mode forward as captured CUDA graphs.

``replay_eval_forward(name, max_graphs, when)`` decorates a module class:
the style encoders (``models/style_encoders/register``: one tensor in, a
list of taps out) and G's decoder (``models/decoder.py``: content, AdaIN
parameters and the style pyramid in, one image out).  Each argument of the
forward is a tensor, a list or tuple of tensors, or a hashable non-tensor;
the forward returns a tensor or a list of tensors.  A call that passes
its arguments by position replays a CUDA graph of that forward when
everything it needs can be read from the call itself:

  * the module is in eval mode (the 4-phase train step runs G in train
    mode under ``no_grad``, ``frozen_stats``: that pass stays eager);
  * grad is off (``no_grad`` or ``inference_mode``);
  * no ``TorchDispatchMode`` watches the ops (``FlopCounterMode``,
    ``utils/profiling.ByteCounter``, fake tensors): a replay would hide
    them, so ``op_counts`` counts the eager forward;
  * the tensors are CUDA tensors;
  * no stream capture is under way;
  * the class's own predicate ``when(module)``, where it gives one, holds
    (the decoder's: every int8 conv site in the float path).

Any other call runs the eager forward.  A graph is kept per input
signature (each tensor's shape, strides, dtype and device, each
non-tensor's value), at most ``cls.MAX_GRAPHS`` a module (set from the
decorator's ``max_graphs`` and read at each capture), the least recently
used dropped first.  The first call of a signature warms the forward once
on a side stream (cuDNN's and cuBLAS's first-call set-up stays out of the
capture), captures it into static inputs with the caller's strides
(``empty_like`` of a dense input: a channels-last view stays one, so
cuDNN picks the convolutions the eager call picks), then replays it.  A
replay copies each tensor into its static buffer, replays the graph on
the current stream and returns fresh clones of the outputs, never the
static ones: callers keep the outputs across calls.  Forward hooks on
the module fire around the replay, once a call; hooks on its submodules,
spans opened inside the forward and host-side counters
(``in_relu.launches``, ``phase_head.launches*``, ``cuda_build.count_work``)
see the eager calls and a capture's warm-up and capture, never a replay.

The graph reads the parameters and buffers by address, so in-place
updates (``load_state_dict``, optimizer steps, ``copy_``) reach it;
``train(mode)``, where it changes the module's mode, and ``_apply``
(``.to()``, ``.half()``, ...) drop the module's graphs, and so does
``drop_graphs(module)``.  Rebinding a parameter's storage in any other way
(``p.data = ...``) needs one of those calls after it.

Under a profiler the captures and replays open the spans
``<name>.capture`` and ``<name>.replay`` (``utils/profiling.span``).
"""

from __future__ import annotations

import functools
import weakref
from collections import OrderedDict
from typing import Callable

import torch
from torch import nn
from torch.utils._python_dispatch import _get_current_dispatch_mode

from affganwriting_torch.utils.profiling import span

# kept outside the modules, so that copies, pickles and state dicts of a
# module never meet a graph; an entry goes with its module
_GRAPHS: "weakref.WeakKeyDictionary[nn.Module, OrderedDict]" = (
    weakref.WeakKeyDictionary())


def _tensors(args) -> list[torch.Tensor]:
    """The tensors of ``args`` in order, sequences flattened."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _sig(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.stride(), t.dtype, t.device


def signature(args) -> tuple | None:
    """The key of a call's arguments, or None where one cannot be made (a
    sequence that mixes tensors and other values, an unhashable value)."""
    key = []
    for a in args:
        if isinstance(a, torch.Tensor):
            key.append(_sig(a))
        elif isinstance(a, (list, tuple)) and any(
                isinstance(t, torch.Tensor) for t in a):
            if not all(isinstance(t, torch.Tensor) for t in a):
                return None
            key.append((type(a), tuple(map(_sig, a))))
        else:
            try:
                hash(a)
            except TypeError:
                return None
            key.append(("value", a))
    return tuple(key)


def _rebuild(args, tensors: list[torch.Tensor]) -> tuple:
    """``args`` with its tensors replaced, in order, by ``tensors``."""
    it = iter(tensors)
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(next(it))
        elif isinstance(a, (list, tuple)) and any(
                isinstance(t, torch.Tensor) for t in a):
            out.append(type(a)(next(it) for _ in a))
        else:
            out.append(a)
    return tuple(out)


def replayable(module: nn.Module, *args) -> bool:
    """Whether ``module(*args)`` replays a graph (the module docstring's
    conditions)."""
    tensors = _tensors(args)
    when = getattr(type(module), "_replay_when", None)
    return (bool(tensors) and not module.training
            and not torch.is_grad_enabled()
            and _get_current_dispatch_mode() is None and _on_card(tensors)
            and (when is None or when(module)))


def _on_card(tensors: list[torch.Tensor]) -> bool:
    """CUDA tensors on one device, and no stream capture under way to nest
    in."""
    dev = tensors[0].device
    return (dev.type == "cuda" and all(t.device == dev for t in tensors)
            and not torch.cuda.is_current_stream_capturing())


def signatures(module: nn.Module) -> list[tuple]:
    """The input signatures ``module`` holds graphs of, oldest use first."""
    return list(_GRAPHS.get(module, ()))


def drop_graphs(module: nn.Module) -> None:
    _GRAPHS.pop(module, None)


def _clones(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    return [t.clone() for t in out]


class _Graph:
    """One captured forward: its static inputs, the graph and its static
    outputs."""

    def __init__(self, forward, args):
        # plain tensors, which a later call under no_grad may write too (an
        # inference tensor would refuse it outside inference_mode)
        tensors = _tensors(args)
        with torch.inference_mode(False):
            self.inputs = [torch.empty_like(t) for t in tensors]
        for s, t in zip(self.inputs, tensors):
            s.copy_(t)
        self.args = _rebuild(args, self.inputs)
        self.outputs = self._capture(forward)

    def _capture(self, forward):
        """Warm ``forward`` on the static inputs, capture it into
        ``self.graph``; returns its static outputs."""
        dev = self.inputs[0].device
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                forward(*self.args)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side,
                                  capture_error_mode="thread_local"):
                return forward(*self.args)

    def __call__(self, args):
        for s, t in zip(self.inputs, _tensors(args)):
            s.copy_(t)
        self.graph.replay()
        return _clones(self.outputs)


def replay_eval_forward(name: str, max_graphs: int,
                        when: Callable[[nn.Module], bool] | None = None):
    """Class decorator: the class's forward replays as the module
    docstring says, keeping at most ``max_graphs`` signatures a module
    (``cls.MAX_GRAPHS``) and, with ``when``, only while ``when(module)``
    holds; its spans are ``<name>.capture`` and ``<name>.replay``."""

    def decorate(cls):
        eager = cls.forward
        base_train, base_apply = cls.train, cls._apply

        @functools.wraps(eager)
        def forward(self, *args, **kwargs):
            key = (signature(args) if not kwargs and replayable(self, *args)
                   else None)
            if key is None:
                return eager(self, *args, **kwargs)
            graphs = _GRAPHS.setdefault(self, OrderedDict())
            graph = graphs.get(key)
            if graph is None:
                with span(f"{name}.capture"):
                    graph = _Graph(functools.partial(eager, self), args)
                if len(graphs) >= type(self).MAX_GRAPHS:
                    graphs.popitem(last=False)
                graphs[key] = graph
            else:
                graphs.move_to_end(key)
            with span(f"{name}.replay"):
                return graph(args)

        def train(self, mode: bool = True):
            if mode != self.training:
                drop_graphs(self)
            return base_train(self, mode)

        def _apply(self, fn, *args, **kwargs):
            drop_graphs(self)
            return base_apply(self, fn, *args, **kwargs)

        cls.forward, cls.train, cls._apply = forward, train, _apply
        cls.MAX_GRAPHS = max_graphs
        cls._replay_when = staticmethod(when) if when is not None else None
        return cls

    return decorate
