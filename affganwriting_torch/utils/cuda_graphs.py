"""Replay of a module's eval-mode forward as captured CUDA graphs.

``replay_eval_forward(name)`` decorates a module class whose ``forward``
takes one tensor and returns a list of tensors (the style encoders,
``models/style_encoders/register``).  A call replays a CUDA graph of that
forward when everything it needs can be read from the call itself:

  * the module is in eval mode (the 4-phase train step runs G in train
    mode under ``no_grad``, ``frozen_stats``: that pass stays eager);
  * grad is off (``no_grad`` or ``inference_mode``);
  * no ``TorchDispatchMode`` watches the ops (``FlopCounterMode``,
    ``utils/profiling.ByteCounter``, fake tensors): a replay would hide
    them, so ``op_counts`` counts the eager forward;
  * the input is a CUDA tensor;
  * no stream capture is under way.

Any other call runs the eager forward.  A graph is kept per input
signature (shape, strides, dtype, device), at most ``MAX_GRAPHS`` a
module, the least recently used dropped first.  The first call of a
signature warms the forward once on a side stream (cuDNN's and cuBLAS's
first-call set-up stays out of the capture), captures it into a static
input with the caller's strides (``empty_like`` of a dense input: a
channels-last view stays one, so cuDNN picks the convolutions the eager
call picks), then replays it.  A
replay copies the input into the static buffer, replays the graph on the
current stream and returns fresh clones of the outputs, never the static
ones: callers keep the outputs across calls.  Forward hooks on the module
fire around the replay, once a call; hooks on its submodules fire only
while a signature is captured.

The graph reads the parameters and buffers by address, so in-place
updates (``load_state_dict``, optimizer steps, ``copy_``) reach it;
``train()``/``eval()`` and ``_apply`` (``.to()``, ``.half()``, ...) drop
the module's graphs.  Rebinding a parameter's storage in any other way
(``p.data = ...``) needs one of those calls after it.

Under a profiler the captures and replays open the spans
``<name>.capture`` and ``<name>.replay`` (``utils/profiling.span``).
"""

from __future__ import annotations

import functools
import weakref
from collections import OrderedDict

import torch
from torch import nn
from torch.utils._python_dispatch import _get_current_dispatch_mode

from affganwriting_torch.utils.profiling import span

MAX_GRAPHS = 4

# kept outside the modules, so that copies, pickles and state dicts of a
# module never meet a graph; an entry goes with its module
_GRAPHS: "weakref.WeakKeyDictionary[nn.Module, OrderedDict]" = (
    weakref.WeakKeyDictionary())


def replayable(module: nn.Module, x: torch.Tensor) -> bool:
    """Whether ``module(x)`` replays a graph (the module docstring's
    conditions)."""
    return (not module.training and not torch.is_grad_enabled()
            and _get_current_dispatch_mode() is None and _on_card(x))


def _on_card(x: torch.Tensor) -> bool:
    """A CUDA input, and no stream capture under way to nest in."""
    return x.is_cuda and not torch.cuda.is_current_stream_capturing()


def signatures(module: nn.Module) -> list[tuple]:
    """The input signatures ``module`` holds graphs of, oldest use first."""
    return list(_GRAPHS.get(module, ()))


def drop_graphs(module: nn.Module) -> None:
    _GRAPHS.pop(module, None)


class _Graph:
    """One captured forward: its static input, the graph and its static
    outputs."""

    def __init__(self, forward, x: torch.Tensor):
        dev = x.device
        with torch.cuda.device(dev):
            # a plain tensor, which a later call under no_grad may write
            # too (an inference tensor would refuse it outside
            # inference_mode)
            with torch.inference_mode(False):
                self.input = torch.empty_like(x)
            self.input.copy_(x)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                forward(self.input)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side,
                                  capture_error_mode="thread_local"):
                self.outputs = forward(self.input)

    def __call__(self, x: torch.Tensor) -> list[torch.Tensor]:
        self.input.copy_(x)
        self.graph.replay()
        return [t.clone() for t in self.outputs]


def replay_eval_forward(name: str):
    """Class decorator: the class's forward replays as the module
    docstring says; its spans are ``<name>.capture`` and
    ``<name>.replay``."""

    def decorate(cls):
        eager = cls.forward
        base_train, base_apply = cls.train, cls._apply

        @functools.wraps(eager)
        def forward(self, x):
            if not replayable(self, x):
                return eager(self, x)
            graphs = _GRAPHS.setdefault(self, OrderedDict())
            key = (tuple(x.shape), x.stride(), x.dtype, x.device)
            graph = graphs.get(key)
            if graph is None:
                with span(f"{name}.capture"):
                    graph = _Graph(functools.partial(eager, self), x)
                if len(graphs) >= MAX_GRAPHS:
                    graphs.popitem(last=False)
                graphs[key] = graph
            else:
                graphs.move_to_end(key)
            with span(f"{name}.replay"):
                return graph(x)

        def train(self, mode: bool = True):
            drop_graphs(self)
            return base_train(self, mode)

        def _apply(self, fn, *args, **kwargs):
            drop_graphs(self)
            return base_apply(self, fn, *args, **kwargs)

        cls.forward, cls.train, cls._apply = forward, train, _apply
        return cls

    return decorate
