"""Spans recorded from the benchmark's own side: CUDA events and
``record_function`` ranges opened and closed by forward hooks on the
program's modules.  Only a traced run installs them."""

from __future__ import annotations

import collections

import torch


class Spans:
    def __init__(self):
        self.pairs = collections.defaultdict(list)
        self.handles = []
        self._open = {}

    def between(self, name: str, first, last=None):
        """A span ``name`` from the start of ``first``'s forward to the end
        of ``last``'s (``first``'s own by default)."""
        last = last or first

        def pre(mod, args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            rf = torch.autograd.profiler.record_function(name)
            rf.__enter__()
            self._open[name] = (ev, rf)

        def post(mod, args, out):
            ev, rf = self._open.pop(name)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            rf.__exit__(None, None, None)
            self.pairs[name].append((ev, end))

        self.handles.append(first.register_forward_pre_hook(pre))
        self.handles.append(last.register_forward_hook(post))

    def ms(self, name: str) -> list[float]:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.pairs.get(name, [])]

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles = []
