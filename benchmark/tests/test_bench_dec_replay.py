"""``dec_replay_share.synth`` on hand-built Chrome traces: the share of
traced requests whose ``G.dec`` holds a ``G.dec.replay`` span; no number
without program spans or in a train cell."""

import pytest

from benchmark.harness import spec
from benchmark.tests.test_bench_program_spans import (  # noqa: F401
    BOUNDS_A,
    BOUNDS_B,
    REQUEST,
    kernel,
    program,
    span,
    traced,
)

NAME = "dec_replay_share.synth"


def requests(*replays):
    """Requests A and B of ``test_bench_program_spans`` with a kernel each;
    ``replays`` gives, per request, the bounds of its decoder's replay span
    or None."""
    events = [span(n, *b) for bounds in (BOUNDS_A, BOUNDS_B)
              for n, b in zip(REQUEST, bounds)]
    events += kernel(1, 8, 12, 7) + kernel(2, 208, 212, 207)
    events += [span("G.dec.replay", *b) for b in replays if b]
    return program(events, 2)


@pytest.mark.parametrize("replays, share", [
    (((26, 59), (226, 279)), 100.0),      # both decoders replay
    (((26, 59), None), 50.0),
    (((26, 59), (206, 219)), 50.0),       # B's replay span is in the encode
    (((26, 59), (150, 160)), 50.0),       # ... or between the requests
    (((61, 70), None), 0.0),              # A's is in R
    ((None, None), 0.0),                  # the eager decoder's spans
])
def test_share_of_requests_whose_decoder_replays(replays, share, traced):
    ctx = traced(requests(*replays), "closed")
    assert spec.metric(NAME).read(ctx) == pytest.approx(share)


def test_no_program_spans_no_number(traced):
    events = kernel(1, 2, 8, 1) + [span("gen", 0, 10), span("style", 0, 5)]
    ctx = traced(program(events, 1), "closed")
    assert spec.metric(NAME).read(ctx) is None
    assert spec.metric(NAME).read(dict(ctx, cell={"name": "absent"})) is None
    served = traced(requests((26, 59), (226, 279)), "closed")
    assert spec.metric(NAME).read(served) == pytest.approx(100.0)
    assert spec.metric(NAME).read(dict(served, kind="train")) is None
