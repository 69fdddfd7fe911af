"""The 95th percentile of the wait from a request's due time to the start
of its service, over the requests served in the window."""

from benchmark.harness.serve import nearest_rank

LAYER = "serving entry: gen/inference.py and the benchmark's loop"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "request_p95_ms"


def read(ctx):
    q = ctx.get("queue_ms")
    return nearest_rank(q, 0.95) if q else None
