"""``partial_p95_ms.live``: the 95th percentile (nearest rank) of
due-to-result latency over every partial due inside the window, in ms, a
failed one counting as waiting until the deadline: ``partial_p95_ms``'s
number, read per layer (the engine queue, where a partial waits behind
the groups before it) in cells whose runs spread too widely for it to be
held end to end. Host clock."""

from benchmark.core.stats import percentile


def read(run):
    reqs = run.counted("partial")
    if not reqs:
        return None
    return 1e3 * percentile([run.latency_s(r) for r in reqs], 95)
