"""``partial_p95_ms``: the 95th percentile (nearest rank) of due-to-result
latency over every partial due inside the window, in ms. A partial that
failed or had no result by the deadline counts as waiting until then at
least. Host clock."""

from benchmark.core.stats import percentile


def read(run):
    reqs = run.counted("partial")
    if not reqs:
        return None
    return 1e3 * percentile([run.latency_s(r) for r in reqs], 95)
