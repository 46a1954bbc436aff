"""``partial_group_ms_p50.live``: the median of the engine's
``inference_sec`` over the window's partials, in ms: a group's device
phase (host preparation and every launch) through its harvest."""

from benchmark.core.stats import median


def read(run):
    reqs = [r for r in run.counted("partial") if r.ok]
    if not reqs:
        return None
    return 1e3 * median([r.output.inference_sec for r in reqs])
