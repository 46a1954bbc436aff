"""``final_wait_p95_ms.live``: the 95th percentile over the window's
finals of the time a final waited before its group's device phase began:
due-to-result latency less the engine's ``inference_sec`` (device phase
start to harvest end), in ms. The engine queue's layer: its batching
window, grouping and the pipeline's two groups in flight."""

from benchmark.core.stats import percentile


def read(run):
    reqs = [r for r in run.counted("final") if r.ok]
    if not reqs:
        return None
    return 1e3 * percentile([(r.done - r.due) - r.output.inference_sec for r in reqs], 95)
