"""``final_queue_p95_ms.live``: the 95th percentile (nearest rank) over
the window's finished finals of the time each waited in the engine before
its group began: the group's start (its record's ``prep``) less the
request's submission, in ms. The engine queue's layer: the batching
window, grouping, the pipeline's groups in flight and the device lock.
Never above ``final_wait_p95_ms.live``, which adds the harness's send and
the result's hand-back. Program span (``benchmark/core/spans.py``)."""

from benchmark.core.spans import queue_p95_ms


def read(run):
    return queue_p95_ms(run, "final")
