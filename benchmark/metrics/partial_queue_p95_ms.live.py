"""``partial_queue_p95_ms.live``: ``final_queue_p95_ms.live``'s reading
over the window's finished partials: the 95th percentile (nearest rank) of
their group's start less their submission, in ms. Program span
(``benchmark/core/spans.py``)."""

from benchmark.core.spans import queue_p95_ms


def read(run):
    return queue_p95_ms(run, "partial")
