"""``idle_wait_pct.live``: the share of the traced stretch in which no
operation ran on the card and the engine thread was in **wait** (an empty
queue, the batching window, grouping, a place among the groups in flight,
the device lock): the engine queue's layer, in %. With its two siblings it
sums to ``device_idle_pct.live``. Device trace and the engine's span
records (``benchmark/core/spans.py`` ``idle_split``)."""

from benchmark.core.spans import idle_split


def read(run):
    split = idle_split(run)
    return None if split is None else split["wait"]
