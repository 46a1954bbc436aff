"""``idle_launch_pct.live``: the share of the traced stretch in which no
operation ran on the card and the engine thread was in **launch** (a
group's host preparation, copies and eager launches: prep, h2d, encode,
detect, prefill, pack): the engine group's layer, in %. With its two
siblings it sums to ``device_idle_pct.live``. Device trace and the
engine's span records (``benchmark/core/spans.py`` ``idle_split``)."""

from benchmark.core.spans import idle_split


def read(run):
    split = idle_split(run)
    return None if split is None else split["launch"]
