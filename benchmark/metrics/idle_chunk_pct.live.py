"""``idle_chunk_pct.live``: the share of the traced stretch in which no
operation ran on the card and the engine thread was in **chunk** (a decode
chunk's replay, or the host's read of its finish flag before the next
chunk): the model step's layer, in %. With its two siblings it sums to
``device_idle_pct.live``. Device trace and the engine's span records
(``benchmark/core/spans.py`` ``idle_split``)."""

from benchmark.core.spans import idle_split


def read(run):
    split = idle_split(run)
    return None if split is None else split["chunk"]
