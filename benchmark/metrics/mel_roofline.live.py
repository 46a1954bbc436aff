"""``mel_roofline.live``: the log-mel kernel's share of its roofline: the
least time of every launch the trace holds whole (the larger of its
operations over the float32 peak and its bytes over HBM bandwidth, from
its rows and bucket, ``benchmark/core/flops.py``) over the launches' traced
device time, in %. The trace gives no launch shapes: the launches are
paired in order with the engine groups that made them (one a group, groups
one after another on the card; ``benchmark/core/readers.py``
``mel_pairs``), whose padded rows and bucket each takes."""

from benchmark.core.readers import mel_roofline_pct as read  # noqa: F401
