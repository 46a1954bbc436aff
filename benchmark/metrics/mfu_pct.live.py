"""``mfu_pct.live``: the model step's share of the card's bf16 peak: the
matrix-product FLOPs of the requests whose group ran wholly inside the
traced stretch (each counted at its bucket with the tokens it produced,
``benchmark/core/flops.py``), over the card's busy seconds across those
groups, over 989 TFLOP/s, in %."""

from benchmark.core.readers import mfu_pct as read  # noqa: F401
