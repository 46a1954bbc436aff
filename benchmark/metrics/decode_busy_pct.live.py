"""``decode_busy_pct.live``: the share of the traced stretch's busy time
taken by device operations launched from a decode chunk's ``replay``
interval (the captured decode steps), against the log-mel, encoder,
detection and prefill launches, in %. Device trace (each operation's
launching host call) and the engine's span records
(``benchmark/core/spans.py``)."""

from benchmark.core.spans import decode_busy_pct as read  # noqa: F401
