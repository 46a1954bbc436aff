"""``device_idle_pct.live``: the share of the traced stretch in which no
operation ran on the card: one less the union of the device operations'
intervals over the stretch, in %."""

from benchmark.core.readers import idle_pct as read  # noqa: F401
