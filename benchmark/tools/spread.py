"""The spread of each metric over runs, for setting a cell's bounds.

    python3 benchmark/tools/spread.py SET1.jsonl SET2.jsonl

Each file holds one set's result lines (the last stdout line of each run
of ``benchmark/run.py``), one JSON object a line. For every metric the tool
prints each set's median and spread (the distance between the first and
third quartile of ``statistics.quantiles(values, n=4)`` over the median),
the wider spread, five times it (the bound to set, never under 1%), and
how far the second set's median lies from the first's. It also prints the
spread that leaves out each set's run farthest from its median, which is
what a check of tightness reads.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.core.stats import spread  # noqa: E402


def load(path: str):
    rows = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if line.startswith("{"):
            rows.append(json.loads(line))
    return rows


def trimmed(values):
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]


def main() -> int:
    sets = [load(p) for p in sys.argv[1:]]
    names = sorted({m for s in sets for r in s for m in r["metrics"]})
    for name in names:
        cols = [[r["metrics"][name]["value"] for r in s if name in r["metrics"]] for s in sets]
        cols = [c for c in cols if len(c) >= 2]
        if not cols:
            continue
        spreads = [spread(c) for c in cols]
        trim = [spread(trimmed(c)) for c in cols if len(c) >= 4]
        meds = [statistics.median(c) for c in cols]
        wide = max(spreads)
        print(json.dumps({
            "metric": name, "runs": [len(c) for c in cols], "medians": meds,
            "spreads": spreads, "trimmed_spreads": trim, "widest": wide,
            "bound_5x": max(0.01, 5 * wide),
            "second_vs_first": (meds[-1] - meds[0]) / meds[0] if len(meds) > 1 else None,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
