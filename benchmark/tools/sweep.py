"""Find a live cell's knee: the most sessions the card sustains.

    python3 benchmark/tools/sweep.py --workload small.live --seed 7 \
        --sessions 32 48 64 80 --seconds 20

Builds and warms the cell's engine once, as ``benchmark/run.py`` does, then
drives the cell's traffic at each session count in turn, lowest first, and
prints one JSON line per count: partial and final p95 (ms), failures, and
whether the backlog grew (the finals due in the window's second half
against its first). It stops after two counts in a row that the card does
not sustain (final p95 over ``--final-ms``, a failure or a growing
backlog). The knee is the highest count with partial p95 under
``--partial-ms`` as well, and a live cell's ``sessions`` is 4/5 of it,
rounded; the last line also gives the highest count the card sustains
without the partial limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run as harness  # noqa: E402
from benchmark.core import manifest  # noqa: E402
from benchmark.core.records import Recorder, Run, Tracker  # noqa: E402
from benchmark.core.stats import percentile  # noqa: E402


def p95_ms(run: Run, reqs) -> float:
    return 1e3 * percentile([run.latency_s(r) for r in reqs], 95) if reqs else float("nan")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--sessions", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--partial-ms", type=float, default=300.0)
    p.add_argument("--final-ms", type=float, default=1500.0)
    args = p.parse_args()
    cell = manifest.load_cell(args.workload, False, ROOT)
    if harness.check_card(cell.chips):
        print("no card", file=sys.stderr)
        return 2
    recorder = Recorder()
    engine = harness.build_engine(cell, harness.WEIGHTS_SEED, "cuda", recorder)
    harness.check_deployment(engine, cell.config)
    cell.generator.prewarm(engine, cell.traffic, cell.config)
    engine.start()
    knee = sustained = None
    misses = 0
    try:
        for sessions in sorted(args.sessions):
            tracker = Tracker()
            traffic = dict(cell.traffic, sessions=sessions)
            ctx = harness.Context(engine, tracker, None)
            captures = engine.graph_captures
            info = cell.generator.drive(ctx, traffic, cell.config, args.seed, args.seconds)
            tracker.wait_all(120.0)
            run = Run(cell=cell.name, config=cell.config, traffic=traffic,
                      seconds=args.seconds, window=info["window"], deadline=info["deadline"],
                      requests=tracker.requests, recorder=recorder)
            w0, w1 = run.window
            half = 0.5 * (w0 + w1)
            finals = run.counted("final")
            line = {
                "sessions": sessions,
                "partial_p95_ms": p95_ms(run, run.counted("partial")),
                "final_p95_ms": p95_ms(run, finals),
                "final_p95_ms_first_half": p95_ms(run, [r for r in finals if r.due < half]),
                "final_p95_ms_second_half": p95_ms(run, [r for r in finals if r.due >= half]),
                "partials": len(run.counted("partial")), "finals": len(finals),
                "failed": sum(1 for r in run.counted() if not r.ok or r.done > run.deadline),
                "captures": engine.graph_captures - captures,
                "send_late_ms": info["send_late_ms"],
            }
            growing = line["final_p95_ms_second_half"] > 1.5 * line["final_p95_ms_first_half"]
            line["backlog_grows"] = bool(growing)
            line["sustained"] = bool(line["final_p95_ms"] < args.final_ms
                                     and line["failed"] == 0 and not growing)
            line["within"] = bool(line["sustained"]
                                  and line["partial_p95_ms"] < args.partial_ms)
            if line["sustained"]:
                sustained, misses = sessions, 0
            else:
                misses += 1
            if line["within"]:
                knee = sessions
            print(json.dumps(line), flush=True)
            if misses >= 2:
                break
    finally:
        engine.close()
    print(json.dumps({"workload": args.workload, "knee": knee,
                      "sessions_at_four_fifths": None if knee is None else round(0.8 * knee),
                      "sustained_without_partial_limit": sustained}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
