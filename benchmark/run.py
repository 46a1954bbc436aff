"""The benchmark of stt_tpu_torch on the card: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Finds the cell in ``BENCHMARK.json``, its configuration, the architecture
that names, its traffic and its metrics' readers by name
(``benchmark/core/manifest.py``); builds the port's batching engine
through the architecture's ``build_engine`` (for ``whisper``,
``benchmark/architectures/whisper.py``, as the model registry builds it),
with the configuration's settings, weights drawn from ``WEIGHTS_SEED``
(one model for every run, as a deployment serves one checkpoint: random
weights end a row at an end-of-text that depends on the draw, so the draw
sets how much each request decodes) and this harness's recorder as its
metrics hook; warms up the shapes the cell's traffic uses, as the
registry's boot does; drives the traffic through the engine's ``submit``
from the seed, with traffic before the window so that the window sees a
steady state; with ``--trace 1`` profiles a steady stretch inside the
window. After the window it reads the metrics, frees the program, judges
a sample of the window's results (``benchmark/core/check.py``) with the
architecture's ``judge`` against its plain float32 reference, checks that
nothing of the JAX package was imported, and prints one JSON line.

It needs a CUDA card (as many as the cell asks for) and fails without one;
``--rehearse`` runs a CPU rehearsal at the architecture's ``REHEARSAL``
size for the benchmark's own tests. ``--control fp8`` judges, in the
program's place, the plain reference computed in fp8 over the same prompts
and served tokens: the control that has to come out not correct (it also
prints the program's own readings); the benchmark's runs never pass it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(_var, str(ROOT / ".bench_cache" / _sub))
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.core import manifest  # noqa: E402
from benchmark.core.readers import group_starts, mel_pairs  # noqa: E402
from benchmark.core.records import Recorder, Req, Run, Tracker  # noqa: E402
from benchmark.core.trace import kind_of  # noqa: E402

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "stt_tpu")
WEIGHTS_SEED = 0    # the engine's seeded draw: one model for every run of every cell


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_imports(modules=None) -> List[str]:
    """Top-level names of imported modules that belong to the JAX side,
    compared whole: ``stt_tpu_torch`` is not ``stt_tpu``."""
    names = {name.split(".", 1)[0] for name in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN_MODULES))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="CPU rehearsal at the test size (the benchmark's own tests)")
    p.add_argument("--control", choices=("fp8",),
                   help="judge the reference computed in fp8 in the program's place")
    return p.parse_args(argv)


def check_card(chips: int) -> Optional[str]:
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} cards, torch sees {torch.cuda.device_count()}"
    return None


class Context:
    """What a traffic generator drives: ``submit`` a request, ``subscribe``
    to finished ones, ``tick`` between sends (which opens and closes the
    traced stretch)."""

    def __init__(self, engine, tracker: Tracker, trace_at: Optional[tuple]) -> None:
        self.engine = engine
        self.tracker = tracker
        self._hooks = []
        self._trace_at = trace_at     # (seconds after the window opens, length)
        self.window_start: Optional[float] = None
        self.profiler = None

    def submit(self, req: Req) -> None:
        from stt_tpu_torch.engine.engine import DecodeRequest
        from torch.profiler import record_function

        request = DecodeRequest(audio=req.audio, language=req.language, options=req.options,
                                is_final=req.kind == "final", session_id=req.session)
        with record_function(f"bench: submit {req.kind}"):
            req.sent = time.perf_counter()
            future = self.engine.submit(request)
        self.tracker.attach(req, future, self._finished)

    def subscribe(self, hook) -> None:
        self._hooks.append(hook)

    def _finished(self, req: Req) -> None:
        for hook in self._hooks:
            hook(req)

    def open_window(self, w0: float) -> None:
        self.window_start = w0

    def tick(self, now: float) -> None:
        """Open the traced stretch at its time, ``trace_s`` before the
        window closes. It runs on until the traffic's last counted request
        has its result: stopping the profiler holds the interpreter for
        seconds while it reads the card's buffers, which would stall the
        engine's threads and stretch the latencies of requests in flight."""
        if self._trace_at is None or self.window_start is None:
            return
        offset, length = self._trace_at
        if self.profiler is None and now >= self.window_start + offset:
            from benchmark.core.trace import Profiler

            self.profiler = Profiler()
            self.profiler.start()
            log(f"trace: started {time.perf_counter() - now:.3f} s after its time")

    def finish_trace(self):
        if self.profiler is None:
            return None
        if not self.profiler.stopped:
            t0 = time.perf_counter()
            self.profiler.stop()
            log(f"trace: stopped in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        trace = self.profiler.reduce()
        log(f"trace: {len(trace.ops)} device operations read in {time.perf_counter() - t0:.1f} s")
        return trace


def device_info(torch, chips: int, rehearse: bool) -> Dict:
    if rehearse:
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips)))}


def card_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = manifest.load_cell(args.workload, bool(args.trace), ROOT)
    import torch

    arch = cell.architecture
    if args.rehearse:
        cell.config.update(arch.REHEARSAL)
        cell.config["engine"].update(arch.REHEARSAL_ENGINE)
        device = "cpu"
        torch.set_num_threads(2)
    else:
        why = check_card(cell.chips)
        if why is not None:
            log(f"no result: {why}")
            return 2
        device = "cuda"
    recorder, tracker = Recorder(), Tracker()
    engine = arch.build_engine(cell.config, WEIGHTS_SEED, device, recorder)
    if not args.rehearse:
        arch.check_deployment(engine, cell.config)
    cell.generator.prewarm(engine, cell.traffic, cell.config)
    engine.start()
    captures_warm = engine.graph_captures
    trace_at = None
    if args.trace:
        length = min(float(cell.traffic["trace_s"]), args.seconds)
        trace_at = (args.seconds - length, length)
        if device == "cuda":
            from benchmark.core.trace import Profiler

            Profiler.warm()
    ctx = Context(engine, tracker, trace_at)
    info = cell.generator.drive(ctx, cell.traffic, cell.config, args.seed, args.seconds)
    trace = ctx.finish_trace()
    w0, w1 = info["window"]
    setup_s = w0 - T_START
    settled = tracker.wait_all(timeout=120.0)
    captures_window = engine.graph_captures - captures_warm
    dev = device_info(torch, cell.chips, args.rehearse)
    engine.close()
    ctx.engine = None
    del engine
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    run = Run(cell=cell.name, config=cell.config, traffic=cell.traffic, seconds=args.seconds,
              window=(w0, w1), deadline=info["deadline"], requests=tracker.requests,
              recorder=recorder, setup_s=setup_s, trace=trace, architecture=arch)
    log(f"card: {card_line() if device == 'cuda' else 'cpu rehearsal'}")
    log(f"sends: {json.dumps(info['send_late_ms'])} ms late (p50, p99, max)")
    log(f"decode graphs captured inside the window: {captures_window}; "
        f"all requests settled: {settled}")
    metrics = {}
    for m in cell.metrics:
        value = manifest.read_metric(m, run, ROOT)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    counted = run.counted()
    failed = sum(1 for r in counted if not r.ok or r.done > run.deadline)
    result = {"correct": False, "attempted": len(counted), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace is not None:
        result["device"].update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.top_ops(10),
                               "idle_gaps": trace.idle_gaps(10, run.group_spans())}
        log(f"traced: {len(trace.ops)} device operations over {trace.window_s:.2f} s")
        begun = sum(1 for t, _, _ in group_starts(run) if trace.start <= t < trace.end)
        mels = sum(1 for o in trace.ops if kind_of(o.name) == "log-mel")
        paired = mel_pairs(run)
        log(f"traced stretch: {begun} engine groups began in it, {mels} log-mel launches, "
            f"{len(paired) if paired else 0} paired with their groups")
        log("device time by kind: " + json.dumps(
            {k: round(v, 6) for k, v in sorted(trace.kind_totals().items(),
                                               key=lambda kv: -kv[1])}))

    from benchmark.core import check

    reqs = check.sample(run, args.seed)
    t_check = time.perf_counter()
    numbers = arch.judge(run, reqs, WEIGHTS_SEED, device)
    log(f"reference: {int(numbers['requests_judged'])} requests, "
        f"{int(numbers['tokens_judged'])} tokens in {time.perf_counter() - t_check:.1f} s")
    log("readings: " + json.dumps(numbers))
    if args.control:
        numbers = arch.judge(run, reqs, WEIGHTS_SEED, device, control=True)
        log("control readings: " + json.dumps(numbers))
    limits = cell.traffic["limits"]
    checks = {k: {"value": numbers[k], "limit": float(limits[k])} for k in limits}
    result["correct"] = bool(reqs) and all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks

    found = forbidden_imports()
    if found:
        log(f"no result: the run imported {found}")
        return 3
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
