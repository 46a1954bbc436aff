"""The benchmark's readers of the engine's span records
(``benchmark/core/spans.py`` and the six metrics that use it) against a
hand-built run: two groups' records, a traced stretch of five device
operations, and the values worked out by hand."""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.core import manifest
from benchmark.core import readers as READERS
from benchmark.core import spans as SPANS
from benchmark.core.records import Recorder, Req, Run
from benchmark.core.trace import DeviceOp, Trace
from stt_tpu_torch.engine.spans import GroupSpans

ROOT = Path(__file__).resolve().parents[1]
SMALL = json.loads((ROOT / "benchmark" / "configs" / "whisper-small.json").read_text())
METRICS = ("final_queue_p95_ms.live", "partial_queue_p95_ms.live", "idle_wait_pct.live",
           "idle_launch_pct.live", "idle_chunk_pct.live", "decode_busy_pct.live")


def _record(group_id, submitted, dispatch, end):
    return GroupSpans(group_id, tuple(submitted), list(dispatch), end)


def _names(names, edges):
    return [(n, s, e) for n, s, e in zip(names.split(), edges, edges[1:])]


# group 0: two rows, two chunks; group 1: one row, one chunk, its pack and
# harvest after the stretch's end (1.0)
A = _record(0, (0.0, 0.05), _names(
    "sem_wait prep lock_wait h2d encode detect prefill replay sync replay sync pack",
    (0.08, 0.1, 0.2, 0.21, 0.25, 0.3, 0.35, 0.4, 0.45, 0.6, 0.65, 0.7, 0.75)), 0.85)
B = _record(1, (0.5,), _names(
    "sem_wait prep lock_wait h2d encode detect prefill replay sync pack",
    (0.75, 0.8, 0.9, 0.9, 0.92, 0.95, 0.96, 0.97, 0.98, 1.1, 1.2)), 1.3)
# (start, end, host time of the launching call): encode, two decode chunks,
# encode, a decode chunk the stretch cuts at 1.0
OPS = [("gemm", 0.25, 0.32, 0.26), ("decode", 0.41, 0.55, 0.42), ("decode", 0.61, 0.66, 0.62),
       ("gemm", 0.93, 0.97, 0.94), ("decode", 0.975, 1.0, 0.976)]


def _req(kind, rec, row, trace_output=True):
    submitted = rec.submitted[row]
    out = SimpleNamespace(inference_sec=rec.end - rec.dispatch[1][1], _row=row)
    if trace_output:
        out.spans = rec
    return Req(kind=kind, session="s", due=submitted, audio=np.zeros(16000, np.float32),
               options={}, sent=submitted, done=rec.end + 0.01, output=out)


def _run(with_spans=True, traced=True, failed=False):
    reqs = [_req("final", A, 0, with_spans), _req("partial", A, 1, with_spans),
            _req("final", B, 0, with_spans)]
    if failed:
        reqs.append(Req(kind="final", session="s", due=0.6, audio=np.zeros(16000, np.float32),
                        options={}, sent=0.6, done=0.9, output=None, error="RuntimeError: x"))
    trace = Trace(0.0, 1.0, [DeviceOp(n, s, e, True, at) for n, s, e, at in OPS], []) \
        if traced else None
    return Run(cell="c", config=SMALL, traffic={}, seconds=1.0, window=(0.0, 1.0),
               deadline=5.0, requests=reqs, recorder=Recorder(), trace=trace)


def _read(name, run):
    return manifest.read_metric({"name": name}, run, ROOT)


def test_queue_p95_is_the_group_start_less_the_submission():
    run = _run(failed=True)
    # finals wait 0.1 - 0.0 and 0.8 - 0.5 s: the nearest-rank p95 of two is
    # the larger; the partial 0.1 - 0.05 s
    assert _read("final_queue_p95_ms.live", run) == pytest.approx(300.0)
    assert _read("partial_queue_p95_ms.live", run) == pytest.approx(50.0)
    # never above the wait the harness reads from due, result and inference_sec
    assert _read("final_queue_p95_ms.live", run) <= _read("final_wait_p95_ms.live", run)
    assert [r.group_id for r in SPANS.records(run)] == [0, 1]


def test_idle_split_by_hand():
    run = _run()
    # busy 0.07 + 0.14 + 0.05 + 0.04 + 0.025 = 0.325 of 1.0. chunk: [0.4,
    # 0.7] and [0.97, 1.0], 0.33, of which busy 0.215. launch: [0.1, 0.2],
    # [0.21, 0.4], [0.7, 0.75], [0.8, 0.97], 0.51, of which busy 0.11. wait:
    # [0, 0.1], [0.2, 0.21], [0.75, 0.8]
    assert _read("idle_chunk_pct.live", run) == pytest.approx(11.5)
    assert _read("idle_launch_pct.live", run) == pytest.approx(40.0)
    assert _read("idle_wait_pct.live", run) == pytest.approx(16.0)
    parts = sum(_read(f"idle_{k}_pct.live", run) for k in ("wait", "launch", "chunk"))
    assert parts == pytest.approx(READERS.idle_pct(run), abs=1e-9)
    assert READERS.idle_pct(run) == pytest.approx(67.5)


def test_decode_busy_counts_the_operations_launched_in_a_replay():
    # 0.14 + 0.05 + 0.025 of the 0.325 busy
    assert _read("decode_busy_pct.live", _run()) == pytest.approx(100 * 0.215 / 0.325)


def test_readers_give_nothing_without_a_trace_or_records():
    untraced = _run(traced=False)
    for name in METRICS[2:]:
        assert _read(name, untraced) is None
    assert _read("final_queue_p95_ms.live", untraced) == pytest.approx(300.0)
    # a program whose results carry no records: nothing, and no error
    older = _run(with_spans=False)
    assert SPANS.records(older) == []
    for name in METRICS:
        assert _read(name, older) is None


def test_interval_arithmetic():
    a = SPANS.merge([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (5.0, 5.0)])
    assert a == [(0.0, 2.0), (3.0, 4.0)]
    b = [(1.0, 3.5)]
    assert SPANS.intersect(a, b) == [(1.0, 2.0), (3.0, 3.5)]
    assert SPANS.subtract(a, b) == [(0.0, 1.0), (3.5, 4.0)]
    assert SPANS.subtract(b, a) == [(2.0, 3.0)]
