"""What a run records: each request from due to result, each engine group
the metrics hook reported, and the window they are read over."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

SAMPLE_RATE = 16000


@dataclass
class Req:
    """One request: when it was due, sent and finished, and its result."""

    kind: str                    # "partial" or "final"
    session: str
    due: float                   # host clock (time.perf_counter)
    audio: np.ndarray
    options: Dict[str, Any]
    language: str = "en"
    sent: float = 0.0
    done: Optional[float] = None
    output: Any = None           # the engine's DecodeOutput
    error: Optional[str] = None

    @property
    def audio_s(self) -> float:
        return len(self.audio) / SAMPLE_RATE

    @property
    def beams(self) -> int:
        return int(self.options.get("beam_size", 1) or 1)

    @property
    def ok(self) -> bool:
        return self.done is not None and self.error is None


class Tracker:
    """Completion bookkeeping shared by the traffic generators: a future's
    done-callback stamps its request, and the generator can wait for the
    requests it counts."""

    def __init__(self) -> None:
        self.requests: List[Req] = []
        self._lock = threading.Lock()
        self._open = 0
        self._settled = threading.Condition(self._lock)

    def attach(self, req: Req, future, on_done=None) -> None:
        with self._lock:
            self.requests.append(req)
            self._open += 1

        def finish(fut) -> None:
            req.done = time.perf_counter()
            try:
                req.output = fut.result()
            except BaseException as exc:  # a cancelled or failed decode
                req.error = f"{type(exc).__name__}: {exc}"
            with self._lock:
                self._open -= 1
                self._settled.notify_all()
            if on_done is not None:
                on_done(req)

        future.add_done_callback(finish)

    def wait_all(self, timeout: float) -> bool:
        """Wait until every attached request has settled (or ``timeout``)."""
        end = time.monotonic() + timeout
        with self._lock:
            while self._open > 0:
                left = end - time.monotonic()
                if left <= 0:
                    return False
                self._settled.wait(left)
        return True


class Recorder:
    """The engine's ``metrics=`` hook: the calls the engine makes, stamped."""

    def __init__(self) -> None:
        self.batches: List[tuple] = []    # (time, rows, capacity, step_sec)
        self.compiles: List[float] = []   # times of decode-graph captures

    def record_engine_batch(self, rows: int, capacity: int, step_sec: float) -> None:
        self.batches.append((time.perf_counter(), int(rows), int(capacity), float(step_sec)))

    def record_engine_compile(self, *args, **kwargs) -> None:
        self.compiles.append(time.perf_counter())

    def record_draft_verify(self, *args, **kwargs) -> None:
        pass

    def record_draft_signal(self, *args, **kwargs) -> None:
        pass


@dataclass
class Run:
    """Everything a metric reader reads."""

    cell: str
    config: Dict
    traffic: Dict
    seconds: float
    window: tuple                 # (start, end) on the host clock
    deadline: float               # a counted request unfinished then failed
    requests: List[Req]
    recorder: Recorder
    setup_s: float = 0.0
    trace: Any = None             # core.trace.Trace in a --trace 1 run
    architecture: Any = None      # the configuration's module in benchmark/architectures/

    def counted(self, kind: Optional[str] = None) -> List[Req]:
        """Requests due inside the window (of ``kind``, if given)."""
        w0, w1 = self.window
        return [r for r in self.requests
                if w0 <= r.due < w1 and (kind is None or r.kind == kind)]

    def latency_s(self, req: Req) -> float:
        """Due to result; a request that failed or never finished counts as
        waiting until the deadline at least."""
        if req.ok and req.done <= self.deadline:
            return req.done - req.due
        return max(self.deadline, req.done or 0.0) - req.due

    def bucket_of(self, req: Req) -> float:
        """The audio bucket the configuration assigns to the request."""
        seconds = req.audio_s
        buckets = sorted(self.config["engine"]["audio_buckets_sec"])
        return next((b for b in buckets if seconds <= b), buckets[-1])

    def group_spans(self) -> List[tuple]:
        """Each finished group's (device phase start, harvest end) on the
        host clock."""
        return [(min(r.done for r in reqs) - inference, max(r.done for r in reqs))
                for inference, reqs in self.groups().items()]

    def groups(self, reqs: Optional[List[Req]] = None) -> Dict[float, List[Req]]:
        """Finished requests by the engine group that served them: a group's
        outputs share one ``inference_sec``, from its device phase's start to
        the end of its harvest."""
        out: Dict[float, List[Req]] = {}
        for r in self.requests if reqs is None else reqs:
            if r.ok:
                out.setdefault(r.output.inference_sec, []).append(r)
        return out
