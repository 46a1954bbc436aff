"""The traced stretch: ``torch.profiler`` over a steady part of the window,
reduced to device intervals, kernel names and host labels.

The harness starts the profiler inside the measured window and stops it
some seconds later. Inside, it wraps its own calls into the engine in
``record_function`` ranges; one range, ``TRACE_RANGE``, spans the whole
stretch and ties the profiler's clock to the host clock the harness keeps
for each request. The engine's own threads carry no ranges: a host label
for an idle gap is whatever the host was doing then, as the profiler saw
it (an operator, a CUDA runtime call, or nothing).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .stats import union_length

TRACE_RANGE = "bench: traced stretch"


def kind_of(name: str) -> str:
    """A device operation's kind from its kernel name (a copy of the port's
    bench ``kind_of``)."""
    low = name.lower()
    if "xattn" in low:
        return "xattn_decode"
    if "flash" in low:
        return "flash_attention"
    if "mel" in low and "kernel" in low:
        return "log-mel"
    if low.startswith("nvjet") or (any(k in low for k in ("gemm", "gemv", "xmma", "splitk"))
                                   and ("bf16" in low or "bfloat16" in low)):
        return "matrix products, bf16"
    if any(k in low for k in ("gemm", "gemv", "xmma")):
        return "matrix products, float32"
    if "memcpy" in low or "memset" in low or "copy_kernel" in low:
        return "copies and type conversions"
    return "other"


@dataclass
class DeviceOp:
    name: str
    start: float      # seconds on the host clock (time.perf_counter)
    end: float
    whole: bool = True   # False where the stretch's edge cut it
    launched: Optional[float] = None   # host time of the CUDA call that launched it


@dataclass
class Trace:
    start: float                  # the traced stretch on the host clock
    end: float
    ops: List[DeviceOp]           # device operations inside it, clipped
    host: List[Tuple[str, float, float]]  # host events (name, start, end)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_within(self, lo: float, hi: float) -> float:
        spans = [(max(o.start, lo), min(o.end, hi)) for o in self.ops]
        return union_length([(s, e) for s, e in spans if e > s])

    @property
    def busy_s(self) -> float:
        return self.busy_within(self.start, self.end)

    def top_ops(self, n: int = 10) -> List[List]:
        totals: Dict[str, float] = {}
        for o in self.ops:
            totals[o.name] = totals.get(o.name, 0.0) + (o.end - o.start)
        return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]

    def kind_totals(self) -> Dict[str, float]:
        totals: Dict[str, float] = {}
        for o in self.ops:
            k = kind_of(o.name)
            totals[k] = totals.get(k, 0.0) + (o.end - o.start)
        return totals

    def idle_gaps(self, n: int = 10, groups: List[Tuple[float, float]] = ()) -> List[List]:
        """The ``n`` longest stretches with no device operation, each
        labelled by the innermost host event the profiler saw running at its
        middle (the harness's own calls, CUDA runtime calls), else by
        whether an engine group was between its device phase's start and
        its harvest's end then (``groups``)."""
        gaps, cur = [], self.start
        for s, e in sorted((o.start, o.end) for o in self.ops):
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if self.end > cur:
            gaps.append((cur, self.end))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = 0.5 * (s + e)
            around = [(he - hs, name) for name, hs, he in self.host if hs <= mid <= he]
            if around:
                label = min(around)[1]
            elif any(gs <= mid <= ge for gs, ge in groups):
                label = "engine: a group between its device phase's start and its harvest"
            else:
                label = "engine: no group in flight (queue, batching window)"
            out.append([label, e - s])
        return out


class Profiler:
    """One traced stretch: :meth:`start`, :meth:`stop` (on one thread: the
    profiler records the host operations of the thread that runs it, and
    the card's operations and CUDA runtime calls of every thread), then
    :meth:`reduce` after the window, which gives a :class:`Trace` on the
    host clock. Two marker ranges, one just after the start and one just
    before the stop, tie the profiler's clock to the host clock."""

    def __init__(self) -> None:
        self._prof = None
        self._results = None
        self._marks = []           # host times of the two markers
        self.started = None        # host time the stretch began
        self.stopped = False

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once, so that the stretch's own start
        does not pay for setting up the card's tracing."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(8, device="cuda").sum().item()

    def _mark(self, name: str) -> None:
        from torch.profiler import record_function

        with record_function(name):
            self._marks.append(time.perf_counter())

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self._mark(TRACE_RANGE + " start")
        self.started = self._marks[0]

    def stop(self) -> None:
        self._mark(TRACE_RANGE + " stop")
        self._prof.stop()
        self._results = self._prof.profiler.kineto_results
        self._prof = None
        self.stopped = True

    def reduce(self) -> Trace:
        import torch

        events = self._results.events()
        marks = {e.name(): e for e in events if e.name().startswith(TRACE_RANGE)
                 and e.device_type() == torch.autograd.DeviceType.CPU}
        first, last = marks.get(TRACE_RANGE + " start"), marks.get(TRACE_RANGE + " stop")
        if first is None or last is None:
            raise RuntimeError("the profiler recorded no marker of the traced stretch")
        # profiler ns -> host seconds, pinned at the two markers
        p0, p1 = first.start_ns(), last.start_ns()
        h0, h1 = self._marks
        scale = (h1 - h0) / max(1, p1 - p0)

        def host_s(ns: int) -> float:
            return h0 + (ns - p0) * scale

        cpu = torch.autograd.DeviceType.CPU
        # the CUDA runtime and driver calls, by the correlation id the
        # profiler gives both a launch call and the kernel it launched
        launched = {e.correlation_id(): host_s(e.start_ns()) for e in events
                    if e.device_type() == cpu and e.name().startswith("cu")
                    and e.correlation_id()}
        ops, host = [], []
        for e in events:
            if e.name().startswith(TRACE_RANGE):
                continue
            start, end = host_s(e.start_ns()), host_s(e.end_ns())
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if e.is_user_annotation():
                    continue
                s, t = max(start, h0), min(end, h1)
                if t > s:
                    ops.append(DeviceOp(e.name(), s, t, (s, t) == (start, end),
                                        launched.get(e.correlation_id())))
            elif end > h0 and start < h1:
                host.append((e.name(), start, end))
        self._results = None
        return Trace(h0, h1, ops, host)
