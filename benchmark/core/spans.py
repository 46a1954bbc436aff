"""Readers of the engine's group span records, which several per-layer
metrics share (each metric's own file under ``benchmark/metrics/`` names
which one it is).

Each finished request's result carries its group's record
(``DecodeOutput.spans``, ``stt_tpu_torch/engine/spans.py``): when each
row's request was submitted, and the engine thread's intervals, one after
another, from ``sem_wait`` to ``pack``, stamped with ``time.perf_counter``,
the host clock the traced stretch is pinned to. So the engine thread's
state can be laid beside the device operations of the stretch. At a moment
it is:

- **chunk** inside a ``replay`` or ``sync`` interval (a chunk of decode
  steps launched, or the host reading its finish flag);
- **launch** inside ``prep``, ``h2d``, ``encode``, ``detect``, ``prefill``
  or ``pack`` (the host preparing or launching a group's device work);
- **wait** otherwise: an empty queue, the batching window, grouping,
  ``sem_wait``, ``lock_wait``.

A program whose results carry no records gives every reader here nothing
to read: None, as does a run without a trace where the reader needs one.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

from .stats import percentile

CHUNK = frozenset(("replay", "sync"))
LAUNCH = frozenset(("prep", "h2d", "encode", "detect", "prefill", "pack"))

Span = Tuple[float, float]


def _spans_of(req):
    return getattr(req.output, "spans", None) if req.ok else None


def records(run) -> List:
    """Every group record the run's finished requests carry, once each, in
    order of group id."""
    found = {}
    for r in run.requests:
        rec = _spans_of(r)
        if rec is not None:
            found[id(rec)] = rec
    return sorted(found.values(), key=lambda rec: rec.group_id)


def queue_p95_ms(run, kind: str) -> Optional[float]:
    """The 95th percentile (nearest rank) over the window's finished
    requests of ``kind`` of their group's start less their submission, in
    ms (the record's ``queue_sec``)."""
    waits = []
    for r in run.counted(kind):
        rec = _spans_of(r)
        if rec is not None:
            waits.append(rec.queue_sec(r.output._row))
    if not waits:
        return None
    return 1e3 * percentile(waits, 95)


def merge(spans: Sequence[Span]) -> List[Span]:
    """The union of ``spans`` as sorted, disjoint intervals."""
    out: List[Span] = []
    for s, e in sorted(x for x in spans if x[1] > x[0]):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def intersect(a: List[Span], b: List[Span]) -> List[Span]:
    """The intersection of two unions of sorted, disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: List[Span], b: List[Span]) -> List[Span]:
    """``a`` less ``b`` (both sorted, disjoint)."""
    out = []
    for s, e in a:
        cur = s
        for bs, be in b:
            if be <= cur or bs >= e:
                continue
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
        if e > cur:
            out.append((cur, e))
    return out


def _length(spans: List[Span]) -> float:
    return sum(e - s for s, e in spans)


def _intervals(recs, names, lo: float, hi: float) -> List[Span]:
    return merge([(max(s, lo), min(e, hi)) for rec in recs for name, s, e in rec.dispatch
                  if name in names])


def idle_split(run) -> Optional[Dict[str, float]]:
    """The traced stretch's idle share (no device operation running), in
    % of the stretch, split by the engine thread's state then: ``chunk``,
    ``launch`` and ``wait``, which sum to ``readers.idle_pct``."""
    tr = run.trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    recs = records(run)
    if not recs:
        return None
    busy = merge([(o.start, o.end) for o in tr.ops])
    chunk = _intervals(recs, CHUNK, tr.start, tr.end)
    launch = subtract(_intervals(recs, LAUNCH, tr.start, tr.end), chunk)
    idle_chunk = _length(chunk) - _length(intersect(chunk, busy))
    idle_launch = _length(launch) - _length(intersect(launch, busy))
    idle = tr.window_s - tr.busy_s
    return {"chunk": 100.0 * idle_chunk / tr.window_s,
            "launch": 100.0 * idle_launch / tr.window_s,
            "wait": 100.0 * (idle - idle_chunk - idle_launch) / tr.window_s}


def decode_busy_pct(run) -> Optional[float]:
    """The share of the stretch's busy time taken by device operations
    whose launching host call fell in a ``replay`` interval (the decode
    chunks' steps, against encode, detect and prefill), in %."""
    tr = run.trace
    if tr is None or not tr.ops or tr.busy_s <= 0:
        return None
    recs = records(run)
    if not recs:
        return None
    replay = _intervals(recs, ("replay",), float("-inf"), float("inf"))
    starts = [s for s, _ in replay]

    def in_replay(t: Optional[float]) -> bool:
        k = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        return k >= 0 and t <= replay[k][1]

    decode = merge([(o.start, o.end) for o in tr.ops if in_replay(o.launched)])
    return 100.0 * _length(decode) / tr.busy_s
