"""Readers that several per-layer metrics share (each metric's own file
under ``benchmark/metrics/`` names which one it is)."""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from . import flops as FL
from .trace import kind_of


def idle_pct(run) -> Optional[float]:
    """100 x (1 - busy / length) over the traced stretch."""
    tr = run.trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def _produced(out) -> int:
    """Tokens a row produced: its text, and the end-of-text if it stopped."""
    ended = out._p_len + out._n_gen < len(out._tokens)
    return int(out._n_gen) + int(ended)


def mfu_pct(run) -> Optional[float]:
    """FLOPs of the groups whose device phase and harvest lie wholly in the
    traced stretch, over the card's busy time from the first such group's
    start to the last one's end, over the bf16 peak, in %."""
    tr = run.trace
    if tr is None:
        return None
    spans, work = [], 0.0
    for inference_sec, reqs in run.groups().items():
        start = min(r.done for r in reqs) - inference_sec
        end = max(r.done for r in reqs)
        if start < tr.start or end > tr.end:
            continue
        spans.append((start, end))
        work += sum(FL.request_flops(run.config, run.bucket_of(r), int(r.output._p_len),
                                     _produced(r.output), r.beams) for r in reqs)
    if not spans:
        return None
    busy = tr.busy_within(min(s for s, _ in spans), max(e for _, e in spans))
    if busy <= 0:
        return None
    return 100.0 * work / busy / FL.H100_BF16_FLOPS


def group_starts(run) -> List[Tuple[float, int, float]]:
    """Each engine group of the run as (device phase start, padded rows,
    bucket), in order of start. The engine reports a group once, at its
    harvest's end, with its rows, its batch rung and the seconds since its
    device phase began (``record_engine_batch``); its results carry the
    same seconds as ``inference_sec``, which ties the report to them."""
    by_sec = run.groups()
    out = []
    for t, _rows, rung, sec in run.recorder.batches:
        reqs = by_sec.get(sec)
        if reqs:
            out.append((t - sec, rung, max(run.bucket_of(r) for r in reqs)))
    return sorted(out)


def mel_pairs(run) -> Optional[List[Tuple[object, Tuple[float, int, float]]]]:
    """The log-mel launches the stretch holds whole, each with its engine
    group (device phase start, padded rows, bucket). The trace carries no
    launch shapes, so each launch takes its group's: the engine's one
    dispatch thread runs the groups' device phases one after another and
    launches the kernel once in each, so the host call that launched it
    (which the profiler ties to the kernel) falls after its group's start
    and before the next group's. On the card the kernel may run later,
    queued behind the groups before it. None where a launch has no host
    call in the trace, finds no group, or shares one with another."""
    tr = run.trace
    if tr is None:
        return None
    launches = [op for op in tr.ops if kind_of(op.name) == "log-mel" and op.whole]
    groups = group_starts(run)
    starts = [g[0] for g in groups]
    pairs, used = [], set()
    for op in launches:
        if op.launched is None:
            return None
        k = bisect.bisect_right(starts, op.launched) - 1
        if k < 0 or k in used:
            return None
        used.add(k)
        pairs.append((op, groups[k]))
    return pairs or None


def mel_roofline_pct(run) -> Optional[float]:
    """The log-mel launches' least time over their traced time, in %, over
    the launches the stretch holds whole, each at its group's rows and
    bucket (:func:`mel_pairs`)."""
    pairs = mel_pairs(run)
    if not pairs:
        return None
    eng = run.config["engine"]
    n_mels = int(run.config["num_mel_bins"])
    wire_bytes = 1 if eng["audio_wire"] == "mulaw" else 2
    nonzeros = FL.mel_nonzeros(n_mels)
    least = spent = 0.0
    for op, (_, rows, bucket) in pairs:
        least += FL.mel_least_seconds(rows, bucket, n_mels, wire_bytes, nonzeros)
        spent += op.end - op.start
    return 100.0 * least / spent
