"""Traffic kind ``live``: live captioning, open loop.

``sessions`` independent speakers each speak utterances one after
another, with silences between. While an utterance runs, a partial is due
every ``partial_interval_s`` carrying the trailing ``partial_window_s`` of
it; ``final_delay_s`` after it ends, when the VAD endpoints it, a final is
due carrying all of it. Each request is sent when it is due, whether or not
earlier ones have finished, and timed from when it was due.

Every seed gets the same set of utterance lengths and silences (the
lognormal's and the uniform's quantiles over all sessions' utterances)
and the same session phases, and gives each utterance its own stretch of
the audio. ``ARRIVALS_SEED`` deals the lengths and silences out, so every
run's arrivals are the same and only the audio follows ``--seed``: the
order of long utterances moves a tail more than the code does.

Parameters (the traffic file): ``sessions``, ``utterance`` {median_s,
sigma, min_s, max_s}, ``gap`` {min_s, max_s}, ``partial_interval_s``,
``partial_window_s``, ``final_delay_s``, ``lead_s`` (traffic before the
window), ``deadline_s`` (after the window; a counted request unfinished
then has failed), ``trace_s`` (the traced stretch), ``language``,
``profile`` (a decode profile of the configuration), ``audio``.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Tuple

import numpy as np

from benchmark.core.audio import SAMPLE_RATE, base_signal, lognormal_grid, uniform_grid
from benchmark.core.records import Req

BASE_SECONDS = 45.0
ARRIVALS_SEED = 1    # one set of arrivals for every run of every live cell


def buckets_between(buckets, lo: float, hi: float) -> List[float]:
    """The audio buckets that requests from ``lo`` to ``hi`` seconds long
    land in."""
    ordered = sorted(buckets)
    first = next((b for b in ordered if lo <= b), ordered[-1])
    last = next((b for b in ordered if hi <= b), ordered[-1])
    return [b for b in ordered if first <= b <= last]


def prewarm(engine, traffic: Dict, config: Dict) -> None:
    """Greedy at every audio bucket and batch rung, as the registry's boot
    prewarms them; and, unless drafting is off, the drafted entries of the
    buckets partials land in."""
    rungs = list(config["engine"]["batch_buckets"])
    engine.prewarm(batch_sizes=rungs, beam_sizes=[1])
    if config["engine"].get("draft_mode", "adaptive") != "off":
        partial = buckets_between(engine.audio_buckets_sec, traffic["partial_interval_s"],
                                  traffic["partial_window_s"])
        engine.prewarm(bucket_secs=partial, batch_sizes=rungs, beam_sizes=[1],
                       include_drafted=True)


def schedule(traffic: Dict, seed: int, horizon: float) -> List[Tuple]:
    """(due, session, kind, utterance offset in the base signal, first
    sample, last sample) of every request due before ``horizon`` seconds,
    in due order."""
    s = int(traffic["sessions"])
    u, g = traffic["utterance"], traffic["gap"]
    mean_cycle = u["median_s"] * math.exp(u["sigma"] ** 2 / 2) + 0.5 * (g["min_s"] + g["max_s"])
    per = int(math.ceil(horizon / mean_cycle)) + 2
    deal = np.random.default_rng([ARRIVALS_SEED, 0])
    lengths = deal.permutation(lognormal_grid(s * per, u["median_s"], u["sigma"],
                                              u["min_s"], u["max_s"])).reshape(s, per)
    gaps = deal.permutation(uniform_grid(s * per, g["min_s"], g["max_s"])).reshape(s, per)
    room = int((BASE_SECONDS - u["max_s"]) * SAMPLE_RATE)
    rolls = np.random.default_rng([int(seed), 3]).integers(0, room, size=(s, per))
    every, window = traffic["partial_interval_s"], traffic["partial_window_s"]
    out = []
    for i in range(s):
        t = (i + 0.5) / s * mean_cycle
        k = 0
        while t < horizon:
            length, roll = lengths[i, k % per], int(rolls[i, k % per])
            n = int(round(length * SAMPLE_RATE))
            j = 1
            while j * every < length:
                end = int(round(j * every * SAMPLE_RATE))
                start = max(0, end - int(round(window * SAMPLE_RATE)))
                out.append((t + j * every, i, "partial", roll, start, end))
                j += 1
            out.append((t + length + traffic["final_delay_s"], i, "final", roll, 0, n))
            t += length + gaps[i, k % per]
            k += 1
    out.sort(key=lambda x: x[0])
    return [x for x in out if x[0] < horizon]


def drive(ctx, traffic: Dict, config: Dict, seed: int, seconds: float) -> Dict:
    """Send the schedule from now. The window opens ``lead_s`` in and lasts
    ``seconds``; traffic goes on until every request due in it has a
    result, or until ``deadline_s`` after it. ``ctx.submit(req)`` sends a
    request; ``ctx.tick(now)`` runs between sends. Returns the window, the
    deadline and how late the sends were."""
    lead, deadline_s = float(traffic["lead_s"]), float(traffic["deadline_s"])
    events = schedule(traffic, seed, lead + seconds + deadline_s)
    base = base_signal(seed, BASE_SECONDS, traffic.get("audio", {}))
    profile = config["decode_profiles"][traffic["profile"]]
    language = traffic["language"]
    t0 = time.perf_counter() + 0.05
    w0, w1 = t0 + lead, t0 + lead + seconds
    deadline = w1 + deadline_s
    ctx.open_window(w0)
    counted: List[Req] = []
    late = []
    i = 0
    while True:
        now = time.perf_counter()
        ctx.tick(now)
        if i < len(events) and t0 + events[i][0] <= now:
            due_rel, sess, kind, roll, a, b = events[i]
            i += 1
            req = Req(kind=kind, session=f"live-{sess}", due=t0 + due_rel,
                      audio=base[roll + a: roll + b],
                      options=dict(profile), language=language)
            ctx.submit(req)
            late.append(req.sent - req.due)
            if w0 <= req.due < w1:
                counted.append(req)
            continue
        if now >= w1 and (now >= deadline or all(r.done is not None for r in counted)):
            break
        nxt = t0 + events[i][0] if i < len(events) else now + 0.05
        time.sleep(min(max(0.0, nxt - now), 0.02))
    late_ms = np.array(late) * 1e3
    return {"window": (w0, w1), "deadline": deadline,
            "send_late_ms": {"p50": float(np.percentile(late_ms, 50)),
                             "p99": float(np.percentile(late_ms, 99)),
                             "max": float(late_ms.max()), "sent": len(late_ms)}}
