"""The traffic generators' schedules from a seed."""

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.core.manifest import load_module

BENCH = Path(__file__).resolve().parents[1]
LIVE = load_module(BENCH / "traffic" / "live.py")


def traffic(name):
    with open(BENCH / "traffic" / f"{name}.json") as fh:
        return json.load(fh)


def test_live_schedule_counts_due_times_and_lengths():
    t = dict(traffic("small.live"), sessions=6)
    horizon = 60.0
    events = LIVE.schedule(t, seed=2**31 + 5, horizon=horizon)
    dues = [e[0] for e in events]
    assert dues == sorted(dues) and dues[0] >= 0 and dues[-1] < horizon
    assert {e[1] for e in events} == set(range(6))
    for due, _, kind, _, a, b in events:
        seconds = (b - a) / 16000
        if kind == "partial":
            assert 1.5 - 1e-9 <= seconds <= t["partial_window_s"] + 1e-9
        else:
            assert t["utterance"]["min_s"] - 1e-9 <= seconds <= t["utterance"]["max_s"] + 1e-9
    finals = [e for e in events if e[2] == "final"]
    # one final an utterance: ~horizon / 7.25 s per session
    assert 6 * 5 <= len(finals) <= 6 * 12
    partials = [e for e in events if e[2] == "partial"]
    assert len(partials) > len(finals)


def test_live_partials_fall_every_interval_inside_their_utterance():
    t = dict(traffic("small.live"), sessions=1)
    events = LIVE.schedule(t, seed=11, horizon=40.0)
    final = next(e for e in events if e[2] == "final")
    before = [e for e in events if e[2] == "partial" and e[0] < final[0]]
    gaps = np.diff([e[0] for e in before])
    assert np.allclose(gaps, t["partial_interval_s"])
    # the final carries the whole utterance, due its delay after the end
    assert before[-1][5] < final[5]
    start = before[0][0] - t["partial_interval_s"]
    assert np.isclose(final[0], start + final[5] / 16000 + t["final_delay_s"], atol=1e-4)


def test_every_arrivals_seed_deals_the_same_set_of_lengths_in_another_order(monkeypatch):
    t = dict(traffic("small.live"), sessions=8)
    a = LIVE.schedule(t, seed=1, horizon=200.0)
    monkeypatch.setattr(LIVE, "ARRIVALS_SEED", LIVE.ARRIVALS_SEED + 1)
    b = LIVE.schedule(t, seed=1, horizon=200.0)
    monkeypatch.undo()
    assert a != b
    assert a == LIVE.schedule(t, seed=1, horizon=200.0)
    la = sorted(e[5] - e[4] for e in a if e[2] == "final")
    lb = sorted(e[5] - e[4] for e in b if e[2] == "final")
    # the same multiset, save the few that the horizon cuts off
    assert np.median(la) == pytest.approx(np.median(lb), rel=0.1)


@pytest.mark.parametrize("name", ["small.live", "turbo.live"])
def test_fixed_arrivals_are_the_same_for_every_seed_and_the_audio_is_not(name, monkeypatch):
    t = traffic(name)
    a = LIVE.schedule(t, seed=2**31 + 1, horizon=91.0)
    b = LIVE.schedule(t, seed=2**32 + 7, horizon=91.0)
    assert [e[:3] + e[4:] for e in a] == [e[:3] + e[4:] for e in b]
    assert [e[3] for e in a] != [e[3] for e in b]
    monkeypatch.setattr(LIVE, "ARRIVALS_SEED", LIVE.ARRIVALS_SEED + 1)
    other = LIVE.schedule(t, 2**31 + 1, 91.0)
    assert [e[0] for e in other] != [e[0] for e in a]


def test_buckets_between_takes_the_partials_buckets():
    assert LIVE.buckets_between([1.0, 2.0, 5.0, 10.0, 30.0], 1.5, 5.0) == [2.0, 5.0]
    assert LIVE.buckets_between([1.0, 2.0, 5.0, 10.0, 30.0], 0.5, 40.0) == [
        1.0, 2.0, 5.0, 10.0, 30.0]
