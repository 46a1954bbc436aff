"""The port's server metrics fed from the engine's group span records
(``stt_tpu_torch/server/runtime/metrics.py`` ``record_engine_spans``)."""

from stt_tpu_torch.engine.spans import GroupSpans
from stt_tpu_torch.server.runtime.metrics import Metrics


def test_engine_span_histograms():
    """One queue wait a row, from submission to the group's start, and one
    decode time a group (its chunks' launches and finish-flag reads);
    absent until a group is recorded, so an idle plane keeps the JAX key
    set."""
    m = Metrics()
    hists = m.render()["histograms"]
    assert "engine_queue_wait_sec" not in hists and "engine_decode_sec" not in hists
    spans = GroupSpans(0, (1.0, 1.25))
    spans.dispatch = [("sem_wait", 1.25, 1.5), ("prep", 1.5, 1.625), ("replay", 1.625, 1.75),
                      ("sync", 1.75, 1.8125), ("replay", 1.8125, 1.875),
                      ("sync", 1.875, 1.90625), ("pack", 1.90625, 2.0)]
    m.record_engine_spans(spans)
    hists = m.render()["histograms"]
    queue, decode = hists["engine_queue_wait_sec"], hists["engine_decode_sec"]
    assert queue["count"] == 2 and queue["sum"] == 0.75          # 0.5 and 0.25
    assert queue["buckets"]["0.1"] == 0 and queue["buckets"]["0.25"] == 1
    assert queue["buckets"]["0.5"] == 2
    # 0.125 + 0.0625 + 0.0625 + 0.03125: the replays and the reads, not the pack
    assert decode["count"] == 1 and decode["sum"] == 0.28125
    assert decode["buckets"]["0.25"] == 0 and decode["buckets"]["0.5"] == 1
