"""The engine's group span records (``stt_tpu_torch/engine/spans.py``) on
the CPU, at the ``test`` size.

One batch of mixed requests (a drafted partial, a plain final, a beam-2
request, two plain rows of another bucket) goes through the queue and
forms four groups; ``transcribe_sync`` adds groups that skip it. Every
output of a group carries the same record; the records' stamps are in
order; the engine thread's intervals run one after another from
``sem_wait`` to ``pack`` with each chunk's ``replay`` and ``sync``; the
chunks they count are the chunks the decode ran; ``inference_sec`` is the
harvest's end less the prep's start; the metrics hook gets each record
once."""

import re

import numpy as np
import pytest

from stt_tpu_torch.engine import engine as TE
from stt_tpu_torch.models import whisper as TW
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

PLAIN = re.compile(r"(sem_wait )?prep lock_wait h2d encode detect prefill( replay sync)+ pack")
# a drafted decode reads the finish flag before each chunk
DRAFTED = re.compile(r"(sem_wait )?prep lock_wait h2d encode detect prefill"
                     r"( sync replay)*( sync)? pack")


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal(int(16000 * seconds))).astype(np.float32)


def _req(seconds, seed, sid="", final=False, **options):
    return TE.DecodeRequest(_audio(seconds, seed), language="en", options=options,
                            is_final=final, session_id=sid)


class _Hook:
    """A metrics hook that also takes the span records."""

    def __init__(self):
        self.batches, self.records = [], []

    def record_engine_batch(self, rows, capacity, seconds):
        self.batches.append((rows, capacity, seconds))

    def record_engine_compile(self, seconds):
        pass

    def record_draft_verify(self, *args):
        pass

    def record_draft_signal(self, *args):
        pass

    def record_engine_spans(self, spans):
        self.records.append(spans)


@pytest.fixture(scope="module")
def served():
    """(engine, hook, queued outputs, synchronous outputs, chunks each
    record's decode ran)."""
    hook = _Hook()
    eng = TE.WhisperEngine("test", device="cpu", compute_type="float32",
                           audio_buckets_sec=(1.0, 2.0), batch_buckets=(1, 2, 4),
                           max_decode_tokens=32, batch_window_ms=500.0, max_batch=8,
                           draft_mode="on", metrics=hook)
    ran = {}
    counting = {"n": 0}
    real_decode = eng.graphs.decode
    mp = pytest.MonkeyPatch()

    def count(fn):
        def chunk(*args, **kwargs):
            counting["n"] += 1
            return fn(*args, **kwargs)
        return chunk

    def decode(*args, **kwargs):
        counting["n"] = 0
        out = real_decode(*args, **kwargs)
        ran[kwargs["spans"].group_id] = counting["n"]
        return out

    for name in ("_decode_chunk", "_beam_chunk", "_drafted_chunk"):
        mp.setattr(TW, name, count(getattr(TW, name)))
    mp.setattr(eng.graphs, "decode", decode)
    try:
        # a stored draft for session d1, outside the queue
        sync = [eng.transcribe_sync(_req(0.8, 1, "d1"))]
        futures = [eng.submit(r) for r in (
            _req(0.8, 1, "d1"),                       # drafted partial
            _req(0.9, 2, "f1", final=True),           # plain final, 1 s bucket
            _req(0.7, 3, beam_size=2),                # beam 2
            _req(1.5, 4), _req(1.8, 5),               # two plain rows, 2 s bucket
        )]
        queued = [f.result(timeout=300) for f in futures]
        sync.append(eng.transcribe_sync(_req(1.2, 6)))
    finally:
        mp.undo()
        eng.close()
    return eng, hook, queued, sync, ran


def _records(outputs):
    return list({id(o.spans): o.spans for o in outputs}.values())


def _drafted(rec):
    """Whether the record's decode was drafted: it read the finish flag
    before its first chunk."""
    return " prefill sync" in " ".join(name for name, _, _ in rec.dispatch)


def _chunks(rec):
    return sum(1 for name, _, _ in rec.dispatch if name == "replay")


def test_every_output_of_a_group_shares_one_record(served):
    _, hook, queued, sync, _ = served
    records = _records(queued)
    # drafted partial, plain final, beam 2, and the two rows of the 2 s bucket
    assert [o.spans for o in queued[3:]] == [queued[3].spans] * 2
    assert len(records) == 4
    for rec in records:
        outs = [o for o in queued if o.spans is rec]
        assert len(outs) == len(rec.submitted)
        assert sorted(o._row for o in outs) == list(range(len(outs)))
    every = records + _records(sync)
    ids = [r.group_id for r in every]
    assert len(set(ids)) == len(ids) == 6
    # the hook took each record once, with record_engine_batch's seconds
    assert sorted(r.group_id for r in hook.records) == sorted(ids)
    assert sorted(s for _, _, s in hook.batches) == sorted(r.inference_sec for r in every)


def test_stamps_are_in_order_and_the_intervals_follow_one_another(served):
    _, _, queued, sync, _ = served
    records = _records(queued)
    for rec in records + _records(sync):
        names = " ".join(name for name, _, _ in rec.dispatch)
        assert (DRAFTED if _drafted(rec) else PLAIN).fullmatch(names), names
        assert all(s <= e for _, s, e in rec.dispatch)
        assert all(a[2] == b[1] for a, b in zip(rec.dispatch, rec.dispatch[1:]))
        assert rec.dispatch[-1][2] <= rec.end
        queued_rec = rec in records
        assert rec.dispatch[0][0] == ("sem_wait" if queued_rec else "prep")
        assert rec.t_start == rec.dispatch[1 if queued_rec else 0][1]
        # submitted before the group's first interval (the batching window
        # and the grouping lie between)
        assert max(rec.submitted) <= rec.dispatch[0][1]
        assert all(rec.queue_sec(i) >= 0 for i in range(len(rec.submitted)))
    # the batch's first request, the partial of session d1, was drafted
    assert _drafted(queued[0].spans)
    assert not any(_drafted(o.spans) for o in queued[1:])


def test_chunks_are_the_chunks_the_decode_ran(served):
    _, _, queued, sync, ran = served
    records = _records(queued) + _records(sync)
    assert sorted(ran) == sorted(r.group_id for r in records)
    for rec in records:
        assert _chunks(rec) == ran[rec.group_id]
        syncs = sum(1 for name, _, _ in rec.dispatch if name == "sync")
        assert syncs >= _chunks(rec) if _drafted(rec) else syncs == _chunks(rec)
        assert rec.decode_sec == pytest.approx(
            sum(e - s for name, s, e in rec.dispatch if name in ("replay", "sync")),
            abs=1e-12)
    assert all(_chunks(r) > 0 for r in records if not _drafted(r))


def test_inference_sec_is_the_harvest_end_less_the_prep_start(served):
    _, _, queued, sync, _ = served
    for out in queued + sync:
        rec = out.spans
        assert out.inference_sec == pytest.approx(rec.end - rec.t_start, abs=1e-9)
        assert out.inference_sec == rec.inference_sec > 0
