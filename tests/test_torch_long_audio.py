"""Long finals (the seek loop) in the port against the JAX package.

``WhisperEngine("test", device="cpu", compute_type="float32")`` with audio
buckets of 1 and 2 s, so a final of 3.5 s runs two windows (2 s, then the
1.5 s tail), is held against the JAX engine on the same audio: segments
(start, end, text), language and ``temperature_used`` exactly,
``avg_logprob`` and ``no_speech_prob`` at rtol 1e-5, through
``transcribe_sync`` and through ``submit``. The cases: plain (conditioned
on the text so far, the default), timestamp mode, conditioning off with a
fixed prompt, a detected
language pinned from the first window, a prompt reset under the
temperature ladder (the port fed JAX's own draws), clips over the whole
audio and a prefix on the first window only. With stubbed windows, the
timestamp-mode seek moves to the last closed segment as JAX's does. Then
the port's own
contract (``tests/test_engine.py:963-1165``, ``tests/test_draft_decode.py:
523``): a cancel mid-loop, ``close()`` during a long final, partials not
blocked behind one, a long partial keeping its trailing window, seek
windows bypassing the draft store, and the backend's ``transcribe()`` of a
long file.
"""

import threading
import time

import numpy as np
import pytest

from stt_tpu.backends.jax_whisper import JaxWhisperBackend
from stt_tpu.engine import engine as JE
from stt_tpu_torch.backends.torch_whisper import TorchWhisperBackend
from stt_tpu_torch.engine import engine as TE
from tests.test_torch_sampling import JaxDraws
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

ENGINE_KW = dict(device="cpu", compute_type="float32", audio_buckets_sec=(1.0, 2.0),
                 batch_buckets=(1, 4), max_decode_tokens=16)
SECONDS = 3.5


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    sig = 0.2 * np.sin(2 * np.pi * (180 + 30 * seed) * t) + 0.05 * rng.normal(0, 1, t.shape)
    return sig.astype(np.float32)


@pytest.fixture(scope="module")
def engines():
    port, ref = TE.WhisperEngine("test", **ENGINE_KW), JE.WhisperEngine("test", **ENGINE_KW)
    yield port, ref
    port.close()
    ref.close()


def assert_long_equal(t, j):
    assert [(s.start, s.end, s.text) for s in t.segments] == \
        [(s.start, s.end, s.text) for s in j.segments]
    assert t.info.language == j.info.language
    assert t.temperature_used == j.temperature_used
    assert t.avg_logprob == pytest.approx(j.avg_logprob, rel=1e-5)
    assert t.no_speech_prob == pytest.approx(j.no_speech_prob, rel=1e-5)
    assert t.batch_rows == j.batch_rows == 1


LONG_CASES = {
    "plain": ("en", {}),
    "timestamps": ("en", {"without_timestamps": False}),
    "condition-off": ("en", {"initial_prompt": "seed words",
                             "condition_on_previous_text": False}),
    "detected-language": (None, {"initial_prompt": "seed words"}),
    "prompt-reset": ("en", {"initial_prompt": "steering context words",
                            "temperature": [0.0, 0.8], "prompt_reset_on_temperature": 0.5,
                            "compression_ratio_threshold": -1.0, "log_prob_threshold": None}),
    "clips": ("en", {"clip_timestamps": "0.3,1.4,2.5"}),
    "prefix": ("en", {"prefix": "hello there"}),
}


@pytest.mark.parametrize("case", sorted(LONG_CASES))
def test_long_final_equals_the_jax_engine(engines, case, monkeypatch):
    port, ref = engines
    language, options = LONG_CASES[case]
    options = {"no_speech_threshold": None, **options}
    audio = _audio(SECONDS, 11)
    seen = []
    real_window = port._decode_window

    def spy(sub, cancel_event):
        seen.append(dict(sub.options))
        return real_window(sub, cancel_event)

    monkeypatch.setattr(port, "_decode_window", spy)
    draws = JaxDraws(monkeypatch)

    def request(module):
        return module.DecodeRequest(audio, language=language, options=dict(options),
                                    is_final=True, session_id="long")

    t_sync = port.transcribe_sync(request(TE))
    n_windows = len(seen)
    t_queued = port.submit(request(TE)).result(timeout=300)
    j_out = ref.transcribe_sync(request(JE))
    assert_long_equal(t_sync, j_out)
    assert_long_equal(t_queued, j_out)
    assert n_windows >= 2 and len(seen) == 2 * n_windows
    assert all(o["_seek_window"] for o in seen)
    if case == "plain":
        # the second window is conditioned on the first's text
        assert "initial_prompt" not in seen[0]
        assert seen[1].get("_cond_ctx") and seen[1]["initial_prompt"].strip()
    if case == "condition-off":
        assert [o["initial_prompt"] for o in seen[:n_windows]] == ["seed words"] * n_windows
    if case == "prefix":
        assert seen[0]["prefix"] == "hello there"
        assert all("prefix" not in o for o in seen[1:n_windows])
    if case == "clips":
        assert all("clip_timestamps" not in o for o in seen)
    if case == "detected-language":
        # the first window detects; the rest are pinned to its language
        assert t_sync.info.language == j_out.info.language
    if case == "prompt-reset":
        assert t_sync.temperature_used == 0.8 and draws.seeds
    if case == "timestamps":
        starts = [s.start for s in t_sync.segments]
        assert starts == sorted(starts)
        assert all(0.0 <= s.start <= s.end <= SECONDS + 1e-6 for s in t_sync.segments)


def test_timestamp_seek_moves_to_the_last_closed_segment(engines, monkeypatch):
    """A full window whose last segment closes before its end moves the
    seek there (at least one second on), so the next window decodes the
    cut utterance whole; a tail window moves past its end. Random weights
    leave every segment open at the window's end, so both engines' windows
    are stubbed with one segment closing at 1.2 s: the windows' offsets
    and lengths and the global segments are the JAX engine's."""
    from stt_tpu.backends.base import BackendInfo as JInfo, Segment as JSegment
    from stt_tpu_torch.backends.base import BackendInfo as TInfo, Segment as TSegment

    results = []
    for module, eng, seg_cls, info_cls in ((TE, engines[0], TSegment, TInfo),
                                           (JE, engines[1], JSegment, JInfo)):
        windows = []

        def stub(sub, cancel_event, windows=windows, module=module, seg_cls=seg_cls,
                 info_cls=info_cls):
            windows.append(len(sub.audio))
            return module.DecodeOutput(segments=[seg_cls(0.1, 1.2, " a")],
                                       info=info_cls("en", 1.0))

        monkeypatch.setattr(eng, "_decode_window", stub)
        out = eng.transcribe_sync(module.DecodeRequest(
            _audio(SECONDS, 14), language="en", is_final=True,
            options={"without_timestamps": False}))
        results.append((windows, [(x.start, x.end, x.text) for x in out.segments]))
    assert results[0] == results[1]
    windows, segments = results[0]
    # 2 s windows from 0, 1.2 and 2.4 s; the last is the 1.1 s tail
    assert windows == [32000, 32000, 17600]
    assert [x[0] for x in segments] == pytest.approx([0.1, 1.3, 2.5])


def test_cancel_mid_loop_stops_after_the_window(engines, monkeypatch):
    """A long final whose cancel event is set during its first window
    returns that window alone, as the JAX engine's loop does."""
    outs = []
    for module, eng in zip((TE, JE), engines):
        cancel = threading.Event()
        real_window = eng._decode_window

        def first_then_cancel(sub, cancel_event, real_window=real_window, cancel=cancel):
            out = real_window(sub, cancel_event)
            cancel.set()
            return out

        monkeypatch.setattr(eng, "_decode_window", first_then_cancel)
        outs.append(eng.submit(module.DecodeRequest(
            _audio(SECONDS, 12), language="en", is_final=True,
            options={"no_speech_threshold": None}), cancel_event=cancel).result(timeout=300))
    t_out, j_out = outs
    assert_long_equal(t_out, j_out)
    assert all(s.end <= 2.0 + 1e-6 for s in t_out.segments)


def test_backend_transcribes_a_long_file(engines):
    port, ref = engines
    audio = _audio(SECONDS, 13)
    options = {"language": "en", "without_timestamps": False}
    t_segs, t_info = TorchWhisperBackend("test", engine=port).transcribe(audio, options)
    j_segs, j_info = JaxWhisperBackend("test", engine=ref).transcribe(audio, options)
    assert [(s.start, s.end, s.text) for s in t_segs] == \
        [(s.start, s.end, s.text) for s in j_segs]
    assert t_info.language == j_info.language == "en"


# -- the port's own contract (tests/test_engine.py:1049-1150) ---------------------


def _small_engine(**kw):
    return TE.WhisperEngine("test", device="cpu", compute_type="float32",
                            audio_buckets_sec=(1.0,), batch_buckets=(1,),
                            max_decode_tokens=16, **kw)


def test_close_during_long_final_resolves_future():
    eng = _small_engine(batch_window_ms=0.0)
    fut = eng.submit(TE.DecodeRequest(_audio(4.0, 45), language="en", is_final=True,
                                      session_id="L"))
    time.sleep(0.3)
    eng.close()
    assert fut.done(), "long-final future left hanging by close()"
    try:
        assert fut.result(timeout=1).batch_rows == 1
    except RuntimeError:
        pass  # failed mid-loop by the shutdown
    assert not eng._running
    assert eng._thread is None and eng._harvest_thread is None
    assert eng._long_pool is None


def test_long_final_does_not_block_partials():
    """A long final's windows go through the queue: a partial submitted
    mid-loop is dispatched between its windows and finishes well before
    the final (``tests/test_engine.py:1074``)."""
    eng = _small_engine(batch_window_ms=0.0)
    partial = TE.DecodeRequest(_audio(0.5, 44), language="en", session_id="p")
    eng.transcribe_sync(partial)
    t0 = time.monotonic()
    eng.transcribe_sync(partial)
    baseline = time.monotonic() - t0
    real = eng._device_phase
    delay = max(0.05, baseline)
    dispatch_order = []

    def slow(group):
        dispatch_order.extend(t.request.session_id for t in group)
        time.sleep(delay)
        return real(group)

    eng._device_phase = slow
    t_long = time.monotonic()
    long_fut = eng.submit(TE.DecodeRequest(_audio(8.0, 46), language="en", is_final=True,
                                           session_id="L"))
    time.sleep(delay * 1.5)
    t0 = time.monotonic()
    out = eng.submit(partial).result(timeout=60)
    partial_lat = time.monotonic() - t0
    assert out.batch_rows >= 1
    assert long_fut.result(timeout=120).batch_rows == 1
    long_lat = time.monotonic() - t_long
    assert partial_lat < long_lat / 2
    assert "p" in dispatch_order
    windows_after_partial = len(dispatch_order) - 1 - (
        dispatch_order.index("p") + dispatch_order.count("p"))
    assert windows_after_partial >= 2, dispatch_order
    eng.close()


def test_long_partial_keeps_trailing_window():
    eng = _small_engine()
    out = eng.transcribe_sync(TE.DecodeRequest(_audio(3.0, 42), language="en",
                                               is_final=False))
    assert out.batch_rows == 1
    assert all(seg.end <= 1.0 + 1e-6 for seg in out.segments)
    eng.close()


def test_seek_windows_bypass_draft_store():
    """Seek windows neither take nor store drafts, and the long final
    evicts the session's streaming draft (``tests/test_draft_decode.py:
    523``)."""
    eng = TE.WhisperEngine("test", device="cpu", compute_type="float32",
                           audio_buckets_sec=(1.0, 2.0), batch_buckets=(1, 4),
                           max_decode_tokens=16, draft_mode="on")
    sid = "drafts-long"
    eng.transcribe_sync(TE.DecodeRequest(_audio(1.5, 41), language="en", session_id=sid))
    assert sid in eng._drafts
    before = dict(eng.draft_stats)
    out = eng.transcribe_sync(TE.DecodeRequest(_audio(4.5, 42), language="en",
                                               is_final=True, session_id=sid))
    assert out.segments is not None
    assert dict(eng.draft_stats) == before
    assert len(eng._draft_get(sid)) == 0
    assert not TE._draft_option_ok(TE.DecodeRequest(
        np.zeros(10, np.float32), session_id=sid, options={"_seek_window": True}))
    eng.close()
