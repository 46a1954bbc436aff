"""The port's batched VAD scorer against the per-session numpy path.

Counterparts of ``tests/test_vad_scorer.py`` on the CPU: the scorer's
one :func:`~stt_tpu_torch.ops.vad.vad_step_torch` call per tick over
(B, F, 512) frames gives each session the numpy path's probabilities within
atol 1e-5 (and the JAX scorer's, on the same chunks), sessions scored
concurrently leak nothing across rows, chunks of different frame counts
group apart, and a gate endpointing through the scorer triggers exactly
where the host path does. The failure path is loud: after the device call
fails, every request the host scores is logged and counted (``fallbacks``
and the runtime metrics' ``vad_scorer_fallbacks``). The prewarm scores
every (frame count, batch bucket) shape and raises when it cannot; the
runtime builds the scorer for ``vad_device: device`` and does not catch a
failed prewarm.
"""

import logging
import threading

import numpy as np
import pytest
import torch

from stt_tpu.ops import vad as JV
from stt_tpu.server.component.vad_scorer import BatchedVadScorer as JaxScorer
from stt_tpu_torch.ops import vad as V
from stt_tpu_torch.server.component.vad_gate import VADGate, VADModelPool
from stt_tpu_torch.server.component.vad_scorer import BatchedVadScorer, scorer_device
from stt_tpu_torch.server.runtime.metrics import Metrics
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5


def _scorer(**kw):
    return BatchedVadScorer("cpu", **kw)


def _chunks(seed: int, n_chunks: int = 6, frames_per_chunk: int = 3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_chunks):
        level = 0.2 if i % 2 == 0 else 0.005
        out.append((level * rng.standard_normal((frames_per_chunk, V.VAD_FRAME_SAMPLES)))
                   .astype(np.float32))
    return out


def _numpy_stream(chunks):
    state = V.init_state(np)
    probs = []
    for frames in chunks:
        p, state = V.vad_step(np, frames, state)
        probs.append(p)
    return np.concatenate(probs), state


def _scored_stream(scorer, chunks):
    state = V.init_state(np)
    got = []
    for frames in chunks:
        p, state = scorer.score(frames, state)
        got.append(np.asarray(p))
    return np.concatenate(got), state


def test_batched_scorer_matches_numpy_stream():
    scorer = _scorer(batch_window_ms=1.0)
    try:
        chunks = _chunks(0)
        got, state = _scored_stream(scorer, chunks)
        ref, ref_state = _numpy_stream(chunks)
        np.testing.assert_allclose(got, ref, atol=ATOL)
        np.testing.assert_allclose(state.noise_floor, ref_state.noise_floor, rtol=1e-5)
        np.testing.assert_allclose(state.prob, ref_state.prob, atol=ATOL)
        assert int(state.frames_seen) == int(ref_state.frames_seen) == 18
        assert scorer.batches == 6 and scorer.fallbacks == 0
    finally:
        scorer.close()


def test_batched_scorer_matches_the_jax_scorer():
    chunks = _chunks(4)
    jax_scorer, scorer = JaxScorer(batch_window_ms=1.0), _scorer(batch_window_ms=1.0)
    try:
        state = JV.init_state(np)
        ref = []
        for frames in chunks:
            p, state = jax_scorer.score(frames, state)
            ref.append(np.asarray(p))
        got, _ = _scored_stream(scorer, chunks)
        np.testing.assert_allclose(got, np.concatenate(ref), atol=ATOL)
    finally:
        jax_scorer.close()
        scorer.close()


def test_batched_scorer_concurrent_sessions_independent():
    """Sessions scoring concurrently through one scorer each match their own
    sequential numpy stream: batching leaks nothing across rows."""
    scorer = _scorer(batch_window_ms=3.0)
    results, errors = {}, []

    def session(seed: int):
        try:
            results[seed] = _scored_stream(scorer, _chunks(seed))[0]
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=session, args=(seed,)) for seed in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    try:
        assert not errors
        for seed in range(6):
            np.testing.assert_allclose(results[seed], _numpy_stream(_chunks(seed))[0], atol=ATOL)
        assert scorer.batches < 36      # some ticks batched several sessions
    finally:
        scorer.close()


def test_batched_scorer_mixed_frame_counts():
    """Chunks with different frame counts in one window group apart."""
    scorer = _scorer(batch_window_ms=3.0)
    try:
        rng = np.random.default_rng(3)
        for n_frames in (1, 2, 3, 5):
            frames = (0.1 * rng.standard_normal((n_frames, V.VAD_FRAME_SAMPLES))).astype(
                np.float32)
            p, state = scorer.score(frames, V.init_state(np))
            assert np.asarray(p).shape == (n_frames,)
            assert int(state.frames_seen) == n_frames
            np.testing.assert_allclose(p, V.vad_step(np, frames, V.init_state(np))[0], atol=ATOL)
    finally:
        scorer.close()


def test_group_pads_rows_never_frames():
    scorer = _scorer()
    calls = []
    real = V.vad_step_torch

    def spy(frames, *args, **kw):
        calls.append(tuple(frames.shape))
        return real(frames, *args, **kw)

    try:
        import stt_tpu_torch.server.component.vad_scorer as S
        S.vad_ops.vad_step_torch, saved = spy, S.vad_ops.vad_step_torch
        try:
            pending = [S._Pending(c, V.init_state(np)) for c in _chunks(1, 3)]
            results = scorer._score_group(3, pending)
        finally:
            S.vad_ops.vad_step_torch = saved
        assert calls == [(4, 3, V.VAD_FRAME_SAMPLES)] and len(results) == 3
    finally:
        scorer.close()


def test_scorer_failure_is_counted_and_logged(caplog):
    metrics = Metrics()
    scorer = _scorer(batch_window_ms=1.0, metrics=metrics)

    def boom(*a, **k):
        raise RuntimeError("injected")

    scorer._score_device = boom
    frames = np.zeros((2, V.VAD_FRAME_SAMPLES), np.float32)
    caplog.set_level(logging.WARNING)
    try:
        for _ in range(3):
            p, _ = scorer.score(frames, V.init_state(np))
            np.testing.assert_allclose(p, V.vad_step(np, frames, V.init_state(np))[0])
        assert not scorer.healthy and scorer.fallbacks == 3
        assert metrics.render()["vad_scorer_fallbacks"] == 3
        assert sum("VAD scorer" in r.getMessage() for r in caplog.records) == 3
    finally:
        scorer.close()


def test_pool_attached_scorer_used_by_gate():
    """Endpointing through the batched scorer triggers where the host path
    does (threshold semantics transfer unchanged)."""
    t = np.arange(1600) / 16000.0
    speech = (0.2 * np.sin(2 * np.pi * 220 * t)
              * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t))).astype(np.float32)
    seq = [speech] * 6 + [np.zeros(1600, np.float32)] * 12

    def run(pool):
        gate = VADGate(vad_threshold=0.5, vad_silence=0.4, model_pool=pool)
        trig = [gate.update((chunk * 32767).astype(np.int16).tobytes(), 16000).triggered
                for chunk in seq]
        gate.close()
        return trig

    metrics = Metrics()
    scorer = _scorer(batch_window_ms=1.0, metrics=metrics)
    dev_pool = VADModelPool()
    dev_pool.set_scorer(scorer)
    try:
        host_trig, dev_trig = run(VADModelPool()), run(dev_pool)
        assert host_trig == dev_trig and any(host_trig)
        rendered = metrics.render()
        assert rendered["vad_scorer_batches"] > 0 and rendered["vad_scorer_fallbacks"] == 0
    finally:
        scorer.close()


def test_prewarm_scores_every_shape_and_raises_on_failure():
    scorer = _scorer()
    try:
        scorer.prewarm(frame_counts=(1, 3))
        assert scorer.batches == 2 * len(scorer.batch_buckets)
        scorer._consts = None           # a scorer that cannot run
        with pytest.raises(Exception):
            scorer.prewarm(frame_counts=(1,), batch_sizes=(1,))
    finally:
        scorer.close()


def test_scorer_device_names():
    assert scorer_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        for name in ("tpu", "gpu", "cuda", None):
            with pytest.raises(RuntimeError):
                scorer_device(name)


def test_runtime_builds_the_scorer_and_a_failed_prewarm_raises(monkeypatch):
    from stt_tpu_torch.config.loader import load_config
    from stt_tpu_torch.server.runtime import runtime as R

    config = load_config()
    config.device, config.vad_device = "cpu", "device"
    runtime = R.ApplicationRuntime(config, load_default_model=False)
    try:
        scorer = runtime._vad_scorer
        assert scorer is not None and scorer.device.type == "cpu" and scorer.batches > 0
        session = runtime.vad_model_pool.acquire_model()
        assert session._scorer is scorer
    finally:
        runtime.shutdown()

    def failing(self, *a, **k):
        raise RuntimeError("prewarm failed")

    monkeypatch.setattr(R.BatchedVadScorer, "prewarm", failing)
    with pytest.raises(RuntimeError, match="prewarm failed"):
        R.ApplicationRuntime(config, load_default_model=False)
