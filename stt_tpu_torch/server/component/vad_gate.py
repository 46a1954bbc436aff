"""VAD endpointing gate with pooled capacity semantics.

Own copy of ``stt_tpu/server/component/vad_gate.py`` for the port, which imports nothing of ``stt_tpu``.

Contract-compatible with the reference (``stt_server/backend/component/
vad_gate.py:35-413``): a :class:`VADModelPool` enforces session capacity —
``reserve_slot()`` at CreateSession (ERR1008 when exhausted), geometric
capacity growth up to a max, prewarm — and a per-stream :class:`VADGate`
buffers PCM into 512-sample/32 ms frames, scores them, keeps the max
probability per chunk, and accumulates trailing-silence duration until
``silence >= vad_silence`` triggers endpointing.

What differs: the scorer is the deterministic DSP VAD from
:mod:`stt_tpu_torch.ops.vad` (Silero weights are unreachable in a zero-egress
build; a deployment that has the Silero ONNX file sets ``vad_model_path``
and scores with :mod:`stt_tpu_torch.ops.silero` on the configured device) — "a model instance" is just a tiny :class:`VadSession` state struct,
so pooling costs nothing but the *limits* still behave identically, and the
same scoring math can run batched on device for all sessions (ops.vad is
namespace-generic). The gate additionally tracks the utterance-start estimate
used for leading-silence trimming in final decode windows (reference
``flow.py:149-167``).
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ...ops import vad as vad_ops
from ...utils import audio as audio_utils
from ...utils.logging import LOGGER


class VadSession:
    """Per-stream streaming scorer state (the pool's 'model instance').

    With a shared :class:`~stt_tpu_torch.server.component.vad_scorer.
    BatchedVadScorer` attached (``vad_device: device``), scoring routes
    through ONE cross-session device batch per tick, and after a scorer
    failure through the scorer's own host fallback, which logs and counts
    every request it scores; otherwise (host scoring, tests) the identical
    math runs as per-session numpy — the two paths agree within 1e-5
    (``tests/test_torch_vad_scorer.py``), so tuned ``vad_threshold`` values
    transfer unchanged.
    """

    def __init__(
        self,
        params: Optional[vad_ops.VadParams] = None,
        scorer=None,
    ) -> None:
        self.params = params or vad_ops.VadParams()
        # the batched scorer compiles the default-params program only
        self._scorer = (
            scorer if self.params == vad_ops.VadParams() else None
        )
        self.state = vad_ops.init_state(np, self.params)

    def reset(self) -> None:
        self.state = vad_ops.init_state(np, self.params)

    def score(self, frames: np.ndarray) -> np.ndarray:
        """frames (F, 512) -> probabilities (F,)."""
        if self._scorer is not None:
            probs, self.state = self._scorer.score(frames, self.state)
            return np.asarray(probs)
        probs, self.state = vad_ops.vad_step(np, frames, self.state, self.params)
        return probs


class VADModelPool:
    """Capacity-gated pool of VadSession instances.

    Reservation (slots) and instantiation (models) are decoupled exactly as
    in the reference: CreateSession reserves, the stream acquires on first
    audio, and capacity grows by ``growth_factor`` up to ``max_capacity``.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._capacity = 0
        self._max_capacity = 0
        self._growth = 1.5
        self._reserved = 0
        self._free: list = []
        self._total_created = 0
        self._scorer = None          # shared BatchedVadScorer (vad_device: device)
        self._silero_path: Optional[str] = None
        self._silero_device = None
        self._silero_model = None    # lazily-loaded shared Silero graph

    def set_scorer(self, scorer) -> None:
        """Attach a shared cross-session batched scorer; sessions created
        from here on route their frame scoring through it."""
        with self._lock:
            self._scorer = scorer
            for session in self._free:
                if isinstance(session, VadSession):
                    session._scorer = scorer

    def set_silero_model(self, path: Optional[str], device=None) -> None:
        """Use a learned Silero VAD loaded from a local ONNX file instead
        of the DSP scorer (reference loads Silero ONNX/TorchScript,
        ``stt_server/backend/component/vad_gate.py:235-247``). NOTE:
        Silero probability scales differ from the DSP VAD's — re-tune
        ``vad_threshold`` when switching (Silero's own default is 0.5,
        same as ours, but the distributions are not identical). The
        graph runs on ``device`` (the card unless it names the CPU)."""
        with self._lock:
            self._silero_path = path or None
            self._silero_device = device
            self._silero_model = None
            if self._silero_path:
                self._free.clear()

    def _new_session(self):
        if self._silero_path:
            from ...ops.silero import SileroVad, SileroVadSession

            if self._silero_model is None:
                self._silero_model = SileroVad.from_onnx(self._silero_path,
                                                         device=self._silero_device)
            return SileroVadSession(self._silero_model)
        return VadSession(scorer=self._scorer)

    def configure(
        self,
        max_size: Optional[int] = None,
        prewarm: Optional[int] = None,
        max_capacity: Optional[int] = None,
        growth_factor: Optional[float] = None,
    ) -> None:
        max_size = max(0, int(max_size or 0))
        prewarm = max(0, int(prewarm or 0))
        max_cap = max(0, int(max_capacity or 0)) or max_size
        growth = 1.5
        if growth_factor is not None:
            try:
                growth = max(1.0, float(growth_factor))
            except (TypeError, ValueError):
                pass
        with self._lock:
            if max_size == 0 and max_cap == 0:
                self._capacity = self._max_capacity = 0
                self._free.clear()
                self._reserved = 0
                self._total_created = 0
                return
            self._capacity = min(max_size or max_cap, max_cap)
            self._max_capacity = max_cap
            self._growth = growth
            self._reserved = min(self._reserved, self._capacity)
            del self._free[self._capacity:]
            target = min(prewarm, self._capacity)
            while len(self._free) < target:
                self._free.append(self._new_session())
                self._total_created += 1

    def reserve_slot(self) -> bool:
        with self._lock:
            if self._capacity <= 0:
                return True  # unlimited when unconfigured
            if self._reserved < self._capacity:
                self._reserved += 1
                return True
            if self._capacity < self._max_capacity:
                new_cap = min(
                    self._max_capacity,
                    max(1, int(math.ceil(self._capacity * self._growth))),
                )
                if new_cap > self._capacity:
                    self._capacity = new_cap
                    LOGGER.info("expanded VAD pool capacity to %d", new_cap)
                if self._reserved < self._capacity:
                    self._reserved += 1
                    return True
            return False

    def release_slot(self) -> None:
        with self._lock:
            if self._capacity > 0 and self._reserved > 0:
                self._reserved -= 1

    def acquire_model(self):
        with self._lock:
            if self._capacity > 0 and self._free:
                session = self._free.pop()
                session.reset()
                return session
            if self._capacity > 0:
                if self._total_created >= self._capacity:
                    LOGGER.warning("VAD pool capacity exceeded; overflow instance")
                self._total_created += 1
            return self._new_session()

    def release_model(self, session: VadSession) -> None:
        with self._lock:
            if self._capacity <= 0:
                return
            if len(self._free) >= self._capacity:
                self._total_created = max(0, self._total_created - 1)
                return
            session.reset()
            self._free.append(session)

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self._capacity,
                "max_capacity": self._max_capacity,
                "reserved": self._reserved,
                "free": len(self._free),
                "total_created": self._total_created,
            }


@dataclass
class VADGateUpdate:
    """Result of feeding one chunk through the gate."""

    triggered: bool
    speech_active: bool
    silence_duration: float
    chunk_duration: float
    chunk_rms: float


class VADGate:
    """Per-stream endpointing state machine over 32 ms scored frames."""

    FRAME = vad_ops.VAD_FRAME_SAMPLES

    def __init__(
        self,
        vad_threshold: float,
        vad_silence: float,
        model_pool: Optional[VADModelPool] = None,
    ) -> None:
        self.vad_threshold = vad_threshold
        self.vad_silence = vad_silence
        self.speech_active = False
        self.silence_duration = 0.0
        self._pool = model_pool
        self._scorer: Optional[VadSession] = (
            (model_pool or VADModelPool()).acquire_model()
            if vad_threshold > 0
            else None
        )
        self._pending = np.empty(0, np.float32)  # tail < one frame
        # bookkeeping for leading-silence trimming
        self._stream_seconds = 0.0
        self.speech_started_at: Optional[float] = None

    def _chunk_probability(self, chunk_bytes: bytes, sample_rate: int) -> float:
        audio_f32 = audio_utils.pcm16_to_float32(chunk_bytes)
        if sample_rate and sample_rate != vad_ops.VAD_SAMPLE_RATE:
            audio_f32 = audio_utils.resample_linear(
                audio_f32, sample_rate, vad_ops.VAD_SAMPLE_RATE
            )
        if audio_f32.size == 0:
            return 0.0
        buf = np.concatenate([self._pending, audio_f32])
        n_frames = buf.size // self.FRAME
        self._pending = buf[n_frames * self.FRAME:]
        if n_frames == 0:
            return 0.0
        frames = buf[: n_frames * self.FRAME].reshape(n_frames, self.FRAME)
        probs = self._scorer.score(frames)
        return float(probs.max())

    def update(self, chunk_bytes: bytes, sample_rate: int) -> VADGateUpdate:
        chunk_duration = audio_utils.chunk_duration_seconds(
            len(chunk_bytes), sample_rate
        )
        rms = audio_utils.chunk_rms(chunk_bytes)
        triggered = False

        if chunk_bytes:
            if self._scorer is None:
                speech_detected = True
            else:
                speech_detected = (
                    self._chunk_probability(chunk_bytes, sample_rate)
                    >= self.vad_threshold
                )
            if speech_detected:
                if not self.speech_active:
                    self.speech_started_at = self._stream_seconds
                self.speech_active = True
                self.silence_duration = 0.0
            else:
                self.silence_duration += chunk_duration
        elif chunk_duration > 0:
            self.silence_duration += chunk_duration

        self._stream_seconds += chunk_duration
        if self.speech_active and self.silence_duration >= self.vad_silence:
            triggered = True

        return VADGateUpdate(
            triggered=triggered,
            speech_active=self.speech_active,
            silence_duration=self.silence_duration,
            chunk_duration=chunk_duration,
            chunk_rms=rms,
        )

    def reset_after_trigger(self) -> None:
        self.speech_active = False
        self.silence_duration = 0.0
        self.speech_started_at = None

    def close(self) -> None:
        if self._scorer is not None and self._pool is not None:
            self._pool.release_model(self._scorer)
        self._scorer = None


def buffer_is_speech(buffer_bytes: bytes, threshold: float) -> bool:
    """RMS floor gate protecting decode capacity from pure-noise buffers."""
    if threshold <= 0:
        return True
    return audio_utils.chunk_rms(buffer_bytes) >= threshold


__all__ = [
    "VADGate",
    "VADGateUpdate",
    "VADModelPool",
    "VadSession",
    "buffer_is_speech",
]
