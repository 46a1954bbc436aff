"""Streaming recognition orchestrator: the per-RPC control loop.

Own copy of ``stt_tpu/server/application/orchestrator.py`` for the port, which imports nothing of ``stt_tpu``.

Behavior parity with the reference stream orchestrator
(``stt_server/backend/application/stream_orchestrator/{orchestrator,flow,
types,helpers}.py``), collapsed into one module: the reference splits the
loop across four files with a flow-ops indirection layer; here the state
machine is plain methods on :class:`StreamOrchestrator` with injectable
collaborators (decode scheduler, VAD-gate factory, session facade) so unit
tests can substitute fakes without monkeypatching module internals.

Wire-visible behaviors kept exactly:
- phases INIT -> STREAMING -> DRAINING -> DONE (reference ``types.py:254``)
- per-chunk pipeline: disconnect/timeout gates, session resolution from
  chunk, token validation, chunk-size cap (ERR1007), stream byte-rate
  (ERR2003) and audio-seconds (ERR2004) limits, WAV capture, global buffer
  shed, VAD update, trigger/periodic-partial scheduling, buffer-limit
  enforcement, non-blocking emit (reference ``flow.py:326-477``)
- VAD trigger path: RMS speech gate, leading-silence trim, AUTO_END and
  ``emit_final_on_vad`` finals (reference ``flow.py:45-167``)
- buffer overflow: partial decode over the trailing window retaining
  ``buffer_overlap_sec`` when partials are enabled, else oldest-trim
  (reference ``orchestrator.py:916-1001``)
- per-stream pending cap with partial-drop and global pending slots with
  blocking finals + ERR2001 abort (reference ``orchestrator.py:326-432``)
- drain loop with blocking emit and session-timeout abort ERR1006
  (reference ``flow.py:223-271``)
- inactivity watchdog thread, disconnect callback cancelling pending
  decodes, trailing ``stt-decode-*-sec`` metadata (reference
  ``orchestrator.py:477-537,676-708``)

The decode data plane differs by design: decodes land on the cross-session
micro-batching TPU engine via the registry's fair session queues instead of
per-worker threads, so "scheduling a decode" is cheap and the orchestrator
thread never blocks on device work except in the drain phase.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import grpc

from ...config.languages import SupportedLanguages
from ...errors import ErrorCode, abort_with_error
from ...gen import stt_pb2
from ...utils import audio
from ...utils.logging import LOGGER, set_session_id
from ...utils.rate_limit import KeyedRateLimiter
from ..component.audio_storage import (
    AudioStorageConfig,
    AudioStorageManager,
    SessionAudioRecorder,
)
from ..component.decode_scheduler import DecodeScheduler, DecodeStream
from ..component.vad_gate import VADGate, VADModelPool, buffer_is_speech
from .session_manager import SessionFacade, SessionState

VAD_CONTINUE = stt_pb2.VAD_CONTINUE
VAD_AUTO_END = stt_pb2.VAD_AUTO_END

_TRUE = {"1", "true", "yes", "y", "on", "enable", "enabled"}
_FALSE = {"0", "false", "no", "n", "off", "disable", "disabled"}


def _attr_bool(attributes: Dict[str, str], *keys: str) -> Optional[bool]:
    for key in keys:
        raw = attributes.get(key)
        if raw is None:
            continue
        value = str(raw).strip().lower()
        if value in _TRUE:
            return True
        if value in _FALSE:
            return False
    return None


# ---------------------------------------------------------------------------
# Settings
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StreamSettings:
    vad_threshold: float = 0.5
    vad_silence: float = 0.8
    speech_rms_threshold: float = 0.0
    session_timeout_sec: float = 60.0
    default_sample_rate: int = 16000
    decode_timeout_sec: float = 30.0
    language_lookup: SupportedLanguages = field(default_factory=SupportedLanguages)
    log_transcripts: bool = False
    max_audio_seconds_per_session: float = 0.0
    max_audio_bytes_per_sec: int = 0
    max_audio_bytes_per_sec_burst: int = 0
    max_audio_bytes_per_sec_realtime: Optional[int] = None
    max_audio_bytes_per_sec_burst_realtime: Optional[int] = None
    max_audio_bytes_per_sec_batch: Optional[int] = None
    max_audio_bytes_per_sec_burst_batch: Optional[int] = None
    emit_final_on_vad: bool = False


@dataclass(frozen=True)
class BufferLimits:
    max_buffer_sec: Optional[float] = 20.0
    max_buffer_bytes: Optional[int] = None
    max_chunk_ms: Optional[int] = 2000
    max_total_buffer_bytes: Optional[int] = 64 * 1024 * 1024
    buffer_overlap_sec: float = 0.5


@dataclass(frozen=True)
class PartialDecodeSettings:
    interval_sec: Optional[float] = 1.5
    # trailing 5 s bucket (reference ships 10.0) — the decode-loop halving
    # that meets p95 partial < 300 ms at 64 streams; see config/defaults.py
    window_sec: Optional[float] = 5.0


@dataclass(frozen=True)
class DecodeQueueSettings:
    max_pending_decodes_per_stream: int = 8
    max_pending_decodes_global: int = 64
    decode_queue_timeout_sec: float = 1.0


@dataclass(frozen=True)
class HealthSettings:
    window_sec: float = 60.0
    min_events: int = 5
    max_timeout_ratio: float = 0.5
    min_success_ratio: float = 0.5


@dataclass(frozen=True)
class VADPoolSettings:
    size: Optional[int] = None
    prewarm: Optional[int] = None
    max_size: Optional[int] = None
    growth_factor: float = 1.5


@dataclass(frozen=True)
class StorageSettings:
    enabled: bool = False
    directory: str = "session_audio"
    queue_max_chunks: Optional[int] = None
    max_bytes: Optional[int] = None
    max_files: Optional[int] = None
    max_age_days: Optional[int] = None


@dataclass(frozen=True)
class OrchestratorConfig:
    stream: StreamSettings = field(default_factory=StreamSettings)
    storage: StorageSettings = field(default_factory=StorageSettings)
    vad_pool: VADPoolSettings = field(default_factory=VADPoolSettings)
    buffer_limits: BufferLimits = field(default_factory=BufferLimits)
    partial_decode: PartialDecodeSettings = field(default_factory=PartialDecodeSettings)
    decode_queue: DecodeQueueSettings = field(default_factory=DecodeQueueSettings)
    health: HealthSettings = field(default_factory=HealthSettings)


def _noop(*_a, **_k) -> None:
    return None


@dataclass(frozen=True)
class OrchestratorHooks:
    """Metric fan-out; defaults no-op so this module never imports Metrics."""

    on_vad_trigger: Callable[[], None] = _noop
    on_vad_utterance_start: Callable[[], None] = _noop
    active_vad_utterances: Callable[[], int] = lambda: 0
    on_buffer_total_bytes: Callable[[int], None] = _noop
    on_stream_buffer_bytes: Callable[[str, int], None] = _noop
    on_stream_end: Callable[[str], None] = _noop
    on_partial_drop: Callable[[int], None] = _noop
    on_rate_limit_block: Callable[[str, str], None] = _noop


# ---------------------------------------------------------------------------
# Per-RPC state
# ---------------------------------------------------------------------------


class StreamPhase(Enum):
    INIT = "init"
    STREAMING = "streaming"
    DRAINING = "draining"
    DONE = "done"


@dataclass
class StreamState:
    """Mutable state for one streaming RPC."""

    # session
    session_state: Optional[SessionState] = None
    session_logged: bool = False
    final_reason: str = "stream_end"
    session_start: float = field(default_factory=time.monotonic)
    client_disconnected: bool = False
    sample_rate: Optional[int] = None
    audio_recorder: Optional[SessionAudioRecorder] = None
    # vad
    vad_state: Optional[VADGate] = None
    vad_count: int = 0
    speech_active: bool = False
    utterance_start_sec: Optional[float] = None
    utterance_end_sec: Optional[float] = None
    # decode
    decode_stream: Optional[DecodeStream] = None
    # buffer
    buffer: bytearray = field(default_factory=bytearray)
    buffer_start_sec: float = 0.0
    buffer_start_time: Optional[float] = None
    buffer_has_new_audio: bool = False
    last_partial_decode_sec: Optional[float] = None
    # activity
    audio_received_sec: float = 0.0
    last_activity: float = field(default_factory=time.monotonic)
    # events
    stop_watchdog: threading.Event = field(default_factory=threading.Event)
    timeout_event: threading.Event = field(default_factory=threading.Event)
    disconnect_event: threading.Event = field(default_factory=threading.Event)
    processing_event: threading.Event = field(default_factory=threading.Event)
    stop_stream: bool = False
    phase: StreamPhase = StreamPhase.INIT

    def session_id(self) -> Optional[str]:
        return self.session_state.session_id if self.session_state else None


class AudioBufferLedger:
    """Global buffered-audio byte accounting with oldest-shed on overflow
    (reference ``types.py:337-429``)."""

    def __init__(self, config: OrchestratorConfig) -> None:
        self._config = config
        self._lock = threading.Lock()
        self._total = 0

    def update_total(self, delta: int) -> None:
        if delta == 0:
            return
        with self._lock:
            self._total = max(0, self._total + delta)

    def total_bytes(self) -> int:
        with self._lock:
            return self._total

    def apply_global_limit(self, state: StreamState, incoming_len: int) -> int:
        """Admit incoming bytes against the global cap; sheds oldest bytes
        from this stream's own buffer first, then truncates the incoming
        chunk. Returns how many incoming bytes may be kept."""
        if incoming_len <= 0:
            return 0
        limit = self._config.buffer_limits.max_total_buffer_bytes
        if not limit or limit <= 0:
            self.update_total(incoming_len)
            return incoming_len
        with self._lock:
            overflow = self._total + incoming_len - limit
            if overflow <= 0:
                self._total += incoming_len
                return incoming_len
            shed = min(overflow, len(state.buffer))
            if shed > 0:
                del state.buffer[:shed]
                self._total = max(0, self._total - shed)
                rate = state.sample_rate or self._config.stream.default_sample_rate
                shed_sec = audio.chunk_duration_seconds(shed, rate)
                state.buffer_start_sec += shed_sec
                if state.buffer_start_time is not None:
                    state.buffer_start_time += shed_sec
                overflow -= shed
            if overflow > 0:
                LOGGER.warning(
                    "global buffer limit reached; dropping %d incoming bytes",
                    overflow,
                )
            keep = max(0, incoming_len - overflow)
            self._total = max(0, self._total + keep)
            return keep

    def clear(self, state: StreamState) -> None:
        if state.buffer:
            self.update_total(-len(state.buffer))
            state.buffer = bytearray()
        state.buffer_start_time = None
        state.buffer_has_new_audio = False
        state.last_partial_decode_sec = None

    def buffer_limit_bytes(self, sample_rate: Optional[int]) -> Optional[int]:
        limits = self._config.buffer_limits
        limit: Optional[int] = None
        if limits.max_buffer_bytes and limits.max_buffer_bytes > 0:
            limit = int(limits.max_buffer_bytes)
        if limits.max_buffer_sec and limits.max_buffer_sec > 0:
            rate = sample_rate or self._config.stream.default_sample_rate
            sec_limit = int(limits.max_buffer_sec * rate * 2)
            if sec_limit > 0:
                limit = sec_limit if limit is None else min(limit, sec_limit)
        return limit

    def partial_window_bytes(self, sample_rate: Optional[int]) -> Optional[int]:
        window_sec = self._config.partial_decode.window_sec
        if window_sec is None or window_sec <= 0:
            return None
        rate = sample_rate or self._config.stream.default_sample_rate
        if rate <= 0:
            return None
        return max(1, int(window_sec * rate * 2))


def trim_leading_silence(
    pcm: bytes, offset_sec: float, utterance_start_sec: float, sample_rate: int
) -> tuple:
    """Drop pre-utterance audio from a final decode window, keeping global
    timestamps consistent (reference ``flow.py:149-167``)."""
    if utterance_start_sec <= offset_sec or sample_rate <= 0:
        return pcm, offset_sec
    drop = int((utterance_start_sec - offset_sec) * sample_rate * 2)
    drop -= drop % 2
    if drop <= 0 or drop >= len(pcm):
        return pcm, offset_sec
    return pcm[drop:], offset_sec + drop / (sample_rate * 2.0)


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------


class StreamOrchestrator:
    """Drives one bidirectional streaming RPC end to end."""

    def __init__(
        self,
        session_facade: SessionFacade,
        decode_scheduler: DecodeScheduler,
        config: OrchestratorConfig,
        hooks: Optional[OrchestratorHooks] = None,
        vad_model_pool: Optional[VADModelPool] = None,
        audio_storage: Optional[AudioStorageManager] = None,
    ) -> None:
        self._facade = session_facade
        self._scheduler = decode_scheduler
        self._config = config
        self._hooks = hooks or OrchestratorHooks()
        self._vad_pool = vad_model_pool or VADModelPool()
        self._vad_pool.configure(
            config.vad_pool.size,
            config.vad_pool.prewarm,
            config.vad_pool.max_size,
            config.vad_pool.growth_factor,
        )
        self._ledger = AudioBufferLedger(config)
        self._adaptive_lock = threading.Lock()
        self._partial_interval_override: Optional[float] = None
        self._rate_limiters: Dict[str, Optional[KeyedRateLimiter]] = {}
        self._configure_rate_limiters(config.stream)

        if audio_storage is not None:
            self._storage: Optional[AudioStorageManager] = audio_storage
        elif config.storage.enabled:
            self._storage = AudioStorageManager(
                AudioStorageConfig(
                    directory=config.storage.directory,
                    queue_max_chunks=config.storage.queue_max_chunks,
                    max_bytes=config.storage.max_bytes,
                    max_files=config.storage.max_files,
                    max_age_days=config.storage.max_age_days,
                )
            )
        else:
            self._storage = None

    # -- properties ------------------------------------------------------------

    @property
    def decode_scheduler(self) -> DecodeScheduler:
        return self._scheduler

    @property
    def config(self) -> OrchestratorConfig:
        return self._config

    @property
    def buffer_total_bytes(self) -> int:
        return self._ledger.total_bytes()

    def set_partial_interval_override(self, interval_sec: Optional[float]) -> None:
        """Adaptive-throttle hook: scale the periodic partial cadence."""
        with self._adaptive_lock:
            self._partial_interval_override = interval_sec

    # -- rate limits -------------------------------------------------------------

    def _configure_rate_limiters(self, s: StreamSettings) -> None:
        def pick(limit, burst):
            eff_limit = s.max_audio_bytes_per_sec if limit is None else limit
            eff_burst = s.max_audio_bytes_per_sec_burst if burst is None else burst
            if eff_limit and eff_limit > 0:
                return KeyedRateLimiter(eff_limit, eff_burst or None)
            return None

        self._rate_limiters["realtime"] = pick(
            s.max_audio_bytes_per_sec_realtime,
            s.max_audio_bytes_per_sec_burst_realtime,
        )
        self._rate_limiters["batch"] = pick(
            s.max_audio_bytes_per_sec_batch, s.max_audio_bytes_per_sec_burst_batch
        )

    @staticmethod
    def _rate_key(session_state: SessionState) -> str:
        info = session_state.session_info
        if info.api_key:
            return f"api:{info.api_key}"
        if info.client_ip:
            return f"ip:{info.client_ip}"
        return f"session:{session_state.session_id}"

    @staticmethod
    def _stream_mode(session_state: SessionState) -> str:
        mode = session_state.session_info.attributes.get("upload_mode", "")
        mode = mode.strip().lower()
        return mode if mode in ("batch", "realtime") else "realtime"

    def _enforce_stream_limits(
        self,
        state: StreamState,
        chunk: stt_pb2.AudioChunk,
        context: grpc.ServicerContext,
    ) -> None:
        if not state.session_state:
            return
        n = len(chunk.pcm16)
        if n <= 0:
            return
        limiter = self._rate_limiters.get(self._stream_mode(state.session_state))
        # NB: KeyedRateLimiter defines __len__ (active bucket count), so an
        # idle limiter is falsy — must compare against None here.
        if limiter is not None:
            key = self._rate_key(state.session_state)
            if not limiter.allow(key, cost=n):
                self._hooks.on_rate_limit_block("stream", key)
                LOGGER.warning(
                    "stream rate limit exceeded key=%s session_id=%s",
                    key, state.session_id(),
                )
                abort_with_error(context, ErrorCode.STREAM_RATE_LIMITED)
        max_sec = self._config.stream.max_audio_seconds_per_session
        if max_sec and max_sec > 0:
            rate = state.sample_rate or self._config.stream.default_sample_rate
            next_total = state.audio_received_sec + audio.chunk_duration_seconds(n, rate)
            if next_total > max_sec:
                LOGGER.warning(
                    "stream audio limit exceeded session_id=%s total=%.2f limit=%.2f",
                    state.session_id(), next_total, max_sec,
                )
                abort_with_error(context, ErrorCode.STREAM_AUDIO_LIMIT_EXCEEDED)

    # -- capacity / slots --------------------------------------------------------

    def _ensure_decode_capacity(
        self,
        decode_stream: Optional[DecodeStream],
        is_final: bool,
        session_state: Optional[SessionState],
    ) -> bool:
        """Per-stream pending cap: finals evict all queued partials; a new
        partial evicts one older partial, or is dropped if still at cap."""
        if decode_stream is None:
            return False
        limit = self._config.decode_queue.max_pending_decodes_per_stream
        if limit <= 0:
            return True
        pending = decode_stream.pending_count()
        sid = session_state.session_id if session_state else "unknown"
        if is_final:
            if pending >= limit:
                cancelled, orphaned = decode_stream.drop_pending_partials()
                dropped = cancelled + orphaned
                if dropped:
                    self._hooks.on_partial_drop(dropped)
                    LOGGER.warning(
                        "dropped %d pending partials for final decode session_id=%s",
                        dropped, sid,
                    )
            return True
        if pending < limit:
            return True
        cancelled, orphaned = decode_stream.drop_pending_partials(1)
        if cancelled + orphaned:
            self._hooks.on_partial_drop(cancelled + orphaned)
        if decode_stream.pending_count() >= limit:
            LOGGER.warning(
                "pending decode limit reached; dropping partial session_id=%s "
                "pending=%d limit=%d", sid, pending, limit,
            )
            return False
        return True

    def _acquire_decode_slot(
        self, state: StreamState, is_final: bool, context: grpc.ServicerContext
    ) -> bool:
        limit = self._config.decode_queue.max_pending_decodes_global
        if not limit or limit <= 0:
            return True
        timeout = self._config.decode_queue.decode_queue_timeout_sec if is_final else 0.0
        if self._scheduler.acquire_pending_slot(block=is_final, timeout=timeout):
            return True
        if not is_final:
            LOGGER.warning(
                "global pending decode limit reached; dropping partial "
                "session_id=%s", state.session_id(),
            )
            return False
        LOGGER.error(
            "global pending decode limit reached; aborting session_id=%s",
            state.session_id(),
        )
        state.final_reason = "decode_backpressure"
        abort_with_error(context, ErrorCode.DECODE_TIMEOUT)
        return False  # unreachable; abort raises

    def _schedule_decode(
        self,
        state: StreamState,
        pcm: bytes,
        is_final: bool,
        offset_sec: float,
        count_vad: bool,
        buffer_started_at: Optional[float],
        context: grpc.ServicerContext,
    ) -> bool:
        if not state.decode_stream:
            return False
        if not self._acquire_decode_slot(state, is_final, context):
            return False
        state.decode_stream.schedule_decode(
            pcm,
            state.sample_rate or self._config.stream.default_sample_rate,
            state.session_state.decode_options if state.session_state else {},
            is_final,
            offset_sec,
            count_vad=count_vad,
            buffer_started_at=buffer_started_at,
            holds_slot=True,
        )
        self._mark_activity(state)
        return True

    def _cancel_pending_decodes(self, state: StreamState) -> None:
        if not state.decode_stream:
            return
        cancelled, running = state.decode_stream.cancel_pending()
        if cancelled:
            LOGGER.info(
                "cancelled %d pending decodes session_id=%s",
                cancelled, state.session_id() or "unknown",
            )
        if running:
            LOGGER.info(
                "%d decodes already running; cancellation requested session_id=%s",
                running, state.session_id() or "unknown",
            )

    # -- activity / watchdog -------------------------------------------------------

    @staticmethod
    def _mark_activity(state: StreamState) -> None:
        state.last_activity = time.monotonic()

    def _watchdog_loop(self, state: StreamState) -> None:
        while not state.stop_watchdog.is_set():
            if state.processing_event.is_set():
                self._mark_activity(state)
            if state.decode_stream and state.decode_stream.has_pending_results():
                self._mark_activity(state)
            remaining = self._config.stream.session_timeout_sec - (
                time.monotonic() - state.last_activity
            )
            if remaining <= 0:
                LOGGER.warning("session inactivity timeout detected")
                state.timeout_event.set()
                return
            if state.stop_watchdog.wait(remaining):
                break

    def _start_watchdog(self, state: StreamState) -> threading.Thread:
        thread = threading.Thread(
            target=self._watchdog_loop, args=(state,), daemon=True
        )
        thread.start()
        return thread

    def _handle_disconnect(self, state: StreamState) -> None:
        if state.disconnect_event.is_set():
            return
        state.disconnect_event.set()
        LOGGER.info("client disconnect callback session_id=%s", state.session_id())
        self._cancel_pending_decodes(state)

    # -- emission ------------------------------------------------------------------

    def _emit_with_activity(
        self, state: StreamState, block: bool
    ) -> Iterator[stt_pb2.STTResult]:
        if not state.decode_stream:
            return
        self._mark_activity(state)
        if state.session_state and (
            state.decode_stream.session_id != state.session_state.session_id
        ):
            state.decode_stream.set_session_id(state.session_state.session_id)
        for result in state.decode_stream.emit_ready(block):
            self._mark_activity(state)
            yield result

    # -- VAD -----------------------------------------------------------------------

    def _create_vad_state(
        self, session_state: SessionState, context: grpc.ServicerContext
    ) -> VADGate:
        info = session_state.session_info
        silence = info.vad_silence if info.vad_silence > 0 else self._config.stream.vad_silence
        threshold = info.vad_threshold
        if threshold < 0:
            threshold = self._config.stream.vad_threshold
        if threshold > 0 and not info.vad_reserved:
            if not self._vad_pool.reserve_slot():
                LOGGER.error(
                    "VAD pool exhausted; rejecting session_id=%s",
                    session_state.session_id,
                )
                self._facade.remove_session(session_state, reason="vad_pool_exhausted")
                abort_with_error(context, ErrorCode.VAD_POOL_EXHAUSTED)
            info.vad_reserved = True
        return VADGate(threshold, silence, model_pool=self._vad_pool)

    def _reset_vad_after_trigger(self, state: StreamState) -> None:
        state.speech_active = False
        state.utterance_start_sec = None
        state.utterance_end_sec = None

    def _handle_vad_trigger(
        self,
        state: StreamState,
        vad_update: Any,
        context: grpc.ServicerContext,
    ) -> Iterator[stt_pb2.STTResult]:
        if not (state.vad_state and state.decode_stream and state.session_state):
            return
        stream_cfg = self._config.stream
        if not buffer_is_speech(bytes(state.buffer), stream_cfg.speech_rms_threshold):
            LOGGER.info(
                "session_id=%s ignored low-energy buffer (rms=%.4f < %.4f)",
                state.session_id(), vad_update.chunk_rms,
                stream_cfg.speech_rms_threshold,
            )
            self._ledger.clear(state)
            state.vad_state.reset_after_trigger()
            self._reset_vad_after_trigger(state)
            return
        self._hooks.on_vad_trigger()
        state.vad_count += 1
        self._hooks.on_vad_utterance_start()
        info = state.session_state.session_info
        attr_override = _attr_bool(
            info.attributes, "emit_final_on_vad", "final_on_vad", "vad_final"
        )
        emit_final_on_vad = (
            stream_cfg.emit_final_on_vad if attr_override is None else attr_override
        )
        stop_after = info.vad_mode == VAD_AUTO_END
        emit_final = stop_after or emit_final_on_vad
        if state.disconnect_event.is_set() or state.timeout_event.is_set():
            LOGGER.info("skipping decode due to shutdown signal")
            state.final_reason = (
                "client_disconnect" if state.disconnect_event.is_set() else "timeout"
            )
            state.client_disconnected = state.disconnect_event.is_set()
            state.stop_stream = True
            return
        if not self._ensure_decode_capacity(
            state.decode_stream, emit_final, state.session_state
        ):
            self._ledger.clear(state)
            state.vad_state.reset_after_trigger()
            self._reset_vad_after_trigger(state)
            return
        pcm = bytes(state.buffer)
        offset_sec = state.buffer_start_sec
        if state.utterance_start_sec is not None and info.vad_threshold > 0:
            rate = state.sample_rate or stream_cfg.default_sample_rate
            pcm, offset_sec = trim_leading_silence(
                pcm, offset_sec, state.utterance_start_sec, rate
            )
        self._schedule_decode(
            state, pcm,
            is_final=emit_final,
            offset_sec=offset_sec,
            count_vad=True,
            buffer_started_at=state.buffer_start_time,
            context=context,
        )
        self._ledger.clear(state)
        self._reset_vad_after_trigger(state)
        LOGGER.info(
            "VAD count=%d session_id=%s (pending=%d mode=%s active_vad=%d)",
            state.vad_count, state.session_id(),
            state.decode_stream.pending_partial_decodes(),
            "AUTO_END" if stop_after else "CONTINUE",
            self._hooks.active_vad_utterances(),
        )
        if stop_after:
            yield from self._emit_with_activity(state, False)
            state.final_reason = "auto_vad_finalized"
            state.stop_stream = True
            return
        state.vad_state.reset_after_trigger()

    # -- periodic partials -----------------------------------------------------------

    def _partial_interval_sec(self) -> Optional[float]:
        with self._adaptive_lock:
            override = self._partial_interval_override
        return override if override is not None else self._config.partial_decode.interval_sec

    @staticmethod
    def _partial_enabled(state: StreamState) -> bool:
        if not state.session_state:
            return False
        attrs = state.session_state.session_info.attributes
        value = _attr_bool(attrs, "partial", "partial_mode")
        return bool(value)

    def _maybe_schedule_periodic_partial(
        self, state: StreamState, vad_update: Any, context: grpc.ServicerContext
    ) -> None:
        if not self._partial_enabled(state):
            return
        interval = self._partial_interval_sec()
        if interval is None or interval <= 0:
            return
        if state.disconnect_event.is_set() or state.timeout_event.is_set():
            return
        if not state.session_state or not state.decode_stream:
            return
        if state.session_state.session_info.vad_mode != VAD_CONTINUE:
            return
        if not vad_update.speech_active or not state.buffer:
            return
        limit_bytes = self._ledger.buffer_limit_bytes(state.sample_rate)
        if limit_bytes is not None and len(state.buffer) > limit_bytes:
            return  # overflow path owns scheduling here
        if not buffer_is_speech(
            bytes(state.buffer), self._config.stream.speech_rms_threshold
        ):
            return
        last_sec = (
            state.buffer_start_sec
            if state.last_partial_decode_sec is None
            else state.last_partial_decode_sec
        )
        if state.audio_received_sec - last_sec < interval:
            return
        if not self._ensure_decode_capacity(
            state.decode_stream, False, state.session_state
        ):
            return
        window_bytes = self._ledger.partial_window_bytes(state.sample_rate)
        rate = state.sample_rate or self._config.stream.default_sample_rate
        offset_sec = state.buffer_start_sec
        if window_bytes is not None and len(state.buffer) > window_bytes:
            drop = len(state.buffer) - window_bytes
            offset_sec += audio.chunk_duration_seconds(drop, rate)
            pcm = bytes(state.buffer[-window_bytes:])
        else:
            pcm = bytes(state.buffer)
        if self._schedule_decode(
            state, pcm,
            is_final=False,
            offset_sec=offset_sec,
            count_vad=False,
            buffer_started_at=state.buffer_start_time,
            context=context,
        ):
            state.last_partial_decode_sec = state.audio_received_sec

    # -- buffer limit ------------------------------------------------------------------

    def _enforce_buffer_limit(
        self, state: StreamState, context: grpc.ServicerContext
    ) -> None:
        limit_bytes = self._ledger.buffer_limit_bytes(state.sample_rate)
        if limit_bytes is None or len(state.buffer) <= limit_bytes:
            return
        buffer = state.buffer
        partial_capable = (
            state.session_state is not None
            and state.decode_stream is not None
            and state.session_state.session_info.vad_mode == VAD_CONTINUE
            and self._partial_enabled(state)
        )
        if partial_capable:
            if not buffer_is_speech(
                bytes(buffer), self._config.stream.speech_rms_threshold
            ):
                LOGGER.info("buffer limit reached with low-energy audio; dropping")
                self._ledger.clear(state)
                return
            LOGGER.warning(
                "buffer limit reached (%d bytes); scheduling overflow partial",
                len(buffer),
            )
            if not self._ensure_decode_capacity(
                state.decode_stream, False, state.session_state
            ):
                self._ledger.clear(state)
                return
            rate = state.sample_rate or self._config.stream.default_sample_rate
            window_drop = max(0, len(buffer) - limit_bytes)
            window_offset = state.buffer_start_sec + audio.chunk_duration_seconds(
                window_drop, rate
            )
            window = bytes(buffer[-limit_bytes:])
            if not self._schedule_decode(
                state, window,
                is_final=False,
                offset_sec=window_offset,
                count_vad=False,
                buffer_started_at=state.buffer_start_time,
                context=context,
            ):
                self._ledger.clear(state)
                return
            state.last_partial_decode_sec = state.audio_received_sec
            overlap_bytes = int(
                max(0.0, self._config.buffer_limits.buffer_overlap_sec) * rate * 2
            )
            retain = min(overlap_bytes, len(buffer))
            dropped = len(buffer) - retain
            new_buffer = bytearray(buffer[-retain:]) if retain > 0 else bytearray()
            if dropped > 0:
                dropped_sec = audio.chunk_duration_seconds(dropped, rate)
                state.buffer_start_sec += dropped_sec
                if state.buffer_start_time is not None:
                    state.buffer_start_time += dropped_sec
            before = len(state.buffer)
            state.buffer = new_buffer
            self._ledger.update_total(len(state.buffer) - before)
            self._hooks.on_buffer_total_bytes(self._ledger.total_bytes())
            state.buffer_has_new_audio = False
            return
        # no partial path: trim oldest audio in place
        overflow = len(buffer) - limit_bytes
        if overflow > 0:
            del buffer[:overflow]
            rate = state.sample_rate or self._config.stream.default_sample_rate
            dropped_sec = audio.chunk_duration_seconds(overflow, rate)
            state.buffer_start_sec += dropped_sec
            if state.buffer_start_time is not None:
                state.buffer_start_time += dropped_sec
            self._ledger.update_total(-overflow)
            self._hooks.on_buffer_total_bytes(self._ledger.total_bytes())
            LOGGER.warning(
                "buffer limit reached (%d bytes); trimmed %.2fs of audio",
                limit_bytes, dropped_sec,
            )

    # -- chunk pipeline ------------------------------------------------------------------

    def _max_chunk_bytes(self, sample_rate: Optional[int]) -> Optional[int]:
        max_ms = self._config.buffer_limits.max_chunk_ms
        if max_ms is None or max_ms <= 0:
            return None
        rate = sample_rate or self._config.stream.default_sample_rate
        if rate <= 0:
            return None
        return int((max_ms / 1000.0) * rate * 2)

    def _capture_audio_chunk(self, state: StreamState, pcm16: bytes) -> None:
        if (
            self._storage is None
            or state.session_state is None
            or not pcm16
            or state.sample_rate is None
        ):
            return
        if state.audio_recorder is None:
            state.audio_recorder = self._storage.create_recorder(
                state.session_state.session_id,
                state.sample_rate or self._config.stream.default_sample_rate,
            )
        state.audio_recorder.append(pcm16)

    def _log_session_start(self, state: StreamState) -> None:
        if state.session_logged or not state.session_state:
            return
        info = state.session_state.session_info
        LOGGER.info(
            "streaming started session_id=%s vad_mode=%s decode_profile=%s "
            "vad_silence=%.3f vad_threshold=%.4f model_id=%s",
            state.session_id(),
            "AUTO_END" if info.vad_mode == VAD_AUTO_END else "CONTINUE",
            info.decode_profile, info.vad_silence, info.vad_threshold, info.model_id,
        )
        state.session_logged = True

    def _handle_final_chunk(
        self, state: StreamState, context: grpc.ServicerContext
    ) -> Iterator[stt_pb2.STTResult]:
        if not state.decode_stream:
            return
        if state.buffer and state.buffer_has_new_audio:
            if state.disconnect_event.is_set() or state.timeout_event.is_set():
                LOGGER.info("skipping final decode due to shutdown signal")
                state.final_reason = (
                    "client_disconnect" if state.disconnect_event.is_set() else "timeout"
                )
                state.client_disconnected = state.disconnect_event.is_set()
                state.stop_stream = True
                return
            self._ensure_decode_capacity(state.decode_stream, True, state.session_state)
            pcm = bytes(state.buffer)
            offset_sec = state.buffer_start_sec
            if (
                state.utterance_start_sec is not None
                and state.session_state
                and state.session_state.session_info.vad_threshold > 0
            ):
                rate = state.sample_rate or self._config.stream.default_sample_rate
                pcm, offset_sec = trim_leading_silence(
                    pcm, offset_sec, state.utterance_start_sec, rate
                )
            self._schedule_decode(
                state, pcm,
                is_final=True,
                offset_sec=offset_sec,
                count_vad=False,
                buffer_started_at=state.buffer_start_time,
                context=context,
            )
            self._ledger.clear(state)
        yield from self._emit_with_activity(state, False)
        state.final_reason = "client_sent_final_chunk"
        state.stop_stream = True

    def _step_streaming(
        self,
        state: StreamState,
        chunk: stt_pb2.AudioChunk,
        context: grpc.ServicerContext,
    ) -> Iterator[stt_pb2.STTResult]:
        if state.disconnect_event.is_set():
            LOGGER.info("stopping stream due to disconnect signal")
            state.final_reason = "client_disconnect"
            state.client_disconnected = True
            self._ledger.clear(state)
            state.stop_stream = True
            return
        if state.timeout_event.is_set():
            LOGGER.info("stopping stream due to timeout signal")
            state.final_reason = "timeout"
            abort_with_error(context, ErrorCode.SESSION_TIMEOUT)

        self._mark_activity(state)
        current_session_id = state.session_id()
        if current_session_id:
            set_session_id(current_session_id)
        if not context.is_active():
            LOGGER.info("client inactive; stopping session %s", current_session_id)
            state.final_reason = "client_disconnect"
            state.client_disconnected = True
            self._cancel_pending_decodes(state)
            self._ledger.clear(state)
            state.stop_stream = True
            return
        if chunk.session_id and current_session_id and (
            chunk.session_id != current_session_id
        ):
            LOGGER.warning(
                "chunk session_id=%s mismatches stream session_id=%s; ignoring",
                chunk.session_id, current_session_id,
            )
            return

        if state.session_state is None:
            state.session_state = self._facade.ensure_session_from_chunk(
                state.session_state, chunk, context
            )
        if state.session_state and state.decode_stream:
            state.decode_stream.set_session_id(state.session_state.session_id)
            state.decode_stream.set_model_id(state.session_state.session_info.model_id)
            set_session_id(state.session_state.session_id)

        self._facade.validate_token(state.session_state, chunk, context)
        self._log_session_start(state)
        if state.vad_state is None and state.session_state:
            state.vad_state = self._create_vad_state(state.session_state, context)

        state.sample_rate = (
            chunk.sample_rate
            if chunk.sample_rate > 0
            else state.sample_rate or self._config.stream.default_sample_rate
        )
        max_chunk = self._max_chunk_bytes(state.sample_rate)
        if max_chunk is not None and len(chunk.pcm16) > max_chunk:
            LOGGER.warning(
                "chunk exceeds size limit bytes=%d max=%d session_id=%s",
                len(chunk.pcm16), max_chunk, state.session_id(),
            )
            abort_with_error(
                context,
                ErrorCode.AUDIO_CHUNK_TOO_LARGE,
                detail=f"chunk bytes {len(chunk.pcm16)} exceeds max {max_chunk}",
            )
        self._enforce_stream_limits(state, chunk, context)
        self._capture_audio_chunk(state, chunk.pcm16)

        if not state.buffer and chunk.pcm16:
            state.buffer_start_sec = state.audio_received_sec
            state.buffer_start_time = time.perf_counter()
        incoming = chunk.pcm16
        if incoming:
            allowed = self._ledger.apply_global_limit(state, len(incoming))
            self._hooks.on_buffer_total_bytes(self._ledger.total_bytes())
            if allowed < len(incoming):
                incoming = incoming[-allowed:] if allowed > 0 else b""
        if incoming:
            state.buffer.extend(incoming)
            state.buffer_has_new_audio = True
        elif not state.buffer:
            state.buffer_start_time = None
        state.audio_received_sec += audio.chunk_duration_seconds(
            len(chunk.pcm16), state.sample_rate
        )

        vad_state = state.vad_state
        if vad_state is None:
            LOGGER.error("VAD state missing session_id=%s", state.session_id())
            abort_with_error(context, ErrorCode.STREAM_UNEXPECTED)
        vad_update = vad_state.update(chunk.pcm16, state.sample_rate)
        prev_active = state.speech_active
        state.speech_active = vad_update.speech_active
        if vad_update.speech_active and not prev_active:
            state.utterance_start_sec = max(
                0.0, state.audio_received_sec - vad_update.chunk_duration
            )
        if vad_update.triggered:
            state.utterance_end_sec = max(
                0.0, state.audio_received_sec - vad_update.silence_duration
            )

        if vad_update.triggered:
            yield from self._handle_vad_trigger(state, vad_update, context)
        else:
            self._maybe_schedule_periodic_partial(state, vad_update, context)
        if state.stop_stream:
            return

        # buffer management (skipped for the final chunk)
        if not chunk.is_final:
            if state.disconnect_event.is_set() or state.timeout_event.is_set():
                LOGGER.info("skipping buffer management due to shutdown signal")
                state.final_reason = (
                    "client_disconnect" if state.disconnect_event.is_set() else "timeout"
                )
                state.client_disconnected = state.disconnect_event.is_set()
                state.stop_stream = True
                return
            self._enforce_buffer_limit(state, context)
            if state.session_state is not None:
                self._hooks.on_stream_buffer_bytes(
                    state.session_state.session_id, len(state.buffer)
                )
            self._hooks.on_buffer_total_bytes(self._ledger.total_bytes())
            if state.stop_stream:
                return

        yield from self._emit_with_activity(state, False)
        if chunk.is_final:
            yield from self._handle_final_chunk(state, context)

    def _handle_chunk(
        self,
        state: StreamState,
        chunk: stt_pb2.AudioChunk,
        context: grpc.ServicerContext,
    ) -> Iterator[stt_pb2.STTResult]:
        if state.phase == StreamPhase.INIT:
            state.phase = StreamPhase.STREAMING
        elif state.phase in (StreamPhase.DRAINING, StreamPhase.DONE):
            return
        yield from self._step_streaming(state, chunk, context)
        if state.stop_stream and state.phase == StreamPhase.STREAMING:
            state.phase = StreamPhase.DRAINING

    # -- drain ---------------------------------------------------------------------------

    def _step_drain(
        self, state: StreamState, context: grpc.ServicerContext
    ) -> Iterator[stt_pb2.STTResult]:
        if state.phase == StreamPhase.DONE:
            return
        state.phase = StreamPhase.DRAINING
        if state.timeout_event.is_set():
            LOGGER.info("stopping stream due to timeout signal")
            state.final_reason = "timeout"
            abort_with_error(context, ErrorCode.SESSION_TIMEOUT)
        if state.decode_stream:
            if (
                not state.client_disconnected
                and state.buffer
                and state.buffer_has_new_audio
                and buffer_is_speech(
                    bytes(state.buffer), self._config.stream.speech_rms_threshold
                )
            ):
                self._ensure_decode_capacity(
                    state.decode_stream, True, state.session_state
                )
                if self._schedule_decode(
                    state, bytes(state.buffer),
                    is_final=True,
                    offset_sec=state.buffer_start_sec,
                    count_vad=False,
                    buffer_started_at=state.buffer_start_time,
                    context=context,
                ):
                    self._ledger.clear(state)
            state.buffer_start_time = None
            while True:
                if state.timeout_event.is_set():
                    LOGGER.info("stopping stream due to timeout signal")
                    state.final_reason = "timeout"
                    abort_with_error(context, ErrorCode.SESSION_TIMEOUT)
                emitted = list(
                    self._emit_with_activity(
                        state, block=state.decode_stream.has_pending_results()
                    )
                )
                if not emitted:
                    break
                yield from emitted
        state.phase = StreamPhase.DONE

    # -- finalize -------------------------------------------------------------------------

    def _finalize_stream(
        self, state: StreamState, context: grpc.ServicerContext
    ) -> None:
        state.stop_watchdog.set()
        if state.timeout_event.is_set():
            state.final_reason = "timeout"
        try:
            if state.vad_state:
                state.vad_state.close()
        except Exception:
            # a VAD release failure must not block session removal (which
            # releases the VAD slot reservation)
            LOGGER.exception("VAD close failed during stream teardown")

        if state.decode_stream:
            bw, qw, inf, emit, count = state.decode_stream.timing_summary()
            trailing = [
                ("stt-decode-buffer-wait-sec", f"{bw:.6f}"),
                ("stt-decode-queue-wait-sec", f"{qw:.6f}"),
                ("stt-decode-inference-sec", f"{inf:.6f}"),
                ("stt-decode-response-emit-sec", f"{emit:.6f}"),
                ("stt-decode-total-sec", f"{bw + qw + inf + emit:.6f}"),
                ("stt-decode-count", str(count)),
            ]
            words = getattr(state.decode_stream, "last_word_timings", [])
            if words:
                # the proto carries segment times only; word-level times
                # (word_timestamps option) ride the trailing metadata as
                # compact JSON (the reference proto has no field either)
                import json as _json

                def _render(entries):
                    return _json.dumps(
                        [[round(ws, 3), round(we, 3), wt]
                         for ws, we, wt in entries],
                        # gRPC non-'-bin' metadata values must be ASCII;
                        # \uXXXX escapes keep non-English words valid
                        # (grpc-python validates at RPC termination, so a
                        # bad value would drop the whole trailing block)
                        ensure_ascii=True, separators=(",", ":"),
                    )

                payload = _render(words)
                # real gRPC clients reject oversized metadata (core
                # GRPC_ARG_MAX_METADATA_SIZE defaults to 8 KB) and the
                # WHOLE trailing block would drop with it. In-process
                # transports (REST/WS fake contexts) are unbounded and
                # need full coverage for long uploads; the wire path
                # keeps the most recent words within a byte budget and
                # reports how many older entries were dropped.
                if not getattr(context, "inprocess_trailing", False):
                    try:
                        budget = int(os.getenv(
                            "STT_WORD_METADATA_MAX_BYTES", "7000"))
                    except ValueError:
                        budget = 7000
                    dropped = 0
                    while len(payload) > budget and dropped < len(words) - 1:
                        # halve-and-retry beats popping one at a time for
                        # hour-long word lists
                        drop = max(1, (len(words) - dropped) // 2)
                        dropped += drop
                        payload = _render(words[dropped:])
                    if dropped:
                        trailing.append(
                            ("stt-word-timestamps-dropped", str(dropped))
                        )
                trailing.append(("stt-word-timestamps", payload))
            try:
                context.set_trailing_metadata(tuple(trailing))
            except (grpc.RpcError, RuntimeError, ValueError):
                pass

        if state.audio_recorder is not None:
            try:
                state.audio_recorder.finalize()
            except Exception:
                LOGGER.exception("audio recorder finalize failed")
            if self._storage is not None:
                try:
                    self._storage.enforce_retention()
                except Exception:
                    LOGGER.exception("audio retention enforcement failed")

        if state.buffer:
            self._ledger.update_total(-len(state.buffer))
            self._hooks.on_buffer_total_bytes(self._ledger.total_bytes())
            state.buffer = bytearray()
            if state.session_state:
                self._hooks.on_stream_buffer_bytes(state.session_state.session_id, 0)
        try:
            if state.session_state:
                self._hooks.on_stream_end(state.session_state.session_id)
                LOGGER.info(
                    "streaming finished session_id=%s reason=%s vad_count=%d "
                    "duration=%.2fs",
                    state.session_id(), state.final_reason, state.vad_count,
                    time.monotonic() - state.session_start,
                )
        finally:
            # always remove the session so the VAD slot reservation is
            # released via the registry on_remove hook
            self._facade.remove_session(state.session_state, reason=state.final_reason)
            set_session_id(None)

    # -- entry ----------------------------------------------------------------------------

    @staticmethod
    def _build_metadata(context: grpc.ServicerContext) -> Dict[str, Any]:
        try:
            return {str(k).lower(): v for (k, v) in context.invocation_metadata() or ()}
        except Exception:
            return {}

    def _bootstrap_stream(
        self,
        state: StreamState,
        metadata: Dict[str, Any],
        context: grpc.ServicerContext,
    ) -> None:
        state.session_state = self._facade.resolve_from_metadata(metadata, context)
        if state.session_state:
            set_session_id(state.session_state.session_id)
            if not state.session_state.session_info.token_required:
                self._log_session_start(state)
                state.vad_state = self._create_vad_state(state.session_state, context)
        state.decode_stream = self._scheduler.new_stream()
        if state.session_state and state.decode_stream:
            state.decode_stream.set_session_id(state.session_state.session_id)
            state.decode_stream.set_model_id(
                state.session_state.session_info.model_id
            )

    def run(
        self,
        request_iterator: Iterable[stt_pb2.AudioChunk],
        context: grpc.ServicerContext,
    ) -> Iterator[stt_pb2.STTResult]:
        """Process incoming audio chunks and yield recognition results."""
        state = StreamState()
        metadata = self._build_metadata(context)
        md_session = metadata.get("session-id") or metadata.get("session_id")
        if md_session:
            if isinstance(md_session, bytes):
                md_session = md_session.decode("utf-8", errors="ignore")
            if md_session:
                set_session_id(str(md_session).strip())

        context.add_callback(lambda: self._handle_disconnect(state))
        self._start_watchdog(state)
        try:
            state.processing_event.set()
            try:
                self._bootstrap_stream(state, metadata, context)
                if state.phase == StreamPhase.INIT:
                    state.phase = StreamPhase.STREAMING
            finally:
                state.processing_event.clear()
            for chunk in request_iterator:
                state.processing_event.set()
                try:
                    yield from self._handle_chunk(state, chunk, context)
                finally:
                    state.processing_event.clear()
                if state.stop_stream:
                    break
            state.processing_event.set()
            try:
                yield from self._step_drain(state, context)
            finally:
                state.processing_event.clear()
        except (RuntimeError, grpc.RpcError):
            if state.timeout_event.is_set():
                state.final_reason = "timeout"
            else:
                raise
        finally:
            state.phase = StreamPhase.DONE
            self._finalize_stream(state, context)


__all__ = [
    "AudioBufferLedger",
    "BufferLimits",
    "DecodeQueueSettings",
    "HealthSettings",
    "OrchestratorConfig",
    "OrchestratorHooks",
    "PartialDecodeSettings",
    "StorageSettings",
    "StreamOrchestrator",
    "StreamPhase",
    "StreamSettings",
    "StreamState",
    "VADPoolSettings",
    "trim_leading_silence",
]
