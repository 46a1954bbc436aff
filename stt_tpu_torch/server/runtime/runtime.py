"""Application runtime: builds and owns every app-layer dependency.

Counterpart of ``stt_tpu/server/runtime/runtime.py``, copied line for line
but for two places: it builds the port's model registry (engines on the
card), and the two opt-in VAD options run on the server's ``device`` (the
card unless it says ``cpu``): ``vad_model_path`` loads Silero through the
port's ONNX executor (``ops/silero.py``), and ``vad_device: device``
builds the batched scorer (``server/component/vad_scorer.py``) with the
runtime's metrics, whose prewarm failing at boot raises instead of being
logged and passed over as the JAX runtime does. The shipped ``auto``
resolves to host scoring, as in the JAX package.

Parity with the reference runtime (``stt_server/backend/runtime/
runtime.py:42-374``): wires Metrics into the orchestrator/scheduler through
hook dataclasses (components never import Metrics), loads the default model
at boot, exposes ``health_snapshot()`` for the HTTP plane, gates
CreateSession during shutdown/overload, and runs the adaptive-throttle loop
(pressure signals -> scaled partial interval + temporary CreateSession
rejection, reference ``runtime.py:276-374``).

Difference by design: configuration is the flat contract-tested
:class:`~stt_tpu_torch.config.loader.ServerConfig` instead of the reference's
nested ``ServicerConfig`` wrapper, and model loading passes the ``tpu:``
section's shape matrix (shape buckets, batch window, decode token budget) down to
:class:`~stt_tpu_torch.engine.engine.WhisperEngine`.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from ...config.loader import (
    ServerConfig,
    ensure_default_model_load_profile,
    parse_mesh_shape,
)
from ...config.languages import SupportedLanguages
from ...engine.registry import DEFAULT_MODEL_ID, ModelRegistry
from ...utils.logging import LOGGER
from ...utils.rate_limit import KeyedRateLimiter
from ..application.orchestrator import (
    BufferLimits,
    DecodeQueueSettings,
    HealthSettings,
    OrchestratorConfig,
    OrchestratorHooks,
    PartialDecodeSettings,
    StorageSettings,
    StreamOrchestrator,
    StreamSettings,
    VADPoolSettings,
)
from ..application.profile_resolver import normalize_decode_profiles
from ..application.session_manager import (
    CreateSessionConfig,
    CreateSessionHandler,
    SessionFacade,
    SessionInfo,
    SessionRegistry,
    SessionRegistryHooks,
)
from ..component.decode_scheduler import DecodeScheduler, DecodeSchedulerHooks
from ..component.vad_gate import VADModelPool
from ..component.vad_scorer import BatchedVadScorer, scorer_device
from .metrics import Metrics


class ApplicationRuntime:
    """Builds and owns application-layer dependencies."""

    def __init__(self, config: ServerConfig, *, load_default_model: bool = True):
        self.config = config
        ensure_default_model_load_profile(config)
        self.metrics = Metrics()
        self.metrics.set_expose_api_key_metrics(config.expose_api_key_metrics)
        self._accepting_sessions = True
        self._overload_until = 0.0
        self._overload_lock = threading.Lock()
        self._adaptive_throttle: Optional[AdaptiveThrottle] = None

        self.supported_languages = SupportedLanguages()
        self.default_language = (config.language or "").strip().lower()
        self.default_task = (config.task or "transcribe").lower()

        self.decode_profiles = normalize_decode_profiles(config.decode_profiles)
        default_profile = config.default_decode_profile
        if default_profile not in self.decode_profiles:
            LOGGER.warning(
                "unknown default decode profile '%s'; using 'realtime'",
                default_profile,
            )
            default_profile = "realtime"
        self.default_decode_profile = default_profile

        self.vad_model_pool = VADModelPool()
        self._vad_scorer = None
        if config.vad_model_path:
            # learned Silero VAD from a local ONNX file, executed by the
            # port's own ONNX executor on the server's device
            self.vad_model_pool.set_silero_model(config.vad_model_path,
                                                 device=scorer_device(config.device))
        elif config.vad_device == "device":
            # one cross-session device batch per tick, opt-in as in the JAX
            # package ("auto" resolves to host scoring there and here); on
            # the card on a stream of its own. A prewarm that fails raises:
            # the server does not boot on a scorer it could not run
            self._vad_scorer = BatchedVadScorer(scorer_device(config.device),
                                                metrics=self.metrics)
            self._vad_scorer.prewarm()
            self.vad_model_pool.set_scorer(self._vad_scorer)

        self.model_registry = ModelRegistry(
            metrics=self.metrics,
            engine_defaults={
                "audio_buckets_sec": list(config.tpu_audio_buckets_sec),
                "batch_buckets": list(config.tpu_batch_buckets),
                "max_decode_tokens": config.tpu_max_decode_tokens,
                "batch_window_ms": config.decode_batch_window_ms,
                "max_batch": config.max_decode_batch_size,
                "use_pallas": config.tpu_use_pallas,
                "pad_to_30s": config.tpu_pad_to_30s,
                "prewarm": config.tpu_prewarm,
                "prewarm_batch_sizes": list(config.tpu_prewarm_batch_sizes),
                "prewarm_mode": config.tpu_prewarm_mode,
                # beam widths from the configured decode profiles, each
                # prewarmed at boot by the registry
                "prewarm_beam_sizes": sorted(
                    {1}
                    | {
                        int(p.get("beam_size", 1) or 1)
                        for p in self.decode_profiles.values()
                        if isinstance(p, dict)
                    }
                ),
                "mesh_shape": parse_mesh_shape(config.tpu_mesh_shape),
            },
        )

        self.session_registry = SessionRegistry(
            SessionRegistryHooks(
                on_create=self._on_session_created,
                on_remove=self._on_session_removed,
            )
        )
        self.session_facade = SessionFacade(self.session_registry)

        create_limiter = (
            KeyedRateLimiter(config.create_session_rps, config.create_session_burst)
            if config.create_session_rps and config.create_session_rps > 0
            else None
        )
        self.create_session_handler = CreateSessionHandler(
            CreateSessionConfig(
                default_vad_silence=config.vad_silence,
                default_vad_threshold=config.vad_threshold,
                default_language=self.default_language,
                language_fix=config.language_fix,
                default_task=self.default_task,
                decode_profiles=self.decode_profiles,
                default_decode_profile=self.default_decode_profile,
                supported_languages=self.supported_languages,
                require_api_key=config.require_api_key,
                create_session_auth_profile=config.create_session_auth_profile,
                create_session_auth_secret=config.create_session_auth_secret,
                create_session_auth_ttl_sec=config.create_session_auth_ttl_sec,
                max_sessions_per_ip=config.max_sessions_per_ip,
                max_sessions_per_api_key=config.max_sessions_per_api_key,
                allow_new_sessions=self._allow_new_sessions,
                allow_overload_sessions=self._allow_overload_sessions,
            ),
            self.session_registry,
            self.vad_model_pool,
            rate_limiter=create_limiter,
            metrics=self.metrics,
        )

        def _record_decode(
            latency_sec: float,
            rtf: float,
            queue_wait_sec: float,
            buffer_wait_sec: float,
            emit_sec: float,
        ) -> None:
            # hook order fixed by DecodeSchedulerHooks.on_decode_result
            self.metrics.record_decode(
                latency_sec,
                buffer_wait_sec=buffer_wait_sec,
                queue_wait_sec=queue_wait_sec,
                response_emit_sec=emit_sec,
                real_time_factor=rtf if rtf >= 0 else None,
            )

        decode_hooks = DecodeSchedulerHooks(
            on_error=self.metrics.record_error,
            on_decode_result=_record_decode,
            on_vad_utterance_end=self.metrics.decrease_active_vad_utterances,
            on_decode_cancelled=self.metrics.record_decode_cancelled,
            on_decode_orphaned=self.metrics.record_decode_orphaned,
            on_decode_pending=self.metrics.set_decode_pending,
        )
        self.decode_scheduler = DecodeScheduler(
            submit_fn=self.model_registry.submit_decode,
            cancel_fn=self.model_registry.request_cancel,
            registry_health_fn=self.model_registry.health_summary,
            decode_timeout_sec=config.decode_timeout_sec,
            language_lookup=self.supported_languages,
            max_pending_decodes_global=config.max_pending_decodes_global,
            health_window_sec=config.health_window_sec,
            health_min_events=config.health_min_events,
            health_max_timeout_ratio=config.health_max_timeout_ratio,
            health_min_success_ratio=config.health_min_success_ratio,
            log_transcripts=config.log_transcripts,
            hooks=decode_hooks,
        )

        orchestrator_config = OrchestratorConfig(
            stream=StreamSettings(
                vad_threshold=config.vad_threshold,
                vad_silence=config.vad_silence,
                speech_rms_threshold=config.speech_rms_threshold,
                session_timeout_sec=config.session_timeout_sec,
                default_sample_rate=config.sample_rate,
                decode_timeout_sec=config.decode_timeout_sec,
                language_lookup=self.supported_languages,
                log_transcripts=config.log_transcripts,
                max_audio_seconds_per_session=config.max_audio_seconds_per_session,
                max_audio_bytes_per_sec=config.max_audio_bytes_per_sec,
                max_audio_bytes_per_sec_burst=config.max_audio_bytes_per_sec_burst,
                max_audio_bytes_per_sec_realtime=config.max_audio_bytes_per_sec_realtime,
                max_audio_bytes_per_sec_burst_realtime=(
                    config.max_audio_bytes_per_sec_burst_realtime
                ),
                max_audio_bytes_per_sec_batch=config.max_audio_bytes_per_sec_batch,
                max_audio_bytes_per_sec_burst_batch=(
                    config.max_audio_bytes_per_sec_burst_batch
                ),
                emit_final_on_vad=config.emit_final_on_vad,
            ),
            storage=StorageSettings(
                enabled=config.persist_audio,
                directory=config.audio_storage_dir,
                queue_max_chunks=config.audio_storage_queue_max_chunks,
                max_bytes=config.audio_storage_max_bytes,
                max_files=config.audio_storage_max_files,
                max_age_days=config.audio_storage_max_age_days,
            ),
            vad_pool=VADPoolSettings(
                size=config.vad_model_pool_size,
                prewarm=config.vad_model_prewarm,
                max_size=config.vad_model_pool_size,
                growth_factor=config.vad_model_pool_growth_factor,
            ),
            buffer_limits=BufferLimits(
                max_buffer_sec=config.max_buffer_sec,
                max_buffer_bytes=config.max_buffer_bytes,
                max_chunk_ms=config.max_chunk_ms,
                max_total_buffer_bytes=config.max_total_buffer_bytes,
                buffer_overlap_sec=config.buffer_overlap_sec,
            ),
            partial_decode=PartialDecodeSettings(
                interval_sec=config.partial_decode_interval_sec,
                window_sec=config.partial_decode_window_sec,
            ),
            decode_queue=DecodeQueueSettings(
                max_pending_decodes_per_stream=config.max_pending_decodes_per_stream,
                max_pending_decodes_global=config.max_pending_decodes_global,
                decode_queue_timeout_sec=config.decode_queue_timeout_sec,
            ),
            health=HealthSettings(
                window_sec=config.health_window_sec,
                min_events=config.health_min_events,
                max_timeout_ratio=config.health_max_timeout_ratio,
                min_success_ratio=config.health_min_success_ratio,
            ),
        )
        stream_hooks = OrchestratorHooks(
            on_vad_trigger=self.metrics.record_vad_trigger,
            on_vad_utterance_start=self.metrics.increase_active_vad_utterances,
            active_vad_utterances=self.metrics.active_vad_utterances,
            on_buffer_total_bytes=self.metrics.set_buffer_total,
            on_stream_buffer_bytes=self.metrics.set_stream_buffer_bytes,
            on_stream_end=self.metrics.clear_stream_buffer,
            on_partial_drop=self.metrics.record_partial_drop,
            on_rate_limit_block=self.metrics.record_rate_limit_block,
        )
        self.stream_orchestrator = StreamOrchestrator(
            self.session_facade,
            self.decode_scheduler,
            orchestrator_config,
            hooks=stream_hooks,
            vad_model_pool=self.vad_model_pool,
        )

        if load_default_model:
            self.load_default_model()

        if config.adaptive_throttle_enabled:
            self._adaptive_throttle = AdaptiveThrottle(self, config)
            self._adaptive_throttle.start()

    # -- model lifecycle ---------------------------------------------------------

    def load_default_model(self) -> None:
        profile_name = self.config.default_model_load_profile
        profile = dict(self.config.model_load_profiles.get(profile_name) or {})
        if not profile:
            LOGGER.warning("no default model load profile; skipping model load")
            return
        if self.config.language_fix and self.default_language:
            profile.setdefault("language", self.default_language)
        profile.setdefault("task", self.default_task)
        self.model_registry.load_model(DEFAULT_MODEL_ID, profile)

    # -- session hooks -------------------------------------------------------------

    def _on_session_created(self, info: SessionInfo) -> None:
        self.metrics.increase_active_sessions(info.api_key)

    def _on_session_removed(self, info: SessionInfo) -> None:
        if info.vad_reserved:
            self.vad_model_pool.release_slot()
            info.vad_reserved = False
        self.metrics.decrease_active_sessions(info.api_key)

    # -- gates ------------------------------------------------------------------------

    def stop_accepting_sessions(self) -> None:
        self._accepting_sessions = False

    def _allow_new_sessions(self) -> bool:
        return self._accepting_sessions

    def _allow_overload_sessions(self) -> bool:
        with self._overload_lock:
            return time.monotonic() >= self._overload_until

    def _set_overload_until(self, deadline: float) -> None:
        with self._overload_lock:
            self._overload_until = max(self._overload_until, deadline)

    # -- health / shutdown ---------------------------------------------------------------

    def health_snapshot(self) -> Dict[str, Any]:
        snap = self.metrics.snapshot()
        summary = self.model_registry.health_summary()
        return {
            "model_pool_healthy": self.decode_scheduler.workers_healthy(),
            "models_loaded": summary["models_loaded"],
            "model_count": len(summary["models_loaded"]),
            "model_worker_total": summary["total_workers"],
            "model_worker_shutdown": summary["shutdown_workers"],
            "active_sessions": self.session_registry.active_count(),
            "decode_queue_depth": self.decode_scheduler.pending_decodes(),
            "decode_latency_avg": snap.get("decode_latency_avg"),
            "decode_latency_max": snap.get("decode_latency_max"),
        }

    def shutdown(self, drain_timeout_sec: Optional[float] = None) -> None:
        if self._adaptive_throttle is not None:
            self._adaptive_throttle.stop()
        if self._vad_scorer is not None:
            self._vad_scorer.close()
        self.model_registry.close(drain_timeout_sec)


class AdaptiveThrottle:
    """Pressure-driven throttle: stretches the partial-decode cadence and
    temporarily rejects CreateSession when pending/buffer/orphan ratios run
    hot (reference ``runtime.py:276-374``)."""

    def __init__(self, runtime: ApplicationRuntime, config: ServerConfig) -> None:
        self._runtime = runtime
        self._config = config
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._base_partial_interval = config.partial_decode_interval_sec
        self._pending_limit = max(0, int(config.max_pending_decodes_global))
        self._buffer_limit = int(config.max_total_buffer_bytes or 0)
        self._last_orphaned = 0.0
        self._last_cancelled = 0.0
        self._mode = "normal"

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=1.0)

    def _loop(self) -> None:
        interval = max(0.5, float(self._config.adaptive_throttle_interval_sec))
        while not self._stop.wait(interval):
            self._tick()

    def _tick(self) -> None:
        metrics = self._runtime.metrics.render()
        pending = float(metrics.get("decode_pending") or 0.0)
        buffer_total = float(metrics.get("buffer_bytes_total") or 0.0)
        orphaned = float(metrics.get("decode_orphaned") or 0.0)
        cancelled = float(metrics.get("decode_cancelled") or 0.0)

        delta_orphaned = max(0.0, orphaned - self._last_orphaned)
        delta_cancelled = max(0.0, cancelled - self._last_cancelled)
        self._last_orphaned = orphaned
        self._last_cancelled = cancelled

        denom = delta_orphaned + delta_cancelled
        orphan_rate = delta_orphaned / denom if denom > 0 else 0.0
        pending_ratio = pending / self._pending_limit if self._pending_limit else 0.0
        buffer_ratio = buffer_total / self._buffer_limit if self._buffer_limit else 0.0

        pressure = (
            pending_ratio >= self._config.adaptive_pending_ratio_high
            or buffer_ratio >= self._config.adaptive_buffer_ratio_high
            or orphan_rate >= self._config.adaptive_orphan_rate_high
        )
        if pressure:
            self._apply_throttle()
        else:
            self._restore_defaults()

    def _apply_throttle(self) -> None:
        self._runtime._set_overload_until(
            time.monotonic()
            + max(0.0, float(self._config.adaptive_create_session_backoff_sec))
        )
        interval = self._scaled_partial_interval()
        self._runtime.stream_orchestrator.set_partial_interval_override(interval)
        if self._mode != "throttled":
            self._mode = "throttled"
            LOGGER.warning("adaptive throttling enabled: partial_interval=%s", interval)

    def _restore_defaults(self) -> None:
        self._runtime.stream_orchestrator.set_partial_interval_override(
            self._base_partial_interval
        )
        if self._mode != "normal":
            self._mode = "normal"
            LOGGER.info("adaptive throttling disabled; restored defaults")

    def _scaled_partial_interval(self) -> Optional[float]:
        base = self._base_partial_interval
        if base is None or base <= 0:
            return base
        scaled = base * max(1.0, float(self._config.adaptive_partial_interval_scale))
        max_sec = self._config.adaptive_partial_interval_max_sec
        if max_sec is not None and max_sec > 0:
            return min(scaled, max_sec)
        return scaled


__all__ = ["AdaptiveThrottle", "ApplicationRuntime"]
