"""YAML configuration loading into a typed ``ServerConfig``.

Own copy of ``stt_tpu/config/loader.py`` for the port, which imports nothing of ``stt_tpu``.

Layering (last wins): built-in defaults -> ``config/server.yaml`` ->
``config/model.yaml`` -> CLI overrides (applied by ``server.main``).
Section->field maps are explicit (no reflection magic) and contract-tested
so every YAML key provably lands on a real field (reference behavior:
``stt_server/config/loader.py:217-331``).
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from pathlib import Path
from typing import Any, Dict, List, Optional

import yaml

from . import defaults as d

PROJECT_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_CONFIG_PATH = PROJECT_ROOT / "config" / "server.yaml"
DEFAULT_MODEL_CONFIG_PATH = PROJECT_ROOT / "config" / "model.yaml"


@dataclass
class ServerConfig:
    """All runtime knobs with defaults applied; one flat namespace."""

    # model
    model: str = d.DEFAULT_MODEL_NAME
    device: str = d.DEFAULT_DEVICE
    compute_type: str = d.DEFAULT_COMPUTE_TYPE
    language: str = d.DEFAULT_LANGUAGE
    language_fix: bool = d.DEFAULT_LANGUAGE_FIX
    task: str = d.DEFAULT_TASK
    decode_profiles: Dict[str, Dict[str, Any]] = field(
        default_factory=d.default_decode_profiles
    )
    default_decode_profile: str = d.DEFAULT_DECODE_PROFILE_NAME
    model_load_profiles: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    default_model_load_profile: str = d.DEFAULT_MODEL_LOAD_PROFILE_NAME
    model_backend: str = d.DEFAULT_MODEL_BACKEND
    model_pool_size: int = d.DEFAULT_MODEL_POOL_SIZE
    model_weights_path: Optional[str] = None
    model_tokenizer_path: Optional[str] = None

    # server / transports
    port: int = d.DEFAULT_PORT
    max_sessions: int = d.DEFAULT_MAX_SESSIONS
    metrics_port: int = d.DEFAULT_METRICS_PORT
    http_host: str = d.DEFAULT_HTTP_HOST
    ws_host: str = d.DEFAULT_WS_HOST
    ws_port: int = d.DEFAULT_WS_PORT
    grpc_worker_threads: int = d.DEFAULT_GRPC_WORKER_THREADS
    grpc_max_receive_message_bytes: Optional[int] = d.DEFAULT_GRPC_MAX_RECEIVE_MESSAGE_BYTES
    grpc_max_send_message_bytes: Optional[int] = d.DEFAULT_GRPC_MAX_SEND_MESSAGE_BYTES

    # rate limits / quotas
    create_session_rps: float = d.DEFAULT_CREATE_SESSION_RPS
    create_session_burst: float = d.DEFAULT_CREATE_SESSION_BURST
    max_sessions_per_ip: int = d.DEFAULT_MAX_SESSIONS_PER_IP
    max_sessions_per_api_key: int = d.DEFAULT_MAX_SESSIONS_PER_API_KEY
    max_audio_seconds_per_session: float = d.DEFAULT_MAX_AUDIO_SECONDS_PER_SESSION
    max_audio_bytes_per_sec: int = d.DEFAULT_MAX_AUDIO_BYTES_PER_SEC
    max_audio_bytes_per_sec_burst: int = d.DEFAULT_MAX_AUDIO_BYTES_PER_SEC_BURST
    max_audio_bytes_per_sec_realtime: Optional[int] = d.DEFAULT_MAX_AUDIO_BYTES_PER_SEC_REALTIME
    max_audio_bytes_per_sec_burst_realtime: Optional[int] = d.DEFAULT_MAX_AUDIO_BYTES_PER_SEC_BURST_REALTIME
    max_audio_bytes_per_sec_batch: Optional[int] = d.DEFAULT_MAX_AUDIO_BYTES_PER_SEC_BATCH
    max_audio_bytes_per_sec_burst_batch: Optional[int] = d.DEFAULT_MAX_AUDIO_BYTES_PER_SEC_BURST_BATCH
    http_rate_limit_rps: float = d.DEFAULT_HTTP_RATE_LIMIT_RPS
    http_rate_limit_burst: float = d.DEFAULT_HTTP_RATE_LIMIT_BURST
    http_trusted_proxies: List[str] = field(
        default_factory=lambda: list(d.DEFAULT_HTTP_TRUSTED_PROXIES)
    )

    # streaming / decode pipeline
    decode_timeout_sec: float = d.DEFAULT_DECODE_TIMEOUT
    session_timeout_sec: float = d.DEFAULT_SESSION_TIMEOUT_SEC
    sample_rate: int = d.DEFAULT_SAMPLE_RATE
    max_buffer_sec: Optional[float] = d.DEFAULT_MAX_BUFFER_SEC
    max_buffer_bytes: Optional[int] = None
    max_chunk_ms: Optional[int] = d.DEFAULT_MAX_CHUNK_MS
    partial_decode_interval_sec: Optional[float] = d.DEFAULT_PARTIAL_DECODE_INTERVAL_SEC
    partial_decode_window_sec: Optional[float] = d.DEFAULT_PARTIAL_DECODE_WINDOW_SEC
    emit_final_on_vad: bool = d.DEFAULT_EMIT_FINAL_ON_VAD
    max_pending_decodes_per_stream: int = d.DEFAULT_MAX_PENDING_DECODES_PER_STREAM
    max_pending_decodes_global: int = d.DEFAULT_MAX_PENDING_DECODES_GLOBAL
    max_total_buffer_bytes: Optional[int] = d.DEFAULT_MAX_TOTAL_BUFFER_BYTES
    decode_queue_timeout_sec: float = d.DEFAULT_DECODE_QUEUE_TIMEOUT_SEC
    decode_batch_window_ms: float = d.DEFAULT_DECODE_BATCH_WINDOW_MS
    max_decode_batch_size: int = d.DEFAULT_MAX_DECODE_BATCH_SIZE
    buffer_overlap_sec: float = d.DEFAULT_BUFFER_OVERLAP_SEC
    log_metrics: bool = d.DEFAULT_LOG_METRICS

    # VAD
    vad_silence: float = d.DEFAULT_VAD_SILENCE
    vad_threshold: float = d.DEFAULT_VAD_THRESHOLD
    vad_model_pool_size: int = d.DEFAULT_VAD_MODEL_POOL_SIZE
    vad_model_prewarm: int = d.DEFAULT_VAD_MODEL_PREWARM
    vad_model_pool_growth_factor: float = d.DEFAULT_VAD_MODEL_POOL_GROWTH_FACTOR
    vad_device: str = d.DEFAULT_VAD_DEVICE
    vad_model_path: Optional[str] = d.DEFAULT_VAD_MODEL_PATH
    speech_rms_threshold: float = d.DEFAULT_SPEECH_RMS_THRESHOLD

    # adaptive throttle
    adaptive_throttle_enabled: bool = d.DEFAULT_ADAPTIVE_THROTTLE_ENABLED
    adaptive_throttle_interval_sec: float = d.DEFAULT_ADAPTIVE_THROTTLE_INTERVAL_SEC
    adaptive_pending_ratio_high: float = d.DEFAULT_ADAPTIVE_PENDING_RATIO_HIGH
    adaptive_buffer_ratio_high: float = d.DEFAULT_ADAPTIVE_BUFFER_RATIO_HIGH
    adaptive_orphan_rate_high: float = d.DEFAULT_ADAPTIVE_ORPHAN_RATE_HIGH
    adaptive_partial_interval_scale: float = d.DEFAULT_ADAPTIVE_PARTIAL_INTERVAL_SCALE
    adaptive_partial_interval_max_sec: Optional[float] = d.DEFAULT_ADAPTIVE_PARTIAL_INTERVAL_MAX_SEC
    adaptive_create_session_backoff_sec: float = d.DEFAULT_ADAPTIVE_CREATE_SESSION_BACKOFF_SEC

    # health
    health_window_sec: float = d.DEFAULT_HEALTH_WINDOW_SEC
    health_min_events: int = d.DEFAULT_HEALTH_MIN_EVENTS
    health_max_timeout_ratio: float = d.DEFAULT_HEALTH_MAX_TIMEOUT_RATIO
    health_min_success_ratio: float = d.DEFAULT_HEALTH_MIN_SUCCESS_RATIO

    # TLS / auth
    tls_cert_file: Optional[str] = d.DEFAULT_TLS_CERT_FILE
    tls_key_file: Optional[str] = d.DEFAULT_TLS_KEY_FILE
    tls_required: bool = d.DEFAULT_TLS_REQUIRED
    require_api_key: bool = d.DEFAULT_REQUIRE_API_KEY
    create_session_auth_profile: str = d.DEFAULT_CREATE_SESSION_AUTH_PROFILE
    create_session_auth_secret: str = d.DEFAULT_CREATE_SESSION_AUTH_SECRET
    create_session_auth_ttl_sec: float = d.DEFAULT_CREATE_SESSION_AUTH_TTL_SEC

    # logging / metrics exposure
    log_level: str = d.DEFAULT_LOG_LEVEL
    log_file: Optional[str] = d.DEFAULT_LOG_FILE
    log_transcripts: bool = d.DEFAULT_LOG_TRANSCRIPTS
    transcript_log_file: Optional[str] = d.DEFAULT_TRANSCRIPT_LOG_FILE
    transcript_retention_days: Optional[int] = d.DEFAULT_TRANSCRIPT_RETENTION_DAYS
    expose_api_key_metrics: bool = d.DEFAULT_EXPOSE_API_KEY_METRICS

    # audio persistence
    persist_audio: bool = d.DEFAULT_PERSIST_AUDIO
    audio_storage_dir: str = d.DEFAULT_AUDIO_STORAGE_DIR
    audio_storage_queue_max_chunks: Optional[int] = d.DEFAULT_AUDIO_STORAGE_QUEUE_MAX_CHUNKS
    audio_storage_max_bytes: Optional[int] = None
    audio_storage_max_files: Optional[int] = None
    audio_storage_max_age_days: Optional[int] = None

    # TPU execution
    tpu_mesh_shape: str = d.DEFAULT_TPU_MESH_SHAPE
    tpu_audio_buckets_sec: List[float] = field(
        default_factory=lambda: list(d.DEFAULT_TPU_AUDIO_BUCKETS_SEC)
    )
    tpu_batch_buckets: List[int] = field(
        default_factory=lambda: list(d.DEFAULT_TPU_BATCH_BUCKETS)
    )
    tpu_max_decode_tokens: int = d.DEFAULT_TPU_MAX_DECODE_TOKENS
    tpu_decode_token_chunk: int = d.DEFAULT_TPU_DECODE_TOKEN_CHUNK
    tpu_use_pallas: bool = d.DEFAULT_TPU_USE_PALLAS
    tpu_pad_to_30s: bool = d.DEFAULT_TPU_PAD_TO_30S
    tpu_prewarm: bool = d.DEFAULT_TPU_PREWARM
    tpu_prewarm_batch_sizes: List[int] = field(
        default_factory=lambda: list(d.DEFAULT_TPU_PREWARM_BATCH_SIZES)
    )
    tpu_prewarm_mode: str = d.DEFAULT_TPU_PREWARM_MODE
    tpu_prefer_donation: bool = d.DEFAULT_TPU_PREFER_DONATION


SECTION_MAP: Dict[str, Dict[str, str]] = {"model": d.MODEL_SECTION_MAP}
SECTION_MAP.update(d.SERVER_SECTION_MAP)


def _read_yaml(path: Optional[Path]) -> Optional[Dict[str, Any]]:
    if not path or not Path(path).exists():
        return None
    with open(path, "r", encoding="utf-8") as fh:
        data = yaml.safe_load(fh)
    return data if isinstance(data, dict) else None


def _normalize_profiles(profiles: Any) -> Dict[str, Dict[str, Any]]:
    if not isinstance(profiles, dict):
        return {}
    return {
        name: dict(options)
        for name, options in profiles.items()
        if isinstance(options, dict)
    }


def _apply_sections(cfg: ServerConfig, raw: Dict[str, Any]) -> None:
    field_names = {f.name for f in fields(ServerConfig)}
    for section, mapping in SECTION_MAP.items():
        data = raw.get(section)
        if not isinstance(data, dict):
            continue
        for key, attr in mapping.items():
            if key in data and data[key] is not None:
                setattr(cfg, attr, data[key])
        if section == "model":
            for kind in ("decode_profiles", "model_load_profiles"):
                normalized = _normalize_profiles(data.get(kind))
                if normalized:
                    setattr(cfg, kind, normalized)
    # top-level profile maps and direct field keys also apply
    for kind in ("decode_profiles", "model_load_profiles"):
        normalized = _normalize_profiles(raw.get(kind))
        if normalized:
            setattr(cfg, kind, normalized)
    for key, value in raw.items():
        if key in SECTION_MAP:
            continue
        if key in field_names and value is not None:
            setattr(cfg, key, value)


def _build_default_model_load_profile(cfg: ServerConfig) -> Dict[str, Any]:
    profile: Dict[str, Any] = {
        "model_size": cfg.model,
        "device": cfg.device,
        "compute_type": cfg.compute_type,
        "pool_size": max(1, int(cfg.model_pool_size)),
        "language": cfg.language,
        "language_fix": cfg.language_fix,
        "task": cfg.task,
        "backend": cfg.model_backend,
        "log_metrics": cfg.log_metrics,
    }
    if cfg.model_weights_path:
        profile["weights_path"] = cfg.model_weights_path
    if cfg.model_tokenizer_path:
        profile["tokenizer_path"] = cfg.model_tokenizer_path
    return profile


def ensure_default_model_load_profile(cfg: ServerConfig) -> None:
    """Synthesize the ``default`` load profile from flat model fields."""
    if cfg.model_load_profiles:
        if cfg.default_model_load_profile not in cfg.model_load_profiles:
            cfg.default_model_load_profile = next(iter(cfg.model_load_profiles))
        return
    cfg.model_load_profiles = {
        cfg.default_model_load_profile: _build_default_model_load_profile(cfg)
    }


def load_config(
    server_path: Optional[Path] = None, model_path: Optional[Path] = None
) -> ServerConfig:
    """Build a ServerConfig from defaults + server.yaml + model.yaml."""
    cfg = ServerConfig()
    for path in (
        server_path or DEFAULT_CONFIG_PATH,
        model_path or DEFAULT_MODEL_CONFIG_PATH,
    ):
        data = _read_yaml(path)
        if data:
            _apply_sections(cfg, data)
    ensure_default_model_load_profile(cfg)
    return cfg


def parse_mesh_shape(shape: str) -> tuple:
    """Parse ``"<data>x<model>"`` (e.g. ``"4x2"``) into an int tuple."""
    parts = str(shape).lower().replace("*", "x").split("x")
    dims = tuple(int(p) for p in parts if p.strip())
    if not dims:
        return (1, 1)
    if len(dims) == 1:
        return (dims[0], 1)
    return dims[:2]


__all__ = [
    "ServerConfig",
    "SECTION_MAP",
    "DEFAULT_CONFIG_PATH",
    "DEFAULT_MODEL_CONFIG_PATH",
    "load_config",
    "ensure_default_model_load_profile",
    "parse_mesh_shape",
]
