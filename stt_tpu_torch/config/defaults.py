"""Built-in configuration defaults and YAML section->field maps.

Own copy of ``stt_tpu/config/defaults.py`` for the port, which imports nothing of ``stt_tpu``.

Knob names and YAML layout are compatible with the reference service
(reference: ``stt_server/config/default/server.py:5-172`` and
``default/model.py:5-79``) so existing deployment YAML keeps working. New
TPU-specific knobs live in their own ``tpu:`` section; the decode-batching
knobs that the reference documents but never wires
(``decode_batch_window_ms`` / ``max_decode_batch_size``, reference
``README.md:173-174``) are first-class here because continuous batching is
the default execution model.
"""

from typing import Any, Dict

# --- server / runtime -------------------------------------------------------
DEFAULT_PORT = 50051
DEFAULT_MAX_SESSIONS = 4
DEFAULT_METRICS_PORT = 8000
DEFAULT_HTTP_HOST = "127.0.0.1"
DEFAULT_WS_HOST = DEFAULT_HTTP_HOST
DEFAULT_WS_PORT = 8001
DEFAULT_DECODE_TIMEOUT = 30.0
DEFAULT_LOG_METRICS = False
DEFAULT_LOG_TRANSCRIPTS = False
DEFAULT_SESSION_TIMEOUT_SEC = 60.0
DEFAULT_SAMPLE_RATE = 16000
DEFAULT_MAX_BUFFER_SEC = 20.0
DEFAULT_MAX_CHUNK_MS = 2000
DEFAULT_PARTIAL_DECODE_INTERVAL_SEC = 1.5
# Trailing window a PARTIAL decode covers (finals decode the full buffer).
# The reference ships 10.0 (stream_orchestrator/types.py:117); here the
# default is the 5 s audio bucket: the unrolled decode loop is ~40 steps
# instead of ~80, which is what meets the north-star p95 partial latency
# < 300 ms at 64 concurrent streams on one v5e chip. Continuity across
# the shorter window rides the committed-transcript conditioning
# (decode_scheduler passes committed[-400:] as initial_prompt) and the
# LCP commit machinery; audio older than the window stays in the buffer
# for the final decode. Set 10.0 to restore reference behavior.
DEFAULT_PARTIAL_DECODE_WINDOW_SEC = 5.0
DEFAULT_EMIT_FINAL_ON_VAD = False
DEFAULT_MAX_PENDING_DECODES_PER_STREAM = 8
DEFAULT_MAX_PENDING_DECODES_GLOBAL = 64
DEFAULT_MAX_TOTAL_BUFFER_BYTES = 64 * 1024 * 1024
DEFAULT_DECODE_QUEUE_TIMEOUT_SEC = 1.0
DEFAULT_BUFFER_OVERLAP_SEC = 0.5
DEFAULT_GRPC_MAX_RECEIVE_MESSAGE_BYTES = 8 * 1024 * 1024
DEFAULT_GRPC_MAX_SEND_MESSAGE_BYTES = 4 * 1024 * 1024
# 0 = auto-size (> max_sessions so short RPCs are never starved).
DEFAULT_GRPC_WORKER_THREADS = 0

# --- rate limits / quotas ---------------------------------------------------
DEFAULT_CREATE_SESSION_RPS = 5.0
DEFAULT_CREATE_SESSION_BURST = 10.0
DEFAULT_MAX_SESSIONS_PER_IP = 4
DEFAULT_MAX_SESSIONS_PER_API_KEY = 8
DEFAULT_MAX_AUDIO_SECONDS_PER_SESSION = 300.0
DEFAULT_MAX_AUDIO_BYTES_PER_SEC = 32000
DEFAULT_MAX_AUDIO_BYTES_PER_SEC_BURST = 64000
DEFAULT_MAX_AUDIO_BYTES_PER_SEC_REALTIME = None
DEFAULT_MAX_AUDIO_BYTES_PER_SEC_BURST_REALTIME = None
DEFAULT_MAX_AUDIO_BYTES_PER_SEC_BATCH = None
DEFAULT_MAX_AUDIO_BYTES_PER_SEC_BURST_BATCH = None
DEFAULT_HTTP_RATE_LIMIT_RPS = 5.0
DEFAULT_HTTP_RATE_LIMIT_BURST = 10.0
DEFAULT_HTTP_TRUSTED_PROXIES: list = []

# --- VAD / endpointing ------------------------------------------------------
DEFAULT_VAD_SILENCE = 0.8
DEFAULT_VAD_THRESHOLD = 0.5
DEFAULT_VAD_MODEL_POOL_SIZE = DEFAULT_MAX_SESSIONS
DEFAULT_VAD_MODEL_PREWARM = 1
DEFAULT_VAD_MODEL_POOL_GROWTH_FACTOR = 1.5
DEFAULT_SPEECH_RMS_THRESHOLD = 0.02
# where VAD frames are scored: "auto" = one jitted cross-session batch per
# tick on non-CPU servers, host numpy on CPU; "host" forces numpy;
# "device" forces the batched path everywhere
# "auto" == host scoring: on a shared serving chip, VAD dispatches queue
# behind long decode dispatches and stall the stream path (measured).
# "device" opts into the batched cross-session device scorer for
# deployments with a dedicated chip for the control plane.
DEFAULT_VAD_DEVICE = "auto"
# optional local Silero-VAD ONNX file (learned VAD; probability scale
# differs from the built-in DSP VAD - re-tune vad_threshold on switch)
DEFAULT_VAD_MODEL_PATH = None

# --- TLS / auth -------------------------------------------------------------
DEFAULT_TLS_CERT_FILE = None
DEFAULT_TLS_KEY_FILE = None
DEFAULT_TLS_REQUIRED = False
DEFAULT_REQUIRE_API_KEY = False
DEFAULT_CREATE_SESSION_AUTH_PROFILE = "none"
DEFAULT_CREATE_SESSION_AUTH_SECRET = ""
DEFAULT_CREATE_SESSION_AUTH_TTL_SEC = 0.0

# --- health / adaptive throttle --------------------------------------------
DEFAULT_HEALTH_WINDOW_SEC = 60.0
DEFAULT_HEALTH_MIN_EVENTS = 5
DEFAULT_HEALTH_MAX_TIMEOUT_RATIO = 0.5
DEFAULT_HEALTH_MIN_SUCCESS_RATIO = 0.5
DEFAULT_ADAPTIVE_THROTTLE_ENABLED = False
DEFAULT_ADAPTIVE_THROTTLE_INTERVAL_SEC = 2.0
DEFAULT_ADAPTIVE_PENDING_RATIO_HIGH = 0.8
DEFAULT_ADAPTIVE_BUFFER_RATIO_HIGH = 0.85
DEFAULT_ADAPTIVE_ORPHAN_RATE_HIGH = 0.2
DEFAULT_ADAPTIVE_PARTIAL_INTERVAL_SCALE = 2.0
DEFAULT_ADAPTIVE_PARTIAL_INTERVAL_MAX_SEC = None
DEFAULT_ADAPTIVE_CREATE_SESSION_BACKOFF_SEC = 2.0

# --- logging / metrics ------------------------------------------------------
DEFAULT_LOG_LEVEL = "INFO"
DEFAULT_LOG_FILE = None
DEFAULT_TRANSCRIPT_LOG_FILE = None
DEFAULT_TRANSCRIPT_RETENTION_DAYS = 7
DEFAULT_EXPOSE_API_KEY_METRICS = False

# --- audio persistence ------------------------------------------------------
DEFAULT_PERSIST_AUDIO = False
DEFAULT_AUDIO_STORAGE_DIR = "data/audio"
DEFAULT_AUDIO_STORAGE_QUEUE_MAX_CHUNKS = 256

# --- model ------------------------------------------------------------------
DEFAULT_MODEL_ID = "default"
DEFAULT_MODEL_NAME = "small"
DEFAULT_DEVICE = "tpu"
DEFAULT_COMPUTE_TYPE = "bfloat16"
DEFAULT_TASK = "transcribe"
DEFAULT_LANGUAGE = "ko"
DEFAULT_LANGUAGE_FIX = False
DEFAULT_MODEL_POOL_SIZE = 1
DEFAULT_MODEL_BACKEND = "jax_whisper"
DEFAULT_DECODE_PROFILE_NAME = "realtime"
DEFAULT_MODEL_LOAD_PROFILE_NAME = "default"

DEFAULT_DECODE_PROFILE: Dict[str, Any] = {
    "beam_size": 1,
    "best_of": 1,
    "patience": 1.0,
    "temperature": 0.0,
    "length_penalty": 1.0,
    "without_timestamps": True,
    "compression_ratio_threshold": 2.4,
    "no_speech_threshold": 0.6,
    "log_prob_threshold": -1.0,
    # Explicit here (the reference inherits the same default from
    # faster-whisper's transcribe(); engine.py defaults it on within a
    # request too) because the decode scheduler ALSO keys cross-window
    # conditioning off it: with the trailing 5 s partial window the
    # committed transcript is passed as initial_prompt so each window
    # decodes in context (decode_scheduler.schedule_decode).
    "condition_on_previous_text": True,
}


def default_decode_profiles() -> Dict[str, Dict[str, Any]]:
    return {DEFAULT_DECODE_PROFILE_NAME: dict(DEFAULT_DECODE_PROFILE)}


# Per-request decode options accepted over the wire (reference whitelist,
# ``stt_server/config/default/model.py:34-66``). Unknown keys are rejected
# with ERR1010.
ALLOWED_DECODE_OPTION_KEYS = {
    "append_punctuations",
    "batch_size",
    "beam_size",
    "best_of",
    "chunk_length",
    "clip_timestamps",
    "compression_ratio_threshold",
    "condition_on_previous_text",
    "hotwords",
    "initial_prompt",
    "language",
    "length_penalty",
    "log_prob_threshold",
    "max_initial_timestamp",
    "no_repeat_ngram_size",
    "no_speech_threshold",
    "patience",
    "prefix",
    "prepend_punctuations",
    "prompt_reset_on_temperature",
    "repetition_penalty",
    "suppress_blank",
    "suppress_tokens",
    "task",
    "temperature",
    "temperature_increment_on_fallback",
    "vad_filter",
    "vad_parameters",
    "without_timestamps",
    "word_timestamps",
}

# --- TPU execution ----------------------------------------------------------
DEFAULT_DECODE_BATCH_WINDOW_MS = 5.0   # micro-batching window for the engine
# Engine batch-row cap per step. 64 so a 64-stream partial burst decodes
# as ONE MXU-efficient group: at the old cap of 16 the same burst ran as
# 4 sequential 16-row groups and the group-queue wait alone pushed loaded
# partial p95 past the 300 ms north star. The wider shapes' boot compiles
# ride the committed .exec_cache artifacts + persistent XLA cache.
DEFAULT_MAX_DECODE_BATCH_SIZE = 64
DEFAULT_TPU_MESH_SHAPE = "1x1"         # "<data>x<model>" device mesh layout
DEFAULT_TPU_AUDIO_BUCKETS_SEC = [1.0, 2.0, 5.0, 10.0, 30.0]
# sparse on purpose: batch rows pad to the next bucket, and small-batch
# dispatches are latency-bound on TPU, so intermediate rungs buy little
# serving latency while multiplying the boot compile matrix
DEFAULT_TPU_BATCH_BUCKETS = [1, 4, 16, 64]
DEFAULT_TPU_MAX_DECODE_TOKENS = 224
DEFAULT_TPU_DECODE_TOKEN_CHUNK = 8     # tokens per engine step (preemption grain)
# Pallas fused log-mel: 3.2x faster than the XLA mel standalone on a v5e
# and, since the kernel emits the transposed (B, n_mels, F) layout
# directly, the fused serve program matches XLA-mel throughput with better
# partial latency (p95 55 ms vs 66 ms measured).
DEFAULT_TPU_USE_PALLAS = True
# Boot-time shape prewarm: compile (audio bucket x batch size) programs at
# model load so first decodes never stall on XLA compilation (a cold shape
# costs tens of seconds on TPU — measured 8-16s first-decode stalls when a
# batch bucket was left cold). Empty list = every batch bucket, which is
# the safe default: serving reaches ALL of them under load.
# Accuracy-parity mode: whisper checkpoints are trained on 30 s windows and
# the reference backends always pad to 30 s. Bucketed shorter windows are
# faster (the latency default) but shift the input distribution slightly;
# set true to force full-window padding for maximum transcript parity.
DEFAULT_TPU_PAD_TO_30S = False
DEFAULT_TPU_PREWARM = True
DEFAULT_TPU_PREWARM_BATCH_SIZES: list = []
# "aot": lower+compile every shape host-side (no device execution; fills
# the persistent XLA cache; fast parallel boots). "execute": also run a
# zero-audio batch per shape on device (slowest, proves execution).
DEFAULT_TPU_PREWARM_MODE = "aot"
DEFAULT_TPU_PREFER_DONATION = True


# --- YAML section -> ServerConfig field maps --------------------------------
SERVER_SECTION_MAP: Dict[str, Dict[str, str]] = {
    "server": {
        "port": "port",
        "http_host": "http_host",
        "ws_host": "ws_host",
        "max_sessions": "max_sessions",
        "metrics_port": "metrics_port",
        "ws_port": "ws_port",
        "grpc_worker_threads": "grpc_worker_threads",
        "create_session_rps": "create_session_rps",
        "create_session_burst": "create_session_burst",
        "max_sessions_per_ip": "max_sessions_per_ip",
        "max_sessions_per_api_key": "max_sessions_per_api_key",
        "max_audio_seconds_per_session": "max_audio_seconds_per_session",
        "max_audio_bytes_per_sec": "max_audio_bytes_per_sec",
        "max_audio_bytes_per_sec_burst": "max_audio_bytes_per_sec_burst",
        "max_audio_bytes_per_sec_realtime": "max_audio_bytes_per_sec_realtime",
        "max_audio_bytes_per_sec_burst_realtime": "max_audio_bytes_per_sec_burst_realtime",
        "max_audio_bytes_per_sec_batch": "max_audio_bytes_per_sec_batch",
        "max_audio_bytes_per_sec_burst_batch": "max_audio_bytes_per_sec_burst_batch",
        "http_rate_limit_rps": "http_rate_limit_rps",
        "http_rate_limit_burst": "http_rate_limit_burst",
        "http_trusted_proxies": "http_trusted_proxies",
        "decode_timeout_sec": "decode_timeout_sec",
        "session_timeout_sec": "session_timeout_sec",
        "max_buffer_sec": "max_buffer_sec",
        "max_buffer_bytes": "max_buffer_bytes",
        "max_chunk_ms": "max_chunk_ms",
        "max_pending_decodes_per_stream": "max_pending_decodes_per_stream",
        "max_pending_decodes_global": "max_pending_decodes_global",
        "max_total_buffer_bytes": "max_total_buffer_bytes",
        "decode_queue_timeout_sec": "decode_queue_timeout_sec",
        "decode_batch_window_ms": "decode_batch_window_ms",
        "max_decode_batch_size": "max_decode_batch_size",
        "buffer_overlap_sec": "buffer_overlap_sec",
        "partial_decode_interval_sec": "partial_decode_interval_sec",
        "partial_decode_window_sec": "partial_decode_window_sec",
        "emit_final_on_vad": "emit_final_on_vad",
        "adaptive_throttle_enabled": "adaptive_throttle_enabled",
        "adaptive_throttle_interval_sec": "adaptive_throttle_interval_sec",
        "adaptive_pending_ratio_high": "adaptive_pending_ratio_high",
        "adaptive_buffer_ratio_high": "adaptive_buffer_ratio_high",
        "adaptive_orphan_rate_high": "adaptive_orphan_rate_high",
        "adaptive_partial_interval_scale": "adaptive_partial_interval_scale",
        "adaptive_partial_interval_max_sec": "adaptive_partial_interval_max_sec",
        "adaptive_create_session_backoff_sec": "adaptive_create_session_backoff_sec",
        "grpc_max_receive_message_bytes": "grpc_max_receive_message_bytes",
        "grpc_max_send_message_bytes": "grpc_max_send_message_bytes",
        "log_metrics": "log_metrics",
        "sample_rate": "sample_rate",
    },
    "vad": {
        "silence": "vad_silence",
        "threshold": "vad_threshold",
        "model_pool_size": "vad_model_pool_size",
        "model_prewarm": "vad_model_prewarm",
        "model_pool_growth_factor": "vad_model_pool_growth_factor",
        "device": "vad_device",
        "model_path": "vad_model_path",
    },
    "safety": {
        "speech_rms_threshold": "speech_rms_threshold",
    },
    "metrics": {
        "expose_api_key_sessions": "expose_api_key_metrics",
    },
    "logging": {
        "level": "log_level",
        "file": "log_file",
        "log_transcripts": "log_transcripts",
        "transcript_file": "transcript_log_file",
        "transcript_retention_days": "transcript_retention_days",
    },
    "tls": {
        "cert_file": "tls_cert_file",
        "key_file": "tls_key_file",
        "required": "tls_required",
    },
    "auth": {
        "require_api_key": "require_api_key",
        "create_session_auth_profile": "create_session_auth_profile",
        "create_session_auth_secret": "create_session_auth_secret",
        "create_session_auth_ttl_sec": "create_session_auth_ttl_sec",
    },
    "storage": {
        "persist_audio": "persist_audio",
        "directory": "audio_storage_dir",
        "queue_max_chunks": "audio_storage_queue_max_chunks",
        "max_bytes": "audio_storage_max_bytes",
        "max_files": "audio_storage_max_files",
        "max_age_days": "audio_storage_max_age_days",
    },
    "health": {
        "window_sec": "health_window_sec",
        "min_events": "health_min_events",
        "max_timeout_ratio": "health_max_timeout_ratio",
        "min_success_ratio": "health_min_success_ratio",
    },
    "tpu": {
        "mesh_shape": "tpu_mesh_shape",
        "audio_buckets_sec": "tpu_audio_buckets_sec",
        "batch_buckets": "tpu_batch_buckets",
        "max_decode_tokens": "tpu_max_decode_tokens",
        "decode_token_chunk": "tpu_decode_token_chunk",
        "use_pallas": "tpu_use_pallas",
        "pad_to_30s": "tpu_pad_to_30s",
        "prewarm": "tpu_prewarm",
        "prewarm_batch_sizes": "tpu_prewarm_batch_sizes",
        "prewarm_mode": "tpu_prewarm_mode",
        "prefer_donation": "tpu_prefer_donation",
    },
}

MODEL_SECTION_MAP: Dict[str, str] = {
    "backend": "model_backend",
    "name": "model",
    "device": "device",
    "compute_type": "compute_type",
    "language": "language",
    "language_fix": "language_fix",
    "pool_size": "model_pool_size",
    "task": "task",
    "default_decode_profile": "default_decode_profile",
    "default_model_load_profile": "default_model_load_profile",
    "weights_path": "model_weights_path",
    "tokenizer_path": "model_tokenizer_path",
}
