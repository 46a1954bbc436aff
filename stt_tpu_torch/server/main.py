"""Server entrypoint: CLI parsing, config merge, lifecycle, shutdown.

    python3 -m stt_tpu_torch.server.main [--config server.yaml] [--model-config model.yaml] ...

Counterpart of ``stt_tpu/server/main.py`` for the port, with the same flags
and the same shipped YAML files. It serves ``CreateSession`` and
``StreamingRecognize`` over gRPC, with Whisper on the card (``--device
cpu`` serves on the host); the HTTP plane on ``metrics_port`` (``/health``,
``/metrics``, ``/metrics.json``, ``/system``, the admin API, ``/v1/models``
and REST transcription at ``/v1/audio/transcriptions`` and
``/v1/audio/translations``); and the WebSocket bridge on ``ws_port`` when it
is above 0 and ``websockets`` imports (else one warning, and gRPC + HTTP).
The runtime is built first, so the model is loaded and every configured
shape prewarmed before the planes start, and ``/health`` answers 200 only
once ``server.start()`` has run. XLA's compilation cache and the JAX
platform pin have no counterpart here.

Parity with the reference entrypoint (``stt_server/main.py:34-653``):
- CLI flags mirror the reference set (model/backend/device/ports/limits/TLS/
  VAD/logging); tri-state booleans default to ``None`` so "unset" falls
  through to YAML (reference ``main.py:455-461``)
- gRPC thread pool auto-sized ``max(4, max_sessions + 4)`` (``main.py:94``)
- TLS binding with ``[::]`` -> ``0.0.0.0`` fallback (``main.py:229-258``)
- WS public-bind auth guard with ``STT_ALLOW_INSECURE_WS`` escape hatch
  (``main.py:49-80``)
- two-stage shutdown: first signal drains with ``grace=decode_timeout`` and
  arms a force-exit timer; second signal stops immediately
  (``main.py:285-342``)
"""

from __future__ import annotations

import argparse
import ipaddress
import os
import signal
import threading
from concurrent import futures
from pathlib import Path
from typing import Optional

import grpc

from ..config.loader import (
    DEFAULT_CONFIG_PATH,
    DEFAULT_MODEL_CONFIG_PATH,
    ServerConfig,
    load_config,
)
from ..gen import stt_pb2_grpc
from ..utils.logging import LOGGER, configure_logging
from .runtime.runtime import ApplicationRuntime
from .transport.grpc_servicer import STTGrpcServicer
from .transport.http_server import start_http_server


def _binds_public_host(host: str) -> bool:
    value = (host or "").strip().lower()
    if not value or value in {"localhost", "127.0.0.1", "::1"}:
        return False
    if value in {"0.0.0.0", "::"}:
        return True
    try:
        return not ipaddress.ip_address(value).is_loopback
    except ValueError:
        return True  # hostnames are treated as externally reachable


def enforce_ws_auth_guard(config: ServerConfig) -> None:
    """Refuse to expose the WS bridge publicly without CreateSession auth."""
    if not config.ws_port or config.ws_port <= 0:
        return
    if not _binds_public_host(config.ws_host):
        return
    profile = (config.create_session_auth_profile or "").strip().lower()
    if profile not in {"", "none"} or config.require_api_key:
        return
    message = (
        "WebSocket is bound to a non-loopback host without CreateSession auth. "
        "Set auth.create_session_auth_profile (api_key or signed_token) "
        "or auth.require_api_key=true."
    )
    if os.getenv("STT_ALLOW_INSECURE_WS", "").strip().lower() in {
        "1", "true", "yes", "on",
    }:
        LOGGER.warning(
            "%s Allowing startup only because STT_ALLOW_INSECURE_WS is enabled.",
            message,
        )
        return
    raise ValueError(
        f"{message} For local testing only, set STT_ALLOW_INSECURE_WS=1 to bypass."
    )


def build_grpc_server(config: ServerConfig) -> grpc.Server:
    workers = config.grpc_worker_threads
    if workers <= 0:
        workers = max(4, config.max_sessions + 4)
    options = []
    if config.grpc_max_receive_message_bytes and config.grpc_max_receive_message_bytes > 0:
        options.append(
            ("grpc.max_receive_message_length", config.grpc_max_receive_message_bytes)
        )
    if config.grpc_max_send_message_bytes and config.grpc_max_send_message_bytes > 0:
        options.append(
            ("grpc.max_send_message_length", config.grpc_max_send_message_bytes)
        )
    executor = futures.ThreadPoolExecutor(max_workers=workers)
    return grpc.server(executor, options=options or None)


def bind_grpc_port(server: grpc.Server, config: ServerConfig) -> int:
    """Bind the service port, with TLS when configured. Returns bound port."""
    if config.tls_required and not (config.tls_cert_file and config.tls_key_file):
        raise ValueError("TLS is required but tls_cert_file/tls_key_file not set.")
    credentials = None
    if config.tls_cert_file or config.tls_key_file:
        if not (config.tls_cert_file and config.tls_key_file):
            raise ValueError(
                "Both tls_cert_file and tls_key_file must be set to enable TLS."
            )
        cert_path = Path(config.tls_cert_file).expanduser()
        key_path = Path(config.tls_key_file).expanduser()
        if not cert_path.exists():
            raise FileNotFoundError(f"TLS cert file not found: {cert_path}")
        if not key_path.exists():
            raise FileNotFoundError(f"TLS key file not found: {key_path}")
        credentials = grpc.ssl_server_credentials(
            [(key_path.read_bytes(), cert_path.read_bytes())]
        )
        LOGGER.info("gRPC TLS enabled cert=%s key=%s", cert_path, key_path)
    else:
        LOGGER.warning(
            "gRPC is running without TLS. Set tls.cert_file/tls.key_file or "
            "--tls-cert-file/--tls-key-file to enable TLS."
        )

    def _bind(addr: str) -> int:
        if credentials is not None:
            return server.add_secure_port(addr, credentials)
        return server.add_insecure_port(addr)

    bind_addr = f"[::]:{config.port}"
    fallback = f"0.0.0.0:{config.port}"
    try:
        port = _bind(bind_addr)
        if port > 0:
            return port
        raise RuntimeError(f"bind failed on {bind_addr}")
    except RuntimeError as exc:
        LOGGER.warning(
            "Failed to bind gRPC on %s (%s); falling back to %s",
            bind_addr, exc, fallback,
        )
        return _bind(fallback)


def serve(config: ServerConfig, *, ready_event: Optional[threading.Event] = None) -> None:
    """Launch gRPC + HTTP + WS servers and block until shutdown."""
    enforce_ws_auth_guard(config)

    server_state = {"grpc_running": False}
    stop_event = threading.Event()
    shutdown_once = threading.Event()
    shutdown_done = threading.Event()
    force_exit_scheduled = threading.Event()

    server = build_grpc_server(config)
    runtime = ApplicationRuntime(config)
    servicer = STTGrpcServicer(runtime)
    stt_pb2_grpc.add_STTBackendServicer_to_server(servicer, server)
    bind_grpc_port(server, config)

    http_handle = start_http_server(
        runtime=runtime,
        server_state=server_state,
        host=config.http_host,
        port=config.metrics_port,
        http_rate_limit_rps=config.http_rate_limit_rps,
        http_rate_limit_burst=config.http_rate_limit_burst,
        http_trusted_proxies=config.http_trusted_proxies,
    )
    ws_handle = None
    if config.ws_port and config.ws_port > 0:
        try:
            from .transport.ws_server import start_ws_server

            ws_handle = start_ws_server(
                runtime=runtime,
                host=config.ws_host,
                port=config.ws_port,
                ws_rate_limit_rps=config.http_rate_limit_rps,
                ws_rate_limit_burst=config.http_rate_limit_burst,
                ws_trusted_proxies=config.http_trusted_proxies,
            )
        except ImportError:
            LOGGER.warning("websockets not available; WS bridge disabled")

    LOGGER.info(
        "STT server started on port %s (model=%s, device=%s, backend=%s)",
        config.port, config.model, config.device, config.model_backend,
    )

    def shutdown(grace_override: Optional[float] = None) -> None:
        if shutdown_once.is_set():
            if grace_override is not None and grace_override <= 0:
                try:
                    server.stop(0)
                except Exception:
                    LOGGER.exception("failed to request immediate gRPC stop")
            return
        shutdown_once.set()
        server_state["grpc_running"] = False
        runtime.stop_accepting_sessions()
        if grace_override is None:
            grace = config.decode_timeout_sec if config.decode_timeout_sec > 0 else 5.0
        else:
            grace = max(0.0, grace_override)
        LOGGER.info("graceful shutdown started (grace=%.2fs)", grace)
        try:
            server.stop(grace).wait()
        finally:
            stop_timeout = max(1.0, grace + 1.0)
            http_handle.stop(timeout=stop_timeout)
            if ws_handle is not None:
                ws_handle.stop(timeout=stop_timeout)
            runtime.shutdown()
            shutdown_done.set()

    def _force_exit_after(delay: float) -> None:
        if shutdown_done.wait(timeout=delay):
            return
        LOGGER.error("graceful shutdown timed out; forcing immediate shutdown")
        stop_event.set()
        shutdown(grace_override=0.0)

    def _handle_signal(signum: int, _frame) -> None:
        if shutdown_once.is_set():
            LOGGER.error("second signal %s received; forcing immediate shutdown", signum)
            stop_event.set()
            shutdown(grace_override=0.0)
            return
        LOGGER.info("received signal %s; shutting down", signum)
        stop_event.set()
        if not force_exit_scheduled.is_set():
            force_exit_scheduled.set()
            delay = (
                config.decode_timeout_sec if config.decode_timeout_sec > 0 else 5.0
            ) + 2.0
            threading.Thread(
                target=_force_exit_after, args=(delay,), daemon=True
            ).start()

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _handle_signal)
        signal.signal(signal.SIGINT, _handle_signal)
    else:
        LOGGER.warning("signal handlers not installed (not on the main thread)")

    server.start()
    server_state["grpc_running"] = True
    if ready_event is not None:
        ready_event.set()
    try:
        while not stop_event.is_set():
            server.wait_for_termination(timeout=1.0)
    finally:
        shutdown()


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Streaming STT gRPC server on PyTorch and CUDA (stt_tpu_torch)")
    parser.add_argument("--config", type=str,
                        help=f"Path to YAML config (default: {DEFAULT_CONFIG_PATH})")
    parser.add_argument("--model-config", type=str,
                        help=f"Path to model YAML (default: {DEFAULT_MODEL_CONFIG_PATH})")
    parser.add_argument("--model", default=None, help="Whisper model size to load")
    parser.add_argument("--model-backend", default=None,
                        help="Model backend (torch_whisper | jax_whisper | fake)")
    parser.add_argument("--device", default=None,
                        help="Target device (cuda | cuda:N | gpu | tpu | cpu)")
    parser.add_argument("--compute-type", default=None, help="Backend compute type")
    parser.add_argument("--language", action="append", dest="languages",
                        help="BCP-47 language code; last occurrence wins")
    parser.add_argument("--language-fix", dest="language_fix", action="store_true",
                        help="Force decoding in the configured language")
    parser.add_argument("--no-language-fix", dest="language_fix", action="store_false",
                        help="Allow automatic language detection")
    parser.add_argument("--task", choices=("transcribe", "translate"), default=None)
    parser.add_argument("--model-pool-size", type=int, default=None,
                        help="Engine batch-capacity hint / thread pool size")
    parser.add_argument("--port", type=int, default=None, help="gRPC port to bind")
    parser.add_argument("--metrics-port", type=int, default=None,
                        help="Port for HTTP metrics/health server")
    parser.add_argument("--ws-port", type=int, default=None,
                        help="Port for the WebSocket bridge (0 disables)")
    parser.add_argument("--grpc-worker-threads", type=int, default=None,
                        help="gRPC thread pool size (0 = auto)")
    parser.add_argument("--max-sessions", type=int, default=None,
                        help="Maximum concurrent streaming sessions")
    parser.add_argument("--decode-timeout", type=float, default=None,
                        help="Seconds to wait for a decode before aborting")
    parser.add_argument("--log-metrics", dest="log_metrics", action="store_true")
    parser.add_argument("--no-log-metrics", dest="log_metrics", action="store_false")
    parser.add_argument("--log-transcripts", dest="log_transcripts",
                        action="store_true", help="Log transcript text (PII risk)")
    parser.add_argument("--no-log-transcripts", dest="log_transcripts",
                        action="store_false")
    parser.set_defaults(
        log_metrics=None,
        log_transcripts=None,
        language_fix=None,
        tls_required=None,
        require_api_key=None,
    )
    parser.add_argument("--log-level", default=None)
    parser.add_argument("--log-file", default=None)
    parser.add_argument("--transcript-log-file", default=None)
    parser.add_argument("--transcript-log-retention-days", type=int, default=None)
    parser.add_argument("--tls-cert-file", default=None)
    parser.add_argument("--tls-key-file", default=None)
    parser.add_argument("--tls-required", dest="tls_required", action="store_true")
    parser.add_argument("--no-tls-required", dest="tls_required", action="store_false")
    parser.add_argument("--vad-silence", type=float, default=None,
                        help="Seconds of trailing silence that trigger VAD")
    parser.add_argument("--vad-threshold", type=float, default=None,
                        help="VAD probability threshold (0-1)")
    parser.add_argument("--speech-threshold", type=float, default=None,
                        help="Minimum RMS required before decoding")
    parser.add_argument("--sample-rate", type=int, default=None)
    parser.add_argument("--require-api-key", dest="require_api_key",
                        action="store_true")
    parser.add_argument("--no-require-api-key", dest="require_api_key",
                        action="store_false")
    parser.add_argument("--tpu-mesh-shape", default=None,
                        help='Device mesh "<data>x<model>", e.g. "4x2"')
    return parser.parse_args(argv)


def configure_from_args(args: argparse.Namespace) -> ServerConfig:
    """Load YAML configs then apply CLI overrides (CLI wins)."""
    config = load_config(
        Path(args.config).expanduser() if args.config else None,
        Path(args.model_config).expanduser() if args.model_config else None,
    )
    simple = {
        "model": "model",
        "model_backend": "model_backend",
        "device": "device",
        "compute_type": "compute_type",
        "task": "task",
        "model_pool_size": "model_pool_size",
        "port": "port",
        "metrics_port": "metrics_port",
        "ws_port": "ws_port",
        "grpc_worker_threads": "grpc_worker_threads",
        "max_sessions": "max_sessions",
        "decode_timeout": "decode_timeout_sec",
        "log_level": "log_level",
        "log_file": "log_file",
        "transcript_log_file": "transcript_log_file",
        "transcript_log_retention_days": "transcript_retention_days",
        "tls_cert_file": "tls_cert_file",
        "tls_key_file": "tls_key_file",
        "vad_silence": "vad_silence",
        "vad_threshold": "vad_threshold",
        "speech_threshold": "speech_rms_threshold",
        "sample_rate": "sample_rate",
        "tpu_mesh_shape": "tpu_mesh_shape",
    }
    for arg_name, field in simple.items():
        value = getattr(args, arg_name, None)
        if value is not None:
            setattr(config, field, value)
    for tri_state in (
        "log_metrics", "log_transcripts", "language_fix",
        "tls_required", "require_api_key",
    ):
        value = getattr(args, tri_state, None)
        if value is not None:
            setattr(config, tri_state, value)
    if getattr(args, "languages", None):
        config.language = args.languages[-1]
    if args.transcript_log_file:
        config.log_transcripts = True
    # CLI model overrides invalidate a YAML-derived default load profile
    if any(
        getattr(args, name, None) is not None
        for name in ("model", "model_backend", "device", "compute_type",
                     "model_pool_size")
    ):
        config.model_load_profiles = {}
    return config


def main(argv: Optional[list] = None) -> None:
    args = parse_args(argv)
    config = configure_from_args(args)
    configure_logging(
        level=config.log_level,
        log_file=config.log_file,
        log_transcripts=config.log_transcripts,
        transcript_file=config.transcript_log_file,
        transcript_retention_days=config.transcript_retention_days,
    )
    serve(config)


if __name__ == "__main__":
    main()
