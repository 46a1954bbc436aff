"""HTTP observability + admin plane on the stdlib ThreadingHTTPServer.

Own copy of ``stt_tpu/server/transport/http_server.py`` for the port, which imports nothing of ``stt_tpu``.

Endpoint / auth / payload parity with the reference FastAPI plane
(``stt_server/backend/transport/http_server.py:29-746``):

- ``GET /metrics`` Prometheus text (flattened gauges + histograms),
  ``GET /metrics.json``, ``GET /health`` (minimal / token-gated detail
  modes), ``GET /system``
- admin: ``POST /admin/load_model`` (profile-based, background thread, job
  status tracking), ``GET /admin/load_model_status``,
  ``POST /admin/unload_model``, ``GET /admin/list_models``
- env gates: ``STT_ADMIN_ENABLED`` + ``STT_ADMIN_TOKEN``,
  ``STT_ADMIN_ALLOW_MODEL_PATH`` + ``STT_ADMIN_MODEL_PATH_ALLOWLIST``,
  ``STT_OBSERVABILITY_TOKEN``, ``STT_PUBLIC_HEALTH``,
  ``STT_HEALTH_DETAIL_MODE``, ``STT_HTTP_ALLOWLIST``,
  ``STT_HTTP_TRUSTED_PROXIES``, ``STT_HTTP_RATE_LIMIT_RPS/_BURST``
- keyed per-IP rate limit, X-Forwarded-For only from trusted proxies

The substrate differs deliberately: FastAPI/uvicorn are replaced by the
stdlib ``http.server`` (no pydantic/ASGI dependency in the serving image);
request bodies are parsed with ``json`` and the error mapping reuses
``errors.http_payload_for``.
"""

from __future__ import annotations

import ipaddress
import json
import math
import os
import sys
import threading
import time
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ...errors import ErrorCode, STTError, http_payload_for
from ...utils.logging import LOGGER
from ...utils.rate_limit import KeyedRateLimiter
from ..runtime.system_metrics import collect_system_metrics
from .rest_transcribe import handle_transcription

_ADMIN_ENABLE_ENV = "STT_ADMIN_ENABLED"
_ADMIN_TOKEN_ENV = "STT_ADMIN_TOKEN"
_ADMIN_ALLOW_MODEL_PATH_ENV = "STT_ADMIN_ALLOW_MODEL_PATH"
_ADMIN_MODEL_PATH_ALLOWLIST_ENV = "STT_ADMIN_MODEL_PATH_ALLOWLIST"
_OBS_TOKEN_ENV = "STT_OBSERVABILITY_TOKEN"
_PUBLIC_HEALTH_ENV = "STT_PUBLIC_HEALTH"
_HEALTH_DETAIL_MODE_ENV = "STT_HEALTH_DETAIL_MODE"
_HTTP_RATE_LIMIT_RPS_ENV = "STT_HTTP_RATE_LIMIT_RPS"
_HTTP_RATE_LIMIT_BURST_ENV = "STT_HTTP_RATE_LIMIT_BURST"
_HTTP_ALLOWLIST_ENV = "STT_HTTP_ALLOWLIST"
_HTTP_TRUSTED_PROXIES_ENV = "STT_HTTP_TRUSTED_PROXIES"

_REST_TRANSCRIBE_ENV = "STT_REST_TRANSCRIBE"
_HTTP_MAX_BODY_ENV = "STT_HTTP_MAX_BODY_MB"
# default fits a ~1h 16 kHz mono PCM16 WAV (~115 MB) with headroom;
# admin/observability requests are orders of magnitude smaller
_HTTP_MAX_BODY_MB_DEFAULT = 128.0

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off"}


def _env_enabled(name: str) -> bool:
    return os.getenv(name, "").strip().lower() in _TRUE


def _max_body_bytes() -> int:
    """Request-body cap in bytes. ``inf`` disables the cap; unparseable,
    negative, or nan values fall back to the default (a bad env var must
    never 413 every request or crash the dispatch loop)."""
    default = int(_HTTP_MAX_BODY_MB_DEFAULT * 1024 * 1024)
    raw = os.getenv(_HTTP_MAX_BODY_ENV, "").strip()
    if not raw:
        return default
    try:
        mb = float(raw)
    except ValueError:
        return default
    if math.isnan(mb) or mb < 0:
        return default
    if math.isinf(mb):
        return sys.maxsize
    try:
        return int(mb * 1024 * 1024)
    except (OverflowError, ValueError):
        return sys.maxsize


def _rest_transcribe_enabled() -> bool:
    """REST transcription is on unless explicitly disabled (the endpoint
    enforces the same allowlist/rate-limit/session gauntlet as gRPC)."""
    return os.getenv(_REST_TRANSCRIBE_ENV, "").strip().lower() not in _FALSE


def _admin_token() -> str:
    return os.getenv(_ADMIN_TOKEN_ENV, "").strip()


def _observability_token() -> str:
    return os.getenv(_OBS_TOKEN_ENV, "").strip()


def _public_health_mode() -> str:
    value = os.getenv(_PUBLIC_HEALTH_ENV, "").strip().lower()
    return "minimal" if value in _TRUE | {"minimal"} else ""


def _health_detail_mode() -> str:
    value = os.getenv(_HEALTH_DETAIL_MODE_ENV, "").strip().lower()
    return "token" if value in _TRUE | {"token"} else ""


def _bearer_token(headers) -> str:
    auth = (headers.get("authorization") or "").strip()
    if auth.lower().startswith("bearer "):
        return auth[7:].strip()
    return ""


def _model_path_allowed(model_path: Optional[str]) -> bool:
    if not model_path:
        return True
    if not _env_enabled(_ADMIN_ALLOW_MODEL_PATH_ENV):
        return False
    allowlist = [
        item.strip()
        for item in os.getenv(_ADMIN_MODEL_PATH_ALLOWLIST_ENV, "").split(",")
        if item.strip()
    ]
    if not allowlist:
        return True
    return any(model_path.startswith(prefix) for prefix in allowlist)


# -- metric rendering ---------------------------------------------------------


def _sanitize_metric_name(value: str) -> str:
    out = []
    for idx, ch in enumerate(value):
        out.append(ch if ch.isalnum() or ch == "_" else "_")
        if idx == 0 and out[-1].isdigit():
            out.insert(0, "m")
    return "".join(out) or "metric"


def flatten_metrics(payload: Dict[str, Any]) -> Dict[str, float]:
    flat: Dict[str, float] = {}
    for key, value in payload.items():
        if value is None:
            continue
        if isinstance(value, (int, float, bool)):
            flat[_sanitize_metric_name(key)] = float(value)
        elif isinstance(value, dict):
            for sub_key, sub_val in value.items():
                if isinstance(sub_val, (int, float, bool)):
                    flat[_sanitize_metric_name(f"{key}_{sub_key}")] = float(sub_val)
    return flat


def _histogram_text(payload: Dict[str, Any]) -> List[str]:
    lines: List[str] = []
    histograms = payload.get("histograms")
    if not isinstance(histograms, dict):
        return lines
    for raw_name in sorted(histograms.keys()):
        spec = histograms.get(raw_name)
        if not isinstance(spec, dict):
            continue
        buckets = spec.get("buckets")
        if not isinstance(buckets, dict):
            continue
        name = f"stt_{_sanitize_metric_name(str(raw_name))}"
        lines.append(f"# HELP {name} Histogram for '{raw_name}'.")
        lines.append(f"# TYPE {name} histogram")
        items: List[Tuple[float, str, float]] = []
        inf_value: Optional[Tuple[str, float]] = None
        for label, count in buckets.items():
            if not isinstance(count, (int, float, bool)):
                continue
            label = str(label)
            if label == "+Inf":
                inf_value = (label, float(count))
                continue
            try:
                order = float(label)
            except ValueError:
                continue
            items.append((order, label, float(count)))
        items.sort(key=lambda it: it[0])
        for _order, label, count in items:
            lines.append(f'{name}_bucket{{le="{label}"}} {count}')
        if inf_value is not None:
            lines.append(f'{name}_bucket{{le="{inf_value[0]}"}} {inf_value[1]}')
        elif items:
            lines.append(f'{name}_bucket{{le="+Inf"}} {items[-1][2]}')
        total, count = spec.get("sum"), spec.get("count")
        if isinstance(total, (int, float, bool)):
            lines.append(f"{name}_sum {float(total)}")
        if isinstance(count, (int, float, bool)):
            lines.append(f"{name}_count {float(count)}")
    return lines


def prometheus_text(payload: Dict[str, Any]) -> str:
    flat = flatten_metrics(payload)
    lines: List[str] = []
    for key in sorted(flat.keys()):
        name = f"stt_{key}"
        lines.append(f"# HELP {name} Server metric '{key}' exposed as a gauge.")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {flat[key]}")
    lines.extend(_histogram_text(payload))
    return "\n".join(lines) + "\n"


# -- load job tracking ----------------------------------------------------------


@dataclass
class LoadJobState:
    status: str
    model_id: str
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    error: Optional[str] = None

    def to_payload(self) -> Dict[str, Any]:
        payload: Dict[str, Any] = {
            "status": self.status,
            "model_id": self.model_id,
            "started_at": self.started_at,
            "finished_at": self.finished_at,
        }
        if self.error:
            payload["error"] = self.error
        if self.started_at is not None and self.finished_at is not None:
            payload["duration_sec"] = max(0.0, self.finished_at - self.started_at)
        return payload


_LEGACY_LOAD_FIELDS = {
    "model_path", "model_size", "backend", "device", "compute_type", "language",
}


class HttpPlane:
    """Request-routing core, transport-agnostic for testability."""

    def __init__(
        self,
        runtime,
        server_state: Dict[str, bool],
        http_rate_limit_rps: Optional[float] = None,
        http_rate_limit_burst: Optional[float] = None,
        http_trusted_proxies: Optional[List[str]] = None,
    ) -> None:
        self.runtime = runtime
        self.server_state = server_state
        self._load_statuses: Dict[str, LoadJobState] = {}
        self._load_lock = threading.Lock()
        self.load_threads: List[threading.Thread] = []
        self.load_threads_lock = threading.Lock()

        if http_rate_limit_rps is None:
            try:
                http_rate_limit_rps = float(os.getenv(_HTTP_RATE_LIMIT_RPS_ENV, ""))
            except (TypeError, ValueError):
                http_rate_limit_rps = 0.0
        if http_rate_limit_burst is None:
            try:
                http_rate_limit_burst = float(os.getenv(_HTTP_RATE_LIMIT_BURST_ENV, ""))
            except (TypeError, ValueError):
                http_rate_limit_burst = max(1.0, http_rate_limit_rps)
        self._rate_limiter = KeyedRateLimiter(
            http_rate_limit_rps, http_rate_limit_burst or 0.0
        )

        self._allowlist: List[Any] = []
        for entry in os.getenv(_HTTP_ALLOWLIST_ENV, "").split(","):
            entry = entry.strip()
            if not entry:
                continue
            try:
                self._allowlist.append(ipaddress.ip_network(entry, strict=False))
            except ValueError:
                LOGGER.warning("invalid HTTP allowlist entry ignored: %s", entry)

        if http_trusted_proxies is None:
            proxy_entries = [
                e.strip()
                for e in os.getenv(_HTTP_TRUSTED_PROXIES_ENV, "").split(",")
                if e.strip()
            ]
        else:
            proxy_entries = [e.strip() for e in http_trusted_proxies if e]
        self._trusted_proxies: List[Any] = []
        self._trusted_proxy_hosts: List[str] = []
        for entry in proxy_entries:
            try:
                self._trusted_proxies.append(ipaddress.ip_network(entry, strict=False))
            except ValueError:
                if any(ch.isalpha() for ch in entry):
                    self._trusted_proxy_hosts.append(entry)
                else:
                    LOGGER.warning("invalid trusted proxy entry ignored: %s", entry)

    # -- guards -----------------------------------------------------------------

    def client_ip(self, peer_ip: str, headers) -> str:
        trusted = peer_ip in self._trusted_proxy_hosts
        if not trusted and self._trusted_proxies:
            try:
                addr = ipaddress.ip_address(peer_ip)
                trusted = any(addr in net for net in self._trusted_proxies)
            except ValueError:
                pass
        if not trusted:
            return peer_ip
        forwarded = (headers.get("x-forwarded-for") or "").strip()
        if not forwarded:
            return peer_ip
        return forwarded.split(",")[-1].strip()

    def _enforce_allowlist(self, client_ip: str) -> None:
        if not self._allowlist:
            return
        try:
            addr = ipaddress.ip_address(client_ip)
        except ValueError:
            raise STTError(ErrorCode.HTTP_IP_FORBIDDEN)
        if not any(addr in net for net in self._allowlist):
            raise STTError(ErrorCode.HTTP_IP_FORBIDDEN)

    def _enforce_rate_limit(self, client_ip: str) -> None:
        key = client_ip or "unknown"
        if not self._rate_limiter.allow(key):
            self.runtime.metrics.record_rate_limit_block("http", key)
            raise STTError(ErrorCode.HTTP_RATE_LIMITED)

    @staticmethod
    def _require_admin(headers) -> None:
        if not _env_enabled(_ADMIN_ENABLE_ENV) or not _admin_token():
            raise STTError(ErrorCode.ADMIN_API_DISABLED)
        if _bearer_token(headers) != _admin_token():
            raise STTError(ErrorCode.ADMIN_UNAUTHORIZED)

    @staticmethod
    def _require_observability(headers) -> None:
        token = _observability_token()
        if token and _bearer_token(headers) != token:
            raise STTError(ErrorCode.OBS_UNAUTHORIZED)

    # -- load-job state -------------------------------------------------------------

    def _get_load_status(self, model_id: str) -> Optional[LoadJobState]:
        with self._load_lock:
            return self._load_statuses.get(model_id)

    def _set_load_status(self, model_id: str, status: str, *, started_at=None,
                         finished_at=None, error=None) -> None:
        with self._load_lock:
            state = self._load_statuses.get(model_id)
            if state is None:
                state = LoadJobState(status=status, model_id=model_id)
                self._load_statuses[model_id] = state
            state.status = status
            if started_at is not None:
                state.started_at = started_at
            if finished_at is not None:
                state.finished_at = finished_at
            state.error = error

    def _prune_load_threads(self) -> None:
        with self.load_threads_lock:
            self.load_threads[:] = [t for t in self.load_threads if t.is_alive()]

    # -- runtime snapshot --------------------------------------------------------------

    def _runtime_snapshot(self) -> Dict[str, Any]:
        cfg = getattr(self.runtime, "config", None)
        if cfg is None:
            return {}
        return {
            "model": {
                "model_size": getattr(cfg, "model", None),
                "model_backend": getattr(cfg, "model_backend", None),
                "device": getattr(cfg, "device", None),
                "compute_type": getattr(cfg, "compute_type", None),
                "model_pool_size": getattr(cfg, "model_pool_size", None),
                "default_decode_profile": getattr(cfg, "default_decode_profile", None),
                "language": getattr(cfg, "language", None),
                "task": getattr(cfg, "task", None),
            },
            "streaming": {
                "sample_rate": getattr(cfg, "sample_rate", None),
                "session_timeout_sec": getattr(cfg, "session_timeout_sec", None),
                "decode_timeout_sec": getattr(cfg, "decode_timeout_sec", None),
                "create_session_rps": getattr(cfg, "create_session_rps", None),
                "create_session_burst": getattr(cfg, "create_session_burst", None),
                "vad_model_pool_size": getattr(cfg, "vad_model_pool_size", None),
                "vad_model_prewarm": getattr(cfg, "vad_model_prewarm", None),
                "vad_silence": getattr(cfg, "vad_silence", None),
                "vad_threshold": getattr(cfg, "vad_threshold", None),
                "max_chunk_ms": getattr(cfg, "max_chunk_ms", None),
                "partial_decode_interval_sec": getattr(
                    cfg, "partial_decode_interval_sec", None
                ),
                "partial_decode_window_sec": getattr(
                    cfg, "partial_decode_window_sec", None
                ),
                "max_pending_decodes_global": getattr(
                    cfg, "max_pending_decodes_global", None
                ),
                "max_pending_decodes_per_stream": getattr(
                    cfg, "max_pending_decodes_per_stream", None
                ),
                "adaptive_throttle_enabled": getattr(
                    cfg, "adaptive_throttle_enabled", None
                ),
            },
        }

    # -- dispatch -------------------------------------------------------------------------

    def handle(
        self,
        method: str,
        path: str,
        query: Dict[str, List[str]],
        headers,
        body: bytes,
        peer_ip: str,
    ) -> Tuple[int, str, Any]:
        """Returns (status, content_type, payload). payload str => raw body."""
        client_ip = self.client_ip(peer_ip, headers)
        try:
            if method == "GET" and path == "/metrics":
                self._enforce_allowlist(client_ip)
                self._enforce_rate_limit(client_ip)
                self._require_observability(headers)
                return (
                    200,
                    "text/plain; version=0.0.4",
                    prometheus_text(self.runtime.metrics.render()),
                )
            if method == "GET" and path == "/metrics.json":
                self._enforce_allowlist(client_ip)
                self._enforce_rate_limit(client_ip)
                self._require_observability(headers)
                return 200, "application/json", self.runtime.metrics.render()
            if method == "GET" and path == "/health":
                return self._health(client_ip, headers)
            if method == "GET" and path == "/system":
                self._enforce_allowlist(client_ip)
                self._enforce_rate_limit(client_ip)
                self._require_observability(headers)
                payload = collect_system_metrics()
                snapshot = self._runtime_snapshot()
                if snapshot:
                    payload["runtime"] = snapshot
                return 200, "application/json", payload
            if method == "POST" and path == "/admin/load_model":
                self._enforce_allowlist(client_ip)
                self._enforce_rate_limit(client_ip)
                self._require_admin(headers)
                return self._load_model(body)
            if method == "GET" and path == "/admin/load_model_status":
                self._enforce_allowlist(client_ip)
                self._enforce_rate_limit(client_ip)
                self._require_admin(headers)
                model_id = (query.get("model_id") or [""])[0]
                state = self._get_load_status(model_id)
                if not state:
                    return 200, "application/json", {
                        "status": "unknown", "model_id": model_id,
                    }
                return 200, "application/json", state.to_payload()
            if method == "POST" and path == "/admin/unload_model":
                self._enforce_allowlist(client_ip)
                self._enforce_rate_limit(client_ip)
                self._require_admin(headers)
                model_id = (query.get("model_id") or [""])[0]
                drain_raw = (query.get("drain_timeout_sec") or [None])[0]
                if not model_id and body:
                    try:
                        parsed = json.loads(body)
                        model_id = parsed.get("model_id", "")
                        drain_raw = parsed.get("drain_timeout_sec", drain_raw)
                    except (ValueError, AttributeError):
                        pass
                drain = float(drain_raw) if drain_raw is not None else None
                if self.runtime.model_registry.unload_model(
                    model_id, drain_timeout_sec=drain
                ):
                    return 200, "application/json", {
                        "status": "unloaded", "model_id": model_id,
                    }
                raise STTError(ErrorCode.MODEL_UNLOAD_FAILED)
            if method == "GET" and path == "/admin/list_models":
                self._enforce_allowlist(client_ip)
                self._enforce_rate_limit(client_ip)
                self._require_admin(headers)
                return 200, "application/json", {
                    "models": self.runtime.model_registry.list_models(),
                }
            if method == "GET" and path == "/v1/models":
                # OpenAI-models-shaped listing so REST integrations can
                # discover valid `model_id` values without admin access.
                # Only non-operational fields are exposed (pool depth,
                # device placement etc. stay behind /admin/list_models).
                if not _rest_transcribe_enabled():
                    return 404, "application/json", {
                        "code": "404", "message": "not found",
                    }
                self._enforce_allowlist(client_ip)
                self._enforce_rate_limit(client_ip)
                return 200, "application/json", {
                    "object": "list",
                    "data": [
                        {
                            "id": info.get("model_id"),
                            "object": "model",
                            "owned_by": "stt_tpu_torch",
                            "model_size": info.get("model_size"),
                        }
                        for info in
                        self.runtime.model_registry.list_models()
                    ],
                }
            if method == "POST" and path in (
                "/v1/audio/transcriptions",
                "/v1/audio/translations",
            ):
                if not _rest_transcribe_enabled():
                    return 404, "application/json", {
                        "code": "404", "message": "not found",
                    }
                self._enforce_allowlist(client_ip)
                self._enforce_rate_limit(client_ip)
                return handle_transcription(
                    self.runtime, query, headers, body, client_ip,
                    _bearer_token(headers),
                    # the OpenAI audio API splits translation into its own
                    # endpoint; the alias pins task=translate
                    force_task=(
                        "translate" if path.endswith("/translations") else ""
                    ),
                )
            return 404, "application/json", {"code": "404", "message": "not found"}
        except STTError as exc:
            return (
                exc.http_status,
                "application/json",
                http_payload_for(exc.code, exc.detail),
            )

    def _health(self, client_ip: str, headers) -> Tuple[int, str, Any]:
        self._enforce_allowlist(client_ip)
        self._enforce_rate_limit(client_ip)
        public_mode = _public_health_mode()
        detail_mode = _health_detail_mode()
        snapshot = self.runtime.health_snapshot()
        snapshot["grpc_running"] = self.server_state.get("grpc_running", False)
        healthy = snapshot["grpc_running"] and snapshot["model_pool_healthy"]
        if public_mode == "minimal" or detail_mode == "token":
            token = _observability_token()
            auth_ok = bool(token) and _bearer_token(headers) == token
            payload: Dict[str, Any] = {"status": "ok" if healthy else "error"}
            if auth_ok:
                payload.update(snapshot)
            return (200 if healthy else 503), "application/json", payload
        self._require_observability(headers)
        return (
            (200 if healthy else 500),
            "application/json",
            {"status": "ok" if healthy else "error", **snapshot},
        )

    def _load_model(self, body: bytes) -> Tuple[int, str, Any]:
        try:
            req = json.loads(body or b"{}")
        except ValueError:
            return 400, "application/json", {
                "code": "400", "message": "invalid JSON body",
            }
        model_id = (req.get("model_id") or "").strip()
        if not model_id:
            return 400, "application/json", {
                "code": "400", "message": "model_id is required",
            }
        self._prune_load_threads()
        existing = self._get_load_status(model_id)
        if existing and existing.status in {"queued", "running"}:
            return 200, "application/json", {
                "status": existing.status,
                "message": f"Model '{model_id}' is already loading.",
                "job": existing.to_payload(),
            }
        if self.runtime.model_registry.has_model(model_id):
            raise STTError(
                ErrorCode.MODEL_ALREADY_LOADED,
                f"Model '{model_id}' is already loaded",
            )

        profiles = getattr(self.runtime.config, "model_load_profiles", {}) or {}
        default_profile = getattr(
            self.runtime.config, "default_model_load_profile", None
        )
        profile_id = req.get("profile_id")
        use_legacy = bool(set(req.keys()) & _LEGACY_LOAD_FIELDS)
        if profile_id:
            profile_cfg = profiles.get(profile_id)
            if not profile_cfg:
                raise STTError(
                    ErrorCode.ADMIN_MODEL_PROFILE_UNKNOWN,
                    f"Unknown model profile '{profile_id}'",
                )
            load_config = dict(profile_cfg)
        elif profiles and not use_legacy:
            profile_id = default_profile or "default"
            profile_cfg = profiles.get(profile_id)
            if not profile_cfg:
                raise STTError(
                    ErrorCode.ADMIN_MODEL_PROFILE_UNKNOWN,
                    f"Unknown model profile '{profile_id}'",
                )
            load_config = dict(profile_cfg)
        else:
            load_config = {
                k: v for k, v in req.items() if k not in {"profile_id", "model_id"}
            }
        if not load_config.get("backend") and not load_config.get("model_backend"):
            load_config["backend"] = (
                getattr(self.runtime.config, "model_backend", "") or "torch_whisper"
            )
        if not _model_path_allowed(
            load_config.get("model_path") or load_config.get("weights_path")
        ):
            raise STTError(ErrorCode.ADMIN_MODEL_PATH_FORBIDDEN)

        self._set_load_status(
            model_id, "queued", started_at=None, finished_at=None, error=None
        )

        def _load_safe() -> None:
            self._set_load_status(
                model_id, "running", started_at=time.time(), error=None
            )
            try:
                self.runtime.model_registry.load_model(model_id, load_config)
            except (OSError, RuntimeError, TypeError, ValueError, STTError) as exc:
                error = str(exc).strip() or exc.__class__.__name__
                self._set_load_status(
                    model_id, "failed", finished_at=time.time(), error=error
                )
                LOGGER.exception("failed to load model '%s'", model_id)
                return
            self._set_load_status(
                model_id, "success", finished_at=time.time(), error=None
            )

        thread = threading.Thread(target=_load_safe, daemon=True)
        with self.load_threads_lock:
            self.load_threads.append(thread)
        thread.start()
        job = self._get_load_status(model_id)
        return 200, "application/json", {
            "status": "loading_started",
            "message": f"Model '{model_id}' is loading in the background.",
            "job": job.to_payload() if job else {
                "status": "unknown", "model_id": model_id,
            },
        }


class _Handler(BaseHTTPRequestHandler):
    plane: HttpPlane  # set on the subclass by start_http_server
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet internal-endpoint access logs
        path = args[0].split(" ")[1] if args and " " in str(args[0]) else ""
        if path in ("/metrics", "/metrics.json", "/system", "/health"):
            return
        LOGGER.debug("http %s", fmt % args)

    def _refuse(self, status: int, code: str, message: str) -> None:
        """Write a JSON error and close, without reading the body."""
        data = json.dumps({"code": code, "message": message}).encode("utf-8")
        self.send_response(status)
        self.send_header("content-type", "application/json")
        self.send_header("content-length", str(len(data)))
        self.send_header("connection", "close")
        self.end_headers()
        self.wfile.write(data)
        self.close_connection = True

    def _dispatch(self, method: str) -> None:
        parsed = urlparse(self.path)
        query = parse_qs(parsed.query)
        try:
            length = int(self.headers.get("content-length") or 0)
        except ValueError:
            length = None
        if length is None or length < 0:
            self._refuse(400, "invalid_request",
                         "content-length header is not a valid length")
            return
        limit = _max_body_bytes()
        if length > limit:
            # refuse before buffering: an audio upload surface must not
            # let a declared content-length allocate unbounded RAM
            self._refuse(413, "payload_too_large",
                         f"body exceeds {limit} bytes "
                         f"(tune {_HTTP_MAX_BODY_ENV})")
            return
        body = self.rfile.read(length) if length > 0 else b""
        peer_ip = self.client_address[0] if self.client_address else ""
        status, content_type, payload = self.plane.handle(
            method, parsed.path, query, self.headers, body, peer_ip
        )
        data = (
            payload.encode("utf-8")
            if isinstance(payload, str)
            else json.dumps(payload).encode("utf-8")
        )
        self.send_response(status)
        self.send_header("content-type", content_type)
        self.send_header("content-length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:
        self._dispatch("GET")

    def do_POST(self) -> None:
        self._dispatch("POST")


@dataclass
class HttpServerHandle:
    server: ThreadingHTTPServer
    thread: threading.Thread
    plane: HttpPlane

    @property
    def port(self) -> int:
        return self.server.server_address[1]

    def stop(self, timeout: Optional[float] = None) -> None:
        self.server.shutdown()
        self.server.server_close()
        if self.thread.is_alive():
            self.thread.join(timeout=timeout)
        with self.plane.load_threads_lock:
            threads = list(self.plane.load_threads)
        deadline = time.monotonic() + timeout if timeout is not None else None
        for t in threads:
            remaining = max(0.0, deadline - time.monotonic()) if deadline else None
            t.join(timeout=remaining)


def start_http_server(
    runtime,
    server_state: Dict[str, bool],
    host: str,
    port: int,
    http_rate_limit_rps: Optional[float] = None,
    http_rate_limit_burst: Optional[float] = None,
    http_trusted_proxies: Optional[List[str]] = None,
) -> HttpServerHandle:
    """Start the observability/admin HTTP plane on a daemon thread."""
    plane = HttpPlane(
        runtime,
        server_state,
        http_rate_limit_rps=http_rate_limit_rps,
        http_rate_limit_burst=http_rate_limit_burst,
        http_trusted_proxies=http_trusted_proxies,
    )
    handler = type("BoundHandler", (_Handler,), {"plane": plane})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    LOGGER.info("HTTP plane listening on %s:%d", host, server.server_address[1])
    return HttpServerHandle(server=server, thread=thread, plane=plane)


__all__ = [
    "HttpPlane",
    "HttpServerHandle",
    "LoadJobState",
    "flatten_metrics",
    "prometheus_text",
    "start_http_server",
]
