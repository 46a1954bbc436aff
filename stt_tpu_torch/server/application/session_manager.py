"""Session lifecycle: registry, facade, and the CreateSession pipeline.

Own copy of ``stt_tpu/server/application/session_manager.py`` for the port, which imports nothing of ``stt_tpu``.

Wire-behavior parity with the reference (``stt_server/backend/application/
session_manager.py:39-678``). The CreateSession gauntlet, in order:
shutdown/overload gates -> session_id required (ERR1001) -> api-key policy
(ERR1009) -> HMAC signed-token auth (ERR1014) -> rate limit (ERR1012) and
per-IP/api-key caps (ERR1011) -> decode profile/language/task resolution ->
decode-option whitelist (ERR1010) -> VAD threshold validation (ERR1003) and
slot reservation (ERR1008) -> registry insert (ERR1002 on duplicate) -> echo
response with resolved settings (+ optional issued token).

Client attribute keys (``api_key``, ``api_key_required``, ``model_id``,
``decode_profile``, ``upload_mode``), metadata auth keys
(``authorization``/``x-stt-auth`` + ``x-stt-auth-ts`` with legacy
``ts:sig`` fallback), and the HMAC payload ``"{session_id}:{timestamp}"``
are all kept byte-identical so existing clients work unchanged.
"""

from __future__ import annotations

import hmac
import hashlib
import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Union

import grpc

from ...config.languages import SupportedLanguages
from ...errors import ErrorCode, abort_with_error, format_error
from ...gen import stt_pb2
from ...utils.logging import LOGGER, set_session_id
from ...utils.rate_limit import KeyedRateLimiter
from ..component.vad_gate import VADModelPool
from .profile_resolver import (
    invalid_decode_options,
    profile_enum_from_name,
    profile_name_from_enum,
    resolve_decode_profile,
    resolve_language_code,
    resolve_task,
    task_enum_from_name,
)

DEFAULT_MODEL_ID = "default"

AUTH_PROFILE_NONE = "none"
AUTH_PROFILE_API_KEY = "api_key"
AUTH_PROFILE_SIGNED_TOKEN = "signed_token"
_AUTH_PROFILE_ALIASES = {
    "none": AUTH_PROFILE_NONE,
    "off": AUTH_PROFILE_NONE,
    "false": AUTH_PROFILE_NONE,
    "0": AUTH_PROFILE_NONE,
    "api_key": AUTH_PROFILE_API_KEY,
    "api-key": AUTH_PROFILE_API_KEY,
    "apikey": AUTH_PROFILE_API_KEY,
    "signed_token": AUTH_PROFILE_SIGNED_TOKEN,
    "signed": AUTH_PROFILE_SIGNED_TOKEN,
    "signature": AUTH_PROFILE_SIGNED_TOKEN,
    "hmac": AUTH_PROFILE_SIGNED_TOKEN,
}
_AUTH_METADATA_SIG_KEYS = (
    "authorization",
    "x-stt-auth",
    "x-auth-sig",
    "x-auth-signature",
)
_AUTH_METADATA_TS_KEYS = ("x-stt-auth-ts", "x-auth-ts", "x-auth-timestamp")
_AUTH_ATTRIBUTE_KEYS = {
    "auth_sig", "auth_signature", "signature",
    "auth_ts", "auth_timestamp", "timestamp",
}


@dataclass
class SessionInfo:
    """Resolved per-session settings recorded at CreateSession time."""

    attributes: Dict[str, str]
    vad_mode: int
    vad_silence: float
    vad_threshold: float
    token: str
    token_required: bool
    client_ip: str
    api_key: str
    decode_profile: str
    decode_options: Dict[str, Any]
    language_code: str
    task: str
    model_id: str = DEFAULT_MODEL_ID
    vad_reserved: bool = False


def _noop_hook(_: SessionInfo) -> None:
    return None


@dataclass(frozen=True)
class SessionRegistryHooks:
    on_create: Callable[[SessionInfo], None] = _noop_hook
    on_remove: Callable[[SessionInfo], None] = _noop_hook


class SessionRegistry:
    """Thread-safe active-session table with lifecycle hooks."""

    def __init__(self, hooks: Optional[SessionRegistryHooks] = None) -> None:
        self._hooks = hooks or SessionRegistryHooks()
        self._lock = threading.Lock()
        self._sessions: Dict[str, SessionInfo] = {}

    def create_session(self, session_id: str, info: SessionInfo) -> None:
        with self._lock:
            if session_id in self._sessions:
                raise ValueError("session already exists")
            self._sessions[session_id] = info
        self._hooks.on_create(info)

    def get_session(self, session_id: str) -> Optional[SessionInfo]:
        with self._lock:
            return self._sessions.get(session_id)

    def remove_session(self, session_id: str) -> Optional[SessionInfo]:
        with self._lock:
            info = self._sessions.pop(session_id, None)
        if info:
            self._hooks.on_remove(info)
        return info

    def _count_where(self, predicate) -> int:
        with self._lock:
            return sum(1 for i in self._sessions.values() if predicate(i))

    def active_count(self) -> int:
        return self._count_where(lambda _: True)

    def active_count_by_ip(self, client_ip: str) -> int:
        if not client_ip:
            return 0
        return self._count_where(lambda i: i.client_ip == client_ip)

    def active_count_by_api_key(self, api_key: str) -> int:
        if not api_key:
            return 0
        return self._count_where(lambda i: i.api_key == api_key)


@dataclass
class SessionState:
    """Per-RPC resolved session context."""

    session_id: str
    session_info: SessionInfo
    decode_options: Dict[str, Any]


class SessionFacade:
    """Transport-facing session resolution and token checks.

    The wire behavior is contract-fixed (ERR1001 when no usable session id
    can be resolved, ERR1003 on a bad per-chunk token with immediate
    session removal); the flow is organized around a candidate-id chain:
    each resolution site lists its id sources in priority order and the
    first non-empty one wins.
    """

    def __init__(self, session_registry: SessionRegistry) -> None:
        self._registry = session_registry

    @staticmethod
    def _normalize_session_id(value: Union[str, bytes, None]) -> Optional[str]:
        if value is None:
            return None
        if isinstance(value, bytes):
            value = value.decode("utf-8", errors="ignore")
        normalized = str(value).strip()
        return normalized or None

    def _first_id(self, *candidates) -> Optional[str]:
        """First candidate that normalizes to a non-empty session id."""
        for raw in candidates:
            sid = self._normalize_session_id(raw)
            if sid:
                return sid
        return None

    @staticmethod
    def _abort(context: grpc.ServicerContext, code: ErrorCode) -> None:
        LOGGER.error(format_error(code))
        abort_with_error(context, code)

    def _state_for(
        self, session_id: str, context: grpc.ServicerContext
    ) -> SessionState:
        info = self._registry.get_session(session_id)
        if info is None:
            # unknown id is indistinguishable from a missing one at the
            # wire level: same ERR1001 (contract, reference parity)
            self._abort(context, ErrorCode.SESSION_ID_MISSING)
        return SessionState(session_id, info, dict(info.decode_options))

    def resolve_from_metadata(
        self, metadata: Dict[str, Any], context: grpc.ServicerContext
    ) -> Optional[SessionState]:
        sid = self._first_id(
            metadata.get("session-id"), metadata.get("session_id")
        )
        return self._state_for(sid, context) if sid else None

    def ensure_session_from_chunk(
        self,
        current_state: Optional[SessionState],
        chunk: stt_pb2.AudioChunk,
        context: grpc.ServicerContext,
    ) -> SessionState:
        held = current_state.session_id if current_state else None
        sid = self._first_id(chunk.session_id, held)
        if sid is None:
            self._abort(context, ErrorCode.SESSION_ID_MISSING)
        if current_state is not None and sid == held:
            return current_state
        return self._state_for(sid, context)

    def validate_token(
        self,
        state: Optional[SessionState],
        chunk: stt_pb2.AudioChunk,
        context: grpc.ServicerContext,
    ) -> None:
        if state is None:
            return
        info = state.session_info
        if not info.token_required or chunk.session_token == info.token:
            return
        # a bad token burns the session before the abort (parity: a
        # client cannot keep probing an established session id)
        self.remove_session(state, reason="invalid_token")
        self._abort(context, ErrorCode.SESSION_TOKEN_INVALID)

    def remove_session(
        self, state: Optional[SessionState], reason: str = ""
    ) -> None:
        if state is None:
            return
        self._registry.remove_session(state.session_id)
        if reason:
            LOGGER.info("removed session %s (%s)", state.session_id, reason)

    def remove_session_by_id(self, session_id: Union[str, bytes, None]) -> None:
        sid = self._first_id(session_id)
        if sid:
            self._registry.remove_session(sid)


@dataclass(frozen=True)
class CreateSessionConfig:
    """Policy inputs for the CreateSession pipeline."""

    default_vad_silence: float = 0.8
    default_vad_threshold: float = 0.5
    default_language: str = ""
    language_fix: bool = False
    default_task: str = "transcribe"
    decode_profiles: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    default_decode_profile: str = "realtime"
    supported_languages: SupportedLanguages = field(default_factory=SupportedLanguages)
    require_api_key: bool = False
    create_session_auth_profile: str = AUTH_PROFILE_NONE
    create_session_auth_secret: str = ""
    create_session_auth_ttl_sec: float = 0.0
    max_sessions_per_ip: int = 0
    max_sessions_per_api_key: int = 0
    allow_new_sessions: Callable[[], bool] = lambda: True
    allow_overload_sessions: Callable[[], bool] = lambda: True


class CreateSessionHandler:
    """Runs the full CreateSession validation pipeline."""

    def __init__(
        self,
        config: CreateSessionConfig,
        session_registry: SessionRegistry,
        vad_model_pool: VADModelPool,
        *,
        model_id_provider: Callable[[], Optional[str]] = lambda: None,
        rate_limiter: Optional[KeyedRateLimiter] = None,
        metrics=None,
    ) -> None:
        self._config = config
        self._registry = session_registry
        self._vad_pool = vad_model_pool
        self._model_id_provider = model_id_provider
        self._limiter = rate_limiter
        self._metrics = metrics

    # -- helpers ---------------------------------------------------------------

    def _auth_profile(self) -> str:
        raw = (self._config.create_session_auth_profile or "").strip().lower()
        return _AUTH_PROFILE_ALIASES.get(raw, raw)

    @staticmethod
    def _metadata_of(context: grpc.ServicerContext) -> Dict[str, str]:
        out: Dict[str, str] = {}
        try:
            items = context.invocation_metadata() or ()
        except Exception:
            return out
        for key, value in items:
            if isinstance(value, bytes):
                value = value.decode("utf-8", errors="ignore")
            out[str(key).lower()] = str(value)
        return out

    @staticmethod
    def _first_of(metadata: Dict[str, str], keys) -> str:
        for key in keys:
            value = (metadata.get(key) or "").strip()
            if value:
                return value
        return ""

    def _sanitize_attributes(self, attributes: Dict[str, str]) -> Dict[str, str]:
        return {k: v for k, v in attributes.items() if k not in _AUTH_ATTRIBUTE_KEYS}

    def _validate_signed_token(
        self, session_id: str, metadata: Dict[str, str],
        context: grpc.ServicerContext,
    ) -> None:
        secret = (self._config.create_session_auth_secret or "").strip()
        if not secret:
            LOGGER.error("signed_token auth profile requires a secret")
            abort_with_error(context, ErrorCode.CREATE_SESSION_AUTH_INVALID)
        ts_raw = self._first_of(metadata, _AUTH_METADATA_TS_KEYS)
        sig_raw = self._first_of(metadata, _AUTH_METADATA_SIG_KEYS)
        if sig_raw:
            parts = sig_raw.split(None, 1)
            if len(parts) == 2 and parts[0].lower() in {
                "bearer", "token", "signature", "hmac",
            }:
                sig_raw = parts[1].strip()
        # legacy single-header "ts:signature" format
        if (not ts_raw or ":" in sig_raw) and ":" in sig_raw:
            maybe_ts, maybe_sig = sig_raw.split(":", 1)
            if not ts_raw:
                ts_raw = maybe_ts.strip()
            sig_raw = maybe_sig.strip()
            LOGGER.warning(
                "CreateSession auth used legacy 'ts:sig' format; prefer "
                "'authorization: Bearer <signature>' + 'x-stt-auth-ts'."
            )
        if not ts_raw or not sig_raw:
            abort_with_error(context, ErrorCode.CREATE_SESSION_AUTH_INVALID)
        try:
            timestamp_raw = int(float(ts_raw))
        except (TypeError, ValueError):
            abort_with_error(context, ErrorCode.CREATE_SESSION_AUTH_INVALID)
        timestamp_sec = timestamp_raw
        if timestamp_sec > 100_000_000_000:  # epoch millis
            timestamp_sec = int(timestamp_sec / 1000)
        ttl = float(self._config.create_session_auth_ttl_sec or 0.0)
        if ttl > 0 and abs(time.time() - timestamp_sec) > ttl:
            LOGGER.warning("CreateSession auth token expired (ts=%s)", timestamp_raw)
            abort_with_error(context, ErrorCode.CREATE_SESSION_AUTH_INVALID)
        payload = f"{session_id}:{timestamp_raw}".encode("utf-8")
        expected = hmac.new(secret.encode("utf-8"), payload, hashlib.sha256).hexdigest()
        if not hmac.compare_digest(expected, sig_raw):
            LOGGER.warning("CreateSession auth signature mismatch")
            abort_with_error(context, ErrorCode.CREATE_SESSION_AUTH_INVALID)

    def _enforce_auth(
        self,
        profile: str,
        session_id: str,
        metadata: Dict[str, str],
        context: grpc.ServicerContext,
    ) -> None:
        if profile in ("", AUTH_PROFILE_NONE, AUTH_PROFILE_API_KEY):
            return
        if profile == AUTH_PROFILE_SIGNED_TOKEN:
            self._validate_signed_token(session_id, metadata, context)
            return
        LOGGER.error("unknown CreateSession auth profile: %s", profile)
        abort_with_error(context, ErrorCode.CREATE_SESSION_AUTH_INVALID)

    def _enforce_limits(
        self,
        session_id: str,
        api_key: str,
        client_ip: str,
        context: grpc.ServicerContext,
    ) -> None:
        if self._limiter is not None:
            key = api_key or client_ip or "anonymous"
            if not self._limiter.allow(key):
                if self._metrics is not None:
                    self._metrics.record_rate_limit_block("create_session", key)
                LOGGER.warning(
                    "CreateSession rate limited key=%s session_id=%s", key, session_id
                )
                abort_with_error(context, ErrorCode.CREATE_SESSION_RATE_LIMITED)
        cfg = self._config
        # per-identity concurrent-session caps (ERR1011); each axis only
        # applies when configured AND the identity is present
        caps = (
            (client_ip, cfg.max_sessions_per_ip,
             self._registry.active_count_by_ip),
            (api_key, cfg.max_sessions_per_api_key,
             self._registry.active_count_by_api_key),
        )
        for identity, cap, count_active in caps:
            if cap > 0 and identity and count_active(identity) >= cap:
                abort_with_error(context, ErrorCode.SESSION_LIMIT_EXCEEDED)

    def _resolve_vad_threshold(
        self, value: float, context: grpc.ServicerContext,
        allow_default: bool = True,
    ) -> float:
        """Negative is a client error; 0 means "use the server default"
        (unless the caller already resolved a default)."""
        if value >= 0:
            if value == 0 and allow_default:
                return self._config.default_vad_threshold
            return value
        LOGGER.error(format_error(ErrorCode.VAD_THRESHOLD_NEGATIVE))
        abort_with_error(context, ErrorCode.VAD_THRESHOLD_NEGATIVE)

    # -- the pipeline ----------------------------------------------------------

    def handle(
        self, request: stt_pb2.SessionRequest, context: grpc.ServicerContext
    ) -> stt_pb2.SessionResponse:
        cfg = self._config
        # admission gates, cheapest first; each aborts with its own code
        gates = (
            (cfg.allow_new_sessions, "CreateSession rejected during shutdown",
             ErrorCode.SERVER_SHUTTING_DOWN),
            (cfg.allow_overload_sessions,
             "CreateSession rejected due to overload",
             ErrorCode.CREATE_SESSION_RATE_LIMITED),
        )
        for is_open, message, code in gates:
            if not is_open():
                LOGGER.warning(message)
                abort_with_error(context, code)
        if not request.session_id:
            LOGGER.error(format_error(ErrorCode.SESSION_ID_REQUIRED))
            abort_with_error(context, ErrorCode.SESSION_ID_REQUIRED)

        session_id = request.session_id
        set_session_id(session_id)
        try:
            client_ip = extract_client_ip(context)
            attributes = dict(request.attributes)
            metadata = self._metadata_of(context)

            vad_mode = (
                request.vad_mode
                if request.vad_mode in (stt_pb2.VAD_CONTINUE, stt_pb2.VAD_AUTO_END)
                else stt_pb2.VAD_CONTINUE
            )
            token_required = bool(request.require_token)
            token = secrets.token_hex(16) if token_required else ""

            api_key = (
                attributes.get("api_key") or attributes.get("api-key") or ""
            ).strip()
            required_attr = str(
                attributes.get("api_key_required")
                or attributes.get("api-key-required")
                or ""
            ).lower() in ("1", "true", "yes", "on")
            auth_profile = self._auth_profile()
            api_key_required = required_attr or auth_profile == AUTH_PROFILE_API_KEY
            if (cfg.require_api_key or api_key_required) and not api_key:
                LOGGER.error(format_error(ErrorCode.API_KEY_MISSING))
                abort_with_error(context, ErrorCode.API_KEY_MISSING)

            self._enforce_auth(auth_profile, session_id, metadata, context)
            self._enforce_limits(session_id, api_key, client_ip, context)

            requested_profile = profile_name_from_enum(request.decode_profile)
            if not requested_profile:
                requested_profile = attributes.get("decode_profiles") or attributes.get(
                    "decode_profile"
                )
            profile_name, profile_options = resolve_decode_profile(
                requested_profile, cfg.decode_profiles, cfg.default_decode_profile
            )
            language_code = resolve_language_code(
                request.language_code,
                cfg.default_language,
                cfg.language_fix,
                cfg.supported_languages,
            )
            session_task = resolve_task(request.task, cfg.default_task)

            model_id = (
                attributes.get("model_id")
                or attributes.get("model")
                or self._model_id_provider()
                or DEFAULT_MODEL_ID
            )

            options = dict(profile_options)
            if session_task:
                options["task"] = session_task
            if language_code:
                options["language"] = language_code
            bad = invalid_decode_options(options)
            if bad:
                detail = f"invalid decode option(s): {', '.join(sorted(bad))}"
                LOGGER.error(format_error(ErrorCode.DECODE_OPTION_INVALID, detail))
                abort_with_error(context, ErrorCode.DECODE_OPTION_INVALID, detail)

            vad_silence = (
                request.vad_silence if request.vad_silence > 0 else cfg.default_vad_silence
            )
            if request.HasField("vad_threshold_override"):
                vad_threshold = self._resolve_vad_threshold(
                    request.vad_threshold_override, context, allow_default=False
                )
            else:
                vad_threshold = self._resolve_vad_threshold(
                    request.vad_threshold, context
                )

            vad_reserved = False
            if vad_threshold > 0 and not token_required:
                if not self._vad_pool.reserve_slot():
                    LOGGER.error(
                        "VAD pool exhausted; rejecting session_id=%s", session_id
                    )
                    abort_with_error(context, ErrorCode.VAD_POOL_EXHAUSTED)
                vad_reserved = True

            sanitized = self._sanitize_attributes(attributes)
            # settings echoed verbatim in the wire response (proto
            # contract) — shared between the registry record and the
            # SessionResponse below
            echoed = dict(
                vad_mode=vad_mode, vad_silence=vad_silence,
                vad_threshold=vad_threshold, token=token,
                token_required=token_required,
            )
            info = SessionInfo(
                attributes=sanitized,
                client_ip=client_ip,
                api_key=api_key,
                decode_profile=profile_name,
                decode_options=options,
                language_code=language_code,
                task=session_task,
                model_id=model_id,
                vad_reserved=vad_reserved,
                **echoed,
            )
            try:
                self._registry.create_session(session_id, info)
            except ValueError:
                if vad_reserved:
                    self._vad_pool.release_slot()
                LOGGER.error(format_error(ErrorCode.SESSION_ID_ALREADY_ACTIVE))
                abort_with_error(context, ErrorCode.SESSION_ID_ALREADY_ACTIVE)

            response_attributes = dict(sanitized)
            response_attributes["decode_profile"] = profile_name
            if language_code:
                response_attributes["language_code"] = language_code

            LOGGER.info(
                "created session_id=%s vad_mode=%s token_required=%s profile=%s "
                "language=%s task=%s vad_silence=%.3f vad_threshold=%.4f model_id=%s",
                session_id,
                "AUTO_END" if vad_mode == stt_pb2.VAD_AUTO_END else "CONTINUE",
                token_required, profile_name, language_code or "auto",
                session_task, vad_silence, vad_threshold, model_id,
            )
            return stt_pb2.SessionResponse(
                attributes=response_attributes,
                language_code=language_code,
                task=task_enum_from_name(session_task),
                decode_profile=profile_enum_from_name(profile_name),
                **echoed,
            )
        finally:
            set_session_id(None)


def extract_client_ip(context: Optional[grpc.ServicerContext]) -> str:
    """Parse the client IP out of a gRPC peer string."""
    peer = context.peer() if context else ""
    if not peer:
        return ""
    for prefix in ("ipv4:", "ipv6:"):
        if peer.startswith(prefix):
            rest = peer[len(prefix):]
            if rest.startswith("[") and "]" in rest:
                return rest[1:rest.index("]")]
            return rest.split(":", 1)[0]
    return ""


__all__ = [
    "AUTH_PROFILE_API_KEY",
    "AUTH_PROFILE_NONE",
    "AUTH_PROFILE_SIGNED_TOKEN",
    "CreateSessionConfig",
    "CreateSessionHandler",
    "DEFAULT_MODEL_ID",
    "SessionFacade",
    "SessionInfo",
    "SessionRegistry",
    "SessionRegistryHooks",
    "SessionState",
    "extract_client_ip",
]
