"""Stable application error codes with gRPC/HTTP status mappings.

Own copy of ``stt_tpu/errors.py`` for the port, which imports nothing of ``stt_tpu``.

The ERR#### identifiers and their status mappings are part of the public API
contract shared with the reference service (reference: ``stt_server/errors.py:12-238``)
and are pinned by ``tests/compat/error_code_contract.json``. Clients parse the
leading ``ERR####`` token out of gRPC status details, so the
``"{code} {message}"`` wire format must not change.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Dict, NoReturn, Optional

import grpc

_SC = grpc.StatusCode


class ErrorCode(str, Enum):
    """Public error identifiers, grouped by subsystem."""

    # session lifecycle (ERR10xx)
    SESSION_ID_REQUIRED = "ERR1001"
    SESSION_ID_ALREADY_ACTIVE = "ERR1002"
    VAD_THRESHOLD_NEGATIVE = "ERR1003"
    SESSION_ID_MISSING = "ERR1004"
    SESSION_TOKEN_INVALID = "ERR1005"
    SESSION_TIMEOUT = "ERR1006"
    AUDIO_CHUNK_TOO_LARGE = "ERR1007"
    VAD_POOL_EXHAUSTED = "ERR1008"
    API_KEY_MISSING = "ERR1009"
    DECODE_OPTION_INVALID = "ERR1010"
    SESSION_LIMIT_EXCEEDED = "ERR1011"
    CREATE_SESSION_RATE_LIMITED = "ERR1012"
    SERVER_SHUTTING_DOWN = "ERR1013"
    CREATE_SESSION_AUTH_INVALID = "ERR1014"

    # decode path (ERR20xx)
    DECODE_TIMEOUT = "ERR2001"
    DECODE_TASK_FAILED = "ERR2002"
    STREAM_RATE_LIMITED = "ERR2003"
    STREAM_AUDIO_LIMIT_EXCEEDED = "ERR2004"

    # unexpected internal (ERR30xx)
    CREATE_SESSION_UNEXPECTED = "ERR3001"
    STREAM_UNEXPECTED = "ERR3002"

    # HTTP admin/observability plane (ERR40xx)
    ADMIN_API_DISABLED = "ERR4001"
    MODEL_ALREADY_LOADED = "ERR4002"
    MODEL_UNLOAD_FAILED = "ERR4003"
    ADMIN_UNAUTHORIZED = "ERR4004"
    ADMIN_MODEL_PATH_FORBIDDEN = "ERR4005"
    OBS_UNAUTHORIZED = "ERR4006"
    HTTP_RATE_LIMITED = "ERR4007"
    HTTP_IP_FORBIDDEN = "ERR4008"
    ADMIN_MODEL_PROFILE_UNKNOWN = "ERR4009"


@dataclass(frozen=True)
class ErrorSpec:
    """gRPC status, HTTP status, and default message for one error code."""

    code: ErrorCode
    status: grpc.StatusCode
    http_status: int
    message: str


# code -> (grpc status, http status, default message)
_TABLE: Dict[ErrorCode, tuple] = {
    ErrorCode.SESSION_ID_REQUIRED: (_SC.INVALID_ARGUMENT, 400, "session_id is required"),
    ErrorCode.SESSION_ID_ALREADY_ACTIVE: (_SC.ALREADY_EXISTS, 409, "session_id already active"),
    ErrorCode.VAD_THRESHOLD_NEGATIVE: (_SC.INVALID_ARGUMENT, 400, "vad_threshold must be non-negative"),
    ErrorCode.SESSION_ID_MISSING: (_SC.UNAUTHENTICATED, 401, "Unknown or missing session_id"),
    ErrorCode.SESSION_TOKEN_INVALID: (_SC.PERMISSION_DENIED, 403, "Invalid session token"),
    ErrorCode.SESSION_TIMEOUT: (_SC.DEADLINE_EXCEEDED, 504, "Session timeout due to inactivity"),
    ErrorCode.AUDIO_CHUNK_TOO_LARGE: (_SC.INVALID_ARGUMENT, 400, "audio chunk exceeds maximum size"),
    ErrorCode.VAD_POOL_EXHAUSTED: (_SC.RESOURCE_EXHAUSTED, 503, "VAD capacity exhausted"),
    ErrorCode.API_KEY_MISSING: (_SC.UNAUTHENTICATED, 401, "API key is required"),
    ErrorCode.DECODE_OPTION_INVALID: (_SC.INVALID_ARGUMENT, 400, "invalid decode option"),
    ErrorCode.SESSION_LIMIT_EXCEEDED: (_SC.RESOURCE_EXHAUSTED, 429, "session limit exceeded"),
    ErrorCode.CREATE_SESSION_RATE_LIMITED: (_SC.RESOURCE_EXHAUSTED, 429, "create session rate limited"),
    ErrorCode.SERVER_SHUTTING_DOWN: (_SC.UNAVAILABLE, 503, "server shutting down"),
    ErrorCode.CREATE_SESSION_AUTH_INVALID: (_SC.UNAUTHENTICATED, 401, "CreateSession authentication failed"),
    ErrorCode.DECODE_TIMEOUT: (_SC.DEADLINE_EXCEEDED, 504, "decode timeout waiting for pending tasks"),
    ErrorCode.DECODE_TASK_FAILED: (_SC.INTERNAL, 500, "decode task failed"),
    ErrorCode.STREAM_RATE_LIMITED: (_SC.RESOURCE_EXHAUSTED, 429, "stream rate limit exceeded"),
    ErrorCode.STREAM_AUDIO_LIMIT_EXCEEDED: (_SC.RESOURCE_EXHAUSTED, 429, "stream audio limit exceeded"),
    ErrorCode.CREATE_SESSION_UNEXPECTED: (_SC.UNKNOWN, 500, "Unexpected CreateSession error"),
    ErrorCode.STREAM_UNEXPECTED: (_SC.UNKNOWN, 500, "Unexpected streaming error"),
    ErrorCode.ADMIN_API_DISABLED: (_SC.UNIMPLEMENTED, 501, "Admin API not enabled"),
    ErrorCode.MODEL_ALREADY_LOADED: (_SC.ALREADY_EXISTS, 409, "Model is already loaded"),
    ErrorCode.MODEL_UNLOAD_FAILED: (_SC.FAILED_PRECONDITION, 400, "Model not found or is default"),
    ErrorCode.ADMIN_UNAUTHORIZED: (_SC.UNAUTHENTICATED, 401, "Invalid or missing admin token"),
    ErrorCode.ADMIN_MODEL_PATH_FORBIDDEN: (_SC.PERMISSION_DENIED, 403, "model_path is not allowed"),
    ErrorCode.OBS_UNAUTHORIZED: (_SC.UNAUTHENTICATED, 401, "Invalid or missing observability token"),
    ErrorCode.HTTP_RATE_LIMITED: (_SC.RESOURCE_EXHAUSTED, 429, "Too many HTTP requests"),
    ErrorCode.HTTP_IP_FORBIDDEN: (_SC.PERMISSION_DENIED, 403, "Client IP not allowed"),
    ErrorCode.ADMIN_MODEL_PROFILE_UNKNOWN: (_SC.INVALID_ARGUMENT, 400, "Unknown model profile"),
}

ERROR_SPECS: Dict[ErrorCode, ErrorSpec] = {
    code: ErrorSpec(code, status, http, msg)
    for code, (status, http, msg) in _TABLE.items()
}

ERROR_STATUS_MAP: Dict[ErrorCode, grpc.StatusCode] = {
    code: spec.status for code, spec in ERROR_SPECS.items()
}

ERROR_HTTP_STATUS_MAP: Dict[ErrorCode, int] = {
    code: spec.http_status for code, spec in ERROR_SPECS.items()
}


def spec_for(code: ErrorCode) -> ErrorSpec:
    return ERROR_SPECS[code]


def status_for(code: ErrorCode) -> grpc.StatusCode:
    return ERROR_SPECS[code].status


def http_status_for(code: ErrorCode) -> int:
    return ERROR_SPECS[code].http_status


def format_error(code: ErrorCode, detail: Optional[str] = None) -> str:
    """Render the wire-format message: ``"ERR#### <detail-or-default>"``."""
    return f"{code.value} {detail or ERROR_SPECS[code].message}"


def http_payload_for(code: ErrorCode, detail: Optional[str] = None) -> Dict[str, str]:
    """JSON error body used by the HTTP plane."""
    return {"code": code.value, "message": detail or ERROR_SPECS[code].message}


class STTError(RuntimeError):
    """Application error carrying its gRPC and HTTP status mappings."""

    def __init__(self, code: ErrorCode, detail: Optional[str] = None) -> None:
        self.code = code
        self.status = status_for(code)
        self.http_status = http_status_for(code)
        self.detail = detail or ERROR_SPECS[code].message
        super().__init__(format_error(code, detail))


def abort_with_error(
    context: grpc.ServicerContext,
    code: ErrorCode,
    detail: Optional[str] = None,
) -> NoReturn:
    """Abort the RPC with the mapped status; never returns."""
    context.abort(status_for(code), format_error(code, detail))
    raise AssertionError("context.abort returned")  # pragma: no cover


__all__ = [
    "ErrorCode",
    "ErrorSpec",
    "ERROR_SPECS",
    "ERROR_STATUS_MAP",
    "ERROR_HTTP_STATUS_MAP",
    "STTError",
    "abort_with_error",
    "format_error",
    "http_payload_for",
    "http_status_for",
    "spec_for",
    "status_for",
]
