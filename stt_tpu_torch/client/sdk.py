"""gRPC client SDK for the streaming STT server (stt_tpu_torch's or stt_tpu's: one wire).

Three wire-level contracts are shared with the server and therefore fixed:

* CreateSession auth (``signed_token`` profile): HMAC-SHA256 over the ASCII
  payload ``"<session_id>:<unix_ts>"`` keyed by the shared secret, carried as
  metadata ``authorization: Bearer <hex digest>`` + ``x-stt-auth-ts: <ts>``
  (validated in ``stt_tpu_torch/server/application/session_manager.py``).
* Server failures embed a machine-readable ``ERR####`` code in the gRPC
  status details string (``stt_tpu_torch/errors.py``).
* Statuses considered transient (worth retrying): UNAVAILABLE,
  RESOURCE_EXHAUSTED, DEADLINE_EXCEEDED.

Covers the same client role as the reference SDK
(``stt_client/sdk/streaming.py``, cited for parity review only); the
implementation here is original, organized around an immutable
:class:`ChannelOptions` transport config and retry policy methods on
:class:`RetryConfig`.
"""

from __future__ import annotations

import hashlib
import hmac
import itertools
import random
import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable, Iterator, List, Optional, Tuple, TypeVar

import grpc

from ..gen import stt_pb2, stt_pb2_grpc

__all__ = [
    "ChannelOptions",
    "RetryConfig",
    "StreamingClient",
    "build_signed_token_metadata",
    "parse_error_code",
]

#: gRPC call metadata: sequence of (key, value) pairs, or None.
Metadata = Optional[Iterable[Tuple[str, str]]]

_T = TypeVar("_T")

#: Status codes the server contract treats as transient.
TRANSIENT_STATUS = (
    grpc.StatusCode.UNAVAILABLE,
    grpc.StatusCode.RESOURCE_EXHAUSTED,
    grpc.StatusCode.DEADLINE_EXCEEDED,
)

_ERR_CODE = re.compile(r"\bERR\d{4}\b")

#: Fractional jitter applied symmetrically around each backoff delay.
_JITTER = 0.2


def parse_error_code(exc: grpc.RpcError) -> Optional[str]:
    """Return the server's ``ERR####`` code from an RpcError, or None.

    The server puts the code at the front of the status details; any
    position is accepted here so wrapped/annotated details still parse.
    """
    try:
        found = _ERR_CODE.search(exc.details() or "")
    except Exception:  # noqa: BLE001 - RpcError subclasses vary
        return None
    return found.group(0) if found else None


def build_signed_token_metadata(
    session_id: str, signed_token_secret: Optional[str]
) -> List[Tuple[str, str]]:
    """Produce the CreateSession HMAC auth metadata pair.

    Empty/absent secret means auth is not configured: returns ``[]`` so
    callers can pass ``metadata or None`` straight to gRPC.
    """
    secret = (signed_token_secret or "").strip()
    if not secret:
        return []
    now = str(int(time.time()))
    digest = hmac.new(
        secret.encode("utf-8"),
        f"{session_id}:{now}".encode("utf-8"),
        hashlib.sha256,
    ).hexdigest()
    return [("authorization", f"Bearer {digest}"), ("x-stt-auth-ts", now)]


@dataclass(frozen=True)
class RetryConfig:
    """Retry policy: how many re-attempts, which statuses, what backoff.

    ``attempts`` counts *retries* (a call may run ``attempts + 1`` times).
    Backoff doubles from ``base_backoff_sec`` up to ``max_backoff_sec``,
    with +/-20% jitter to de-synchronize reconnect storms.
    """

    attempts: int = 3
    base_backoff_sec: float = 0.5
    max_backoff_sec: float = 5.0
    retryable_status: Tuple[grpc.StatusCode, ...] = TRANSIENT_STATUS

    def permits(self, exc: grpc.RpcError, attempt: int) -> bool:
        """True if ``exc`` is transient and the retry budget is not spent."""
        if attempt >= max(0, self.attempts):
            return False
        code = exc.code() if hasattr(exc, "code") else None
        return code in self.retryable_status

    def delay(self, attempt: int) -> float:
        """Jittered exponential backoff for the given (0-based) attempt."""
        ideal = min(
            self.max_backoff_sec,
            max(0.0, self.base_backoff_sec) * (2.0 ** attempt),
        )
        spread = ideal * _JITTER
        return max(0.0, ideal + random.uniform(-spread, spread))


def _should_retry(exc: grpc.RpcError, retry: RetryConfig, attempt: int) -> bool:
    return retry.permits(exc, attempt)


def _backoff_delay(retry: RetryConfig, attempt: int) -> float:
    return retry.delay(attempt)


_NO_RETRY = RetryConfig(attempts=0)


@dataclass(frozen=True)
class ChannelOptions:
    """Everything needed to open a channel, minus the target address.

    Defaults mirror the server's keepalive expectations: 30 s client pings
    with a 10 s ack timeout, pings allowed on idle connections, and no cap
    on data-less pings (the stream can legitimately sit quiet while the
    user isn't speaking).
    """

    tls_enabled: bool = False
    tls_ca_file: Optional[str] = None
    max_receive_bytes: Optional[int] = None
    max_send_bytes: Optional[int] = None
    keepalive_time_ms: int = 30000
    keepalive_timeout_ms: int = 10000
    keepalive_permit_without_calls: bool = True
    keepalive_max_pings_without_data: int = 0
    keepalive_min_ping_interval_ms: int = 10000

    def channel_args(self) -> List[Tuple[str, int]]:
        args: List[Tuple[str, int]] = [
            ("grpc.keepalive_time_ms", self.keepalive_time_ms),
            ("grpc.keepalive_timeout_ms", self.keepalive_timeout_ms),
            (
                "grpc.keepalive_permit_without_calls",
                1 if self.keepalive_permit_without_calls else 0,
            ),
            (
                "grpc.http2.max_pings_without_data",
                self.keepalive_max_pings_without_data,
            ),
            (
                "grpc.http2.min_time_between_pings_ms",
                self.keepalive_min_ping_interval_ms,
            ),
        ]
        for key, limit in (
            ("grpc.max_receive_message_length", self.max_receive_bytes),
            ("grpc.max_send_message_length", self.max_send_bytes),
        ):
            if limit and limit > 0:
                args.append((key, limit))
        return args

    def open(self, target: str) -> grpc.Channel:
        """Dial ``target``; TLS when enabled or when a CA file is given."""
        ca_bytes: Optional[bytes] = None
        if self.tls_ca_file:
            ca_path = Path(self.tls_ca_file).expanduser()
            if not ca_path.exists():
                raise FileNotFoundError(f"TLS CA file not found: {ca_path}")
            ca_bytes = ca_path.read_bytes()
        if self.tls_enabled or ca_bytes is not None:
            creds = grpc.ssl_channel_credentials(root_certificates=ca_bytes)
            return grpc.secure_channel(target, creds, options=self.channel_args())
        return grpc.insecure_channel(target, options=self.channel_args())


#: Accepted StreamingClient transport keywords -> ChannelOptions field.
#: Kept flat on the constructor for drop-in compatibility with existing
#: callers (and the reference SDK surface).
_TRANSPORT_KWARGS = {
    "tls_enabled": "tls_enabled",
    "tls_ca_file": "tls_ca_file",
    "grpc_max_receive_message_bytes": "max_receive_bytes",
    "grpc_max_send_message_bytes": "max_send_bytes",
    "keepalive_time_ms": "keepalive_time_ms",
    "keepalive_timeout_ms": "keepalive_timeout_ms",
    "keepalive_permit_without_calls": "keepalive_permit_without_calls",
    "keepalive_max_pings_without_data": "keepalive_max_pings_without_data",
    "keepalive_min_time_between_pings_ms": "keepalive_min_ping_interval_ms",
}


class StreamingClient:
    """Thin, retry-aware wrapper over the STTBackend stub.

    Usable as a context manager::

        with StreamingClient("localhost:50051") as client:
            resp = client.create_session(request)

    Transport keywords (``tls_enabled``, ``keepalive_time_ms``, ...) are
    listed in ``_TRANSPORT_KWARGS``; alternatively pass a prebuilt
    :class:`ChannelOptions` as ``channel_options``.
    """

    def __init__(
        self,
        target: str,
        *,
        signed_token_secret: Optional[str] = None,
        channel_options: Optional[ChannelOptions] = None,
        **transport,
    ) -> None:
        bogus = sorted(set(transport) - set(_TRANSPORT_KWARGS))
        if bogus:
            raise TypeError(f"unknown StreamingClient options: {bogus}")
        if channel_options is None:
            channel_options = ChannelOptions(
                **{_TRANSPORT_KWARGS[k]: v for k, v in transport.items()}
            )
        elif transport:
            raise TypeError("pass either channel_options or flat keywords, not both")
        self._options = channel_options
        self._secret = signed_token_secret
        self._channel = channel_options.open(target)
        self._stub = stt_pb2_grpc.STTBackendStub(self._channel)

    # -- lifecycle -----------------------------------------------------

    def close(self) -> None:
        self._channel.close()

    def __enter__(self) -> "StreamingClient":
        return self

    def __exit__(self, *_exc) -> None:
        self.close()

    # -- auth ----------------------------------------------------------

    def build_signed_metadata(
        self, session_id: str, signed_token_secret: Optional[str] = None
    ) -> List[Tuple[str, str]]:
        """Auth metadata using the per-call secret, else the client's."""
        if signed_token_secret is None:
            signed_token_secret = self._secret
        return build_signed_token_metadata(session_id, signed_token_secret)

    # -- RPCs ------------------------------------------------------------

    def create_session(
        self,
        request: stt_pb2.SessionRequest,
        *,
        metadata: Metadata = None,
        retry: Optional[RetryConfig] = None,
    ) -> stt_pb2.SessionResponse:
        """Unary CreateSession with transient-status retry.

        Safe to retry: CreateSession is idempotent per session_id on the
        server (duplicate registration returns ERR1002, a non-transient
        status, which surfaces immediately).
        """
        return _retry_unary(
            lambda: self._stub.CreateSession(request, metadata=metadata),
            retry or _NO_RETRY,
        )

    def streaming_recognize(
        self,
        audio_iter: Iterable[stt_pb2.AudioChunk],
        *,
        metadata: Metadata = None,
        timeout: Optional[float] = None,
    ) -> Iterable[stt_pb2.STTResult]:
        """Open the bidirectional stream; no retry (the iterator is hot)."""
        return self._stub.StreamingRecognize(audio_iter, metadata=metadata, timeout=timeout)

    def streaming_recognize_with_retry(
        self,
        audio_iter_factory: Callable[[], Iterable[stt_pb2.AudioChunk]],
        *,
        metadata: Metadata = None,
        timeout: Optional[float] = None,
        retry: Optional[RetryConfig] = None,
    ) -> Iterator[stt_pb2.STTResult]:
        """Bidi stream that reconnects on transient failure *before* any
        result arrives.

        Once a result has been yielded the server has consumed audio and
        advanced session state, so a mid-stream failure is NOT replayed —
        it propagates to the caller, who owns dedup/rewind policy.
        """
        policy = retry or _NO_RETRY
        for attempt in itertools.count():
            call = self._stub.StreamingRecognize(
                audio_iter_factory(), metadata=metadata, timeout=timeout
            )
            delivered = False
            try:
                for result in call:
                    delivered = True
                    yield result
            except grpc.RpcError as exc:
                if delivered or not policy.permits(exc, attempt):
                    raise
                time.sleep(policy.delay(attempt))
                continue
            return


def _retry_unary(invoke: Callable[[], _T], policy: RetryConfig) -> _T:
    """Run ``invoke`` under ``policy``; sleeps between transient failures."""
    for attempt in itertools.count():
        try:
            return invoke()
        except grpc.RpcError as exc:
            if not policy.permits(exc, attempt):
                raise
            time.sleep(policy.delay(attempt))
    raise AssertionError("unreachable")  # pragma: no cover
