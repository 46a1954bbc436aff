"""gRPC transport adapter: maps application errors to RPC aborts.

Own copy of ``stt_tpu/server/transport/grpc_servicer.py`` for the port, which imports nothing of ``stt_tpu``.

Same transport role as the reference servicer (``stt_server/backend/
transport/grpc_servicer.py:15-81``, cited for parity review): delegate to
the runtime's CreateSession handler and stream orchestrator, count errors
in metrics, and convert :class:`STTError` into ``context.abort`` with the
mapped status. Differences from the reference: the runtime is injected
(one runtime backs gRPC, HTTP, and WS simultaneously) and both RPCs share
a single error-translation guard instead of duplicating handler chains.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterable, Iterator

import grpc

from ...errors import ErrorCode, STTError, format_error, status_for
from ...gen import stt_pb2, stt_pb2_grpc
from ...utils.logging import LOGGER
from ..runtime.runtime import ApplicationRuntime

# Unexpected-exception classes the guard converts into a counted, logged
# re-raise (anything else — e.g. KeyboardInterrupt — passes through raw).
_UNEXPECTED = (AttributeError, KeyError, OSError, RuntimeError, TypeError, ValueError)


def _status_of(exc: grpc.RpcError) -> grpc.StatusCode:
    """Best-effort status extraction; RpcError subclasses vary widely."""
    getter = getattr(exc, "code", None)
    if callable(getter):
        try:
            status = getter()
        except Exception:
            status = None
        if isinstance(status, grpc.StatusCode):
            return status
    return grpc.StatusCode.UNKNOWN


class STTGrpcServicer(stt_pb2_grpc.STTBackendServicer):
    """Implements the STTBackend service over a shared runtime."""

    def __init__(self, runtime: ApplicationRuntime) -> None:
        self.runtime = runtime

    @contextmanager
    def _abort_guard(
        self, context: grpc.ServicerContext, unexpected: ErrorCode
    ) -> Iterator[None]:
        """Translate exceptions escaping an RPC body.

        * grpc.RpcError — already transport-shaped; count and re-raise.
        * STTError — the application's typed failure; count, log, abort
          with its mapped status (abort raises, ending the RPC).
        * _UNEXPECTED — programming/environment faults; count and log
          under the RPC-specific ``unexpected`` code, then re-raise so
          grpc returns UNKNOWN.
        """
        metrics = self.runtime.metrics
        try:
            yield
        except grpc.RpcError as exc:
            metrics.record_error(_status_of(exc))
            raise
        except STTError as exc:
            metrics.record_error(exc.status)
            LOGGER.error(str(exc))
            context.abort(exc.status, str(exc))
        except _UNEXPECTED:
            metrics.record_error(status_for(unexpected))
            LOGGER.exception(format_error(unexpected))
            raise

    def CreateSession(
        self, request: stt_pb2.SessionRequest, context: grpc.ServicerContext
    ) -> stt_pb2.SessionResponse:
        with self._abort_guard(context, ErrorCode.CREATE_SESSION_UNEXPECTED):
            return self.runtime.create_session_handler.handle(request, context)

    def StreamingRecognize(
        self,
        request_iterator: Iterable[stt_pb2.AudioChunk],
        context: grpc.ServicerContext,
    ) -> Iterable[stt_pb2.STTResult]:
        with self._abort_guard(context, ErrorCode.STREAM_UNEXPECTED):
            yield from self.runtime.stream_orchestrator.run(request_iterator, context)


__all__ = ["STTGrpcServicer"]
