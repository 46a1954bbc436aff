"""Async logging with session-scoped context and a separate transcript sink.

Own copy of ``stt_tpu/utils/logging.py`` for the port, which imports nothing of ``stt_tpu``.

Capabilities mirror the reference logger (``stt_server/utils/logger.py:1-140``):

- a custom ``TRACE`` level below DEBUG,
- every record carries a ``session_id`` pulled from a ContextVar so all log
  lines within one RPC are correlated without threading IDs through calls,
- handlers run behind a queue (QueueHandler/QueueListener) so formatting and
  file IO never block the streaming hot path,
- transcripts are NEVER written to the main log; an opt-in rotating logger
  with day-based retention handles them separately (privacy policy).
"""

from __future__ import annotations

import logging
import logging.handlers
import queue
from contextvars import ContextVar
from typing import Optional

TRACE = 5
if logging.getLevelName(TRACE) != "TRACE":
    logging.addLevelName(TRACE, "TRACE")

LOGGER = logging.getLogger("stt_tpu_torch")
TRANSCRIPT_LOGGER = logging.getLogger("stt_tpu_torch.transcripts")
TRANSCRIPT_LOGGER.propagate = False

_session_id: ContextVar[str] = ContextVar("session_id", default="-")

_listener: Optional[logging.handlers.QueueListener] = None
_transcript_listener: Optional[logging.handlers.QueueListener] = None


def set_session_id(session_id: Optional[str]) -> None:
    """Bind a session id to the current context for log correlation."""
    _session_id.set(session_id or "-")


def get_session_id() -> str:
    return _session_id.get()


class _SessionContextFilter(logging.Filter):
    """Injects the context session_id into every record."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.session_id = _session_id.get()
        return True


def trace(logger: logging.Logger, msg: str, *args) -> None:
    if logger.isEnabledFor(TRACE):
        logger.log(TRACE, msg, *args)


_FORMAT = "%(asctime)s %(levelname)s [%(session_id)s] %(name)s: %(message)s"


def configure_logging(
    level: str = "INFO",
    log_file: Optional[str] = None,
    log_transcripts: bool = False,
    transcript_file: Optional[str] = None,
    transcript_retention_days: Optional[int] = 7,
) -> None:
    """Install queue-backed handlers; idempotent (re-configures on repeat)."""
    global _listener, _transcript_listener

    if _listener is not None:
        _listener.stop()
        _listener = None
    if _transcript_listener is not None:
        _transcript_listener.stop()
        _transcript_listener = None

    numeric = TRACE if level.upper() == "TRACE" else getattr(
        logging, level.upper(), logging.INFO
    )
    LOGGER.setLevel(numeric)
    LOGGER.handlers.clear()
    LOGGER.propagate = False

    handlers: list = [logging.StreamHandler()]
    if log_file:
        handlers.append(logging.FileHandler(log_file))
    formatter = logging.Formatter(_FORMAT)
    for h in handlers:
        h.setFormatter(formatter)

    log_queue: queue.Queue = queue.Queue(-1)
    qh = logging.handlers.QueueHandler(log_queue)
    qh.addFilter(_SessionContextFilter())
    LOGGER.addHandler(qh)
    _listener = logging.handlers.QueueListener(
        log_queue, *handlers, respect_handler_level=False
    )
    _listener.start()

    TRANSCRIPT_LOGGER.handlers.clear()
    if log_transcripts and transcript_file:
        TRANSCRIPT_LOGGER.setLevel(logging.INFO)
        th = logging.handlers.TimedRotatingFileHandler(
            transcript_file,
            when="D",
            backupCount=transcript_retention_days or 0,
        )
        th.setFormatter(logging.Formatter("%(asctime)s [%(session_id)s] %(message)s"))
        tq: queue.Queue = queue.Queue(-1)
        tqh = logging.handlers.QueueHandler(tq)
        tqh.addFilter(_SessionContextFilter())
        TRANSCRIPT_LOGGER.addHandler(tqh)
        _transcript_listener = logging.handlers.QueueListener(tq, th)
        _transcript_listener.start()
    else:
        TRANSCRIPT_LOGGER.setLevel(logging.CRITICAL + 1)
        TRANSCRIPT_LOGGER.addHandler(logging.NullHandler())


def shutdown_logging() -> None:
    """Flush and stop queue listeners (call on server shutdown)."""
    global _listener, _transcript_listener
    for listener in (_listener, _transcript_listener):
        if listener is not None:
            listener.stop()
    _listener = None
    _transcript_listener = None


__all__ = [
    "LOGGER",
    "TRACE",
    "TRANSCRIPT_LOGGER",
    "configure_logging",
    "get_session_id",
    "set_session_id",
    "shutdown_logging",
    "trace",
]
