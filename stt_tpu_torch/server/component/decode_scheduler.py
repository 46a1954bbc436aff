"""Per-stream decode tracking: pending futures, timings, transcript state.

Own copy of ``stt_tpu/server/component/decode_scheduler.py`` for the port, which imports nothing of ``stt_tpu``.

Behavior-compatible with the reference component (``stt_server/backend/
component/decode_scheduler.py:105-744``): a process-wide
:class:`DecodeScheduler` owns the global pending-slot semaphore and a rolling
health-event window, and hands out per-RPC :class:`DecodeStream` objects that
track in-flight decode futures, convert backend segments into ``STTResult``
messages with offset-shifted timestamps, and maintain the committed/unstable
transcript split across consecutive partials (LCP + whitespace/punctuation
boundary commit — golden-tested against the reference cases incl. CJK).

Layering differs from the reference: instead of reaching back into the
orchestrator to find the registry, the scheduler is constructed with a
``submit_fn`` and ``cancel_fn`` (dependency-injected from the runtime), so
this module has no upward imports.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent import futures
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import grpc

from ...config.languages import SupportedLanguages
from ...errors import ErrorCode, STTError, status_for
from ...gen import stt_pb2
from ...utils.logging import LOGGER, TRANSCRIPT_LOGGER

# ---------------------------------------------------------------------------
# Transcript merge / commit helpers (wire-visible behavior; keep exact)
# ---------------------------------------------------------------------------

_PUNCTUATION = ".,?!、。，！？…"


def merge_transcript(prefix: str, next_text: str) -> str:
    """Join a committed prefix with newly decoded text, deduplicating when
    the new decode already contains the prefix."""
    prefix = (prefix or "").strip()
    next_text = (next_text or "").strip()
    if not prefix:
        return next_text
    if not next_text:
        return prefix
    if next_text.startswith(prefix):
        return next_text
    return f"{prefix} {next_text}"


def longest_common_prefix(left: str, right: str) -> int:
    limit = min(len(left), len(right))
    i = 0
    while i < limit and left[i] == right[i]:
        i += 1
    return i


def commit_from_partials(committed: str, previous: str, current: str) -> str:
    """Advance the committed prefix using agreement between two consecutive
    partials, preferring whitespace then punctuation boundaries, falling back
    to the raw agreement point (CJK text has no spaces)."""
    if not previous or not current:
        return committed
    lcp = longest_common_prefix(previous, current)
    if lcp <= len(committed):
        return committed
    candidate = current[:lcp]

    ws = max(candidate.rfind(" "), candidate.rfind("\t"), candidate.rfind("\n"))
    if ws > len(committed):
        return candidate[:ws].strip()

    punct = max((candidate.rfind(ch) for ch in _PUNCTUATION), default=-1)
    if punct >= len(committed):
        return candidate[: punct + 1].strip()

    fallback = candidate.strip()
    return fallback if len(fallback) > len(committed) else committed


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------


def _noop(*_args, **_kwargs) -> None:
    return None


@dataclass(frozen=True)
class DecodeSchedulerHooks:
    """Metric fan-out; defaults are no-ops so components never import Metrics."""

    on_error: Callable[[grpc.StatusCode], None] = _noop
    on_decode_result: Callable[[float, float, float, float, float], None] = _noop
    on_vad_utterance_end: Callable[[], None] = _noop
    on_decode_cancelled: Callable[[int], None] = _noop
    on_decode_orphaned: Callable[[int], None] = _noop
    on_decode_pending: Callable[[int], None] = _noop


@dataclass
class PendingDecode:
    """One scheduled decode awaiting emission."""

    future: futures.Future
    is_final: bool
    offset_sec: float
    count_vad: bool
    buffer_wait_sec: float
    holds_slot: bool


class DecodeScheduler:
    """Global decode bookkeeping: pending slots, health window, hooks."""

    def __init__(
        self,
        *,
        submit_fn: Callable[..., futures.Future],
        cancel_fn: Callable[[futures.Future], None] = _noop,
        registry_health_fn: Callable[[], Dict[str, Any]] = lambda: {
            "models_loaded": ["default"],
            "total_workers": 1,
            "empty_pools": 0,
            "shutdown_workers": 0,
        },
        decode_timeout_sec: float = 30.0,
        language_lookup: Optional[SupportedLanguages] = None,
        max_pending_decodes_global: Optional[int] = None,
        health_window_sec: float = 60.0,
        health_min_events: int = 5,
        health_max_timeout_ratio: float = 0.5,
        health_min_success_ratio: float = 0.5,
        log_transcripts: bool = False,
        hooks: Optional[DecodeSchedulerHooks] = None,
    ) -> None:
        self.submit_fn = submit_fn
        self.cancel_fn = cancel_fn
        self.registry_health_fn = registry_health_fn
        self.decode_timeout_sec = decode_timeout_sec
        self.language_lookup = language_lookup or SupportedLanguages()
        self.log_transcripts = log_transcripts
        self.hooks = hooks or DecodeSchedulerHooks()

        self._pending_lock = threading.Lock()
        self._pending_tasks = 0
        limit = int(max_pending_decodes_global or 0)
        self._pending_sem = (
            threading.BoundedSemaphore(limit) if limit > 0 else None
        )

        self._health_lock = threading.Lock()
        self._health_events: "deque[Tuple[float, str, int]]" = deque()
        self._health_window_sec = max(1.0, float(health_window_sec))
        self._health_min_events = max(1, int(health_min_events))
        self._health_max_timeout_ratio = min(1.0, max(0.0, health_max_timeout_ratio))
        self._health_min_success_ratio = min(1.0, max(0.0, health_min_success_ratio))

    def new_stream(self) -> "DecodeStream":
        return DecodeStream(self)

    # -- pending slots ---------------------------------------------------------

    def acquire_pending_slot(self, block: bool, timeout: Optional[float]) -> bool:
        if self._pending_sem is None:
            return True
        if not block:
            return self._pending_sem.acquire(blocking=False)
        return self._pending_sem.acquire(timeout=timeout)

    def release_pending_slot(self) -> None:
        if self._pending_sem is None:
            return
        try:
            self._pending_sem.release()
        except ValueError:
            pass

    def pending_decodes(self) -> int:
        with self._pending_lock:
            return self._pending_tasks

    def _adjust_pending(self, delta: int) -> None:
        with self._pending_lock:
            self._pending_tasks = max(0, self._pending_tasks + delta)
            pending = self._pending_tasks
        self.hooks.on_decode_pending(pending)

    # -- health ----------------------------------------------------------------

    def record_health_event(self, outcome: str, count: int = 1) -> None:
        if count <= 0:
            return
        now = time.monotonic()
        with self._health_lock:
            self._health_events.append((now, outcome, count))
            cutoff = now - self._health_window_sec
            while self._health_events and self._health_events[0][0] < cutoff:
                self._health_events.popleft()

    def _health_counts(self) -> Dict[str, int]:
        now = time.monotonic()
        with self._health_lock:
            cutoff = now - self._health_window_sec
            while self._health_events and self._health_events[0][0] < cutoff:
                self._health_events.popleft()
            counts = {"success": 0, "timeout": 0, "error": 0}
            for _, outcome, count in self._health_events:
                if outcome in counts:
                    counts[outcome] += count
            return counts

    def workers_healthy(self) -> bool:
        summary = self.registry_health_fn()
        if not summary.get("models_loaded"):
            return False
        if summary.get("total_workers", 0) <= 0:
            return False
        if summary.get("empty_pools", 0) > 0:
            return False
        if summary.get("shutdown_workers", 0) > 0:
            return False
        counts = self._health_counts()
        total = sum(counts.values())
        if total < self._health_min_events:
            return True
        if counts["timeout"] / total >= self._health_max_timeout_ratio:
            return False
        if counts["success"] / total < self._health_min_success_ratio:
            return False
        return True

    def notify_orphaned(self, count: int) -> None:
        self.hooks.on_decode_orphaned(count)
        if count > 0:
            # orphaned tasks signal resource pressure -> count as errors
            self.record_health_event("error", count)


class DecodeStream:
    """Tracks decode futures and transcript state for one streaming RPC."""

    def __init__(self, scheduler: DecodeScheduler) -> None:
        self.scheduler = scheduler
        self.session_id: Optional[str] = None
        self.model_id: str = "default"
        self._lock = threading.Lock()
        self._pending: List[PendingDecode] = []
        self._pending_partials = 0
        self._committed = ""
        self._last_partial = ""
        # word-level times ACCUMULATED across decodes (word_timestamps
        # option); each decode window replaces the entries it re-covers
        # (start >= its offset) and extends the rest, so multi-window
        # uploads (REST > max_buffer_sec, overflow partials + final) keep
        # word coverage aligned with the full transcript instead of the
        # last window only (ADVICE r4 medium). Surfaced in trailing
        # metadata at finalize.
        self.last_word_timings: List[tuple] = []
        self._timing = {
            "buffer_wait": 0.0,
            "queue_wait": 0.0,
            "inference": 0.0,
            "response_emit": 0.0,
            "count": 0,
        }

    # -- identity --------------------------------------------------------------

    def set_session_id(self, session_id: Optional[str]) -> None:
        self.session_id = session_id

    def set_model_id(self, model_id: str) -> None:
        self.model_id = model_id

    # -- transcript state ------------------------------------------------------

    def _update_commit_state(self, decoded_text: str, is_final: bool) -> Tuple[str, str]:
        decoded_text = (decoded_text or "").strip()
        if not decoded_text:
            if is_final:
                self._last_partial = self._committed
            return self._committed, ""
        merged = merge_transcript(self._committed, decoded_text)
        if is_final:
            self._committed = merged
            self._last_partial = merged
            return self._committed, ""
        advanced = commit_from_partials(self._committed, self._last_partial, merged)
        if len(advanced) > len(self._committed):
            self._committed = advanced
        self._last_partial = merged
        if not self._committed:
            return self._committed, merged
        return self._committed, merged[len(self._committed):].lstrip()

    # -- scheduling ------------------------------------------------------------

    def schedule_decode(
        self,
        pcm: bytes,
        sample_rate: int,
        decode_options: Optional[Dict[str, Any]],
        is_final: bool,
        offset_sec: float,
        count_vad: bool = False,
        buffer_started_at: Optional[float] = None,
        holds_slot: bool = False,
    ) -> None:
        if not pcm:
            if holds_slot:
                self.scheduler.release_pending_slot()
            return
        if decode_options and decode_options.get("condition_on_previous_text"):
            # streaming conditioning: the committed transcript so far becomes
            # the decode's sot_prev context (reference faster_whisper option;
            # here it spans decode windows within the stream)
            with self._lock:
                committed = self._committed
            if committed and not decode_options.get("initial_prompt"):
                decode_options = dict(decode_options)
                decode_options["initial_prompt"] = committed[-400:]
                # grows every commit -> the engine buckets its token
                # count so the stream hits a bounded set of prompt shapes
                decode_options["_cond_ctx"] = True
        future = self.scheduler.submit_fn(
            self.model_id,
            self.session_id or "unknown",
            pcm,
            sample_rate,
            decode_options,
            is_final,
        )
        buffer_wait = (
            max(0.0, time.perf_counter() - buffer_started_at)
            if buffer_started_at is not None
            else 0.0
        )
        self.scheduler._adjust_pending(1)
        with self._lock:
            self._pending.append(
                PendingDecode(future, is_final, offset_sec, count_vad,
                              buffer_wait, holds_slot)
            )
            if not is_final:
                self._pending_partials += 1
            depth = len(self._pending)
        LOGGER.info(
            "scheduled decode session_id=%s bytes=%d final=%s pending=%d "
            "offset=%.2f model_id=%s",
            self.session_id or "unknown", len(pcm), is_final, depth,
            offset_sec, self.model_id,
        )

    # -- pending management ----------------------------------------------------

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def pending_partial_decodes(self) -> int:
        with self._lock:
            return self._pending_partials

    def has_pending_results(self) -> bool:
        return self.pending_count() > 0

    def _settle(self, item: PendingDecode) -> None:
        with self._lock:
            if not item.is_final and self._pending_partials > 0:
                self._pending_partials -= 1
        self.scheduler._adjust_pending(-1)
        if item.holds_slot:
            self.scheduler.release_pending_slot()

    def _cancel_items(self, items: List[PendingDecode]) -> Tuple[int, int]:
        cancelled = orphaned = 0
        for item in items:
            if item.future.cancel():
                cancelled += 1
            else:
                self.scheduler.cancel_fn(item.future)
                orphaned += 1
            self._settle(item)
        if cancelled:
            self.scheduler.hooks.on_decode_cancelled(cancelled)
        if orphaned:
            self.scheduler.notify_orphaned(orphaned)
        return cancelled, orphaned

    def drop_pending_partials(self, max_drop: Optional[int] = None) -> Tuple[int, int]:
        if max_drop is not None and max_drop <= 0:
            return 0, 0
        with self._lock:
            budget = max_drop if max_drop is not None else float("inf")
            dropped, kept = [], []
            for item in self._pending:
                if budget > 0 and not item.is_final:
                    dropped.append(item)
                    budget -= 1
                else:
                    kept.append(item)
            self._pending[:] = kept
        if not dropped:
            return 0, 0
        return self._cancel_items(dropped)

    def cancel_pending(self) -> Tuple[int, int]:
        with self._lock:
            items = list(self._pending)
            self._pending.clear()
        if not items:
            return 0, 0
        return self._cancel_items(items)

    # -- timing ----------------------------------------------------------------

    def timing_summary(self) -> Tuple[float, float, float, float, int]:
        with self._lock:
            t = self._timing
            return (t["buffer_wait"], t["queue_wait"], t["inference"],
                    t["response_emit"], t["count"])

    def _record_timing(self, buffer_wait, queue_wait, inference, emit) -> None:
        with self._lock:
            t = self._timing
            if buffer_wait >= 0:
                t["buffer_wait"] += buffer_wait
            if queue_wait >= 0:
                t["queue_wait"] += queue_wait
            if inference >= 0:
                t["inference"] += inference
            if emit >= 0:
                t["response_emit"] += emit
            t["count"] += 1

    # -- emission ---------------------------------------------------------------

    def _take_ready(self) -> Tuple[List[PendingDecode], List[PendingDecode]]:
        with self._lock:
            ready = [p for p in self._pending if p.future.done()]
            still = [p for p in self._pending if not p.future.done()]
            self._pending[:] = still
            return ready, list(still)

    def emit_ready(self, block: bool) -> Iterable[stt_pb2.STTResult]:
        """Yield STTResult messages for completed decodes; optionally block
        until at least one pending decode completes (ERR2001 on timeout)."""
        ready, still_pending = self._take_ready()

        if not ready and block and still_pending:
            timeout = (
                self.scheduler.decode_timeout_sec
                if self.scheduler.decode_timeout_sec > 0
                else None
            )
            done, _ = futures.wait(
                [p.future for p in still_pending],
                timeout=timeout,
                return_when=futures.FIRST_COMPLETED,
            )
            if not done:
                self.scheduler.hooks.on_error(status_for(ErrorCode.DECODE_TIMEOUT))
                self.scheduler.record_health_event("timeout", len(still_pending))
                with self._lock:
                    items = list(self._pending)
                    self._pending.clear()
                self._cancel_items(items)
                detail = f"decode timeout after {timeout}s" if timeout else None
                raise STTError(ErrorCode.DECODE_TIMEOUT, detail)
            with self._lock:
                ready = [p for p in self._pending if p.future in done]
                self._pending[:] = [p for p in self._pending if p.future not in done]

        for item in ready:
            try:
                result = item.future.result()
            except STTError as exc:
                self.scheduler.hooks.on_error(exc.status)
                self.scheduler.record_health_event("error")
                self._settle(item)
                raise
            except futures.CancelledError:
                self._settle(item)
                continue
            except Exception as exc:
                self.scheduler.hooks.on_error(grpc.StatusCode.INTERNAL)
                self.scheduler.record_health_event("error")
                self._settle(item)
                raise STTError(
                    ErrorCode.DECODE_TASK_FAILED, f"decode task failed: {exc}"
                ) from exc

            yield from self._emit_result(item, result)

    def _emit_result(self, item: PendingDecode, result) -> Iterable[stt_pb2.STTResult]:
        language_name = self.scheduler.language_lookup.get_name(result.language_code)
        emit_start = time.perf_counter()
        decoded_text = " ".join(
            seg.text.strip() for seg in result.segments if seg.text and seg.text.strip()
        )
        committed, unstable = self._update_commit_state(decoded_text, item.is_final)
        words = getattr(result, "words", ()) or ()
        if words:
            # the wire contract (proto STTResult) carries segment times
            # only; word-level times surface via the transcript log and
            # the stream's trailing metadata (orchestrator finalize).
            # This window re-decoded audio from item.offset_sec onward:
            # its words REPLACE accumulated entries in that span and the
            # earlier (no-longer-covered) entries are retained.
            shifted = [
                (ws + item.offset_sec, we + item.offset_sec, wt)
                for ws, we, wt in words
            ]
            self.last_word_timings = [
                w for w in self.last_word_timings
                if w[0] < item.offset_sec - 1e-6
            ] + shifted
            if self.scheduler.log_transcripts:
                TRANSCRIPT_LOGGER.info(
                    "session_id=%s words=%s",
                    self.session_id or "unknown",
                    " ".join(
                        f"[{ws:.2f}-{we:.2f}]{wt}"
                        for ws, we, wt in shifted
                    ),
                )
        for seg in result.segments:
            if self.scheduler.log_transcripts:
                TRANSCRIPT_LOGGER.info(
                    "session_id=%s %s result='%s' [%.2f, %.2f] lang=%s prob=%.2f",
                    self.session_id or "unknown",
                    "final" if item.is_final else "partial",
                    seg.text or "",
                    seg.start + item.offset_sec,
                    seg.end + item.offset_sec,
                    result.language_code or "auto",
                    max(-1.0, result.language_probability),
                )
            yield stt_pb2.STTResult(
                text=seg.text,
                is_final=item.is_final,
                start_sec=seg.start + item.offset_sec,
                end_sec=seg.end + item.offset_sec,
                language_code=result.language_code or "",
                language=language_name,
                probability=max(0.0, result.language_probability),
                committed_text=committed,
                unstable_text=unstable,
            )
        emit_sec = max(0.0, time.perf_counter() - emit_start)
        if item.count_vad:
            self.scheduler.hooks.on_vad_utterance_end()
        if result.latency_sec >= 0:
            self.scheduler.hooks.on_decode_result(
                result.latency_sec, result.rtf, result.queue_wait_sec,
                item.buffer_wait_sec, emit_sec,
            )
            self.scheduler.record_health_event("success")
            self._record_timing(
                item.buffer_wait_sec, result.queue_wait_sec,
                result.latency_sec, emit_sec,
            )
            LOGGER.info(
                "decode_timing session_id=%s final=%s buffer_wait=%.3fs "
                "queue_wait=%.3fs inference=%.3fs response_emit=%.3fs "
                "audio_duration=%.2fs rtf=%.3f",
                self.session_id or "unknown", item.is_final,
                item.buffer_wait_sec, result.queue_wait_sec, result.latency_sec,
                emit_sec, result.audio_duration, max(-1.0, result.rtf),
            )
        self._settle(item)


__all__ = [
    "DecodeScheduler",
    "DecodeSchedulerHooks",
    "DecodeStream",
    "PendingDecode",
    "commit_from_partials",
    "longest_common_prefix",
    "merge_transcript",
]
