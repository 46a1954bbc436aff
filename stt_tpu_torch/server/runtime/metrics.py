"""Server metrics: counters, gauges, timing aggregates, histograms.

Own copy of ``stt_tpu/server/runtime/metrics.py`` for the port, which imports nothing of ``stt_tpu``.

Design differs from the reference's one-attribute-per-metric class
(``stt_server/backend/runtime/metrics.py:64-368``): metrics live in generic
registries (counter/gauge/stat/histogram dicts) behind one lock, and the
``render()``/``snapshot()`` methods project them into the exact payload keys
the reference exposes, so ``/metrics``, ``/metrics.json`` and both dashboards
stay drop-in compatible. Per-key identities (api keys, session ids) are always
SHA-256-hashed before use as labels; TPU-engine metrics (batch occupancy,
compile counts, device step time) are additive keys with an ``engine_`` prefix.
"""

from __future__ import annotations

import hashlib
import threading
from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import grpc

# Latency histogram bounds (seconds). Same coverage as the reference buckets.
LATENCY_BOUNDS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
WAIT_BOUNDS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


@dataclass(frozen=True)
class HistogramSnapshot:
    bounds: Tuple[float, ...]
    cumulative_counts: Tuple[int, ...]  # one per bound, then +Inf
    count: int
    sum: float


class Histogram:
    """Fixed-bucket cumulative histogram (not thread-safe; callers lock)."""

    def __init__(self, bounds: Tuple[float, ...]) -> None:
        self._bounds = tuple(sorted(set(float(b) for b in bounds)))
        self._counts = [0] * (len(self._bounds) + 1)
        self._count = 0
        self._sum = 0.0

    def observe(self, value: float) -> None:
        v = max(0.0, float(value))
        self._count += 1
        self._sum += v
        for i, bound in enumerate(self._bounds):
            if v <= bound:
                self._counts[i] += 1
                return
        self._counts[-1] += 1

    def snapshot(self) -> HistogramSnapshot:
        cumulative: List[int] = []
        running = 0
        for c in self._counts:
            running += c
            cumulative.append(running)
        return HistogramSnapshot(
            bounds=self._bounds,
            cumulative_counts=tuple(cumulative),
            count=self._count,
            sum=self._sum,
        )


class _Stat:
    """count/total/max aggregate for one timing series."""

    __slots__ = ("count", "total", "max")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def record(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.max = max(self.max, value)

    @property
    def avg(self) -> float:
        return self.total / self.count if self.count else 0.0


def hash_key(value: str) -> str:
    """Short stable hash for privacy-preserving per-key labels."""
    if not value:
        return ""
    return hashlib.sha256(value.encode("utf-8")).hexdigest()[:16]


class Metrics:
    """Thread-safe metrics registry for one server runtime."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = defaultdict(int)
        self._gauges: Dict[str, float] = defaultdict(float)
        self._stats: Dict[str, _Stat] = defaultdict(_Stat)
        self._error_counts: Dict[str, int] = defaultdict(int)
        self._rate_limit_blocks: Dict[str, int] = defaultdict(int)
        self._rate_limit_blocks_by_key: Dict[str, int] = defaultdict(int)
        self._api_key_sessions: Dict[str, int] = defaultdict(int)
        self._stream_buffer_bytes: Dict[str, int] = {}
        self._expose_api_key_metrics = False
        self._histograms: Dict[str, Histogram] = {
            "decode_latency_sec": Histogram(LATENCY_BOUNDS),
            "decode_buffer_wait_sec": Histogram(WAIT_BOUNDS),
            "decode_queue_wait_sec": Histogram(WAIT_BOUNDS),
            "decode_response_emit_sec": Histogram(WAIT_BOUNDS),
        }

    # -- sessions ------------------------------------------------------------

    def increase_active_sessions(self, api_key: str = "") -> None:
        with self._lock:
            self._gauges["active_sessions"] += 1
            hashed = hash_key(api_key)
            if hashed:
                self._api_key_sessions[hashed] += 1

    def decrease_active_sessions(self, api_key: str = "") -> None:
        with self._lock:
            self._gauges["active_sessions"] = max(
                0, self._gauges["active_sessions"] - 1
            )
            hashed = hash_key(api_key)
            if hashed and hashed in self._api_key_sessions:
                remaining = self._api_key_sessions[hashed] - 1
                if remaining > 0:
                    self._api_key_sessions[hashed] = remaining
                else:
                    del self._api_key_sessions[hashed]

    # -- gauges ----------------------------------------------------------------

    def set_buffer_total(self, total_bytes: int) -> None:
        with self._lock:
            self._gauges["buffer_bytes_total"] = max(0, int(total_bytes))

    def set_decode_pending(self, pending: int) -> None:
        with self._lock:
            self._gauges["decode_pending"] = max(0, int(pending))

    def set_stream_buffer_bytes(self, session_id: str, buffer_bytes: int) -> None:
        hashed = hash_key(session_id)
        if not hashed:
            return
        with self._lock:
            self._stream_buffer_bytes[hashed] = max(0, int(buffer_bytes))

    def clear_stream_buffer(self, session_id: str) -> None:
        hashed = hash_key(session_id)
        with self._lock:
            self._stream_buffer_bytes.pop(hashed, None)

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    # -- decode timings --------------------------------------------------------

    def record_decode(
        self,
        inference_sec: float,
        *,
        buffer_wait_sec: Optional[float] = None,
        queue_wait_sec: Optional[float] = None,
        response_emit_sec: Optional[float] = None,
        real_time_factor: Optional[float] = None,
    ) -> None:
        with self._lock:
            self._stats["decode_latency"].record(inference_sec)
            self._histograms["decode_latency_sec"].observe(inference_sec)
            if buffer_wait_sec is not None:
                self._stats["decode_buffer_wait"].record(buffer_wait_sec)
                self._histograms["decode_buffer_wait_sec"].observe(buffer_wait_sec)
            if queue_wait_sec is not None:
                self._stats["decode_queue_wait"].record(queue_wait_sec)
                self._histograms["decode_queue_wait_sec"].observe(queue_wait_sec)
            if response_emit_sec is not None:
                self._stats["decode_response_emit"].record(response_emit_sec)
                self._histograms["decode_response_emit_sec"].observe(response_emit_sec)
            if real_time_factor is not None:
                self._stats["rtf"].record(real_time_factor)

    def record_decode_cancelled(self, count: int = 1) -> None:
        with self._lock:
            self._counters["decode_cancelled"] += max(0, int(count))

    def record_decode_orphaned(self, count: int = 1) -> None:
        with self._lock:
            self._counters["decode_orphaned"] += max(0, int(count))

    def record_partial_drop(self, count: int = 1) -> None:
        with self._lock:
            self._counters["partial_drop_count"] += max(0, int(count))

    # -- engine (TPU) ----------------------------------------------------------

    def record_engine_batch(self, rows: int, capacity: int, step_sec: float) -> None:
        """One decode-engine device step: how full the batch was, how long."""
        with self._lock:
            self._stats["engine_batch_rows"].record(float(rows))
            self._stats["engine_step"].record(step_sec)
            if capacity > 0:
                self._stats["engine_batch_occupancy"].record(rows / capacity)

    def record_engine_compile(self, seconds: float) -> None:
        with self._lock:
            self._counters["engine_compile_count"] += 1
            self._stats["engine_compile"].record(seconds)

    def record_draft_verify(self, rows: int, offered: int,
                            accepted: int) -> None:
        """One drafted-partial batch: rows carrying a non-empty draft,
        draft tokens offered, draft tokens the verify pass accepted
        (accepted/offered is the streaming speedup signal)."""
        with self._lock:
            self._counters["draft_rows"] += rows
            self._counters["draft_tokens_offered"] += offered
            self._counters["draft_tokens_accepted"] += accepted

    def record_draft_signal(self, hyp_offered: int, hyp_accepted: int,
                            ema: float, engaged: bool) -> None:
        """Adaptive draft-routing signal: hypothetical acceptance
        counters measured on plain-routed partials (host LCP of
        consecutive token streams), plus the engagement EMA/state that
        decides whether the drafted program is serving."""
        with self._lock:
            self._counters["draft_hyp_tokens_offered"] += hyp_offered
            self._counters["draft_hyp_tokens_accepted"] += hyp_accepted
            self._gauges["draft_accept_ema"] = float(ema)
            self._gauges["draft_engaged"] = 1.0 if engaged else 0.0

    # -- VAD -------------------------------------------------------------------

    def record_vad_trigger(self) -> None:
        with self._lock:
            self._counters["vad_triggers_total"] += 1

    def increase_active_vad_utterances(self) -> None:
        with self._lock:
            self._gauges["active_vad_utterances"] += 1

    def decrease_active_vad_utterances(self) -> None:
        with self._lock:
            self._gauges["active_vad_utterances"] = max(
                0, self._gauges["active_vad_utterances"] - 1
            )

    def active_vad_utterances(self) -> int:
        with self._lock:
            return int(self._gauges["active_vad_utterances"])

    # -- errors / limits -------------------------------------------------------

    def record_error(self, status_code: grpc.StatusCode) -> None:
        with self._lock:
            self._error_counts[status_code.name] += 1

    def record_rate_limit_block(self, scope: str, key: Optional[str] = None) -> None:
        scope = scope or "unknown"
        with self._lock:
            self._rate_limit_blocks[scope] += 1
            if key:
                hashed = hash_key(key)
                if hashed:
                    self._rate_limit_blocks_by_key[f"{scope}_{hashed}"] += 1

    def set_expose_api_key_metrics(self, enabled: bool) -> None:
        with self._lock:
            self._expose_api_key_metrics = bool(enabled)

    # -- export ----------------------------------------------------------------

    def _stat_triplet(self, payload: Dict[str, Any], name: str, key: str) -> None:
        stat = self._stats[key]
        payload[f"{name}_total"] = stat.total
        payload[f"{name}_count"] = stat.count
        payload[f"{name}_max"] = stat.max

    def render(self) -> Dict[str, Any]:
        """Full serializable payload (reference-compatible key set)."""
        with self._lock:
            payload: Dict[str, Any] = {
                "active_sessions": int(self._gauges["active_sessions"]),
                "buffer_bytes_total": int(self._gauges["buffer_bytes_total"]),
                "decode_pending": int(self._gauges["decode_pending"]),
                "decode_cancelled": self._counters["decode_cancelled"],
                "decode_orphaned": self._counters["decode_orphaned"],
                "partial_drop_count": self._counters["partial_drop_count"],
                "vad_triggers_total": self._counters["vad_triggers_total"],
                "active_vad_utterances": int(self._gauges["active_vad_utterances"]),
                "error_counts": dict(self._error_counts),
                "rate_limit_blocks": dict(self._rate_limit_blocks),
            }
            self._stat_triplet(payload, "decode_latency", "decode_latency")
            self._stat_triplet(payload, "decode_buffer_wait", "decode_buffer_wait")
            self._stat_triplet(payload, "decode_queue_wait", "decode_queue_wait")
            self._stat_triplet(
                payload, "decode_response_emit", "decode_response_emit"
            )
            self._stat_triplet(payload, "rtf", "rtf")
            # TPU engine extension keys
            self._stat_triplet(payload, "engine_step", "engine_step")
            self._stat_triplet(payload, "engine_batch_rows", "engine_batch_rows")
            self._stat_triplet(
                payload, "engine_batch_occupancy", "engine_batch_occupancy"
            )
            payload["engine_compile_count"] = self._counters["engine_compile_count"]
            payload["draft_rows"] = self._counters["draft_rows"]
            payload["draft_tokens_offered"] = self._counters[
                "draft_tokens_offered"
            ]
            payload["draft_tokens_accepted"] = self._counters[
                "draft_tokens_accepted"
            ]
            if self._expose_api_key_metrics and self._api_key_sessions:
                payload["active_sessions_by_api"] = dict(self._api_key_sessions)
            if self._stream_buffer_bytes:
                payload["stream_buffer_bytes"] = dict(self._stream_buffer_bytes)
            if self._rate_limit_blocks_by_key:
                payload["rate_limit_blocks_by_key"] = dict(
                    self._rate_limit_blocks_by_key
                )
            payload["histograms"] = {
                name: self._histogram_payload(hist)
                for name, hist in self._histograms.items()
            }
            return payload

    @staticmethod
    def _histogram_payload(histogram: Histogram) -> Dict[str, Any]:
        snap = histogram.snapshot()
        buckets = {
            str(bound): snap.cumulative_counts[i]
            for i, bound in enumerate(snap.bounds)
        }
        buckets["+Inf"] = snap.cumulative_counts[-1]
        return {"buckets": buckets, "count": snap.count, "sum": snap.sum}

    def snapshot(self) -> Dict[str, float]:
        """Compact health-view snapshot with averages."""
        with self._lock:
            return {
                "active_sessions": self._gauges["active_sessions"],
                "decode_latency_avg": self._stats["decode_latency"].avg,
                "decode_latency_max": self._stats["decode_latency"].max,
                "decode_pending": self._gauges["decode_pending"],
                "decode_buffer_wait_avg": self._stats["decode_buffer_wait"].avg,
                "decode_buffer_wait_max": self._stats["decode_buffer_wait"].max,
                "decode_queue_wait_avg": self._stats["decode_queue_wait"].avg,
                "decode_queue_wait_max": self._stats["decode_queue_wait"].max,
                "decode_response_emit_avg": self._stats["decode_response_emit"].avg,
                "decode_response_emit_max": self._stats["decode_response_emit"].max,
                "decode_cancelled": float(self._counters["decode_cancelled"]),
                "decode_orphaned": float(self._counters["decode_orphaned"]),
                "rtf_avg": self._stats["rtf"].avg,
                "rtf_max": self._stats["rtf"].max,
                "vad_triggers": float(self._counters["vad_triggers_total"]),
                "active_vad_utterances": self._gauges["active_vad_utterances"],
                "engine_step_avg": self._stats["engine_step"].avg,
                "engine_batch_occupancy_avg": self._stats[
                    "engine_batch_occupancy"
                ].avg,
            }


__all__ = [
    "Histogram",
    "HistogramSnapshot",
    "LATENCY_BOUNDS",
    "Metrics",
    "WAIT_BOUNDS",
    "hash_key",
]
