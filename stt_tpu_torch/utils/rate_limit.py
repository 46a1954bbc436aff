"""Keyed token-bucket rate limiting with TTL pruning.

Own copy of ``stt_tpu/utils/rate_limit.py`` for the port, which imports nothing of ``stt_tpu``.

One limiter instance guards one resource class (CreateSession, stream bytes,
HTTP requests); buckets are keyed by caller identity (IP, api-key, session).
Semantics match the reference (``stt_server/backend/utils/rate_limit.py:18-97``):
refill at ``rate`` tokens/sec up to ``burst``, prune idle keys so hostile key
churn cannot grow memory unboundedly.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple


class KeyedRateLimiter:
    """Thread-safe per-key token bucket.

    ``rate`` <= 0 disables limiting (every ``allow`` succeeds). ``burst`` <= 0
    falls back to ``rate``. ``time_fn`` is injectable for deterministic tests.
    """

    def __init__(
        self,
        rate: float,
        burst: float = 0.0,
        *,
        ttl_sec: float = 300.0,
        prune_interval_sec: float = 60.0,
        prune_every_calls: int = 1024,
        time_fn: Callable[[], float] = time.monotonic,
    ) -> None:
        self._rate = float(rate)
        self._burst = float(burst) if burst and burst > 0 else float(rate)
        self._ttl = ttl_sec
        self._prune_interval = prune_interval_sec
        self._prune_every_calls = max(1, prune_every_calls)
        self._time = time_fn
        self._lock = threading.Lock()
        # key -> (tokens, last_refill_ts)
        self._buckets: Dict[str, Tuple[float, float]] = {}
        self._calls_since_prune = 0
        self._last_prune = self._time()

    @property
    def enabled(self) -> bool:
        return self._rate > 0

    def allow(self, key: str, cost: float = 1.0) -> bool:
        """Consume ``cost`` tokens for ``key``; False when over limit."""
        if not self.enabled:
            return True
        now = self._time()
        with self._lock:
            tokens, last = self._buckets.get(key, (self._burst, now))
            tokens = min(self._burst, tokens + (now - last) * self._rate)
            allowed = tokens >= cost
            if allowed:
                tokens -= cost
            self._buckets[key] = (tokens, now)
            self._calls_since_prune += 1
            if (
                self._calls_since_prune >= self._prune_every_calls
                or now - self._last_prune >= self._prune_interval
            ):
                self._prune_locked(now)
        return allowed

    def retry_after(self, key: str, cost: float = 1.0) -> float:
        """Seconds until ``key`` would have ``cost`` tokens again."""
        if not self.enabled:
            return 0.0
        now = self._time()
        with self._lock:
            tokens, last = self._buckets.get(key, (self._burst, now))
            tokens = min(self._burst, tokens + (now - last) * self._rate)
        deficit = cost - tokens
        return max(0.0, deficit / self._rate)

    def reset(self, key: Optional[str] = None) -> None:
        with self._lock:
            if key is None:
                self._buckets.clear()
            else:
                self._buckets.pop(key, None)

    def _prune_locked(self, now: float) -> None:
        self._calls_since_prune = 0
        self._last_prune = now
        stale = [k for k, (_, last) in self._buckets.items() if now - last > self._ttl]
        for k in stale:
            del self._buckets[k]

    def __len__(self) -> int:
        with self._lock:
            return len(self._buckets)


__all__ = ["KeyedRateLimiter"]
