"""Cross-session batched VAD scoring: one device call per tick.

Counterpart of ``stt_tpu/server/component/vad_scorer.py``. The DSP VAD's
streaming state is two float32 scalars and a frame counter a session, so
the sessions whose chunks arrive within a short batch window are scored by
one :func:`~stt_tpu_torch.ops.vad.vad_step_torch` call over (B, F, 512)
frames on the scorer's device instead of N per-session numpy calls,
mirroring the engine's micro-batching loop.

- Rows are grouped by exact frame count (a 100 ms chunk is 3 frames, so a
  tick forms one group); the batch axis pads to the buckets 1-64 with fresh
  states whose outputs are discarded, the frame axis never (the noise floor
  is sequential).
- On the card the scorer enqueues on a CUDA stream of its own, so a tick
  does not queue behind the decode work the engine enqueues on its stream:
  one host-to-device copy of the frames and one of the states, the scoring,
  and one device-to-host copy of the probabilities and new states.
- The frame counter is kept on the host (it only counts).
- :meth:`BatchedVadScorer.prewarm` scores every (frame count, batch bucket)
  shape once before serving; a failure there raises.

No quiet fallback. The JAX scorer falls back to per-session numpy when its
thread fails, so endpointing never takes the data plane down; the port
keeps that, loudly: every score served by the host after a failure is
logged and counted (``fallbacks``, and the metrics hook's
``record_vad_scorer_fallback``), as every device batch is counted
(``batches``, ``record_vad_scorer_batch``).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ...ops import vad as vad_ops
from ...utils.logging import LOGGER

_DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
# the server config's accelerator names, as the registry reads them
_CARD_NAMES = ("cuda", "gpu", "tpu")


def scorer_device(name: Optional[str]) -> torch.device:
    """The scorer's device from the server config's ``device`` (``tpu``
    and ``gpu`` name the card, as in the registry): the card unless it says
    ``cpu``; a card without CUDA raises."""
    text = (name or "cuda").strip().lower()
    base, sep, index = text.partition(":")
    if base in _CARD_NAMES:
        text = "cuda" + sep + index
    return resolve_device(text)


class _Pending:
    __slots__ = ("frames", "state", "future")

    def __init__(self, frames: np.ndarray, state: vad_ops.VadState):
        self.frames = frames
        self.state = state
        self.future: Future = Future()


class BatchedVadScorer:
    """Micro-batching device scorer for the streaming DSP VAD.

    ``score(frames, state)`` blocks until the batch holding the request has
    been scored (window ``batch_window_ms``, a couple of ms against the
    32 ms frame cadence). ``device`` is the card unless the caller asks for
    the CPU; ``metrics`` receives ``record_vad_scorer_batch(seconds)`` once
    per device call and ``record_vad_scorer_fallback()`` once per
    host-scored request after a failure."""

    def __init__(
        self,
        device=None,
        *,
        batch_window_ms: float = 2.0,
        max_batch: int = 64,
        batch_buckets: Tuple[int, ...] = _DEFAULT_BATCH_BUCKETS,
        metrics=None,
    ) -> None:
        self.device = resolve_device(device)
        self.batch_window_sec = max(0.0, float(batch_window_ms) / 1000.0)
        self.max_batch = max(1, int(max_batch))
        self.batch_buckets = tuple(sorted(batch_buckets))
        self._metrics = metrics
        self._consts = vad_ops.vad_constants(self.device)
        self._stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                        else None)
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._running = False
        self._failed = False
        self.batches = 0
        self.fallbacks = 0

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._running:
                return
            self._running = True
            self._thread = threading.Thread(target=self._loop, name="vad-scorer", daemon=True)
            self._thread.start()

    def close(self) -> None:
        with self._lock:
            if not self._running:
                return
            self._running = False
        self._queue.put(None)
        if self._thread:
            self._thread.join(timeout=10)
            self._thread = None

    @property
    def healthy(self) -> bool:
        return not self._failed

    def prewarm(self, frame_counts=(1, 2, 3, 4), batch_sizes=None) -> None:
        """Score every (frame count, batch bucket) shape once on the
        device before serving (the allocator's blocks and the library
        handles); raises if one fails."""
        for n_frames in frame_counts:
            for b in batch_sizes or self.batch_buckets:
                frames = np.zeros((b, n_frames, vad_ops.VAD_FRAME_SAMPLES), np.float32)
                states = [vad_ops.init_state(np) for _ in range(b)]
                self._score_device(frames, states)

    # -- public scoring API ------------------------------------------------

    def score(self, frames: np.ndarray,
              state: vad_ops.VadState) -> Tuple[np.ndarray, vad_ops.VadState]:
        """frames (F, 512) + a session's state -> (probs (F,), new state).

        Thread-safe; called from every stream's thread at once. After a
        failure the host scores the request, logged and counted."""
        if self._failed:
            return self._fallback(frames, state, None)
        self.start()
        pending = _Pending(frames, state)
        self._queue.put(pending)
        try:
            return pending.future.result(timeout=60.0)
        except Exception as exc:
            self._failed = True
            return self._fallback(frames, state, exc)

    def _fallback(self, frames: np.ndarray, state: vad_ops.VadState,
                  exc: Optional[BaseException]):
        with self._lock:
            self.fallbacks += 1
        if exc is not None:
            LOGGER.error("batched VAD scorer failed (%r); scoring on the host from now on",
                         exc)
        else:
            LOGGER.warning("batched VAD scorer is down: request scored on the host "
                           "(%d fallbacks)", self.fallbacks)
        if self._metrics is not None:
            self._metrics.record_vad_scorer_fallback()
        return vad_ops.vad_step(np, frames, state)

    # -- batching loop -----------------------------------------------------

    def _batch_bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.batch_buckets[-1]

    def _loop(self) -> None:
        while True:
            try:
                first = self._queue.get(timeout=0.25)
            except queue.Empty:
                if not self._running:
                    return
                continue
            if first is None:
                return
            batch = [first]
            deadline = time.monotonic() + self.batch_window_sec
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._queue.put(None)
                    break
                batch.append(nxt)
            self._process(batch)
            if not self._running and self._queue.empty():
                return

    def _process(self, batch: List[_Pending]) -> None:
        groups: Dict[int, List[_Pending]] = {}
        for p in batch:
            groups.setdefault(p.frames.shape[0], []).append(p)
        for n_frames, group in groups.items():
            try:
                results = self._score_group(n_frames, group)
            except Exception as exc:
                for p in group:
                    if not p.future.done():
                        p.future.set_exception(exc)
                continue
            for p, result in zip(group, results):
                if not p.future.done():
                    p.future.set_result(result)

    def _score_group(self, n_frames: int, group: List[_Pending]):
        b = self._batch_bucket(len(group))
        frames = np.zeros((b, n_frames, vad_ops.VAD_FRAME_SAMPLES), np.float32)
        for i, p in enumerate(group):
            frames[i] = p.frames
        states = [p.state for p in group]
        # padding rows take a fresh state; their outputs are discarded
        states.extend(vad_ops.init_state(np) for _ in range(b - len(group)))
        return self._score_device(frames, states)[:len(group)]

    def _score_device(self, frames: np.ndarray, states: List[vad_ops.VadState]):
        """One device call over (B, F, 512) frames: [(probs (F,), state)]
        a row."""
        t0 = time.monotonic()
        b, n_frames = frames.shape[:2]
        packed_state = np.empty((b, 2), np.float32)
        for i, s in enumerate(states):
            packed_state[i] = (s.noise_floor, s.prob)
        on_stream = (torch.cuda.stream(self._stream) if self._stream is not None
                     else contextlib.nullcontext())
        with torch.inference_mode(), on_stream:
            dev_frames = torch.from_numpy(frames).to(self.device)
            dev_state = torch.from_numpy(packed_state).to(self.device)
            probs, floor, prob = vad_ops.vad_step_torch(dev_frames, dev_state[:, 0],
                                                        dev_state[:, 1], self._consts)
            out = torch.cat([probs, floor[:, None], prob[:, None]], dim=1).cpu().numpy()
        self.batches += 1
        if self._metrics is not None:
            self._metrics.record_vad_scorer_batch(time.monotonic() - t0)
        return [(out[i, :n_frames].copy(),
                 vad_ops.VadState(np.float32(out[i, n_frames]), np.float32(out[i, n_frames + 1]),
                                  np.int32(int(s.frames_seen) + n_frames)))
                for i, s in enumerate(states)]


__all__ = ["BatchedVadScorer", "scorer_device"]
